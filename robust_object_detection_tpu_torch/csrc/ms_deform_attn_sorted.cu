// K5-g2, forward and backward: multi-scale deformable attention, the
// sorted-tap generation, for either layout of the value maps.
//
// Replaces: robust_object_detection_tpu/ops/deform.py, _fwd_pallas with its
// preparation _sorted_taps / _tpu_fwd / _tpu_fwd_t, and _bwd_pallas with its
// glue _tpu_bwd_core (public entries ms_deform_attn and ms_deform_attn_t and
// their VJPs). The function is that of ms_deform_attn.cu:
//   out[b, q, h, :] = sum over levels l, points p and the 4 bilinear taps t
//       attn[b, q, h, l, p] * wgt_t * v[b, h, cell_t, :]       (f32)
// and, given dout (B, Q, NH, DH) f32,
//   dv[b, h, cell, :]    = sum over the taps t of that cell, in tap order,
//                          dout[b, q_t, h, :] * attn * wgt_t
//   s_t = <v[b, h, cell_t, :], dout[b, q, h, :]>                 per tap
//   dattn[b, q, h, l, p] = sum_t s_t * wgt_t
//   dloc[b, q, h, l, p]  = attn * (W_l * sum_t s_t * dwx_t,
//                                  H_l * sum_t s_t * dwy_t)
// with the geometry of deform.py:_merged_geometry (pixel = loc * size - 0.5;
// weight and both derivatives 0 for a tap outside its map, whose cell index
// is clipped into the map). v is `values` (B, HW, NH, DH) or `values_t` (B,
// NH, DH, HW), f32 or bf16, read through two strides; out is f32; dv has
// v's dtype and layout.
//
// The TPU version sorts all taps of a (batch, head) by merged cell so that
// 512-tap chunks meet few 1024-cell value tiles, gathers and stamps with
// one-hot matmuls, scatters to queries with a second one-hot, and unsorts
// the per-tap scalars with a second sort of bf16-packed keys. Of that, what
// a GPU needs is the sort's one real gift: d(values) as a sum with a fixed
// order.
//   * Forward: a gather needs no sort. One warp owns a (batch, query, head),
//     lanes 0..L*P-1 work out one sampling point each, the warp walks the
//     taps with lane = channel and stores the f32 row once. With `values` a
//     tap is one coalesced row; with `values_t` its channels are HW elements
//     apart, 32 sectors a tap, of which the point's second tap in x reuses
//     the first's: the price of reading that layout in place, paid to L2,
//     against a relayout copy of the whole map before the launch.
//   * Backward, taps kernel: the same walk computes s_t with a warp
//     reduction; the lane that owns the sampling point writes dattn and
//     dloc in their own order (no unsort, s stays f32 and never reaches
//     memory), and the tap's key (cell << sb) | position and coefficient
//     attn * wgt_t for the sort.
//   * One library sort of the keys per (batch, head) row.
//   * Backward, d(values) kernel: the segmented sum of segment_sum.cuh, a
//     tap's contribution formed on the fly as c[pos] * dout[q(pos)], so no
//     (B, NH, DH, T) tensor exists. No atomics: the same bits every run,
//     and no zero fill or cast pass over d(values).
//
// What bounds it on the H100: bytes. Forward: the distinct value rows the
// taps touch, loc, attn and out. Backward: the same rows, dout, the keys
// and coefficients (written, sorted, read) and d(values), written once.

#include <stdint.h>

#include "deform_levels.cuh"
#include "segment_sum.cuh"

namespace rodt {

// One sampling point, held by lane (level * P + point) of the warp that
// owns its (batch, query, head).
struct Point {
  int x0, y0, lw, lh, lstart;
  float fx, fy, a;
};

__device__ __forceinline__ Point load_point(const float* __restrict__ loc,
                                            const float* __restrict__ attn,
                                            const Levels& lv, size_t wid,
                                            int lane, int LP, int P) {
  Point pt{0, 0, 1, 1, 0, 0.f, 0.f, 0.f};
  if (lane < LP) {
    const int l = lane / P;
    pt.lw = lv.w[l];
    pt.lh = lv.h[l];
    pt.lstart = lv.start[l];
    const float* lp = loc + (wid * LP + lane) * 2;
    const float sx = lp[0] * (float)pt.lw - 0.5f;
    const float sy = lp[1] * (float)pt.lh - 0.5f;
    const float flx = floorf(sx), fly = floorf(sy);
    pt.fx = sx - flx;
    pt.fy = sy - fly;
    // far outside either way: every tap has weight 0; keep the ints sane
    pt.x0 = (int)fminf(fmaxf(flx, -2.f), (float)pt.lw);
    pt.y0 = (int)fminf(fmaxf(fly, -2.f), (float)pt.lh);
    pt.a = attn[wid * LP + lane];
  }
  return pt;
}

__device__ __forceinline__ Point shfl_point(const Point& pt, int i) {
  const unsigned FULL = 0xffffffffu;
  Point o;
  o.x0 = __shfl_sync(FULL, pt.x0, i);
  o.y0 = __shfl_sync(FULL, pt.y0, i);
  o.lw = __shfl_sync(FULL, pt.lw, i);
  o.lh = __shfl_sync(FULL, pt.lh, i);
  o.lstart = __shfl_sync(FULL, pt.lstart, i);
  o.fx = __shfl_sync(FULL, pt.fx, i);
  o.fy = __shfl_sync(FULL, pt.fy, i);
  o.a = __shfl_sync(FULL, pt.a, i);
  return o;
}

// first element of (batch b, head h) in either layout
__device__ __forceinline__ size_t value_base(size_t b, int h, int HW, int NH,
                                             int DH, int transposed) {
  return transposed ? (b * NH + h) * (size_t)DH * HW
                    : (b * HW * NH + h) * (size_t)DH;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
sorted_fwd_kernel(const T* __restrict__ values, const float* __restrict__ loc,
                  const float* __restrict__ attn, float* __restrict__ out,
                  Levels lv, size_t n_warps, int HW, int Q, int NH, int DH,
                  int L, int P, int transposed) {
  const int lane = threadIdx.x & 31;
  const size_t wid =
      (size_t)blockIdx.x * (THREADS / 32) + (threadIdx.x >> 5);
  if (wid >= n_warps) return;  // the whole warp leaves together
  const int h = (int)(wid % NH);
  const size_t b = wid / NH / Q;
  const int LP = L * P;
  const Point mine = load_point(loc, attn, lv, wid, lane, LP, P);
  const T* vb = values + value_base(b, h, HW, NH, DH, transposed);
  const size_t cell_stride = transposed ? 1 : (size_t)NH * DH;
  const size_t chan_stride = transposed ? (size_t)HW : 1;

  for (int c = lane; c - lane < DH; c += 32) {  // uniform trip count
    float acc = 0.f;
    for (int i = 0; i < LP; ++i) {
      const Point pt = shfl_point(mine, i);
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const int tx = pt.x0 + (t & 1), ty = pt.y0 + (t >> 1);
        if (tx < 0 || tx >= pt.lw || ty < 0 || ty >= pt.lh) continue;
        const float wgt = ((t & 1) ? pt.fx : 1.f - pt.fx) *
                          ((t >> 1) ? pt.fy : 1.f - pt.fy) * pt.a;
        if (c < DH)
          acc = fmaf(wgt,
                     to_f(vb[(size_t)(pt.lstart + ty * pt.lw + tx) *
                                 cell_stride +
                             c * chan_stride]),
                     acc);
      }
    }
    if (c < DH) out[wid * DH + c] = acc;
  }
}

// dattn, dloc, and the sort's input: keys (B * NH, T) and c (B * NH, T),
// T = Q * L * P * 4, tap position pos = ((q * L + l) * P + p) * 4 + tap.
template <typename T, typename KeyT>
__global__ void __launch_bounds__(THREADS)
sorted_taps_kernel(const T* __restrict__ values,
                   const float* __restrict__ loc,
                   const float* __restrict__ attn,
                   const float* __restrict__ dout, float* __restrict__ dloc,
                   float* __restrict__ dattn, KeyT* __restrict__ keys,
                   float* __restrict__ coef, Levels lv, size_t n_warps,
                   int HW, int Q, int NH, int DH, int L, int P,
                   int transposed, int sb) {
  const unsigned FULL = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  const size_t wid =
      (size_t)blockIdx.x * (THREADS / 32) + (threadIdx.x >> 5);
  if (wid >= n_warps) return;  // the whole warp leaves together
  const int h = (int)(wid % NH);
  const int q = (int)(wid / NH % Q);
  const size_t b = wid / NH / Q;
  const int LP = L * P;
  const Point mine = load_point(loc, attn, lv, wid, lane, LP, P);

  if (lane < LP) {  // this point's four keys and coefficients
    const size_t T4 = (size_t)Q * LP * 4;
    const int pos = (q * LP + lane) * 4;
    KeyT* kp = keys + (b * NH + h) * T4 + pos;
    float* cp = coef + (b * NH + h) * T4 + pos;
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const int tx = mine.x0 + (t & 1), ty = mine.y0 + (t >> 1);
      const bool inside = tx >= 0 && tx < mine.lw && ty >= 0 && ty < mine.lh;
      const float wgt = ((t & 1) ? mine.fx : 1.f - mine.fx) *
                        ((t >> 1) ? mine.fy : 1.f - mine.fy) * mine.a;
      const int cx = min(max(tx, 0), mine.lw - 1);
      const int cy = min(max(ty, 0), mine.lh - 1);
      const KeyT cell = (KeyT)(mine.lstart + cy * mine.lw + cx);
      kp[t] = (KeyT)((cell << sb) | (KeyT)(pos + t));
      cp[t] = inside ? wgt : 0.f;
    }
  }

  const size_t base = value_base(b, h, HW, NH, DH, transposed);
  const size_t cell_stride = transposed ? 1 : (size_t)NH * DH;
  const size_t chan_stride = transposed ? (size_t)HW : 1;
  const float* dop = dout + wid * DH;
  float my_da = 0.f, my_dx = 0.f, my_dy = 0.f;  // of sampling point `lane`
  for (int i = 0; i < LP; ++i) {
    const Point pt = shfl_point(mine, i);
    float da = 0.f, dx = 0.f, dy = 0.f;
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const int tx = pt.x0 + (t & 1), ty = pt.y0 + (t >> 1);
      if (tx < 0 || tx >= pt.lw || ty < 0 || ty >= pt.lh) continue;
      const float wx = (t & 1) ? pt.fx : 1.f - pt.fx;
      const float wy = (t >> 1) ? pt.fy : 1.f - pt.fy;
      const size_t row =
          base + (size_t)(pt.lstart + ty * pt.lw + tx) * cell_stride;
      float s = 0.f;
      for (int c = lane; c < DH; c += 32)
        s = fmaf(to_f(values[row + c * chan_stride]), dop[c], s);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        s += __shfl_xor_sync(FULL, s, off);
      da = fmaf(s, wx * wy, da);
      dx = fmaf(s, (t & 1) ? wy : -wy, dx);
      dy = fmaf(s, (t >> 1) ? wx : -wx, dy);
    }
    if (lane == i) {
      my_da = da;
      my_dx = dx * pt.a * (float)pt.lw;
      my_dy = dy * pt.a * (float)pt.lh;
    }
  }
  if (lane < LP) {
    dattn[wid * LP + lane] = my_da;
    dloc[(wid * LP + lane) * 2] = my_dx;
    dloc[(wid * LP + lane) * 2 + 1] = my_dy;
  }
}

// A tap's share of d(values): coef[pos] * dout[b, q(pos), h, :].
struct DoutContrib {
  const float* __restrict__ coef;  // this row's (T)
  const float* __restrict__ dout;  // this (batch, head)'s first element
  size_t q_stride;                 // NH * DH
  int taps_per_q, DH;
  float cw;
  int q;
  __device__ __forceinline__ void prefetch(int pos, bool live) {
    cw = live ? coef[pos] : 0.f;
    q = pos / taps_per_q;
  }
  __device__ __forceinline__ float value(int j, int d) const {
    const float w = __shfl_sync(0xffffffffu, cw, j);
    const int qq = __shfl_sync(0xffffffffu, q, j);
    return d < DH ? w * dout[qq * q_stride + d] : 0.f;
  }
};

template <typename T, typename KeyT>
__global__ void __launch_bounds__(THREADS)
sorted_dvalues_kernel(const KeyT* __restrict__ keys,
                      const float* __restrict__ coef,
                      const float* __restrict__ dout, T* __restrict__ dv,
                      int tiles, int Tn, int sb, int HW, int Q, int NH,
                      int DH, int taps_per_q, int transposed) {
  const size_t row = blockIdx.x / tiles;  // b * NH + h
  const size_t b = row / NH;
  const int h = (int)(row % NH);
  DoutContrib contrib{coef + row * Tn,
                      dout + (b * Q * NH + h) * (size_t)DH,
                      (size_t)NH * DH, taps_per_q, DH, 0.f, 0};
  segment_sum_tile<KeyT, T>(
      keys + row * Tn, Tn, sb, HW, DH, (int)(blockIdx.x % tiles), contrib,
      dv + value_base(b, h, HW, NH, DH, transposed),
      transposed ? 1 : (size_t)NH * DH, transposed ? (size_t)HW : 1);
}

inline bool sorted_args_ok(int B, int HW, int Q, int NH, int DH, int L,
                           int P) {
  return B > 0 && HW > 0 && Q > 0 && NH > 0 && DH > 0 && P > 0 && L > 0 &&
         L <= MAX_LEVELS && L * P <= 32 &&
         (size_t)Q * L * P * 4 <= 0x7fffffffu;
}

inline unsigned point_blocks(int B, int Q, int NH) {
  const size_t n_warps = (size_t)B * Q * NH;
  const size_t per_block = THREADS / 32;
  const size_t blocks = (n_warps + per_block - 1) / per_block;
  return blocks > 0x7fffffffu ? 0u : (unsigned)blocks;
}

template <typename T>
inline int launch_sorted_fwd(const void* values, const void* loc,
                             const void* attn, void* out, const Levels& lv,
                             int B, int HW, int Q, int NH, int DH, int L,
                             int P, int transposed, cudaStream_t st) {
  const unsigned blocks = point_blocks(B, Q, NH);
  if (blocks == 0) return static_cast<int>(cudaErrorInvalidValue);
  sorted_fwd_kernel<T><<<blocks, THREADS, 0, st>>>(
      static_cast<const T*>(values), static_cast<const float*>(loc),
      static_cast<const float*>(attn), static_cast<float*>(out), lv,
      (size_t)B * Q * NH, HW, Q, NH, DH, L, P, transposed);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename KeyT>
inline int launch_sorted_taps(const void* values, const void* loc,
                              const void* attn, const void* dout, void* dloc,
                              void* dattn, void* keys, void* coef,
                              const Levels& lv, int B, int HW, int Q, int NH,
                              int DH, int L, int P, int transposed, int sb,
                              cudaStream_t st) {
  const unsigned blocks = point_blocks(B, Q, NH);
  if (blocks == 0) return static_cast<int>(cudaErrorInvalidValue);
  sorted_taps_kernel<T, KeyT><<<blocks, THREADS, 0, st>>>(
      static_cast<const T*>(values), static_cast<const float*>(loc),
      static_cast<const float*>(attn), static_cast<const float*>(dout),
      static_cast<float*>(dloc), static_cast<float*>(dattn),
      static_cast<KeyT*>(keys), static_cast<float*>(coef), lv,
      (size_t)B * Q * NH, HW, Q, NH, DH, L, P, transposed, sb);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename KeyT>
inline int launch_sorted_dvalues(const void* keys, const void* coef,
                                 const void* dout, void* dv, int B, int HW,
                                 int Q, int NH, int DH, int taps_per_q,
                                 int transposed, int sb, cudaStream_t st) {
  const unsigned blocks = segment_sum_blocks(B * NH, HW);
  if (blocks == 0) return static_cast<int>(cudaErrorInvalidValue);
  const int tiles = (HW + SEG_CELLS - 1) / SEG_CELLS;
  sorted_dvalues_kernel<T, KeyT><<<blocks, THREADS, 0, st>>>(
      static_cast<const KeyT*>(keys), static_cast<const float*>(coef),
      static_cast<const float*>(dout), static_cast<T*>(dv), tiles,
      Q * taps_per_q, sb, HW, Q, NH, DH, taps_per_q, transposed);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace rodt

// values (B, HW, NH, DH), or (B, NH, DH, HW) when transposed != 0, f32 or
// bf16; loc (B, Q, NH, L, P, 2) and attn (B, Q, NH, L, P) f32; out (B, Q,
// NH, DH) f32; levels: 3 * L host ints (H_l, W_l, start_l).
extern "C" int ms_deform_attn_sorted_fwd(const void* values, const void* loc,
                                         const void* attn, void* out,
                                         const int* levels, int B, int HW,
                                         int Q, int NH, int DH, int L, int P,
                                         int dtype, int transposed,
                                         void* stream) {
  rodt::Levels lv;
  if (!rodt::sorted_args_ok(B, HW, Q, NH, DH, L, P) ||
      !rodt::fill_levels(lv, levels, L))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == rodt::DTYPE_F32)
    return rodt::launch_sorted_fwd<float>(values, loc, attn, out, lv, B, HW,
                                          Q, NH, DH, L, P, transposed, st);
  if (dtype == rodt::DTYPE_BF16)
    return rodt::launch_sorted_fwd<__nv_bfloat16>(
        values, loc, attn, out, lv, B, HW, Q, NH, DH, L, P, transposed, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The backward's first kernel. dout (B, Q, NH, DH) f32; writes dloc, dattn
// (f32, the shapes of loc and attn) and, for the sort, keys (B * NH, T)
// int32 (key_bytes 4) or int64 (8) = (cell << sb) | tap position, and coef
// (B * NH, T) f32 = attn * bilinear weight; T = Q * L * P * 4 < 2^sb.
extern "C" int ms_deform_attn_sorted_taps(
    const void* values, const void* loc, const void* attn, const void* dout,
    void* dloc, void* dattn, void* keys, void* coef, const int* levels, int B,
    int HW, int Q, int NH, int DH, int L, int P, int dtype, int transposed,
    int sb, int key_bytes, void* stream) {
  rodt::Levels lv;
  if (!rodt::sorted_args_ok(B, HW, Q, NH, DH, L, P) ||
      !rodt::fill_levels(lv, levels, L) || sb < 0 || sb > 31 ||
      (key_bytes != 4 && key_bytes != 8) ||
      (dtype != rodt::DTYPE_F32 && dtype != rodt::DTYPE_BF16))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool f32 = dtype == rodt::DTYPE_F32;
#define RODT_TAPS(T, K)                                                     \
  rodt::launch_sorted_taps<T, K>(values, loc, attn, dout, dloc, dattn,      \
                                 keys, coef, lv, B, HW, Q, NH, DH, L, P,    \
                                 transposed, sb, st)
  if (key_bytes == 4)
    return f32 ? RODT_TAPS(float, int32_t) : RODT_TAPS(__nv_bfloat16, int32_t);
  return f32 ? RODT_TAPS(float, int64_t) : RODT_TAPS(__nv_bfloat16, int64_t);
#undef RODT_TAPS
}

// The backward's second kernel, after the caller sorted each row of keys:
// dv in the dtype and layout of values, every element written.
extern "C" int ms_deform_attn_sorted_dvalues(
    const void* keys, const void* coef, const void* dout, void* dv, int B,
    int HW, int Q, int NH, int DH, int taps_per_q, int dtype, int transposed,
    int sb, int key_bytes, void* stream) {
  if (B <= 0 || HW <= 0 || Q <= 0 || NH <= 0 || DH <= 0 || taps_per_q <= 0 ||
      (size_t)Q * taps_per_q > 0x7fffffffu || sb < 0 || sb > 31 ||
      (key_bytes != 4 && key_bytes != 8) ||
      (dtype != rodt::DTYPE_F32 && dtype != rodt::DTYPE_BF16))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool f32 = dtype == rodt::DTYPE_F32;
#define RODT_DV(T, K)                                                       \
  rodt::launch_sorted_dvalues<T, K>(keys, coef, dout, dv, B, HW, Q, NH, DH, \
                                    taps_per_q, transposed, sb, st)
  if (key_bytes == 4)
    return f32 ? RODT_DV(float, int32_t) : RODT_DV(__nv_bfloat16, int32_t);
  return f32 ? RODT_DV(float, int64_t) : RODT_DV(__nv_bfloat16, int64_t);
#undef RODT_DV
}
