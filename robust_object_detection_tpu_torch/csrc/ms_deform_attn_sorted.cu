// K5-g2 forward: multi-scale deformable attention, the sorted-tap
// generation, for either layout of the value maps.
//
// Replaces: robust_object_detection_tpu/ops/deform.py, _fwd_pallas with its
// preparation _sorted_taps / _tpu_fwd / _tpu_fwd_t (public entries
// ms_deform_attn and ms_deform_attn_t). The function is that of
// ms_deform_attn.cu:
//   out[b, q, h, :] = sum over levels l, points p and the 4 bilinear taps t
//       attn[b, q, h, l, p] * wgt_t * v[b, h, cell_t, :]       (f32)
// with the geometry of deform.py:_merged_geometry (pixel = loc * size - 0.5;
// weight 0 for a tap outside its map). v is `values` (B, HW, NH, DH) or
// `values_t` (B, NH, DH, HW), f32 or bf16, read through two strides; out is
// f32. The backward of both entries is deform_bwd.cu, shared with K5.
//
// The TPU version sorts all taps of a (batch, head) by merged cell so that
// 512-tap chunks meet few 1024-cell value tiles, gathers with one-hot
// matmuls and scatters to queries with a second one-hot. A gather needs no
// sort. One warp owns a (batch, query, head), lanes 0..L*P-1 work out one
// sampling point each, the warp walks the taps with lane = channel and
// stores the f32 row once. With `values` a tap is one coalesced row; with
// `values_t` its channels are HW elements apart, 32 sectors a tap, of which
// the point's second tap in x reuses the first's: the price of reading that
// layout in place, paid to L2, against a relayout copy of the whole map
// before the launch.
//
// What bounds it on the H100: bytes, the distinct value rows the taps
// touch, loc, attn and out.

#include <stdint.h>

#include "conv_tile.cuh"
#include "deform_levels.cuh"

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
