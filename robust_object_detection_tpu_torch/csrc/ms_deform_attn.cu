// K5, forward and backward: multi-scale deformable attention
// (Deformable-DETR sampling).
//
// Replaces: robust_object_detection_tpu/ops/deform.py, _slots_fwd_pallas
// and _slots_bwd_pallas with its glue _slots_bwd (public entry
// ms_deform_attn_slots and its VJP). Forward:
//   out[b, q, h, :] = sum over levels l, points p and the 4 bilinear taps t
//       attn[b, q, h, l, p] * wgt_t * values[b, start_l + y_t * W_l + x_t,
//                                            h, :]
// with sx = loc_x * W_l - 0.5, sy = loc_y * H_l - 0.5, (x0, y0) = floor,
// the taps (x0, y0), (x0+1, y0), (x0, y0+1), (x0+1, y0+1) weighted
// (1-fx)(1-fy), fx(1-fy), (1-fx)fy, fx fy, and weight 0 for a tap outside
// its level's map (deform.py:_geometry_batched).
//
// The TPU version has no gather unit: it lays taps out in (level, query)
// slots, gathers by multiplying value tiles with one-hot matrices between
// per-chunk [lo, hi] tile bounds, and pads Q to whole chunks. A GPU
// gathers. Here one warp owns one (batch, query, head): lanes 0..L*P-1
// each work out one sampling point's geometry, the warp then walks the
// points, every lane reading its channel of the tap's value row (dh = 32:
// one coalesced 64- or 128-byte row per tap), accumulating in f32, and
// stores the row once. No shared memory, no atomics, no order among warps,
// so any query order gives the same bits.
//
// values (B, HW, NH, DH) f32 or bf16; loc (B, Q, NH, L, P, 2) f32 in
// [0, 1]; attn (B, Q, NH, L, P) f32; out (B, Q, NH, DH) in values' dtype
// (one rounding of the f32 sum).
//
// What bounds it on the H100: bytes. At the RT-DETR-L shapes (B 8, Q 300,
// 8 heads, 3 levels x 4 points) it gathers at most 8*300*8*48 rows of 64
// bytes (bf16) and does 2 FLOP per gathered element; the rows of one query
// are scattered, so the floor is the gathered bytes over the memory rate.
//
// Backward (ms_deform_attn_bwd), given dout (B, Q, NH, DH):
//   dV[b, cell_t, h, :] += dout[b, q, h, :] * wgt_t * attn      (f32)
//   s_t = <values[b, cell_t, h, :], dout[b, q, h, :]>            per tap
//   dattn[b, q, h, l, p] = sum_t s_t * wgt_t
//   dloc[b, q, h, l, p]  = attn * (W_l * sum_t s_t * dwx_t,
//                                  H_l * sum_t s_t * dwy_t)
// with dwx_t, dwy_t the derivatives of the bilinear weights by the pixel
// coordinate (deform.py:_geometry_batched) and nothing from a tap outside
// its map. The TPU version re-gathers with one-hot matmuls, stamps dV one
// value tile at a time and hands the (B,Q,H,L,P,4) tap scalars to XLA
// glue. Here the same warp-per-(batch, query, head) walk as the forward
// does all of it: per tap every lane loads its channel of the value row,
// adds its share of dV with an f32 atomicAdd (two queries may hit one
// cell) and the warp reduces <row, dout> with xor shuffles; the lane that
// owns the sampling point keeps the three sums and writes dattn and dloc
// itself, so the tap scalars never reach memory. The atomics make the
// last bits of dV depend on the order the warps arrive in; dattn and dloc
// involve no atomics and keep their bits under any query order. The
// caller zeroes the f32 dV first and casts it to values' dtype after.
// Bound: bytes again, the zero fill, the atomics' traffic and the cast of
// the dV buffer (B x HW x NH x DH x 4 bytes) on top of the gathered rows.

#include "conv_tile.cuh"

namespace rodt {

constexpr int MAX_LEVELS = 4;

struct Levels {
  int h[MAX_LEVELS];
  int w[MAX_LEVELS];
  int start[MAX_LEVELS];
};

template <typename T>
__global__ void __launch_bounds__(THREADS)
ms_deform_attn_kernel(const T* __restrict__ values,
                      const float* __restrict__ loc,
                      const float* __restrict__ attn, T* __restrict__ out,
                      Levels lv, size_t n_warps, int HW, int Q, int NH,
                      int DH, int L, int P) {
  const unsigned FULL = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  const size_t wid =
      (size_t)blockIdx.x * (THREADS / 32) + (threadIdx.x >> 5);
  if (wid >= n_warps) return;  // the whole warp leaves together
  const int h = (int)(wid % NH);
  const size_t b = wid / NH / Q;
  const int LP = L * P;

  // lane i < LP: the geometry of sampling point i = (level, point)
  int x0 = 0, y0 = 0, lw = 1, lh = 1, lstart = 0;
  float fx = 0.f, fy = 0.f, a = 0.f;
  if (lane < LP) {
    const int l = lane / P;
    lw = lv.w[l];
    lh = lv.h[l];
    lstart = lv.start[l];
    const float* lp = loc + (wid * LP + lane) * 2;
    const float sx = lp[0] * (float)lw - 0.5f;
    const float sy = lp[1] * (float)lh - 0.5f;
    const float flx = floorf(sx), fly = floorf(sy);
    fx = sx - flx;
    fy = sy - fly;
    // far outside either way: every tap has weight 0; keep the ints sane
    x0 = (int)fminf(fmaxf(flx, -2.f), (float)lw);
    y0 = (int)fminf(fmaxf(fly, -2.f), (float)lh);
    a = attn[wid * LP + lane];
  }

  const T* vb = values + (b * HW * NH + h) * (size_t)DH;
  const size_t pix_stride = (size_t)NH * DH;
  for (int c = lane; c - lane < DH; c += 32) {  // uniform trip count
    float acc = 0.f;
    for (int i = 0; i < LP; ++i) {
      const int xi = __shfl_sync(FULL, x0, i);
      const int yi = __shfl_sync(FULL, y0, i);
      const int wi = __shfl_sync(FULL, lw, i);
      const int hi = __shfl_sync(FULL, lh, i);
      const int si = __shfl_sync(FULL, lstart, i);
      const float fxi = __shfl_sync(FULL, fx, i);
      const float fyi = __shfl_sync(FULL, fy, i);
      const float ai = __shfl_sync(FULL, a, i);
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const int tx = xi + (t & 1), ty = yi + (t >> 1);
        if (tx < 0 || tx >= wi || ty < 0 || ty >= hi) continue;
        const float wgt = ((t & 1) ? fxi : 1.f - fxi) *
                          ((t >> 1) ? fyi : 1.f - fyi) * ai;
        if (c < DH)
          acc = fmaf(wgt,
                     to_f(vb[(size_t)(si + ty * wi + tx) * pix_stride + c]),
                     acc);
      }
    }
    if (c < DH) out[wid * DH + c] = from_f<T>(acc);
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
ms_deform_attn_bwd_kernel(const T* __restrict__ values,
                          const float* __restrict__ loc,
                          const float* __restrict__ attn,
                          const T* __restrict__ dout, float* __restrict__ dv,
                          float* __restrict__ dloc, float* __restrict__ dattn,
                          Levels lv, size_t n_warps, int HW, int Q, int NH,
                          int DH, int L, int P) {
  const unsigned FULL = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  const size_t wid =
      (size_t)blockIdx.x * (THREADS / 32) + (threadIdx.x >> 5);
  if (wid >= n_warps) return;  // the whole warp leaves together
  const int h = (int)(wid % NH);
  const size_t b = wid / NH / Q;
  const int LP = L * P;

  int x0 = 0, y0 = 0, lw = 1, lh = 1, lstart = 0;
  float fx = 0.f, fy = 0.f, a = 0.f;
  if (lane < LP) {
    const int l = lane / P;
    lw = lv.w[l];
    lh = lv.h[l];
    lstart = lv.start[l];
    const float* lp = loc + (wid * LP + lane) * 2;
    const float sx = lp[0] * (float)lw - 0.5f;
    const float sy = lp[1] * (float)lh - 0.5f;
    const float flx = floorf(sx), fly = floorf(sy);
    fx = sx - flx;
    fy = sy - fly;
    x0 = (int)fminf(fmaxf(flx, -2.f), (float)lw);
    y0 = (int)fminf(fmaxf(fly, -2.f), (float)lh);
    a = attn[wid * LP + lane];
  }

  const size_t base = (b * HW * NH + h) * (size_t)DH;
  const size_t pix_stride = (size_t)NH * DH;
  const T* dop = dout + wid * DH;
  float my_da = 0.f, my_dx = 0.f, my_dy = 0.f;  // of sampling point `lane`
  for (int i = 0; i < LP; ++i) {
    const int xi = __shfl_sync(FULL, x0, i);
    const int yi = __shfl_sync(FULL, y0, i);
    const int wi = __shfl_sync(FULL, lw, i);
    const int hi = __shfl_sync(FULL, lh, i);
    const int si = __shfl_sync(FULL, lstart, i);
    const float fxi = __shfl_sync(FULL, fx, i);
    const float fyi = __shfl_sync(FULL, fy, i);
    const float ai = __shfl_sync(FULL, a, i);
    float da = 0.f, dx = 0.f, dy = 0.f;
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const int tx = xi + (t & 1), ty = yi + (t >> 1);
      if (tx < 0 || tx >= wi || ty < 0 || ty >= hi) continue;  // uniform
      const float wx = (t & 1) ? fxi : 1.f - fxi;
      const float wy = (t >> 1) ? fyi : 1.f - fyi;
      const float wgt = wx * wy;
      const size_t row = base + (size_t)(si + ty * wi + tx) * pix_stride;
      float s = 0.f;
      for (int c = lane; c < DH; c += 32) {
        const float d = to_f(dop[c]);
        s = fmaf(to_f(values[row + c]), d, s);
        atomicAdd(dv + row + c, d * (wgt * ai));
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        s += __shfl_xor_sync(FULL, s, off);
      da = fmaf(s, wgt, da);
      dx = fmaf(s, (t & 1) ? wy : -wy, dx);
      dy = fmaf(s, (t >> 1) ? wx : -wx, dy);
    }
    if (lane == i) {
      my_da = da;
      my_dx = dx * ai * (float)wi;
      my_dy = dy * ai * (float)hi;
    }
  }
  if (lane < LP) {
    dattn[wid * LP + lane] = my_da;
    dloc[(wid * LP + lane) * 2] = my_dx;
    dloc[(wid * LP + lane) * 2 + 1] = my_dy;
  }
}

template <typename T>
inline int launch_ms_deform_bwd(const void* values, const void* loc,
                                const void* attn, const void* dout, void* dv,
                                void* dloc, void* dattn, const Levels& lv,
                                int B, int HW, int Q, int NH, int DH, int L,
                                int P, cudaStream_t st) {
  const size_t n_warps = (size_t)B * Q * NH;
  const size_t per_block = THREADS / 32;
  const size_t blocks = (n_warps + per_block - 1) / per_block;
  if (blocks > 0x7fffffffu) return static_cast<int>(cudaErrorInvalidValue);
  ms_deform_attn_bwd_kernel<T><<<(unsigned)blocks, THREADS, 0, st>>>(
      static_cast<const T*>(values), static_cast<const float*>(loc),
      static_cast<const float*>(attn), static_cast<const T*>(dout),
      static_cast<float*>(dv), static_cast<float*>(dloc),
      static_cast<float*>(dattn), lv, n_warps, HW, Q, NH, DH, L, P);
  return static_cast<int>(cudaGetLastError());
}

inline bool fill_levels(Levels& lv, const int* levels, int L) {
  if (L <= 0 || L > MAX_LEVELS) return false;
  for (int l = 0; l < MAX_LEVELS; ++l) {
    lv.h[l] = l < L ? levels[3 * l] : 1;
    lv.w[l] = l < L ? levels[3 * l + 1] : 1;
    lv.start[l] = l < L ? levels[3 * l + 2] : 0;
  }
  return true;
}

template <typename T>
inline int launch_ms_deform(const void* values, const void* loc,
                            const void* attn, void* out, const Levels& lv,
                            int B, int HW, int Q, int NH, int DH, int L,
                            int P, cudaStream_t st) {
  const size_t n_warps = (size_t)B * Q * NH;
  const size_t per_block = THREADS / 32;
  const size_t blocks = (n_warps + per_block - 1) / per_block;
  if (blocks > 0x7fffffffu) return static_cast<int>(cudaErrorInvalidValue);
  ms_deform_attn_kernel<T><<<(unsigned)blocks, THREADS, 0, st>>>(
      static_cast<const T*>(values), static_cast<const float*>(loc),
      static_cast<const float*>(attn), static_cast<T*>(out), lv, n_warps,
      HW, Q, NH, DH, L, P);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace rodt

// levels: 3 * L host ints, (H_l, W_l, start_l) per level, start_l the flat
// offset of the level's first cell in the HW axis of values.
extern "C" int ms_deform_attn_fwd(const void* values, const void* loc,
                                  const void* attn, void* out,
                                  const int* levels, int B, int HW, int Q,
                                  int NH, int DH, int L, int P, int dtype,
                                  void* stream) {
  rodt::Levels lv;
  if (B <= 0 || HW <= 0 || Q <= 0 || NH <= 0 || DH <= 0 || P <= 0 ||
      !rodt::fill_levels(lv, levels, L) || L * P > 32)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == rodt::DTYPE_F32)
    return rodt::launch_ms_deform<float>(values, loc, attn, out, lv, B, HW,
                                         Q, NH, DH, L, P, st);
  if (dtype == rodt::DTYPE_BF16)
    return rodt::launch_ms_deform<__nv_bfloat16>(values, loc, attn, out, lv,
                                                 B, HW, Q, NH, DH, L, P, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// dout (B, Q, NH, DH) in values' dtype; dv (B, HW, NH, DH) f32, zeroed by
// the caller; dloc (B, Q, NH, L, P, 2) and dattn (B, Q, NH, L, P) f32.
extern "C" int ms_deform_attn_bwd(const void* values, const void* loc,
                                  const void* attn, const void* dout,
                                  void* dv, void* dloc, void* dattn,
                                  const int* levels, int B, int HW, int Q,
                                  int NH, int DH, int L, int P, int dtype,
                                  void* stream) {
  rodt::Levels lv;
  if (B <= 0 || HW <= 0 || Q <= 0 || NH <= 0 || DH <= 0 || P <= 0 ||
      !rodt::fill_levels(lv, levels, L) || L * P > 32)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == rodt::DTYPE_F32)
    return rodt::launch_ms_deform_bwd<float>(values, loc, attn, dout, dv,
                                             dloc, dattn, lv, B, HW, Q, NH,
                                             DH, L, P, st);
  if (dtype == rodt::DTYPE_BF16)
    return rodt::launch_ms_deform_bwd<__nv_bfloat16>(
        values, loc, attn, dout, dv, dloc, dattn, lv, B, HW, Q, NH, DH, L, P,
        st);
  return static_cast<int>(cudaErrorInvalidValue);
}
