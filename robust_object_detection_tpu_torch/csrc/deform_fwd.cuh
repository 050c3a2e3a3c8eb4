// The gather of multi-scale deformable attention, shared by K5 forward
// (ms_deform_attn.cu, out in values' dtype) and K5-g2 forward
// (ms_deform_attn_sorted.cu, out f32): one warp per (batch, query, head),
// lanes = (tap slot, channel group), value rows read in 16-byte pieces,
// each lane its own tap's geometry, the slots summed with xor shuffles in a
// fixed order. ms_deform_attn.cu's header gives the design and its bound.
//
// values (B, HW, NH, DH) T; loc (B, Q, NH, L, P, 2) f32; attn (B, Q, NH,
// L, P) f32; out (B, Q, NH, DH) OutT, one store of the f32 sum (one
// rounding where OutT is bf16).
#pragma once

#include <stdint.h>

#include "deform_rows.cuh"

namespace rodt {

// Tap k of one (batch, query, head): the cell it reads in values' merged HW
// axis and its weight attn * bilinear weight. A tap outside its level's
// map gets weight 0 and cell 0, a valid row, so its load needs no branch.
// lq, aq: the query's (L * P, 2) locations and (L * P) weights.
__device__ __forceinline__ void fwd_tap(int k, int P,
                                        const float* __restrict__ lq,
                                        const float* __restrict__ aq,
                                        const Levels& lv, int& cell,
                                        float& wgt) {
  const int i = k >> 2, corner = k & 3, l = i / P;
  const int lw = pick_level(lv.w, l), lh = pick_level(lv.h, l);
  const float sx = lq[2 * i] * (float)lw - 0.5f;
  const float sy = lq[2 * i + 1] * (float)lh - 0.5f;
  const float flx = floorf(sx), fly = floorf(sy);
  const float fx = sx - flx, fy = sy - fly;
  // far outside either way: every tap has weight 0; keep the ints sane
  const int tx = (int)fminf(fmaxf(flx, -2.f), (float)lw) + (corner & 1);
  const int ty = (int)fminf(fmaxf(fly, -2.f), (float)lh) + (corner >> 1);
  const bool in = tx >= 0 && tx < lw && ty >= 0 && ty < lh;
  const float w = ((corner & 1) ? fx : 1.f - fx) *
                  ((corner >> 1) ? fy : 1.f - fy) * aq[i];
  cell = in ? pick_level(lv.start, l) + ty * lw + tx : 0;
  wgt = in ? w : 0.f;
}

// Sums the slots of each channel group over the warp (xor shuffles, the
// same order for every query); every lane ends with its group's sums.
template <int VEC>
__device__ __forceinline__ void reduce_slots(float (&acc)[VEC], int RL) {
  for (int off = RL; off < 32; off <<= 1)  // uniform
#pragma unroll
    for (int j = 0; j < VEC; ++j)
      acc[j] += __shfl_xor_sync(0xffffffffu, acc[j], off);
}

// The kernel and its launchers have internal linkage: each source that
// includes this header registers its own instantiations.
namespace {

// One warp per (batch, query, head). FL, FP, FRL > 0: the model's (L, P) =
// (3, 4) with DH = FRL * VEC = 32, every tap's geometry and load issued
// before the first FMA (6 rounds in bf16, 12 in f32); 0: any L, P, DH and
// RL, four rounds of loads in flight at a time, DH in passes of RL * VEC
// channels.
template <typename T, typename OutT, int VEC, int FL, int FP, int FRL>
__global__ void __launch_bounds__(THREADS)
ms_deform_attn_kernel(const T* __restrict__ values,
                      const float* __restrict__ loc,
                      const float* __restrict__ attn, OutT* __restrict__ out,
                      Levels lv, size_t n_warps, int HW, int Q, int NH,
                      int DH, int L, int P, int row_lanes) {
  const int lane = threadIdx.x & 31;
  const size_t wid =
      (size_t)blockIdx.x * (THREADS / 32) + (threadIdx.x >> 5);
  if (wid >= n_warps) return;  // the whole warp leaves together
  const int h = (int)(wid % NH);
  const size_t b = wid / NH / Q;
  const int lp = FL ? FL * FP : L * P;
  const int taps = 4 * lp;
  const int RL = FRL ? FRL : row_lanes;
  const int slots = 32 / RL;
  const int s = lane / RL, g = lane % RL;
  const float* lq = loc + wid * lp * 2;
  const float* aq = attn + wid * lp;
  const T* vb = values + (b * HW * NH + h) * (size_t)DH + g * VEC;
  const size_t ps = (size_t)NH * DH;

  if constexpr (FL > 0) {
    constexpr int ROUNDS = (4 * FL * FP + 32 / FRL - 1) / (32 / FRL);
    int cell[ROUNDS];
    float wgt[ROUNDS];
#pragma unroll
    for (int r = 0; r < ROUNDS; ++r) {
      const int k = r * slots + s;
      cell[r] = 0;
      wgt[r] = 0.f;
      if (k < taps) fwd_tap(k, FP, lq, aq, lv, cell[r], wgt[r]);
    }
    RowPiece<T, VEC> raw[ROUNDS];
#pragma unroll
    for (int r = 0; r < ROUNDS; ++r) raw[r].load(vb + cell[r] * ps);
    float acc[VEC] = {};
#pragma unroll
    for (int r = 0; r < ROUNDS; ++r)
#pragma unroll
      for (int j = 0; j < VEC; ++j)
        acc[j] = fmaf(wgt[r], raw[r].get(j), acc[j]);
    reduce_slots<VEC>(acc, RL);
    if (s == 0) store_piece<OutT, VEC>(out + wid * DH + g * VEC, acc);
  } else {
    constexpr int BURST = 4;  // rounds whose loads are in flight together
    for (int c0 = 0; c0 < DH; c0 += RL * VEC) {  // uniform
      const bool live = c0 + g * VEC < DH;
      float acc[VEC] = {};
      for (int r0 = 0; r0 * slots < taps; r0 += BURST) {  // uniform
        int cell[BURST];
        float wgt[BURST];
        RowPiece<T, VEC> raw[BURST];
#pragma unroll
        for (int u = 0; u < BURST; ++u) {
          const int k = (r0 + u) * slots + s;
          cell[u] = 0;
          wgt[u] = 0.f;
          if (k < taps) fwd_tap(k, P, lq, aq, lv, cell[u], wgt[u]);
        }
#pragma unroll
        for (int u = 0; u < BURST; ++u) {
          if (live && (r0 + u) * slots + s < taps)
            raw[u].load(vb + c0 + cell[u] * ps);
          else
            raw[u].zero();
        }
#pragma unroll
        for (int u = 0; u < BURST; ++u)
#pragma unroll
          for (int j = 0; j < VEC; ++j)
            acc[j] = fmaf(wgt[u], raw[u].get(j), acc[j]);
      }
      reduce_slots<VEC>(acc, RL);
      if (s == 0 && live)
        store_piece<OutT, VEC>(out + wid * DH + c0 + g * VEC, acc);
    }
  }
}

template <typename T, typename OutT, int VEC>
inline int launch_ms_deform(const void* values, const void* loc,
                            const void* attn, void* out, const Levels& lv,
                            int B, int HW, int Q, int NH, int DH, int L,
                            int P, int row_lanes, int fixed,
                            cudaStream_t st) {
  const size_t n_warps = (size_t)B * Q * NH;
  const size_t per_block = THREADS / 32;
  const size_t blocks = (n_warps + per_block - 1) / per_block;
  if (blocks > 0x7fffffffu) return static_cast<int>(cudaErrorInvalidValue);
  const T* v = static_cast<const T*>(values);
  const float* l = static_cast<const float*>(loc);
  const float* a = static_cast<const float*>(attn);
  OutT* o = static_cast<OutT*>(out);
  if constexpr (VEC > 1) {
    if (fixed) {
      ms_deform_attn_kernel<T, OutT, VEC, 3, 4, 32 / VEC>
          <<<(unsigned)blocks, THREADS, 0, st>>>(v, l, a, o, lv, n_warps, HW,
                                                 Q, NH, DH, L, P, row_lanes);
      return static_cast<int>(cudaGetLastError());
    }
  }
  ms_deform_attn_kernel<T, OutT, VEC, 0, 0, 0>
      <<<(unsigned)blocks, THREADS, 0, st>>>(v, l, a, o, lv, n_warps, HW, Q,
                                             NH, DH, L, P, row_lanes);
  return static_cast<int>(cudaGetLastError());
}

// The gather's arguments checked: the plan (vec, row_lanes, fixed of
// kernels.deform_fwd_plan) against the shapes and the pointers of values
// and out; fills lv from levels, 3 * L host ints (H_l, W_l, start_l).
inline bool deform_fwd_ok(Levels& lv, const void* values, const void* out,
                          const int* levels, int B, int HW, int Q, int NH,
                          int DH, int L, int P, int dtype, int vec,
                          int row_lanes, int fixed) {
  const int esize = dtype == DTYPE_BF16 ? 2 : 4;
  const bool aligned = (DH * esize) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(values) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(out) % 16 == 0;
  return B > 0 && HW > 0 && Q > 0 && NH > 0 && DH > 0 && P > 0 &&
         (dtype == DTYPE_F32 || dtype == DTYPE_BF16) &&
         fill_levels(lv, levels, L) && L * P <= 32 && row_lanes >= 1 &&
         row_lanes <= 32 && !(row_lanes & (row_lanes - 1)) &&
         (vec == 1 || (vec == 16 / esize && aligned)) &&
         (!fixed ||
          (vec > 1 && L == 3 && P == 4 && DH == 32 && row_lanes * vec == 32));
}

// The gather's launch, by values' dtype, after deform_fwd_ok; F32_OUT: out
// is f32 whatever values' dtype (K5-g2), else values' dtype (K5).
template <bool F32_OUT>
inline int launch_deform_fwd(const void* values, const void* loc,
                             const void* attn, void* out, const int* levels,
                             int B, int HW, int Q, int NH, int DH, int L,
                             int P, int dtype, int vec, int row_lanes,
                             int fixed, cudaStream_t st) {
  using OutBf16 = typename std::conditional<F32_OUT, float,
                                            __nv_bfloat16>::type;
  Levels lv;
  if (!deform_fwd_ok(lv, values, out, levels, B, HW, Q, NH, DH, L, P, dtype,
                     vec, row_lanes, fixed))
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == DTYPE_F32)
    return vec == 1 ? launch_ms_deform<float, float, 1>(
                          values, loc, attn, out, lv, B, HW, Q, NH, DH, L,
                          P, row_lanes, 0, st)
                    : launch_ms_deform<float, float, 4>(
                          values, loc, attn, out, lv, B, HW, Q, NH, DH, L,
                          P, row_lanes, fixed, st);
  return vec == 1 ? launch_ms_deform<__nv_bfloat16, OutBf16, 1>(
                        values, loc, attn, out, lv, B, HW, Q, NH, DH, L, P,
                        row_lanes, 0, st)
                  : launch_ms_deform<__nv_bfloat16, OutBf16, 8>(
                        values, loc, attn, out, lv, B, HW, Q, NH, DH, L, P,
                        row_lanes, fixed, st);
}

}  // namespace
}  // namespace rodt
