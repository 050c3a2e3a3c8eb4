// K5 forward: multi-scale deformable attention
// (Deformable-DETR sampling).
//
// Replaces: robust_object_detection_tpu/ops/deform.py, _slots_fwd_pallas
// (public entry ms_deform_attn_slots):
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
// gathers. Here one warp owns one (batch, query, head) and its L * P * 4
// taps. The lanes are (tap slot, channel group): a value row is read in
// 16-byte pieces, so at dh 32 a bf16 row is 4 lanes and one load
// instruction reads 8 taps (f32: 8 lanes, 4 taps). Each lane works out its
// own tap's geometry from loc and attn (no shuffles per point); a tap
// outside its map gets weight 0 and a valid address, so no load sits
// behind a branch. For the model's 3 levels x 4 points the kernel is
// instantiated with (L, P) fixed and issues all 48 taps' loads (6 rounds in
// bf16, 12 in f32) before its first FMA; a generic instantiation takes any
// L <= 4, L * P <= 32 and any dh (element loads where the row or the
// pointer is not 16-byte aligned), four rounds in flight. The slots are
// summed with xor shuffles in a fixed order, and the lanes of slot 0 store
// the row in 16-byte pieces. No shared memory, no atomics, no order among
// warps, so any query order gives the same bits.
//
// values (B, HW, NH, DH) f32 or bf16; loc (B, Q, NH, L, P, 2) f32 in
// [0, 1]; attn (B, Q, NH, L, P) f32; out (B, Q, NH, DH) in values' dtype
// (one rounding of the f32 sum).
//
// What bounds it on the H100: bytes. At the RT-DETR-L shapes (B 8, Q 300,
// 8 heads, 3 levels x 4 points) it gathers at most 8*300*8*48 rows of 64
// bytes (bf16) and does 2 FLOP per gathered element; the rows of one query
// are scattered, so the floor is the gathered bytes over the memory rate,
// and what the design buys is many rows in flight per warp.
//
// The backward of K5 (and of K5-g2) is deform_bwd.cu.

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

// One warp per (batch, query, head). FL, FP, FRL > 0: the model's (L, P) =
// (3, 4) with DH = FRL * VEC = 32, every tap's geometry and load issued
// before the first FMA (6 rounds in bf16, 12 in f32); 0: any L, P, DH and
// RL, four rounds of loads in flight at a time, DH in passes of RL * VEC
// channels.
template <typename T, int VEC, int FL, int FP, int FRL>
__global__ void __launch_bounds__(THREADS)
ms_deform_attn_kernel(const T* __restrict__ values,
                      const float* __restrict__ loc,
                      const float* __restrict__ attn, T* __restrict__ out,
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
    if (s == 0) store_piece<T, VEC>(out + wid * DH + g * VEC, acc);
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
        store_piece<T, VEC>(out + wid * DH + c0 + g * VEC, acc);
    }
  }
}

template <typename T, int VEC>
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
  T* o = static_cast<T*>(out);
  if constexpr (VEC > 1) {
    if (fixed) {
      ms_deform_attn_kernel<T, VEC, 3, 4, 32 / VEC>
          <<<(unsigned)blocks, THREADS, 0, st>>>(v, l, a, o, lv, n_warps, HW,
                                                 Q, NH, DH, L, P, row_lanes);
      return static_cast<int>(cudaGetLastError());
    }
  }
  ms_deform_attn_kernel<T, VEC, 0, 0, 0><<<(unsigned)blocks, THREADS, 0, st>>>(
      v, l, a, o, lv, n_warps, HW, Q, NH, DH, L, P, row_lanes);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace rodt

// levels: 3 * L host ints, (H_l, W_l, start_l) per level, start_l the flat
// offset of the level's first cell in the HW axis of values. vec, row_lanes,
// fixed: the plan of kernels.deform_fwd_plan (channels a load, lanes a
// value row, the (3, 4) x 32-channel instantiation).
extern "C" int ms_deform_attn_fwd(const void* values, const void* loc,
                                  const void* attn, void* out,
                                  const int* levels, int B, int HW, int Q,
                                  int NH, int DH, int L, int P, int dtype,
                                  int vec, int row_lanes, int fixed,
                                  void* stream) {
  rodt::Levels lv;
  const int esize = dtype == rodt::DTYPE_BF16 ? 2 : 4;
  const bool aligned = (DH * esize) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(values) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(out) % 16 == 0;
  if (B <= 0 || HW <= 0 || Q <= 0 || NH <= 0 || DH <= 0 || P <= 0 ||
      !rodt::fill_levels(lv, levels, L) || L * P > 32 || row_lanes < 1 ||
      row_lanes > 32 || (row_lanes & (row_lanes - 1)) ||
      !(vec == 1 || (vec == 16 / esize && aligned)) ||
      (fixed && !(vec > 1 && L == 3 && P == 4 && DH == 32 &&
                  row_lanes * vec == 32)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == rodt::DTYPE_F32)
    return vec == 1 ? rodt::launch_ms_deform<float, 1>(
                          values, loc, attn, out, lv, B, HW, Q, NH, DH, L,
                          P, row_lanes, 0, st)
                    : rodt::launch_ms_deform<float, 4>(
                          values, loc, attn, out, lv, B, HW, Q, NH, DH, L,
                          P, row_lanes, fixed, st);
  if (dtype == rodt::DTYPE_BF16)
    return vec == 1 ? rodt::launch_ms_deform<__nv_bfloat16, 1>(
                          values, loc, attn, out, lv, B, HW, Q, NH, DH, L,
                          P, row_lanes, 0, st)
                    : rodt::launch_ms_deform<__nv_bfloat16, 8>(
                          values, loc, attn, out, lv, B, HW, Q, NH, DH, L,
                          P, row_lanes, fixed, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
