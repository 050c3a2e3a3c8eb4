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
// The gather is deform_fwd.cuh, shared with K5-g2 forward
// (ms_deform_attn_sorted.cu), which stores the same sums in f32. The
// backward of K5 (and of K5-g2) is deform_bwd.cu.

#include "deform_fwd.cuh"

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
  return rodt::launch_deform_fwd<false>(
      values, loc, attn, out, levels, B, HW, Q, NH, DH, L, P, dtype, vec,
      row_lanes, fixed, static_cast<cudaStream_t>(stream));
}
