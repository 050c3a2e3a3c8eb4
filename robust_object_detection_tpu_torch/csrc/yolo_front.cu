// K2-f: the YOLOv8 P1/P2 front, NHWC, eval and train mode.
//
// Replaces: robust_object_detection_tpu/ops/pallas_yolo_front.py,
// _front1_kernel and _s2silu_kernel (public entries front_fused_inference
// and front_fused):
//   P1  conv3x3 stride 2 pad 1, 3 -> C1, then BN1 (eps 1e-3) and SiLU;
//   P2  conv3x3 stride 2 pad 1, C1 -> C2, returned before BN2 (the caller
//       applies BN2 + SiLU, as models/yolov8.py does after the TPU kernel).
//
// The TPU version splits columns into 4 phases and stacks even/odd output
// columns in sublanes, only because strided lane slices do not exist in
// Mosaic and NHWC 3..96-channel tensors are lane padded. Here both convs
// read NHWC; the bf16 kernels keep a column-parity split of their stride-2
// halos in shared memory, for the banks' sake (front_tc.cuh).
//
// Eval: BN1 uses running statistics, folded into g1, b1 by the caller, so
// BN1 + SiLU run in P1's epilogue on the f32 accumulator and the activated
// a1 is stored in the working dtype (the TPU kernel stores y1 and
// activates while reading: same math, one rounding moved).
//
// Train: BN1 needs the batch statistics of y1, which exist only once P1
// has covered the whole batch. So P1 stores the pre-BN y1 in the working
// dtype with per-block sum / sum-of-squares partials of the stored
// (rounded) values; a reduce kernel turns them into mean1, var1 (flax fast
// variance, clamped at 0) and the fold g1, b1; P2 applies silu(g1 * y1 +
// b1), rounded to the working dtype, to its staged input, and emits its
// own partials, reduced to mean2, var2. As in _front_core.
//
// Two routes, by dtype:
//   * bf16 (the bf16 model paths): yolo_front_tc_nhwc and
//     yolo_front_train_tc_nhwc, the tensor-core implicit GEMMs of
//     front_tc.cuh, with the launch plan of kernels.front_plan. What bounds
//     it on the H100, at (16, 1024, 1024, 3) -> 48 -> 96: P1 does 2*27*48
//     FLOP per y1 pixel and writes y1 (403 MB, 0.12 ms at 3.35 TB/s), so it
//     is bound by that store; P2 does 87 GFLOP (0.088 ms at 989 TFLOP/s) on
//     403 MB of y1 read and 201 MB of y2 written (0.18 ms): bytes-bound, and
//     the train route reads y1 twice more than its minimum (written by P1,
//     read back by P2). P1 runs its 27-deep K on the tensor cores from an
//     im2col tile built in shared memory (x rows staged by 16-byte
//     cp.async); P2 stages each y1 halo once for all 96 output channels and
//     the next one during this one's MMAs; the statistics come out of the
//     accumulator fragments, so no extra pass over y1 or y2 exists. On an
//     H100 80GB HBM3 at 700 W: eval at batch 8 0.34 ms of device time (P1
//     0.13, P2 0.20; bound 0.050), train at batch 16 1.30 ms (P1 0.25, P2
//     1.04; bound 0.099). P2's train route is held back by its in-place
//     BN1 + SiLU pass over each staged halo, which the MMAs cannot overlap
//     at one block an SM.
//   * f32: yolo_front_tf32_nhwc and yolo_front_train_tf32_nhwc, the same
//     two GEMMs on the tensor cores in split TF32 (front_tf32.cuh: three
//     m16n8k8 TF32 MMAs a product, f32 accuracy), with the launch plan of
//     kernels.front_plan("float32", ...). P1 splits its im2col tile as it
//     builds it; P2 keeps the whole filter in shared memory and stages the
//     y1 halo 8 channels at a time (front_tf32.cuh says why). At batch 16
//     P2 does 261 GFLOP of TF32 MMAs (0.53 ms at 495 TFLOP/s; 0.82 ms at
//     the 319 that mma.sync reaches): operations bound it.
// The partials are reduced in a fixed order, so a repeated run gives
// identical bits.

#include "conv_tile.cuh"
#include "front_tc.cuh"
#include "front_tf32.cuh"

namespace {

using rodt::ftc::bf16;

bool tc_shape_ok(int B, int H, int W, int C1, int C2, int blocks1,
                 int blocks2, int vec1, int vec2) {
  return B > 0 && H >= 2 && W >= 2 && C1 > 0 && C2 > 0 && blocks1 > 0 &&
         blocks2 > 0 && !(vec1 && (W % 8 != 0 || C1 % 8 != 0)) &&
         !(vec2 && (C1 % 8 != 0 || C2 % 8 != 0));
}

// f32: 16-byte staging of x needs W a multiple of 4 (12-byte pixels), of
// y1 / a1 C1 a multiple of 4; the filters are staged element by element
bool tf32_shape_ok(int B, int H, int W, int C1, int C2, int blocks1,
                   int blocks2, int vec1, int vec2) {
  return B > 0 && H >= 2 && W >= 2 && C1 > 0 && C2 > 0 && blocks1 > 0 &&
         blocks2 > 0 && !(vec1 && W % 4 != 0) && !(vec2 && C1 % 4 != 0);
}

}  // namespace

// bf16 eval front; blocks1 / blocks2 (persistent blocks of P1 / P2) and
// vec1 / vec2 (16-byte staging) are the plan of kernels.front_plan.
extern "C" int yolo_front_tc_nhwc(const void* x, const void* k1,
                                  const void* g1, const void* b1,
                                  const void* k2, void* a1, void* y2, int B,
                                  int H, int W, int C1, int C2, int blocks1,
                                  int blocks2, int vec1, int vec2,
                                  void* stream) {
  if (!tc_shape_ok(B, H, W, C1, C2, blocks1, blocks2, vec1, vec2))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  int err = rodt::ftc::launch_p1<false>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(k1), f(g1),
      f(b1), static_cast<bf16*>(a1), nullptr, B, H, W, C1, blocks1, vec1, st);
  if (err != 0) return err;
  return rodt::ftc::launch_p2<false>(
      static_cast<const bf16*>(a1), static_cast<const bf16*>(k2), nullptr,
      nullptr, static_cast<bf16*>(y2), nullptr, B, rodt::out_size(H, 2),
      rodt::out_size(W, 2), C1, C2, blocks2, vec2, st);
}

// bf16 train-mode forward: x, k1, k2, y1, y2 bf16, the rest f32 (sc1, bi1
// the BN1 affine; mean1, var1, g1, b1 (the fold), mean2, var2 outputs of
// C1 or C2 floats), with the plan of kernels.front_plan; stats1 / stats2
// hold 2 * blocks1 * C1 and 2 * blocks2 * C2 floats (one partial row per
// persistent block). sync (a rodt::SyncFn, or null) averages each BN's
// batch sums over a data-parallel group before its statistics are taken;
// sync_buf is its scratch of 2 * max(C1, C2) floats.
extern "C" int yolo_front_train_tc_nhwc(
    const void* x, const void* k1, const void* sc1, const void* bi1,
    const void* k2, void* y1, void* y2, void* stats1, void* stats2,
    void* mean1, void* var1, void* g1, void* b1, void* mean2, void* var2,
    int B, int H, int W, int C1, int C2, int blocks1, int blocks2, int vec1,
    int vec2, void* sync, void* sync_buf, void* stream) {
  if (!tc_shape_ok(B, H, W, C1, C2, blocks1, blocks2, vec1, vec2))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto m = [](void* p) { return static_cast<float*>(p); };
  const int H2 = rodt::out_size(H, 2), W2 = rodt::out_size(W, 2);
  const int H4 = rodt::out_size(H2, 2), W4 = rodt::out_size(W2, 2);
  int err = rodt::ftc::launch_p1<true>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(k1), nullptr,
      nullptr, static_cast<bf16*>(y1), m(stats1), B, H, W, C1, blocks1, vec1,
      st);
  if (err != 0) return err;
  err = rodt::launch_finalize_synced(f(stats1), blocks1, C1,
                                     (float)B * H2 * W2, sync, m(sync_buf),
                                     m(mean1), m(var1), f(sc1), f(bi1),
                                     m(g1), m(b1), st);
  if (err != 0) return err;
  err = rodt::ftc::launch_p2<true>(
      static_cast<const bf16*>(y1), static_cast<const bf16*>(k2), f(g1),
      f(b1), static_cast<bf16*>(y2), m(stats2), B, H2, W2, C1, C2, blocks2,
      vec2, st);
  if (err != 0) return err;
  return rodt::launch_finalize_synced(f(stats2), blocks2, C2,
                                      (float)B * H4 * W4, sync, m(sync_buf),
                                      m(mean2), m(var2), nullptr, nullptr,
                                      nullptr, nullptr, st);
}

// f32 eval front: arguments as yolo_front_tc_nhwc, every tensor f32, with
// the plan of kernels.front_plan("float32", ...).
extern "C" int yolo_front_tf32_nhwc(const void* x, const void* k1,
                                    const void* g1, const void* b1,
                                    const void* k2, void* a1, void* y2, int B,
                                    int H, int W, int C1, int C2, int blocks1,
                                    int blocks2, int vec1, int vec2,
                                    void* stream) {
  if (!tf32_shape_ok(B, H, W, C1, C2, blocks1, blocks2, vec1, vec2))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  int err = rodt::ftf::launch_p1<false>(f(x), f(k1), f(g1), f(b1),
                                        static_cast<float*>(a1), nullptr, B,
                                        H, W, C1, blocks1, vec1, st);
  if (err != 0) return err;
  return rodt::ftf::launch_p2<false>(
      f(a1), f(k2), nullptr, nullptr, static_cast<float*>(y2), nullptr, B,
      rodt::out_size(H, 2), rodt::out_size(W, 2), C1, C2, blocks2, vec2, st);
}

// f32 train-mode forward: arguments as yolo_front_train_tc_nhwc, every
// tensor f32, with the plan of kernels.front_plan("float32", ...).
extern "C" int yolo_front_train_tf32_nhwc(
    const void* x, const void* k1, const void* sc1, const void* bi1,
    const void* k2, void* y1, void* y2, void* stats1, void* stats2,
    void* mean1, void* var1, void* g1, void* b1, void* mean2, void* var2,
    int B, int H, int W, int C1, int C2, int blocks1, int blocks2, int vec1,
    int vec2, void* sync, void* sync_buf, void* stream) {
  if (!tf32_shape_ok(B, H, W, C1, C2, blocks1, blocks2, vec1, vec2))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto m = [](void* p) { return static_cast<float*>(p); };
  const int H2 = rodt::out_size(H, 2), W2 = rodt::out_size(W, 2);
  const int H4 = rodt::out_size(H2, 2), W4 = rodt::out_size(W2, 2);
  int err = rodt::ftf::launch_p1<true>(f(x), f(k1), nullptr, nullptr, m(y1),
                                       m(stats1), B, H, W, C1, blocks1, vec1,
                                       st);
  if (err != 0) return err;
  err = rodt::launch_finalize_synced(f(stats1), blocks1, C1,
                                     (float)B * H2 * W2, sync, m(sync_buf),
                                     m(mean1), m(var1), f(sc1), f(bi1),
                                     m(g1), m(b1), st);
  if (err != 0) return err;
  err = rodt::ftf::launch_p2<true>(f(y1), f(k2), f(g1), f(b1), m(y2),
                                   m(stats2), B, H2, W2, C1, C2, blocks2,
                                   vec2, st);
  if (err != 0) return err;
  return rodt::launch_finalize_synced(f(stats2), blocks2, C2,
                                      (float)B * H4 * W4, sync, m(sync_buf),
                                      m(mean2), m(var2), nullptr, nullptr,
                                      nullptr, nullptr, st);
}
