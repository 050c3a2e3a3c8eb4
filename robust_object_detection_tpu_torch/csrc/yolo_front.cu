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
// read NHWC with a strided index and need no phase split.
//
// Eval (yolo_front_nhwc): BN1 uses running statistics, folded into g1, b1
// by the caller, so BN1 + SiLU run in P1's epilogue on the f32 accumulator
// and the activated a1 is stored in the working dtype (the TPU kernel
// stores y1 and activates while reading: same math, one rounding moved).
//
// Train (yolo_front_train_nhwc): BN1 needs the batch statistics of y1,
// which exist only once P1 has covered the whole batch. So P1 stores the
// pre-BN y1 in the working dtype with per-block sum / sum-of-squares
// partials of the stored (rounded) values; a reduce kernel turns them into
// mean1, var1 (flax fast variance, clamped at 0) and the fold g1, b1; P2
// applies silu(g1 * y1 + b1), rounded to the working dtype, while staging
// its input, and emits its own partials, reduced to mean2, var2. As in
// _front_core.
//
// What bounds it on the H100: P1 reads 3 channels and writes C1 = 48 per
// output pixel, 2*27*48 = 2.6 kFLOP per 102 bytes (bf16), so it is bound by
// the write of y1 (B x 512 x 512 x 48 x 2 bytes = 403 MB at batch 16, 1024
// px) plus CUDA-core FLOPs; P2 does 2*9*48*96 = 83 kFLOP per output pixel
// and is compute bound. Both run the tiled CUDA-core kernel of
// conv_tile.cuh; the statistics come out of the conv epilogues as block
// partials, so no extra pass over y1 or y2 exists, and the partials are
// reduced in a fixed order, so a repeated run gives identical bits.

#include "conv_tile.cuh"

extern "C" int yolo_front_nhwc(const void* x, const void* k1, const void* g1,
                               const void* b1, const void* k2, void* a1,
                               void* y2, int B, int H, int W, int C1, int C2,
                               int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  rodt::ConvOpts p1;
  p1.out_scale = static_cast<const float*>(g1);
  p1.out_bias = static_cast<const float*>(b1);
  int err = rodt::launch_conv3x3_dtype<2>(dtype, x, k1, a1, p1, B, H, W, 3,
                                          C1, st);
  if (err != 0) return err;
  return rodt::launch_conv3x3_dtype<2>(dtype, a1, k2, y2, rodt::ConvOpts(),
                                       B, rodt::out_size(H, 2),
                                       rodt::out_size(W, 2), C1, C2, st);
}

// Train-mode forward. stats1 / stats2 are scratch of 2 * P * C floats with
// P = B * tile_count(Ho, Wo) of the respective conv output; every other
// pointer is an output of C1 or C2 floats, or y1 / y2 in the working dtype.
extern "C" int yolo_front_train_nhwc(
    const void* x, const void* k1, const void* sc1, const void* bi1,
    const void* k2, void* y1, void* y2, void* stats1, void* stats2,
    void* mean1, void* var1, void* g1, void* b1, void* mean2, void* var2,
    int B, int H, int W, int C1, int C2, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int H2 = rodt::out_size(H, 2), W2 = rodt::out_size(W, 2);
  const int H4 = rodt::out_size(H2, 2), W4 = rodt::out_size(W2, 2);
  const int P1 = B * rodt::tile_count(H2, W2);
  const int P2 = B * rodt::tile_count(H4, W4);

  rodt::ConvOpts p1;
  p1.stats = static_cast<float*>(stats1);
  int err = rodt::launch_conv3x3_dtype<2>(dtype, x, k1, y1, p1, B, H, W, 3,
                                          C1, st);
  if (err != 0) return err;
  err = rodt::launch_finalize(
      static_cast<const float*>(stats1), P1, C1, (float)B * H2 * W2,
      nullptr, static_cast<float*>(mean1), static_cast<float*>(var1),
      static_cast<const float*>(sc1), static_cast<const float*>(bi1),
      static_cast<float*>(g1), static_cast<float*>(b1), st);
  if (err != 0) return err;

  rodt::ConvOpts p2;
  p2.in_scale = static_cast<const float*>(g1);
  p2.in_bias = static_cast<const float*>(b1);
  p2.stats = static_cast<float*>(stats2);
  err = rodt::launch_conv3x3_dtype<2>(dtype, y1, k2, y2, p2, B, H2, W2, C1,
                                      C2, st);
  if (err != 0) return err;
  return rodt::launch_finalize(
      static_cast<const float*>(stats2), P2, C2, (float)B * H4 * W4,
      nullptr, static_cast<float*>(mean2), static_cast<float*>(var2),
      nullptr, nullptr, nullptr, nullptr, st);
}
