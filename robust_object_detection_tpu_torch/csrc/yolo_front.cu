// K2-f: the YOLOv8 P1/P2 front in eval mode, NHWC.
//
// Replaces: robust_object_detection_tpu/ops/pallas_yolo_front.py,
// _front1_kernel and _s2silu_kernel (public entry front_fused_inference):
//   P1  conv3x3 stride 2 pad 1, 3 -> C1, then BN1 (running statistics,
//       folded into g1, b1 by the caller, eps 1e-3) and SiLU;
//   P2  conv3x3 stride 2 pad 1, C1 -> C2, returned before BN2 (the caller
//       applies BN2 + SiLU, as models/yolov8.py does after the TPU kernel).
//
// The TPU version splits columns into 4 phases and stacks even/odd output
// columns in sublanes, only because strided lane slices do not exist in
// Mosaic and NHWC 3..96-channel tensors are lane padded. Here both convs
// read NHWC with a strided index and need no phase split.
//
// One rounding moves: the TPU kernel stores the pre-BN y1 in the working
// dtype and applies silu(g1 * y1 + b1) while reading it in P2; this kernel
// applies BN1 + SiLU in P1's epilogue to the f32 accumulator and stores the
// activated a1 in the working dtype. The math is the same; a1 is rounded
// once instead of y1 once and a1 once.
//
// What bounds it on the H100: P1 reads 3 channels and writes C1 = 48 per
// output pixel, 2*27*48 = 2.6 kFLOP per 102 bytes (bf16), so it is bound by
// the write of a1 (B x 512 x 512 x 48 x 2 bytes = 201 MB at batch 8, 1024 px)
// plus CUDA-core FLOPs; P2 does 2*9*48*96 = 83 kFLOP per output pixel and is
// compute bound. Both run the tiled CUDA-core kernel of conv_tile.cuh, with
// the BN fold and SiLU fused into P1's store so y1 never reaches memory.

#include "conv_tile.cuh"

extern "C" int yolo_front_nhwc(const void* x, const void* k1, const void* g1,
                               const void* b1, const void* k2, void* a1,
                               void* y2, int B, int H, int W, int C1, int C2,
                               int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int err = rodt::launch_conv3x3_dtype<2>(
      dtype, x, k1, a1, static_cast<const float*>(g1),
      static_cast<const float*>(b1), B, H, W, 3, C1, st);
  if (err != 0) return err;
  return rodt::launch_conv3x3_dtype<2>(dtype, a1, k2, y2, nullptr, nullptr, B,
                                       rodt::out_size(H, 2),
                                       rodt::out_size(W, 2), C1, C2, st);
}
