// K3-f: 3x3 stride-1 SAME convolution, no bias, NHWC.
//
// Replaces: robust_object_detection_tpu/ops/pallas_conv.py, _conv3x3_kernel
// (:37; its pallas_call :114, public entry conv3x3_planes), the forward of
// the YOLOv8 C2f_0 bottleneck convs (48 -> 48 channels at 256x256 for a
// 1024 canvas, 4 calls per forward) and of the RT-DETR-L stage-1 HGBlock
// convs (6 per forward) and, with the filter flipped spatially and
// transposed, their input gradient, as _bwd does on the TPU.
//
// On the TPU the kernel existed to keep a 48-channel tensor out of XLA's
// 128-lane-padded NHWC layout, hence its (B, H, C, W) planes layout and
// roll-built patch matrices. None of that carries over: the H100 has no lane
// padding, so this kernel takes and returns plain NHWC (channels_last).
//
// Two routes, by dtype:
//   * bf16 (every model path): conv3x3_tc_nhwc, the tensor-core implicit
//     GEMM of conv3x3_tc.cuh. What bounds it: at (8, 256, 256, 48) -> 48 it
//     moves 100.7 MB (0.030 ms at 3.35 TB/s) for 21.7 GFLOP (0.022 ms at
//     989 TFLOP/s), so it is bytes-bound on the card. The design keeps the
//     memory busy: persistent blocks (about two per SM) read each input
//     halo once for all output channels, the filter is staged once per
//     block, the next tile's halo is copied by 16-byte cp.async while this
//     tile's MMAs run, and the output leaves as 16-byte NHWC pieces. On an
//     H100 it runs at about 2.5x the byte bound: 8 warps an SM do not hide
//     the ldmatrix -> mma latency of a tile's 27 unrolled k16 steps.
//   * f32 (the models' float32 dtype, and every f32 card-vs-CPU check):
//     conv3x3_tf32_nhwc, the tensor-core implicit GEMM of conv3x3_tf32.cuh
//     in split ("3x") TF32, which keeps f32 accuracy (the f32 checks hold
//     it at 1e-4 x max|ref|). At the same shape it does 65.2 GFLOP of TF32
//     MMAs (0.132 ms at 495 TFLOP/s) against 201 MB (0.060 ms): operations
//     bound it. On an H100 it runs in 0.39 ms, paced by the rate of its
//     three mma.sync a product and by the split (cuDNN: 0.23 ms in one-pass
//     TF32, 0.90 with TF32 off). It replaced the CUDA-core tile of
//     conv_tile.cuh (0.92 ms), which K2's and K4's f32 routes still use.

#include "conv3x3_tc.cuh"
#include "conv3x3_tf32.cuh"

namespace rodt {
namespace tc {

// The wrapper's plan: NT (2 or 6), VEC, blocks.
static int launch_conv_tc(const void* x, const void* w, void* y, int B, int H,
                          int W, int Cin, int Cout, int NT, int vec,
                          int blocks, cudaStream_t stream) {
  if (B <= 0 || H <= 0 || W <= 0 || Cin <= 0 || Cout <= 0 || blocks <= 0 ||
      (vec && (Cin % 8 != 0 || Cout % 8 != 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  const bf16* xb = static_cast<const bf16*>(x);
  const bf16* wb = static_cast<const bf16*>(w);
  bf16* yb = static_cast<bf16*>(y);
  if (NT == 6)
    return vec ? launch_conv_tc_t<6, true>(xb, wb, yb, B, H, W, Cin, Cout,
                                           blocks, stream)
               : launch_conv_tc_t<6, false>(xb, wb, yb, B, H, W, Cin, Cout,
                                            blocks, stream);
  if (NT == 2)
    return vec ? launch_conv_tc_t<2, true>(xb, wb, yb, B, H, W, Cin, Cout,
                                           blocks, stream)
               : launch_conv_tc_t<2, false>(xb, wb, yb, B, H, W, Cin, Cout,
                                            blocks, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace tc

namespace tc32 {

// The wrapper's plan: NT (2 or 6), VEC, blocks.
static int launch_conv_tf32(const void* x, const void* w, void* y, int B,
                            int H, int W, int Cin, int Cout, int NT, int vec,
                            int blocks, cudaStream_t stream) {
  if (B <= 0 || H <= 0 || W <= 0 || Cin <= 0 || Cout <= 0 || blocks <= 0 ||
      (vec && Cin % 4 != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const float* xf = static_cast<const float*>(x);
  const float* wf = static_cast<const float*>(w);
  float* yf = static_cast<float*>(y);
  if (NT == 6)
    return vec ? launch_conv_tf32_t<6, true>(xf, wf, yf, B, H, W, Cin, Cout,
                                             blocks, stream)
               : launch_conv_tf32_t<6, false>(xf, wf, yf, B, H, W, Cin,
                                              Cout, blocks, stream);
  if (NT == 2)
    return vec ? launch_conv_tf32_t<2, true>(xf, wf, yf, B, H, W, Cin, Cout,
                                             blocks, stream)
               : launch_conv_tf32_t<2, false>(xf, wf, yf, B, H, W, Cin,
                                              Cout, blocks, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace tc32
}  // namespace rodt

// bf16 only; nt, vec and blocks are the wrapper's launch plan
// (kernels.conv3x3_tc_plan("bfloat16", ...)).
extern "C" int conv3x3_tc_nhwc(const void* x, const void* w, void* y, int B,
                               int H, int W, int Cin, int Cout, int nt,
                               int vec, int blocks, void* stream) {
  return rodt::tc::launch_conv_tc(x, w, y, B, H, W, Cin, Cout, nt, vec,
                                  blocks, static_cast<cudaStream_t>(stream));
}

// f32 only; nt, vec and blocks are the wrapper's launch plan
// (kernels.conv3x3_tc_plan("float32", ...)).
extern "C" int conv3x3_tf32_nhwc(const void* x, const void* w, void* y,
                                 int B, int H, int W, int Cin, int Cout,
                                 int nt, int vec, int blocks, void* stream) {
  return rodt::tc32::launch_conv_tf32(x, w, y, B, H, W, Cin, Cout, nt, vec,
                                      blocks,
                                      static_cast<cudaStream_t>(stream));
}
