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
//   * f32: conv3x3_nhwc, the CUDA-core tile of conv_tile.cuh (each block
//     stages an input patch and an 8-channel filter slice in shared memory
//     and reuses them for 16 output channels or 16 x 16 pixels). f32 is on
//     no timed path, and a TF32 tensor-core route would not hold the f32
//     checks at 1e-4.

#include "conv3x3_tc.cuh"
#include "conv_tile.cuh"

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
}  // namespace rodt

extern "C" int conv3x3_nhwc(const void* x, const void* w, void* y, int B,
                            int H, int W, int Cin, int Cout, int dtype,
                            void* stream) {
  // bf16 goes to conv3x3_tc_nhwc
  if (dtype != rodt::DTYPE_F32 || B <= 0 || H <= 0 || W <= 0 || Cin <= 0 ||
      Cout <= 0 || B > 65535 || (Cout + rodt::CO_T - 1) / rodt::CO_T > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  return rodt::launch_conv3x3<float, 1, rodt::ACT_SILU>(
      x, w, y, rodt::ConvOpts(), B, H, W, Cin, Cout,
      static_cast<cudaStream_t>(stream));
}

// bf16 only; nt, vec and blocks are the wrapper's launch plan
// (kernels.conv3x3_tc_plan).
extern "C" int conv3x3_tc_nhwc(const void* x, const void* w, void* y, int B,
                               int H, int W, int Cin, int Cout, int nt,
                               int vec, int blocks, void* stream) {
  return rodt::tc::launch_conv_tc(x, w, y, B, H, W, Cin, Cout, nt, vec,
                                  blocks, static_cast<cudaStream_t>(stream));
}
