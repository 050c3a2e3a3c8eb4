// K3-f: 3x3 stride-1 SAME convolution, no bias, NHWC.
//
// Replaces: robust_object_detection_tpu/ops/pallas_conv.py, _conv3x3_kernel
// (public entry conv3x3_planes), the forward of the YOLOv8 C2f_0 bottleneck
// convs (48 -> 48 channels at 256x256 for a 1024 canvas, 4 calls per
// forward) and, with the filter flipped spatially and transposed, their
// input gradient (4 more calls per train step), as _bwd does on the TPU.
//
// On the TPU the kernel existed to keep a 48-channel tensor out of XLA's
// 128-lane-padded NHWC layout, hence its (B, H, C, W) planes layout and
// roll-built patch matrices. None of that carries over: the H100 has no lane
// padding, so this kernel takes and returns plain NHWC (channels_last).
//
// What bounds it on the H100: at 48 -> 48 channels it does 2*9*48 = 864
// FLOP per output element against 2 x 96 bytes moved per pixel (bf16), about
// 430 FLOP/byte, so with tensor cores it would be compute bound and with
// the CUDA cores it certainly is. This first version runs on the CUDA cores
// in f32 (conv_tile.cuh): each block stages the input patch with its halo
// and the filter slice in shared memory once per 8 input channels and reuses
// every staged value for 16 output channels (filter) or 16 x 16 pixels
// (input), so device-memory traffic stays near one read of x per 16 output
// channels. Tensor cores (mma.sync / wgmma) are the next step.

#include "conv_tile.cuh"

extern "C" int conv3x3_nhwc(const void* x, const void* w, void* y, int B,
                            int H, int W, int Cin, int Cout, int dtype,
                            void* stream) {
  return rodt::launch_conv3x3_dtype<1>(dtype, x, w, y, rodt::ConvOpts(), B,
                                       H, W, Cin, Cout,
                                       static_cast<cudaStream_t>(stream));
}
