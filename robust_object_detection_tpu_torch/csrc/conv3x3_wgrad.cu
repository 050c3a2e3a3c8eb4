// K3-b: weight gradient of the 3x3 stride-1 SAME convolution, NHWC in,
// dk (3, 3, Cin, Cout) in f32.
//
// Replaces: robust_object_detection_tpu/ops/pallas_conv.py,
// _conv3x3_wgrad_kernel (the dk half of conv3x3_planes' backward; the dX
// half reuses K3-f with the flipped, transposed filter, as on the TPU).
// On the YOLOv8m train path: the 4 C2f_0 bottleneck convs, (16, 256, 256,
// 48) x dy (16, 256, 256, 48) at a 1024 canvas, 43.5 GFLOP a call.
//
// What bounds it on the H100: 2*9*48*48 = 41 kFLOP per pixel against
// 2 x 96 bytes read (bf16), so it is compute bound; it reduces over
// B x H x W = 1M pixels into only 20,736 outputs. The TPU accumulated dk
// across its sequential grid; here conv_wgrad.cuh splits the pixels into a
// fixed set of chunks (enough blocks to fill the 132 SMs a few times), each
// block keeps its 9 x 16 x 16 slice of dk in registers across all of its
// tiles, and a second kernel adds the per-chunk partials in order:
// deterministic, with no atomics and one small extra pass (n_chunks x
// 83 KB).

#include "conv_wgrad.cuh"

extern "C" int conv3x3_wgrad_nhwc(const void* x, const void* dy, void* part,
                                  void* dk, int B, int H, int W, int Cin,
                                  int Cout, int n_chunks, int dtype,
                                  void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* p = static_cast<float*>(part);
  float* k = static_cast<float*>(dk);
  if (dtype == rodt::DTYPE_F32)
    return rodt::launch_wgrad<float>(1, x, dy, rodt::WgradOpts(), p, k, B,
                                     H, W, Cin, Cout, n_chunks, st);
  if (dtype == rodt::DTYPE_BF16)
    return rodt::launch_wgrad<__nv_bfloat16>(1, x, dy, rodt::WgradOpts(), p,
                                             k, B, H, W, Cin, Cout, n_chunks,
                                             st);
  return static_cast<int>(cudaErrorInvalidValue);
}
