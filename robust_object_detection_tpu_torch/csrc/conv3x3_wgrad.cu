// K3-b: weight gradient of the 3x3 stride-1 SAME convolution, NHWC in,
// dk (3, 3, Cin, Cout) in f32.
//
// Replaces: robust_object_detection_tpu/ops/pallas_conv.py,
// _conv3x3_wgrad_kernel (:62; its pallas_call :136: the dk half of
// conv3x3_planes' backward; the dX half reuses K3-f with the flipped,
// transposed filter, as on the TPU). On the YOLOv8m train path: the 4 C2f_0
// bottleneck convs, (16, 256, 256, 48) x dy (16, 256, 256, 48) at a 1024
// canvas; on the RT-DETR-L one the 6 stage-1 HGBlock convs at batch 8.
//
// Two routes, by dtype:
//   * bf16 (both train steps): conv3x3_wgrad_tc_nhwc, conv3x3_tc.cuh's
//     tensor-core kernel. What bounds it: at batch 16 a GEMM of M = 9 x 48,
//     N = 48, K = 1,048,576 pixels, 43.5 GFLOP (0.044 ms at 989 TFLOP/s)
//     against 201 MB of x and dy (0.060 ms at 3.35 TB/s): bytes and
//     operations nearly balance, so both the copies and the MMAs must
//     overlap. One block holds all of dk (9 warps, one per tap, 72 f32 sums
//     a thread), so x and dy are each read once; 16-byte cp.async copies of
//     the next pixel tile run under this tile's MMAs. On an H100 it runs at
//     about 3x that bound, paced by shared-memory traffic (all nine warps
//     read the same dy fragments) and mma.sync issue; wgmma, which reads B
//     from shared memory once per warpgroup, would lift both.
//   * f32: conv3x3_wgrad_tf32_nhwc, conv3x3_tf32.cuh's tensor-core kernel
//     in split ("3x") TF32 (f32 accuracy): at batch 16, 130 GFLOP of TF32
//     MMAs (0.264 ms at 495 TFLOP/s) against 403 MB (0.120 ms), so
//     operations bound it. Same block scheme as bf16 (all of dk a block),
//     with 18 warps (tap x half the n8 tiles); each staged value is split
//     once into shared memory and the fragments are 128-bit loads with
//     permuted channel rows instead of ldmatrix.trans. On an H100 it runs
//     in 0.88 ms (cuDNN: 1.27-1.32 in one-pass TF32, 2.63-2.81 with TF32
//     off). It replaced the CUDA-core kernel of conv_wgrad.cuh (2.56 ms),
//     which K2's and K4's f32 routes still use.
// Both split the pixels into a fixed set of chunks, write per-chunk partials
// and add them in a fixed order: deterministic, with no atomics.

#include "conv3x3_tc.cuh"
#include "conv3x3_tf32.cuh"

namespace rodt {
namespace tc {

// The wrapper's plan: MT (1 or 3), NT (2 or 6), VEC, n_chunks. dk (3, 3,
// Cin, Cout) f32 = the in-order sum of the n_chunks partials in `part`.
static int launch_wgrad_tc(const void* x, const void* dy, float* part,
                           float* dk, int B, int H, int W, int Cin, int Cout,
                           int MT, int NT, int vec, int n_chunks,
                           cudaStream_t stream) {
  if (B <= 0 || H <= 0 || W <= 0 || Cin <= 0 || Cout <= 0 ||
      n_chunks <= 0 || (vec && (Cin % 8 != 0 || Cout % 8 != 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  const bf16* xb = static_cast<const bf16*>(x);
  const bf16* db = static_cast<const bf16*>(dy);
  int err;
  if (MT == 3 && NT == 6)
    err = launch_wgrad_tc_v<3, 6>(vec, xb, db, part, B, H, W, Cin, Cout,
                                  n_chunks, stream);
  else if (MT == 3 && NT == 2)
    err = launch_wgrad_tc_v<3, 2>(vec, xb, db, part, B, H, W, Cin, Cout,
                                  n_chunks, stream);
  else if (MT == 1 && NT == 6)
    err = launch_wgrad_tc_v<1, 6>(vec, xb, db, part, B, H, W, Cin, Cout,
                                  n_chunks, stream);
  else if (MT == 1 && NT == 2)
    err = launch_wgrad_tc_v<1, 2>(vec, xb, db, part, B, H, W, Cin, Cout,
                                  n_chunks, stream);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  if (err != 0) return err;
  const int n = 9 * Cin * Cout;
  sum_chunks_tc_kernel<<<(n + 31) / 32, 256, 0, stream>>>(part, n_chunks, n,
                                                          dk);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc

namespace tc32 {

// The wrapper's plan: MT (1 or 3), NT (2 or 6), VEC, n_chunks. dk (3, 3,
// Cin, Cout) f32 = the in-order sum of the n_chunks partials in `part`.
static int launch_wgrad_tf32(const void* x, const void* dy, float* part,
                             float* dk, int B, int H, int W, int Cin,
                             int Cout, int MT, int NT, int vec, int n_chunks,
                             cudaStream_t stream) {
  if (B <= 0 || H <= 0 || W <= 0 || Cin <= 0 || Cout <= 0 ||
      n_chunks <= 0 || (vec && (Cin % 4 != 0 || Cout % 4 != 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  const float* xf = static_cast<const float*>(x);
  const float* df = static_cast<const float*>(dy);
  int err;
  if (MT == 3 && NT == 6)
    err = launch_wgrad_tf32_v<3, 6>(vec, xf, df, part, B, H, W, Cin, Cout,
                                    n_chunks, stream);
  else if (MT == 3 && NT == 2)
    err = launch_wgrad_tf32_v<3, 2>(vec, xf, df, part, B, H, W, Cin, Cout,
                                    n_chunks, stream);
  else if (MT == 1 && NT == 6)
    err = launch_wgrad_tf32_v<1, 6>(vec, xf, df, part, B, H, W, Cin, Cout,
                                    n_chunks, stream);
  else if (MT == 1 && NT == 2)
    err = launch_wgrad_tf32_v<1, 2>(vec, xf, df, part, B, H, W, Cin, Cout,
                                    n_chunks, stream);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  if (err != 0) return err;
  const int n = 9 * Cin * Cout;
  tc::sum_chunks_tc_kernel<<<(n + 31) / 32, 256, 0, stream>>>(
      part, n_chunks, n, dk);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc32
}  // namespace rodt

// bf16 only; mt, nt, vec and n_chunks are the wrapper's launch plan
// (kernels.wgrad_tc_plan("bfloat16", ...)); part holds n_chunks x 9 x Cin x Cout f32.
extern "C" int conv3x3_wgrad_tc_nhwc(const void* x, const void* dy,
                                     void* part, void* dk, int B, int H,
                                     int W, int Cin, int Cout, int mt, int nt,
                                     int vec, int n_chunks, void* stream) {
  return rodt::tc::launch_wgrad_tc(x, dy, static_cast<float*>(part),
                                   static_cast<float*>(dk), B, H, W, Cin,
                                   Cout, mt, nt, vec, n_chunks,
                                   static_cast<cudaStream_t>(stream));
}

// f32 only; mt, nt, vec and n_chunks are the wrapper's launch plan
// (kernels.wgrad_tc_plan("float32", ...)); part holds n_chunks x 9 x Cin x Cout f32.
extern "C" int conv3x3_wgrad_tf32_nhwc(const void* x, const void* dy,
                                       void* part, void* dk, int B, int H,
                                       int W, int Cin, int Cout, int mt,
                                       int nt, int vec, int n_chunks,
                                       void* stream) {
  return rodt::tc32::launch_wgrad_tf32(x, dy, static_cast<float*>(part),
                                       static_cast<float*>(dk), B, H, W, Cin,
                                       Cout, mt, nt, vec, n_chunks,
                                       static_cast<cudaStream_t>(stream));
}
