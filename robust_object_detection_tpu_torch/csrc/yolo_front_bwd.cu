// K2-b: backward of the train-mode YOLOv8 P1/P2 front, NHWC.
//
// Replaces: robust_object_detection_tpu/ops/pallas_yolo_front.py,
// _s2silu_bwd_kernel and _k1wgrad_kernel, orchestrated as _front_bwd_impl.
// Given dy2 (cotangent of the pre-BN2 y2) and the cotangents of the four
// batch statistics it computes, in one call:
//   1. ds2 = dmean2/n2 - 2 mean2 dvar2/n2, dss2 = dvar2/n2 (the BN2 stats
//      cotangent, folded in-stream as e2 = dy2 + ds2 + 2 y2 dss2);
//   2. the input gradient of P2 gathered per y1 pixel and chained through
//      BN1 + SiLU: dpre = dA1 * silu'(z1), dy1 = dpre * g1 (working dtype),
//      with the BN1 dgamma/dbeta partials sum(dpre * y1), sum(dpre);
//   3. dk2 = sum a1 (x) e2, a1 = silu(g1 y1 + b1) recomputed from y1;
//   4. the _bn_chain algebra (pallas_stem.py): dsc1, dbi1 and the BN1
//      stats cotangent ds1, dss1;
//   5. dk1 = sum x (x) e1, e1 = dy1 + ds1 + 2 y1 dss1.
// There is no gradient into the image.
//
// Two routes, by dtype:
//   * bf16 (the train step): yolo_front_bwd_tc_nhwc, the tensor-core
//     kernels of front_tc.cuh with the plan of kernels.front_bwd_plan. What
//     bounds it on the H100 at (16, 1024, 1024, 3) -> 48 -> 96: dA1 and dk2
//     each do the P2 conv's 87 GFLOP and dk1 11 GFLOP (0.19 ms at 989
//     TFLOP/s in all), against x, y1, y2 and dy2 read once (0.27 ms at 3.35
//     TB/s): bytes-bound; the design moves about 3.3 GB (e2 formed once and
//     read twice, y1 read by dA1, dk2 and dk1, dy1 written and read back),
//     1.0 ms. Step 2 is the transposed conv split by the parity of the y1
//     pixel into four stride-1 GEMMs over one staged e2 patch; steps 3 and
//     5 are filter-gradient GEMMs over fixed pixel chunks, 16-byte cp.async
//     staging throughout. The TPU split the work into one kernel that
//     emitted dk2, dy1 and the BN1 partials together; here a dX gather and
//     a weight-gradient reduction want different decompositions, so they
//     are separate kernels. On an H100 80GB HBM3 at 700 W: 2.95 ms of device
//     time at batch 16 (dk2 1.31, dA1 0.88, dk1 0.55, e2 prep 0.19; bound
//     0.27). dk2 stages and transforms each y1 halo once for each of its
//     two 48-channel output slices; how much of its time that takes is not
//     measured apart.
//   * f32: yolo_front_bwd_tf32_nhwc, the same five kernels on the tensor
//     cores in split TF32 (front_tf32.cuh: three m16n8k8 TF32 MMAs a
//     product, f32 accuracy), with the plan of
//     kernels.front_bwd_plan("float32", ...): dA1, dk2 and dk1 each do the
//     bf16 route's FLOP, 261 GFLOP of TF32 MMAs for dA1 and for dk2 (0.53
//     ms each at 495 TFLOP/s, 0.82 at the 319 that mma.sync reaches):
//     operations bound it. dA1 splits its fragments in registers; dk2 and
//     dk1 split each staged value once into shared memory (K3-b's f32
//     scheme), dk2 forming a1 from y1 in the same pass.
// Every cross-block sum goes through fixed-order partials, so a repeated
// run gives identical bits.

#include "conv_wgrad.cuh"
#include "front_tc.cuh"
#include "front_tf32.cuh"

// Steps 1 and 4 are stat_cotangent_kernel and bn_chain_kernel of
// conv_wgrad.cuh.

// bf16: x (B,H,W,3), y1 (B,H/2,W/2,C1), y2 / dy2 (B,H/4,W/4,C2) and k2
// (3,3,C1,C2) bf16; sc1, mean1, var1, g1, b1 (the fold), mean2 and the stat
// cotangents dmean1, dvar1, dmean2, dvar2 f32 (averaged over a data-parallel
// group already). Scratch: dy1 like y1, e2 like y2, vecs 2 * C2 + 4 * C1
// floats, and the plan of kernels.front_bwd_plan: da_blocks persistent
// blocks of dA1 (gpart holds 2 * da_blocks * C1 floats), dk2_chunks and
// dk1_chunks pixel chunks (wpart holds max(dk2_chunks * 9 * C1 * C2,
// dk1_chunks * 27 * C1) floats), vec (16-byte staging of y1, y2, dy2, e2,
// dy1 and k2) and vec_x (also of x, for dk1). Outputs f32: dk1 (3,3,3,C1),
// dk2 (3,3,C1,C2), dsc1, dbi1 (C1). sync (a rodt::SyncFn, or null)
// averages BN1's batch sums over a data-parallel group before its chain
// rule.
extern "C" int yolo_front_bwd_tc_nhwc(
    const void* x, const void* k2, const void* y1, const void* y2,
    const void* dy2, const void* sc1, const void* mean1, const void* var1,
    const void* g1, const void* b1, const void* mean2, const void* dmean1,
    const void* dvar1, const void* dmean2, const void* dvar2, void* dy1,
    void* e2, void* gpart, void* wpart, void* vecs, void* dk1, void* dk2,
    void* dsc1, void* dbi1, int B, int H, int W, int C1, int C2,
    int da_blocks, int dk2_chunks, int dk1_chunks, int vec, int vec_x,
    void* sync, void* stream) {
  if (B <= 0 || H < 2 || W < 2 || C1 <= 0 || C2 <= 0 || da_blocks <= 0 ||
      dk2_chunks <= 0 || dk1_chunks <= 0 ||
      (vec && (C1 % 8 != 0 || C2 % 8 != 0)) || (vec_x && (!vec || W % 8 != 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  using rodt::ftc::bf16;
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto h = [](const void* p) { return static_cast<const bf16*>(p); };
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int H2 = rodt::out_size(H, 2), W2 = rodt::out_size(W, 2);
  const int H4 = rodt::out_size(H2, 2), W4 = rodt::out_size(W2, 2);
  const float n1 = (float)B * H2 * W2, n2 = (float)B * H4 * W4;
  float* ds2 = static_cast<float*>(vecs);
  float* dss2 = ds2 + C2;
  float* sums = dss2 + C2;
  float* ds1 = sums + 2 * C1;
  float* dss1 = ds1 + C1;
  float* gp = static_cast<float*>(gpart);
  float* wp = static_cast<float*>(wpart);
  bf16* e2b = static_cast<bf16*>(e2);
  bf16* dy1b = static_cast<bf16*>(dy1);

  rodt::stat_cotangent_kernel<<<1, rodt::THREADS, 0, st>>>(
      f(dmean2), f(dvar2), f(mean2), n2, C2, ds2, dss2);
  int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  err = rodt::ftc::launch_e2(h(dy2), h(y2), ds2, dss2, e2b,
                             (long long)B * H4 * W4 * C2, C2, vec, st);
  if (err != 0) return err;
  err = rodt::ftc::launch_da1(e2b, h(k2), h(y1), f(g1), f(b1), dy1b, gp, B,
                              H2, W2, C1, C2, da_blocks, vec, st);
  if (err != 0) return err;
  err = rodt::ftc::launch_dk2(h(y1), e2b, f(g1), f(b1), wp,
                              static_cast<float*>(dk2), B, H2, W2, C1, C2,
                              dk2_chunks, vec, st);
  if (err != 0) return err;
  err = rodt::launch_finalize(gp, da_blocks, C1, 1.f, sums, nullptr, nullptr,
                        nullptr, nullptr, nullptr, nullptr, st);
  if (err != 0) return err;
  err = rodt::sync_sums(sync, sums, C1);
  if (err != 0) return err;
  rodt::bn_chain_kernel<<<1, rodt::THREADS, 0, st>>>(
      sums, f(sc1), f(mean1), f(var1), n1, f(dmean1), f(dvar1), C1,
      static_cast<float*>(dsc1), static_cast<float*>(dbi1), ds1, dss1);
  err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  return rodt::ftc::launch_dk1(h(x), dy1b, h(y1), ds1, dss1, wp,
                               static_cast<float*>(dk1), B, H, W, C1,
                               dk1_chunks, vec_x, st);
}

// f32: arguments as yolo_front_bwd_tc_nhwc, every tensor f32, with the
// plan of kernels.front_bwd_plan("float32", ...) (vec: C1, C2 multiples of
// 4 and the pointers aligned; vec_x: vec and W a multiple of 4, x aligned).
extern "C" int yolo_front_bwd_tf32_nhwc(
    const void* x, const void* k2, const void* y1, const void* y2,
    const void* dy2, const void* sc1, const void* mean1, const void* var1,
    const void* g1, const void* b1, const void* mean2, const void* dmean1,
    const void* dvar1, const void* dmean2, const void* dvar2, void* dy1,
    void* e2, void* gpart, void* wpart, void* vecs, void* dk1, void* dk2,
    void* dsc1, void* dbi1, int B, int H, int W, int C1, int C2,
    int da_blocks, int dk2_chunks, int dk1_chunks, int vec, int vec_x,
    void* sync, void* stream) {
  if (B <= 0 || H < 2 || W < 2 || C1 <= 0 || C2 <= 0 || da_blocks <= 0 ||
      dk2_chunks <= 0 || dk1_chunks <= 0 ||
      (vec && (C1 % 4 != 0 || C2 % 4 != 0)) || (vec_x && (!vec || W % 4 != 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto m = [](void* p) { return static_cast<float*>(p); };
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int H2 = rodt::out_size(H, 2), W2 = rodt::out_size(W, 2);
  const int H4 = rodt::out_size(H2, 2), W4 = rodt::out_size(W2, 2);
  const float n1 = (float)B * H2 * W2, n2 = (float)B * H4 * W4;
  float* ds2 = m(vecs);
  float* dss2 = ds2 + C2;
  float* sums = dss2 + C2;
  float* ds1 = sums + 2 * C1;
  float* dss1 = ds1 + C1;

  rodt::stat_cotangent_kernel<<<1, rodt::THREADS, 0, st>>>(
      f(dmean2), f(dvar2), f(mean2), n2, C2, ds2, dss2);
  int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  err = rodt::ftf::launch_e2(f(dy2), f(y2), ds2, dss2, m(e2),
                             (long long)B * H4 * W4 * C2, C2, vec, st);
  if (err != 0) return err;
  err = rodt::ftf::launch_da1(f(e2), f(k2), f(y1), f(g1), f(b1), m(dy1),
                              m(gpart), B, H2, W2, C1, C2, da_blocks, vec,
                              st);
  if (err != 0) return err;
  err = rodt::ftf::launch_dk2(f(y1), f(e2), f(g1), f(b1), m(wpart), m(dk2),
                              B, H2, W2, C1, C2, dk2_chunks, vec, st);
  if (err != 0) return err;
  err = rodt::launch_finalize(f(gpart), da_blocks, C1, 1.f, sums, nullptr,
                              nullptr, nullptr, nullptr, nullptr, nullptr,
                              st);
  if (err != 0) return err;
  err = rodt::sync_sums(sync, sums, C1);
  if (err != 0) return err;
  rodt::bn_chain_kernel<<<1, rodt::THREADS, 0, st>>>(
      sums, f(sc1), f(mean1), f(var1), n1, f(dmean1), f(dvar1), C1, m(dsc1),
      m(dbi1), ds1, dss1);
  err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  return rodt::ftf::launch_dk1(f(x), m(dy1), f(y1), ds1, dss1, m(wpart),
                               m(dk1), B, H, W, C1, dk1_chunks, vec_x, st);
}
