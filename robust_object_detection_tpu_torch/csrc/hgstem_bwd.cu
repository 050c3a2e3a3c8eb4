// K4-b: backward of the train-mode HGNetv2 stem (hgstem_train_tc_nhwc,
// hgstem_train_tf32_nhwc), NHWC.
//
// Replaces: robust_object_detection_tpu/ops/pallas_stem.py,
// _stem3_bwd_kernel, _assemble_bwd_kernel, _conv2x2_bwd_kernel (twice) and
// _stem1_bwd_kernel, orchestrated as _bwd_impl with _bn_chain between them.
// Given dy3 (cotangent of the pre-BN3 y3) and the cotangents of the four
// batch means and variances it computes, in one call:
//   (a) e3 = dy3 + ds3 + 2 y3 dss3 (the BN3 statistics cotangent folded
//       in), dk3 = sum cat (x) e3, and d(cat) = the transposed stem3;
//   (b) the concat's halves: the a2b half chained through BN2b + ReLU
//       (dy2b = d * [z2b > 0] * g2b, with the BN2b dgamma/dbeta partials),
//       the pool half routed back to a1 (a maximum's gradient goes to the
//       larger operand, split 0.5 / 0.5 at a tie, the pool being
//       max(max(left, right) of the upper row, max(left, right) of the
//       lower row));
//   (c) stem2b then stem2a: e = dy + ds + 2 y dss with (ds, dss) from the
//       folded-BN algebra (bn_chain_kernel), the weight gradient, the
//       input gradient chained through the BN + ReLU below with its
//       dgamma/dbeta partials;
//   (d) a1's two gradients (pool path and stem2a path) summed before BN1's
//       ReLU mask, BN1's chain, dk1 = sum x (x) e1.
// There is no gradient into the image.
//
// The TPU kernels walk 8-row blocks of channel planes in grid order and
// accumulate dk and dgamma/dbeta in revisited output blocks. On this card
// blocks run in parallel, so a weight gradient (few outputs summed over
// every pixel) and an input gradient (one output per pixel) are separate
// kernels, and every cross-block sum goes through fixed-order partials,
// never float atomics, so a repeated run gives identical bits.
//
// Two routes, by dtype:
//   * bf16 (the train step): hgstem_bwd_tc_nhwc, hand-written tensor-core
//     implicit GEMMs (mma.sync.m16n8k16, ldmatrix, 16-byte cp.async) with
//     the plan of kernels.stem_bwd_plan:
//       (a) e3 = round(dy3 + ds3 + 2 y3 dss3) once (e2_prep_kernel); d(cat)
//           = front_da1_tc_kernel without its chain: the transposed stem3
//           as four parity-class GEMMs over one e3 patch; dk3 =
//           front_dk2_tc_kernel without its input transform (the concat is
//           stored activated), 64 x 32 channels a block;
//       (b) assemble_bwd_vec_kernel (stem_tc.cuh): the concat's halves, 8
//           channels a thread;
//       (c) for stem2b, then stem2a: e = round(dy + ds + 2 y dss) once,
//           written over the buffer that held dy (e2_prep_kernel); the
//           filter gradient over the 2x2 tap range itself
//           (stem2x2_wgrad_tc_kernel, (2, 2, Cin, Cout) written directly);
//           the input gradient, the transposed 2x2 conv, with the BN +
//           ReLU chain below and its dgamma / dbeta partials in the
//           epilogue (stem2x2_dx_tc_kernel; for stem2a the pool's gradient
//           of a1 added before the ReLU mask);
//       (d) dk1 = front_dk1_tc_kernel at 32 channels, e1 formed in place.
//     What bounds it on the H100 at (8, 1024, 1024, 3): 77 GFLOP (0.08 ms
//     at 989 TFLOP/s) against x, y3 and dy3 (0.12 GB, 0.04 ms): operations.
//     This design moves about 2.6 GB more (the saved y1, y2a, y2b and
//     concat read, e3, d(cat), da1p, dy2b, dy2a, dy1 written and read
//     back), about 0.8 ms at 3.35 TB/s, which sets its pace. On an H100
//     80GB HBM3 at 700 W: 1.92-1.94 ms of device time (the concat's
//     backward 0.57, stem2a's dX 0.19, dk1 0.19, d(cat) 0.18, dk2a 0.15,
//     dk3 0.14, e preps 0.22, stem2b's dX and dk2b 0.11 each). The concat's
//     backward recomputes a1 on a 3 x 3 neighbourhood for each item and is
//     the largest stage.
//   * f32: hgstem_bwd_tf32_nhwc, the same stages in split ("3x") TF32 on
//     mma.sync.m16n8k8.tf32 with the plan of kernels.stem_bwd_plan
//     ("float32", ...): e3 by e2_prep_f32_kernel, d(cat) by
//     front_da1_tf32_kernel without its chain (two 32-channel slices), dk3
//     by front_dk2_tf32_kernel without its transform (32 x 32 channels a
//     block), the concat's backward by assemble_bwd_f32_kernel (4 channels
//     a thread), the 2x2 convs' filter and input gradients by
//     stem2x2_wgrad_tf32_kernel and stem2x2_dx_tf32_kernel
//     (stem_tf32.cuh), dk1 by front_dk1_tf32_kernel at 32 channels. The
//     filter gradients take enough pixel chunks that no f32 accumulator of
//     the tensor cores runs a long chain (their f32 accumulation loses
//     more than an IEEE sum there); the chunks are summed in order by plain
//     f32 adds. It moves about 5.2 GB (1.55 ms at 3.35 TB/s) for 231 GFLOP
//     of TF32 MMAs (0.47 ms): bytes.

#include "conv_wgrad.cuh"
#include "stem_tc.cuh"
#include "stem_tf32.cuh"

namespace {

using namespace rodt;

// Slots of 32 floats in the forward's statistics buffer (hgstem.cu)
constexpr int F_MEAN = 0, F_VAR = 1, F_G = 2, F_B = 3;
inline const float* fslot(const float* v, int bn, int which) {
  return v + (4 * bn + which) * 32;
}

}  // namespace

// bf16: the tensors hgstem_train_tc_nhwc read and wrote (x, y1, y2a, y2b,
// cat, y3, the filters k2a, k2b, k3, all in the working dtype; sc1, sc2a,
// sc2b f32; fvecs its statistics buffer), dy3 (B, H/4, W/4, 32) in the
// working dtype and dstat (8 slots of 32 floats: dmean of BN1, 2a, 2b, 3,
// then dvar). Scratch in the working dtype: dcat (B, H/2, W/2, 64), da1p,
// dy2b, dy1 (.., 32), dy2a (.., 16), e3 (like y3); f32: gpart, wpart (as
// below), work 128. Outputs f32: dk1 (3,3,3,32), dk2a (2,2,32,16), dk2b
// (2,2,16,32), dk3 (3,3,64,32) and dvec (6 slots of 32: dsc1, dbi1, dsc2a,
// dbi2a, dsc2b, dbi2b). sync (a rodt::SyncFn, or null) averages each BN's
// batch sums over a data-parallel group before its chain rule; dstat comes
// in averaged already. Then the plan of
// kernels.stem_bwd_plan: da_blocks (d(cat), 2 channel slices), dk3_chunks,
// asm_blocks (the concat's backward: gpart rows), wg2b_chunks,
// dx2b_blocks, wg2a_chunks, dx2a_blocks, dk1_chunks, vec (16-byte staging
// of the filters and dy3) and vec_x (of x). gpart holds 2 * max(asm_blocks
// * 32, dx2b_blocks * 16, dx2a_blocks * 32) floats, wpart max(dk3_chunks *
// 9 * 64 * 32, wg2b_chunks * 4 * 16 * 32, wg2a_chunks * 4 * 32 * 16,
// dk1_chunks * 27 * 32).
extern "C" int hgstem_bwd_tc_nhwc(
    const void* x, const void* y1, const void* y2a, const void* y2b,
    const void* cat, const void* y3, const void* k2a, const void* k2b,
    const void* k3, const void* sc1, const void* sc2a, const void* sc2b,
    const void* fvecs, const void* dy3, const void* dstat, void* dcat,
    void* da1p, void* dy2b, void* dy2a, void* dy1, void* e3, void* gpart,
    void* wpart, void* work, void* dk1, void* dk2a, void* dk2b, void* dk3,
    void* dvec, int B, int H, int W, int da_blocks, int dk3_chunks,
    int asm_blocks, int wg2b_chunks, int dx2b_blocks, int wg2a_chunks,
    int dx2a_blocks, int dk1_chunks, int vec, int vec_x, void* sync,
    void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || H % 4 || W % 4 || da_blocks <= 0 ||
      dk3_chunks <= 0 || asm_blocks <= 0 || wg2b_chunks <= 0 ||
      dx2b_blocks <= 0 || wg2a_chunks <= 0 || dx2a_blocks <= 0 ||
      dk1_chunks <= 0 || (vec_x && (!vec || W % 8 != 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  namespace ftc = rodt::ftc;
  namespace stc = rodt::stc;
  using stc::bf16;
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto h = [](const void* p) { return static_cast<const bf16*>(p); };
  auto hm = [](void* p) { return static_cast<bf16*>(p); };
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int H2 = H / 2, W2 = W / 2, H4 = H / 4, W4 = W / 4;
  const float n1 = (float)B * H2 * W2, n3 = (float)B * H4 * W4;
  const float* fv = f(fvecs);
  const float* ds_in = f(dstat);
  auto dmean = [&](int bn) { return ds_in + bn * 32; };
  auto dvar = [&](int bn) { return ds_in + (4 + bn) * 32; };
  float* ds = static_cast<float*>(work);
  float* dss = ds + 32;
  float* sums = ds + 64;
  float* dv = static_cast<float*>(dvec);
  float* gp = static_cast<float*>(gpart);
  float* wp = static_cast<float*>(wpart);
  // e of stem2b over d(cat)'s buffer (free after (b)), e of stem2a over
  // dy2b's (free once e2b is formed)
  bf16* e2b = hm(dcat);
  bf16* e2a = hm(dy2b);

  // (a)
  rodt::stat_cotangent_kernel<<<1, 32, 0, st>>>(dmean(3), dvar(3),
                                                fv + 12 * 32, n3, 32, ds, dss);
  int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  err = ftc::launch_e2(h(dy3), h(y3), ds, dss, hm(e3),
                       (long long)B * H4 * W4 * 32, 32, vec, st);
  if (err != 0) return err;
  err = ftc::launch_da1<false, 32, 32, rodt::ACT_RELU>(
      h(e3), h(k3), nullptr, nullptr, nullptr, hm(dcat), nullptr, B, H2, W2,
      64, 32, da_blocks, vec, st);
  if (err != 0) return err;
  err = ftc::launch_dk2<false, 4, 4, rodt::ACT_RELU>(
      h(cat), h(e3), nullptr, nullptr, wp, static_cast<float*>(dk3), B, H2,
      W2, 64, 32, dk3_chunks, vec, st);
  if (err != 0) return err;

  // (b)
  const long long items = (long long)B * H2 * W2 * 4;
  stc::assemble_bwd_vec_kernel<32><<<asm_blocks, 256, 0, st>>>(
      h(y1), h(y2b), h(dcat), fslot(fv, 0, F_G), fslot(fv, 0, F_B),
      fslot(fv, 2, F_G), fslot(fv, 2, F_B), hm(da1p), hm(dy2b), gp, H2, W2,
      items);
  err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  err = rodt::launch_finalize(gp, asm_blocks, 32, 1.f, sums, nullptr,
                              nullptr, nullptr, nullptr, nullptr, nullptr,
                              st);
  if (err != 0) return err;
  err = rodt::sync_sums(sync, sums, 32);
  if (err != 0) return err;
  // dvec: dsc1, dbi1, dsc2a, dbi2a, dsc2b, dbi2b in slots 0..5
  rodt::bn_chain_kernel<<<1, 32, 0, st>>>(
      sums, f(sc2b), fslot(fv, 2, F_MEAN), fslot(fv, 2, F_VAR), n1, dmean(2),
      dvar(2), 32, dv + 4 * 32, dv + 5 * 32, ds, dss);
  err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;

  // (c) stem2b: e2b, its filter gradient, the gradient into y2a
  err = ftc::launch_e2(h(dy2b), h(y2b), ds, dss, e2b, (long long)B * H2 * W2
                       * 32, 32, 1, st);
  if (err != 0) return err;
  err = stc::launch_wg2<16, 32>(h(y2a), e2b, fslot(fv, 1, F_G),
                                fslot(fv, 1, F_B), wp,
                                static_cast<float*>(dk2b), B, H2, W2,
                                wg2b_chunks, vec, st);
  if (err != 0) return err;
  err = stc::launch_dx2<32, 16, false>(
      e2b, h(k2b), h(y2a), nullptr, fslot(fv, 1, F_G), fslot(fv, 1, F_B),
      hm(dy2a), gp, B, H2, W2, dx2b_blocks, vec, st);
  if (err != 0) return err;
  err = rodt::launch_finalize(gp, dx2b_blocks, 16, 1.f, sums, nullptr,
                              nullptr, nullptr, nullptr, nullptr, nullptr,
                              st);
  if (err != 0) return err;
  err = rodt::sync_sums(sync, sums, 16);
  if (err != 0) return err;
  rodt::bn_chain_kernel<<<1, 32, 0, st>>>(
      sums, f(sc2a), fslot(fv, 1, F_MEAN), fslot(fv, 1, F_VAR), n1, dmean(1),
      dvar(1), 16, dv + 2 * 32, dv + 3 * 32, ds, dss);
  err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;

  // stem2a: e2a, its filter gradient, the gradient into y1 (plus the
  // pool's)
  err = ftc::launch_e2(h(dy2a), h(y2a), ds, dss, e2a, (long long)B * H2 * W2
                       * 16, 16, 1, st);
  if (err != 0) return err;
  err = stc::launch_wg2<32, 16>(h(y1), e2a, fslot(fv, 0, F_G),
                                fslot(fv, 0, F_B), wp,
                                static_cast<float*>(dk2a), B, H2, W2,
                                wg2a_chunks, vec, st);
  if (err != 0) return err;
  err = stc::launch_dx2<16, 32, true>(
      e2a, h(k2a), h(y1), h(da1p), fslot(fv, 0, F_G), fslot(fv, 0, F_B),
      hm(dy1), gp, B, H2, W2, dx2a_blocks, vec, st);
  if (err != 0) return err;
  err = rodt::launch_finalize(gp, dx2a_blocks, 32, 1.f, sums, nullptr,
                              nullptr, nullptr, nullptr, nullptr, nullptr,
                              st);
  if (err != 0) return err;
  err = rodt::sync_sums(sync, sums, 32);
  if (err != 0) return err;
  rodt::bn_chain_kernel<<<1, 32, 0, st>>>(
      sums, f(sc1), fslot(fv, 0, F_MEAN), fslot(fv, 0, F_VAR), n1, dmean(0),
      dvar(0), 32, dv, dv + 32, ds, dss);
  err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;

  // (d)
  return ftc::launch_dk1<32>(h(x), h(dy1), h(y1), ds, dss, wp,
                             static_cast<float*>(dk1), B, H, W, 32,
                             dk1_chunks, vec_x, st);
}

// f32: hgstem_bwd_tc_nhwc's arguments with every tensor f32 and the plan of
// kernels.stem_bwd_plan("float32", ...): the filter gradients of the 2x2
// convs write two partials a chunk (wpart: max(dk3_chunks * 9 * 64 * 32,
// wg2b_chunks * 2 * 4 * 16 * 32, wg2a_chunks * 2 * 4 * 32 * 16, dk1_chunks
// * 27 * 32) floats); vec_x needs W a multiple of 4. Split-TF32 kernels.
extern "C" int hgstem_bwd_tf32_nhwc(
    const void* x, const void* y1, const void* y2a, const void* y2b,
    const void* cat, const void* y3, const void* k2a, const void* k2b,
    const void* k3, const void* sc1, const void* sc2a, const void* sc2b,
    const void* fvecs, const void* dy3, const void* dstat, void* dcat,
    void* da1p, void* dy2b, void* dy2a, void* dy1, void* e3, void* gpart,
    void* wpart, void* work, void* dk1, void* dk2a, void* dk2b, void* dk3,
    void* dvec, int B, int H, int W, int da_blocks, int dk3_chunks,
    int asm_blocks, int wg2b_chunks, int dx2b_blocks, int wg2a_chunks,
    int dx2a_blocks, int dk1_chunks, int vec, int vec_x, void* sync,
    void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || H % 4 || W % 4 || da_blocks <= 0 ||
      dk3_chunks <= 0 || asm_blocks <= 0 || wg2b_chunks <= 0 ||
      dx2b_blocks <= 0 || wg2a_chunks <= 0 || dx2a_blocks <= 0 ||
      dk1_chunks <= 0 || (vec_x && (!vec || W % 4 != 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  namespace ftf = rodt::ftf;
  namespace stf = rodt::stf;
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto m = [](void* p) { return static_cast<float*>(p); };
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int H2 = H / 2, W2 = W / 2, H4 = H / 4, W4 = W / 4;
  const float n1 = (float)B * H2 * W2, n3 = (float)B * H4 * W4;
  const float* fv = f(fvecs);
  const float* ds_in = f(dstat);
  auto dmean = [&](int bn) { return ds_in + bn * 32; };
  auto dvar = [&](int bn) { return ds_in + (4 + bn) * 32; };
  float* ds = m(work);
  float* dss = ds + 32;
  float* sums = ds + 64;
  float* dv = m(dvec);
  float* gp = m(gpart);
  float* wp = m(wpart);
  // e of stem2b over d(cat)'s buffer (free after (b)), e of stem2a over
  // dy2b's (free once e2b is formed)
  float* e2b = m(dcat);
  float* e2a = m(dy2b);

  // (a)
  rodt::stat_cotangent_kernel<<<1, 32, 0, st>>>(dmean(3), dvar(3),
                                                fv + 12 * 32, n3, 32, ds, dss);
  int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  err = ftf::launch_e2(f(dy3), f(y3), ds, dss, m(e3),
                       (long long)B * H4 * W4 * 32, 32, vec, st);
  if (err != 0) return err;
  err = ftf::launch_da1<false, 32, 32, 32, rodt::ACT_RELU>(
      f(e3), f(k3), nullptr, nullptr, nullptr, m(dcat), nullptr, B, H2, W2,
      64, 32, da_blocks, vec, st);
  if (err != 0) return err;
  err = ftf::launch_dk2<false, 32, 32, rodt::ACT_RELU>(
      f(cat), f(e3), nullptr, nullptr, wp, m(dk3), B, H2, W2, 64, 32,
      dk3_chunks, vec, st);
  if (err != 0) return err;

  // (b)
  const long long items = (long long)B * H2 * W2 * 8;
  stf::assemble_bwd_f32_kernel<32><<<asm_blocks, 256, 0, st>>>(
      f(y1), f(y2b), f(dcat), fslot(fv, 0, F_G), fslot(fv, 0, F_B),
      fslot(fv, 2, F_G), fslot(fv, 2, F_B), m(da1p), m(dy2b), gp, H2, W2,
      items);
  err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  err = rodt::launch_finalize(gp, asm_blocks, 32, 1.f, sums, nullptr,
                              nullptr, nullptr, nullptr, nullptr, nullptr,
                              st);
  if (err != 0) return err;
  err = rodt::sync_sums(sync, sums, 32);
  if (err != 0) return err;
  // dvec: dsc1, dbi1, dsc2a, dbi2a, dsc2b, dbi2b in slots 0..5
  rodt::bn_chain_kernel<<<1, 32, 0, st>>>(
      sums, f(sc2b), fslot(fv, 2, F_MEAN), fslot(fv, 2, F_VAR), n1, dmean(2),
      dvar(2), 32, dv + 4 * 32, dv + 5 * 32, ds, dss);
  err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;

  // (c) stem2b: e2b, its filter gradient, the gradient into y2a
  err = ftf::launch_e2(f(dy2b), f(y2b), ds, dss, e2b,
                       (long long)B * H2 * W2 * 32, 32, 1, st);
  if (err != 0) return err;
  err = stf::launch_wg2<16, 32>(f(y2a), e2b, fslot(fv, 1, F_G),
                                fslot(fv, 1, F_B), wp, m(dk2b), B, H2, W2,
                                wg2b_chunks, vec, st);
  if (err != 0) return err;
  err = stf::launch_dx2<32, 16, false>(
      e2b, f(k2b), f(y2a), nullptr, fslot(fv, 1, F_G), fslot(fv, 1, F_B),
      m(dy2a), gp, B, H2, W2, dx2b_blocks, vec, st);
  if (err != 0) return err;
  err = rodt::launch_finalize(gp, dx2b_blocks, 16, 1.f, sums, nullptr,
                              nullptr, nullptr, nullptr, nullptr, nullptr,
                              st);
  if (err != 0) return err;
  err = rodt::sync_sums(sync, sums, 16);
  if (err != 0) return err;
  rodt::bn_chain_kernel<<<1, 32, 0, st>>>(
      sums, f(sc2a), fslot(fv, 1, F_MEAN), fslot(fv, 1, F_VAR), n1, dmean(1),
      dvar(1), 16, dv + 2 * 32, dv + 3 * 32, ds, dss);
  err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;

  // stem2a: e2a, its filter gradient, the gradient into y1 (plus the
  // pool's)
  err = ftf::launch_e2(f(dy2a), f(y2a), ds, dss, e2a,
                       (long long)B * H2 * W2 * 16, 16, 1, st);
  if (err != 0) return err;
  err = stf::launch_wg2<32, 16>(f(y1), e2a, fslot(fv, 0, F_G),
                                fslot(fv, 0, F_B), wp, m(dk2a), B, H2, W2,
                                wg2a_chunks, vec, st);
  if (err != 0) return err;
  err = stf::launch_dx2<16, 32, true>(
      e2a, f(k2a), f(y1), f(da1p), fslot(fv, 0, F_G), fslot(fv, 0, F_B),
      m(dy1), gp, B, H2, W2, dx2a_blocks, vec, st);
  if (err != 0) return err;
  err = rodt::launch_finalize(gp, dx2a_blocks, 32, 1.f, sums, nullptr,
                              nullptr, nullptr, nullptr, nullptr, nullptr,
                              st);
  if (err != 0) return err;
  err = rodt::sync_sums(sync, sums, 32);
  if (err != 0) return err;
  rodt::bn_chain_kernel<<<1, 32, 0, st>>>(
      sums, f(sc1), fslot(fv, 0, F_MEAN), fslot(fv, 0, F_VAR), n1, dmean(0),
      dvar(0), 32, dv, dv + 32, ds, dss);
  err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;

  // (d)
  return ftf::launch_dk1<32>(f(x), m(dy1), f(y1), ds, dss, wp, m(dk1), B, H,
                             W, 32, dk1_chunks, vec_x, st);
}
