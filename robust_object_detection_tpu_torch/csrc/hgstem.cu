// K4-f: the HGNetv2 stem (HGStem) from the image to stem3's output, NHWC,
// eval mode (hgstem_tc_nhwc, hgstem_tf32_nhwc) and train mode
// (hgstem_train_tc_nhwc, hgstem_train_tf32_nhwc).
//
// Replaces: robust_object_detection_tpu/ops/pallas_stem.py, _stem1_kernel,
// _conv2x2_kernel (twice), _assemble_kernel and _stem3_kernel (public
// entries stem_fused_inference and stem_fused):
//   stem1   conv3x3 stride 2 pad 1, 3 -> 32, BN1 (eps 1e-3) + ReLU   -> a1
//   stem2a  conv2x2 (zero pad right/bottom, VALID), 32 -> 16, BN + ReLU
//   stem2b  conv2x2 (same padding), 16 -> 32, BN + ReLU             -> a2b
//   pool    2x2 stride-1 max of a1 with zero pad right/bottom (equal to the
//           ceil-mode pool, since a1 >= 0)
//   cat     [pool, a2b], 64 channels
//   stem3   conv3x3 stride 2 pad 1, 64 -> 32, returned BEFORE BN3 (the
//           caller applies BN3 + ReLU and the 1x1 stem4).
// Every BN is folded from the running statistics by the caller into
// (g, b) f32 vectors: bn(y) = g * y + b.
//
// The TPU version keeps every tensor as (B, H, C, W) channel planes, builds
// conv patches from lane rolls, splits even and odd columns for the
// stride-2 convs and walks 8-row blocks in order, because NHWC tensors of
// 3..64 channels are lane padded there and strided lane slices do not
// exist. None of that comes along: here every stage reads and writes NHWC
// with plain indices, and blocks run in any order.
//
// Two routes, by dtype, each five launches (eval) or nine (train) on one
// stream, hand-written tensor-core implicit GEMMs with the launch plan of
// kernels.stem_plan (persistent blocks, 16-byte or element staging):
//   1. stem1: P1 (front_tc.cuh / front_tf32.cuh) at 32 output channels, an
//      im2col tile of the x rows; eval: BN1 + ReLU on the f32 accumulator;
//      train: y1 and BN1 partials;
//   2. stem2a, 3. stem2b: the 2x2 conv (stem_tc.cuh / stem_tf32.cuh), a
//      stride-1 GEMM over 4 taps from one staged halo; stem2b writes
//      channels 32..63 of the concat (eval) or y2b (train);
//   4. the pool (eval) or pool + concat (train): 8 (bf16) or 4 (f32)
//      channels a thread, 16-byte loads;
//   5. stem3: P2 at 64 -> 32, no input transform (the concat is stored
//      activated), BN3 partials in train mode.
//   * bf16 (hgstem_tc_nhwc, hgstem_train_tc_nhwc): mma.sync.m16n8k16.
//     What bounds it on the H100 at (8, 1024, 1024, 3): 40 GFLOP (0.04 ms
//     at 989 TFLOP/s) against 84 MB that must move (x in, y3 out: 0.025
//     ms), so operations; this design also writes and reads a1, a2a and
//     the concat (about 1.2 GB, 0.35 ms at 3.35 TB/s), which sets its pace.
//     On an H100 80GB HBM3 at 700 W: eval 0.579 ms of device time (stem1
//     0.081, stem2a 0.103, stem2b 0.103, pool 0.107, stem3 0.165, the
//     caller's BN folds 0.02), train 0.761 (0.101, 0.145, 0.116, assemble
//     0.196, 0.176, finalizes 0.011).
//   * f32 (hgstem_tf32_nhwc, hgstem_train_tf32_nhwc): split ("3x") TF32 on
//     mma.sync.m16n8k8.tf32 (front_tf32.cuh's P1 at 32 channels and P2 at
//     64 -> 32 in 16-channel stages, stem_tf32.cuh's 2x2 convs and 4-channel
//     elementwise stages). The same 40 GFLOP are 120 GFLOP of TF32 MMAs
//     (0.24 ms at 495 TFLOP/s) against 2.3 GB of f32 traffic between the
//     stages (eval; 0.69 ms), so bytes set its pace.
// The concat buffer does reach memory in both routes (the pool is not
// fused into stem3's staging).
//
// Rounding: a1, a2a, a2b (hence the concat) and y3 are stored in the
// working dtype; every sum and every BN + ReLU runs in f32 on the
// accumulator. (The TPU kernels store the pre-BN y and apply BN + ReLU
// while reading: the same math with one rounding moved.)
//
// Train mode: every BN uses the statistics of its own batch, which exist
// only once the conv below it has covered the whole batch. So each conv
// stores its raw (pre-BN) output in the working dtype and emits per-block
// sum / sum-of-squares partials of the stored values from its epilogue; a
// one-block-per-channel pass reduces them in a fixed order into mean, the
// clamped fast variance and the fold (g, b); the next stage applies
// relu(g * y + b), rounded to the working dtype, while it stages its input.
// The pool and the concat read y1 and y2b through the same folds. y1, y2a,
// y2b and the concat stay in memory: the backward (hgstem_bwd.cu) reads
// them. No atomics, so the statistics are the same bits from run to run.

#include "stem_tc.cuh"
#include "stem_tf32.cuh"

namespace {

using rodt::stc::bf16;

// The plan of kernels.stem_plan for one call: persistent blocks and
// 16-byte staging of stem1, stem2a, stem2b and stem3.
struct StemPlan {
  int blocks[4];
  int vec[4];
};

// stem1's 16-byte staging reads x rows in pieces of `piece` elements (8
// bf16, 4 f32), so W must be a multiple of one
bool stem_ok(int B, int H, int W, const StemPlan& p, int piece) {
  for (int i = 0; i < 4; ++i)
    if (p.blocks[i] <= 0) return false;
  return B > 0 && H > 0 && W > 0 && H % 4 == 0 && W % 4 == 0 &&
         !(p.vec[0] && W % piece != 0);
}

const bf16* h(const void* p) { return static_cast<const bf16*>(p); }
bf16* hm(void* p) { return static_cast<bf16*>(p); }
const float* f(const void* p) { return static_cast<const float*>(p); }
float* fm(void* p) { return static_cast<float*>(p); }

}  // namespace

// bf16 eval. x (B, H, W, 3); k1 (3,3,3,32), k2a (2,2,32,16), k2b
// (2,2,16,32), k3 (3,3,64,32) HWIO in the working dtype; g*, b* the folded
// BN vectors, f32; a1 (B, H/2, W/2, 32), a2a (B, H/2, W/2, 16) and cat (B,
// H/2, W/2, 64) are scratch in the working dtype; y3 (B, H/4, W/4, 32). H
// and W are multiples of 4. Then the plan of kernels.stem_plan: blocks of
// stem1, stem2a, stem2b, stem3 and their 16-byte staging flags.
extern "C" int hgstem_tc_nhwc(const void* x, const void* k1, const void* g1,
                              const void* b1, const void* k2a,
                              const void* g2a, const void* b2a,
                              const void* k2b, const void* g2b,
                              const void* b2b, const void* k3, void* a1,
                              void* a2a, void* cat, void* y3, int B, int H,
                              int W, int blocks1, int blocks2a, int blocks2b,
                              int blocks3, int vec1, int vec2a, int vec2b,
                              int vec3, void* stream) {
  const StemPlan p{{blocks1, blocks2a, blocks2b, blocks3},
                   {vec1, vec2a, vec2b, vec3}};
  if (!stem_ok(B, H, W, p, 8)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  namespace ftc = rodt::ftc;
  namespace stc = rodt::stc;
  const int H2 = H / 2, W2 = W / 2;
  int err = ftc::launch_p1<false, 4, rodt::ACT_RELU>(
      h(x), h(k1), f(g1), f(b1), hm(a1), nullptr, B, H, W, 32, blocks1, vec1,
      st);
  if (err != 0) return err;
  err = stc::launch_c2<32, 16, false>(h(a1), h(k2a), f(g2a), f(b2a), hm(a2a),
                                      nullptr, B, H2, W2, 16, 0, blocks2a,
                                      vec2a, st);
  if (err != 0) return err;
  err = stc::launch_c2<16, 32, false>(h(a2a), h(k2b), f(g2b), f(b2b),
                                      hm(cat), nullptr, B, H2, W2, 64, 32,
                                      blocks2b, vec2b, st);
  if (err != 0) return err;
  const long long items = (long long)B * H2 * W2 * 4;
  stc::pool2x2_vec_kernel<32><<<stc::elementwise_blocks(items), 256, 0, st>>>(
      h(a1), hm(cat), H2, W2, 64, items);
  err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  return ftc::launch_p2<false, false, 64, 32, rodt::ACT_RELU>(
      h(cat), h(k3), nullptr, nullptr, hm(y3), nullptr, B, H2, W2, 64, 32,
      blocks3, vec3, st);
}

// bf16 train mode. x and the filters as hgstem_tc_nhwc's; sc*, bi* the BN
// affines, f32. Outputs in the working dtype, all pre-BN: y1 (B, H/2, W/2,
// 32), y2a (.., 16), y2b (.., 32), y3 (B, H/4, W/4, 32), and cat (B, H/2,
// W/2, 64) = [pool(a1), a2b]. stats: scratch of 2 * max(blocks1 * 32,
// blocks2a * 16, blocks2b * 32, blocks3 * 32) floats (one partial row per
// persistent block of each conv). vecs: 14 slots of 32 floats, written
// here: per BN (1, 2a, 2b) mean, var and the fold g, b in slots 4 i .. 4 i
// + 3 (BN2a fills 16 of each), then mean3, var3 in slots 12, 13. sync (a
// rodt::SyncFn, or null) averages each BN's batch sums over a data-parallel
// group before its statistics are taken; sync_buf is its scratch of 64
// floats. Then the plan as hgstem_tc_nhwc's.
extern "C" int hgstem_train_tc_nhwc(
    const void* x, const void* k1, const void* sc1, const void* bi1,
    const void* k2a, const void* sc2a, const void* bi2a, const void* k2b,
    const void* sc2b, const void* bi2b, const void* k3, void* y1, void* y2a,
    void* y2b, void* cat, void* y3, void* stats, void* vecs, int B, int H,
    int W, int blocks1, int blocks2a, int blocks2b, int blocks3, int vec1,
    int vec2a, int vec2b, int vec3, void* sync, void* sync_buf,
    void* stream) {
  const StemPlan p{{blocks1, blocks2a, blocks2b, blocks3},
                   {vec1, vec2a, vec2b, vec3}};
  if (!stem_ok(B, H, W, p, 8)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  namespace ftc = rodt::ftc;
  namespace stc = rodt::stc;
  const int H2 = H / 2, W2 = W / 2, H4 = H / 4, W4 = W / 4;
  const float n2 = (float)B * H2 * W2;
  float* v = static_cast<float*>(vecs);
  float* sp = static_cast<float*>(stats);
  // slots of 32 floats: BN i's mean, var, g, b in 4 i .. 4 i + 3
  auto slot = [&](int bn, int which) { return v + (4 * bn + which) * 32; };
  int err = ftc::launch_p1<true, 4, rodt::ACT_RELU>(
      h(x), h(k1), nullptr, nullptr, hm(y1), sp, B, H, W, 32, blocks1, vec1,
      st);
  if (err != 0) return err;
  float* sb = static_cast<float*>(sync_buf);
  err = rodt::launch_finalize_synced(sp, blocks1, 32, n2, sync, sb,
                                     slot(0, 0), slot(0, 1), f(sc1), f(bi1),
                                     slot(0, 2), slot(0, 3), st);
  if (err != 0) return err;
  err = stc::launch_c2<32, 16, true>(h(y1), h(k2a), slot(0, 2), slot(0, 3),
                                     hm(y2a), sp, B, H2, W2, 16, 0, blocks2a,
                                     vec2a, st);
  if (err != 0) return err;
  err = rodt::launch_finalize_synced(sp, blocks2a, 16, n2, sync, sb,
                                     slot(1, 0), slot(1, 1), f(sc2a),
                                     f(bi2a), slot(1, 2), slot(1, 3), st);
  if (err != 0) return err;
  err = stc::launch_c2<16, 32, true>(h(y2a), h(k2b), slot(1, 2), slot(1, 3),
                                     hm(y2b), sp, B, H2, W2, 32, 0, blocks2b,
                                     vec2b, st);
  if (err != 0) return err;
  err = rodt::launch_finalize_synced(sp, blocks2b, 32, n2, sync, sb,
                                     slot(2, 0), slot(2, 1), f(sc2b),
                                     f(bi2b), slot(2, 2), slot(2, 3), st);
  if (err != 0) return err;
  const long long items = (long long)B * H2 * W2 * 4;
  stc::assemble_train_vec_kernel<32>
      <<<stc::elementwise_blocks(items), 256, 0, st>>>(
          h(y1), h(y2b), slot(0, 2), slot(0, 3), slot(2, 2), slot(2, 3),
          hm(cat), H2, W2, items);
  err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  err = ftc::launch_p2<false, true, 64, 32, rodt::ACT_RELU>(
      h(cat), h(k3), nullptr, nullptr, hm(y3), sp, B, H2, W2, 64, 32,
      blocks3, vec3, st);
  if (err != 0) return err;
  return rodt::launch_finalize_synced(sp, blocks3, 32, (float)B * H4 * W4,
                                      sync, sb, v + 12 * 32, v + 13 * 32,
                                      nullptr, nullptr, nullptr, nullptr,
                                      st);
}

// f32 eval: hgstem_tc_nhwc's arguments with every tensor f32 and the plan
// of kernels.stem_plan("float32", ...); split-TF32 kernels.
extern "C" int hgstem_tf32_nhwc(const void* x, const void* k1,
                                const void* g1, const void* b1,
                                const void* k2a, const void* g2a,
                                const void* b2a, const void* k2b,
                                const void* g2b, const void* b2b,
                                const void* k3, void* a1, void* a2a,
                                void* cat, void* y3, int B, int H, int W,
                                int blocks1, int blocks2a, int blocks2b,
                                int blocks3, int vec1, int vec2a, int vec2b,
                                int vec3, void* stream) {
  const StemPlan p{{blocks1, blocks2a, blocks2b, blocks3},
                   {vec1, vec2a, vec2b, vec3}};
  if (!stem_ok(B, H, W, p, 4)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  namespace ftf = rodt::ftf;
  namespace stf = rodt::stf;
  const int H2 = H / 2, W2 = W / 2;
  int err = ftf::launch_p1<false, 4, rodt::ACT_RELU>(
      f(x), f(k1), f(g1), f(b1), fm(a1), nullptr, B, H, W, 32, blocks1, vec1,
      st);
  if (err != 0) return err;
  err = stf::launch_c2<32, 16, false>(f(a1), f(k2a), f(g2a), f(b2a),
                                      fm(a2a), nullptr, B, H2, W2, 16, 0,
                                      blocks2a, vec2a, st);
  if (err != 0) return err;
  err = stf::launch_c2<16, 32, false>(f(a2a), f(k2b), f(g2b), f(b2b),
                                      fm(cat), nullptr, B, H2, W2, 64, 32,
                                      blocks2b, vec2b, st);
  if (err != 0) return err;
  const long long items = (long long)B * H2 * W2 * 8;
  stf::pool2x2_f32_kernel<32>
      <<<rodt::stc::elementwise_blocks(items), 256, 0, st>>>(
          f(a1), fm(cat), H2, W2, 64, items);
  err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  return ftf::launch_p2<false, false, 16, 64, 32, rodt::ACT_RELU>(
      f(cat), f(k3), nullptr, nullptr, fm(y3), nullptr, B, H2, W2, 64, 32,
      blocks3, vec3, st);
}

// f32 train mode: hgstem_train_tc_nhwc's arguments with every tensor f32
// and the plan of kernels.stem_plan("float32", ...); split-TF32 kernels.
extern "C" int hgstem_train_tf32_nhwc(
    const void* x, const void* k1, const void* sc1, const void* bi1,
    const void* k2a, const void* sc2a, const void* bi2a, const void* k2b,
    const void* sc2b, const void* bi2b, const void* k3, void* y1, void* y2a,
    void* y2b, void* cat, void* y3, void* stats, void* vecs, int B, int H,
    int W, int blocks1, int blocks2a, int blocks2b, int blocks3, int vec1,
    int vec2a, int vec2b, int vec3, void* sync, void* sync_buf,
    void* stream) {
  const StemPlan p{{blocks1, blocks2a, blocks2b, blocks3},
                   {vec1, vec2a, vec2b, vec3}};
  if (!stem_ok(B, H, W, p, 4)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  namespace ftf = rodt::ftf;
  namespace stf = rodt::stf;
  const int H2 = H / 2, W2 = W / 2, H4 = H / 4, W4 = W / 4;
  const float n2 = (float)B * H2 * W2;
  float* v = static_cast<float*>(vecs);
  float* sp = static_cast<float*>(stats);
  // slots of 32 floats: BN i's mean, var, g, b in 4 i .. 4 i + 3
  auto slot = [&](int bn, int which) { return v + (4 * bn + which) * 32; };
  int err = ftf::launch_p1<true, 4, rodt::ACT_RELU, double>(
      f(x), f(k1), nullptr, nullptr, fm(y1), sp, B, H, W, 32, blocks1, vec1,
      st);
  if (err != 0) return err;
  float* sb = static_cast<float*>(sync_buf);
  err = rodt::launch_finalize_synced(sp, blocks1, 32, n2, sync, sb,
                                     slot(0, 0), slot(0, 1), f(sc1), f(bi1),
                                     slot(0, 2), slot(0, 3), st);
  if (err != 0) return err;
  err = stf::launch_c2<32, 16, true>(f(y1), f(k2a), slot(0, 2), slot(0, 3),
                                     fm(y2a), sp, B, H2, W2, 16, 0, blocks2a,
                                     vec2a, st);
  if (err != 0) return err;
  err = rodt::launch_finalize_synced(sp, blocks2a, 16, n2, sync, sb,
                                     slot(1, 0), slot(1, 1), f(sc2a),
                                     f(bi2a), slot(1, 2), slot(1, 3), st);
  if (err != 0) return err;
  err = stf::launch_c2<16, 32, true>(f(y2a), f(k2b), slot(1, 2), slot(1, 3),
                                     fm(y2b), sp, B, H2, W2, 32, 0, blocks2b,
                                     vec2b, st);
  if (err != 0) return err;
  err = rodt::launch_finalize_synced(sp, blocks2b, 32, n2, sync, sb,
                                     slot(2, 0), slot(2, 1), f(sc2b),
                                     f(bi2b), slot(2, 2), slot(2, 3), st);
  if (err != 0) return err;
  const long long items = (long long)B * H2 * W2 * 8;
  stf::assemble_train_f32_kernel<32>
      <<<rodt::stc::elementwise_blocks(items), 256, 0, st>>>(
          f(y1), f(y2b), slot(0, 2), slot(0, 3), slot(2, 2), slot(2, 3),
          fm(cat), H2, W2, items);
  err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  err = ftf::launch_p2<false, true, 16, 64, 32, rodt::ACT_RELU, double>(
      f(cat), f(k3), nullptr, nullptr, fm(y3), sp, B, H2, W2, 64, 32,
      blocks3, vec3, st);
  if (err != 0) return err;
  return rodt::launch_finalize_synced(sp, blocks3, 32, (float)B * H4 * W4,
                                      sync, sb, v + 12 * 32, v + 13 * 32,
                                      nullptr, nullptr, nullptr, nullptr,
                                      st);
}
