// K4-f: the HGNetv2 stem (HGStem) from the image to stem3's output, NHWC,
// eval mode (hgstem_nhwc) and train mode (hgstem_train_nhwc).
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
// stream:
//   * bf16 (every model path): hgstem_tc_nhwc and hgstem_train_tc_nhwc,
//     hand-written tensor-core implicit GEMMs (mma.sync.m16n8k16, ldmatrix,
//     16-byte cp.async staging) with the launch plan of kernels.stem_plan:
//       1. stem1: front_p1_kernel (front_tc.cuh) at 32 output channels, an
//          im2col tile of the 6-byte x rows; eval: BN1 + ReLU on the f32
//          accumulator, a1 stored in bf16; train: y1 and BN1 partials;
//       2. stem2a, 3. stem2b: stem2x2_tc_kernel (stem_tc.cuh), a stride-1
//          GEMM over 4 taps from one staged halo; stem2b writes channels
//          32..63 of the concat (eval) or y2b (train);
//       4. the pool (eval) or pool + concat (train): 8 channels a thread;
//       5. stem3: front_p2_kernel at 64 -> 32, one channel pass, no input
//          transform (the concat is stored activated), BN3 partials in
//          train mode.
//     What bounds it on the H100 at (8, 1024, 1024, 3): 40 GFLOP (0.04 ms
//     at 989 TFLOP/s) against 84 MB that must move (x in, y3 out: 0.025
//     ms), so operations; this design also writes and reads a1, a2a and
//     the concat (about 1.2 GB, 0.35 ms at 3.35 TB/s), which sets its pace.
//     On an H100 80GB HBM3 at 700 W: eval 0.579 ms of device time (stem1
//     0.081, stem2a 0.103, stem2b 0.103, pool 0.107, stem3 0.165, the
//     caller's BN folds 0.02), train 0.761 (0.101, 0.145, 0.116, assemble
//     0.196, 0.176, finalizes 0.011).
//   * f32: hgstem_nhwc and hgstem_train_nhwc, the CUDA-core kernels below
//     (the f32 model checks run through them):
//       1. stem1 through the tiled conv of conv_tile.cuh, BN1 + ReLU in
//          its epilogue on the f32 accumulator;
//       2. stem2a, conv2x2_relu_kernel<32, 16>;
//       3. stem2b, conv2x2_relu_kernel<16, 32>, written straight into
//          channels 32..63 of the concat buffer (output channel stride 64);
//       4. pool2x2_kernel writes channels 0..31 of the concat buffer;
//       5. stem3 through the tiled conv, no epilogue.
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

#include "conv_tile.cuh"
#include "stem_tc.cuh"

namespace rodt {

// y[b, i, j, off + co] = relu(g[co] * sum_{dy,dx in {0,1}, ci}
//     x[b, i+dy, j+dx, ci] * w[dy, dx, ci, co] + b[co]),  x zero outside.
// One block: a TILE x TILE pixel tile of one image, all COUT channels.
// 256 threads = 64 pixel groups x 4 channel groups; a thread accumulates
// 4 pixels x COUT/4 channels. ldo is the channel stride of y.
// TRAIN: (g, b) is instead the fold of the BN BELOW this conv, applied with
// ReLU (rounded to T) while staging x; the raw sum is stored and its
// per-block channel sums / sums of squares go to stats[2][P][COUT].
template <typename T, int CIN, int COUT, bool TRAIN>
__global__ void __launch_bounds__(THREADS)
conv2x2_relu_kernel(const T* __restrict__ x, const T* __restrict__ w,
                    const float* __restrict__ g, const float* __restrict__ b,
                    T* __restrict__ y, float* __restrict__ stats, int H,
                    int W, int ldo, int off, int tiles_x) {
  constexpr int IN_T = TILE + 1;
  constexpr int CPT = COUT / 4;  // channels per thread
  static_assert(CPT % 4 == 0, "COUT must be a multiple of 16");
  __shared__ float s_in[CIN][IN_T][IN_T];
  __shared__ __align__(16) float s_w[4][CIN][COUT];

  const int tid = threadIdx.x;
  const int cg = tid & 3;
  const int pg = tid >> 2;
  const int tx = pg & (TILE - 1);
  const int ty0 = pg >> 4;
  const int oy0 = (blockIdx.x / tiles_x) * TILE;
  const int ox0 = (blockIdx.x % tiles_x) * TILE;
  const int bi = blockIdx.y;
  const T* xb = x + (size_t)bi * H * W * CIN;

  for (int idx = tid; idx < CIN * IN_T * IN_T; idx += THREADS) {
    const int c = idx % CIN;  // fastest: contiguous in NHWC
    const int pix = idx / CIN;
    const int iy = pix / IN_T, ix = pix % IN_T;
    const int gy = oy0 + iy, gx = ox0 + ix;
    float v = 0.f;
    if (gy < H && gx < W) {
      v = to_f(xb[((size_t)gy * W + gx) * CIN + c]);
      if (TRAIN) v = round_to<T>(fmaxf(v * g[c] + b[c], 0.f));
    }
    s_in[c][iy][ix] = v;
  }
  for (int idx = tid; idx < 4 * CIN * COUT; idx += THREADS)
    (&s_w[0][0][0])[idx] = to_f(w[idx]);
  __syncthreads();

  float acc[4][CPT];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int k = 0; k < CPT; ++k) acc[j][k] = 0.f;

  for (int c = 0; c < CIN; ++c) {
#pragma unroll
    for (int dy = 0; dy < 2; ++dy) {
#pragma unroll
      for (int dx = 0; dx < 2; ++dx) {
        float wv[CPT];
#pragma unroll
        for (int k4 = 0; k4 < CPT; k4 += 4) {
          const float4 t = *reinterpret_cast<const float4*>(
              &s_w[dy * 2 + dx][c][cg * CPT + k4]);
          wv[k4] = t.x;
          wv[k4 + 1] = t.y;
          wv[k4 + 2] = t.z;
          wv[k4 + 3] = t.w;
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float xv = s_in[c][ty0 + 4 * j + dy][tx + dx];
#pragma unroll
          for (int k = 0; k < CPT; ++k)
            acc[j][k] = fmaf(xv, wv[k], acc[j][k]);
        }
      }
    }
  }

  float s[CPT], ss[CPT];
#pragma unroll
  for (int k = 0; k < CPT; ++k) s[k] = ss[k] = 0.f;
  const int ox = ox0 + tx;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int oy = oy0 + ty0 + 4 * j;
    if (oy >= H || ox >= W) continue;
    T* yp = y + (((size_t)bi * H + oy) * W + ox) * ldo + off + cg * CPT;
#pragma unroll
    for (int k = 0; k < CPT; ++k) {
      if (TRAIN) {
        const T t = from_f<T>(acc[j][k]);
        yp[k] = t;
        const float r = to_f(t);
        s[k] += r;
        ss[k] = fmaf(r, r, ss[k]);
      } else {
        const int co = cg * CPT + k;
        yp[k] = from_f<T>(fmaxf(acc[j][k] * g[co] + b[co], 0.f));
      }
    }
  }
  if (TRAIN)
    block_partials<CPT>(s, ss, stats, (size_t)gridDim.y * gridDim.x,
                        (size_t)bi * gridDim.x + blockIdx.x);
}

// Train mode: cat[..., 0:32] = 2x2 stride-1 max (zero pad right/bottom) of
// a1 = round(relu(g1 y1 + b1)); cat[..., 32:64] = round(relu(g2b y2b +
// b2b)). One thread per (pixel, channel < C).
template <typename T>
__global__ void __launch_bounds__(THREADS)
assemble_train_kernel(const T* __restrict__ y1, const T* __restrict__ y2b,
                      const float* __restrict__ g1,
                      const float* __restrict__ b1,
                      const float* __restrict__ g2b,
                      const float* __restrict__ b2b, T* __restrict__ cat,
                      int H, int W, int C, size_t total) {
  const size_t i = (size_t)blockIdx.x * THREADS + threadIdx.x;
  if (i >= total) return;
  const int c = (int)(i % C);
  const size_t pix = i / C;
  const int xq = (int)(pix % W);
  const int yq = (int)((pix / W) % H);
  const bool right = xq + 1 < W, below = yq + 1 < H;
  const size_t row = (size_t)W * C;
  const float g = g1[c], b = b1[c];
  auto a1 = [&](size_t at) {
    return round_to<T>(fmaxf(to_f(y1[at]) * g + b, 0.f));
  };
  float m = a1(i);
  m = fmaxf(m, right ? a1(i + C) : 0.f);
  m = fmaxf(m, below ? a1(i + row) : 0.f);
  m = fmaxf(m, (right && below) ? a1(i + row + C) : 0.f);
  cat[pix * 2 * C + c] = from_f<T>(m);
  cat[pix * 2 * C + C + c] =
      from_f<T>(fmaxf(to_f(y2b[i]) * g2b[c] + b2b[c], 0.f));
}

// y[b, i, j, c] (channel stride ldo) = max over dy, dx in {0, 1} of
// a[b, i+dy, j+dx, c], a zero outside; one thread per output element.
template <typename T>
__global__ void __launch_bounds__(THREADS)
pool2x2_kernel(const T* __restrict__ a, T* __restrict__ y, int H, int W,
               int C, int ldo, size_t total) {
  const size_t i = (size_t)blockIdx.x * THREADS + threadIdx.x;
  if (i >= total) return;
  const int c = (int)(i % C);
  const size_t pix = i / C;
  const int xq = (int)(pix % W);
  const int yq = (int)((pix / W) % H);
  const bool right = xq + 1 < W, below = yq + 1 < H;
  const size_t row = (size_t)W * C;
  float m = to_f(a[i]);
  m = fmaxf(m, right ? to_f(a[i + C]) : 0.f);
  m = fmaxf(m, below ? to_f(a[i + row]) : 0.f);
  m = fmaxf(m, (right && below) ? to_f(a[i + row + C]) : 0.f);
  y[pix * ldo + c] = from_f<T>(m);
}

template <typename T>
inline int launch_mid_stages(const void* a1, const void* k2a,
                             const float* g2a, const float* b2a,
                             const void* k2b, const float* g2b,
                             const float* b2b, void* a2a, void* cat, int B,
                             int H2, int W2, cudaStream_t st) {
  const int tiles_x = (W2 + TILE - 1) / TILE;
  dim3 grid(tile_count(H2, W2), B);
  conv2x2_relu_kernel<T, 32, 16, false><<<grid, THREADS, 0, st>>>(
      static_cast<const T*>(a1), static_cast<const T*>(k2a), g2a, b2a,
      static_cast<T*>(a2a), nullptr, H2, W2, 16, 0, tiles_x);
  int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  conv2x2_relu_kernel<T, 16, 32, false><<<grid, THREADS, 0, st>>>(
      static_cast<const T*>(a2a), static_cast<const T*>(k2b), g2b, b2b,
      static_cast<T*>(cat), nullptr, H2, W2, 64, 32, tiles_x);
  err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  const size_t total = (size_t)B * H2 * W2 * 32;
  const unsigned blocks = (unsigned)((total + THREADS - 1) / THREADS);
  pool2x2_kernel<T><<<blocks, THREADS, 0, st>>>(
      static_cast<const T*>(a1), static_cast<T*>(cat), H2, W2, 32, 64,
      total);
  return static_cast<int>(cudaGetLastError());
}

// Train mode, the stages between stem1 and stem3. v: the statistics
// buffer of hgstem_train_nhwc (slot layout there).
template <typename T>
inline int launch_mid_stages_train(const void* y1, const void* k2a,
                                   const float* sc2a, const float* bi2a,
                                   const void* k2b, const float* sc2b,
                                   const float* bi2b, void* y2a, void* y2b,
                                   void* cat, float* stats, float* v, int B,
                                   int H2, int W2, void* sync, float* sb,
                                   cudaStream_t st) {
  const int tiles_x = (W2 + TILE - 1) / TILE;
  const int n_tiles = tile_count(H2, W2);
  const float n = (float)B * H2 * W2;
  dim3 grid(n_tiles, B);
  conv2x2_relu_kernel<T, 32, 16, true><<<grid, THREADS, 0, st>>>(
      static_cast<const T*>(y1), static_cast<const T*>(k2a), v + 2 * 32,
      v + 3 * 32, static_cast<T*>(y2a), stats, H2, W2, 16, 0, tiles_x);
  int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  err = launch_finalize_synced(stats, B * n_tiles, 16, n, sync, sb,
                               v + 4 * 32, v + 5 * 32, sc2a, bi2a, v + 6 * 32,
                               v + 7 * 32, st);
  if (err != 0) return err;
  conv2x2_relu_kernel<T, 16, 32, true><<<grid, THREADS, 0, st>>>(
      static_cast<const T*>(y2a), static_cast<const T*>(k2b), v + 6 * 32,
      v + 7 * 32, static_cast<T*>(y2b), stats, H2, W2, 32, 0, tiles_x);
  err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  err = launch_finalize_synced(stats, B * n_tiles, 32, n, sync, sb,
                               v + 8 * 32, v + 9 * 32, sc2b, bi2b,
                               v + 10 * 32, v + 11 * 32, st);
  if (err != 0) return err;
  const size_t total = (size_t)B * H2 * W2 * 32;
  const unsigned blocks = (unsigned)((total + THREADS - 1) / THREADS);
  assemble_train_kernel<T><<<blocks, THREADS, 0, st>>>(
      static_cast<const T*>(y1), static_cast<const T*>(y2b), v + 2 * 32,
      v + 3 * 32, v + 10 * 32, v + 11 * 32, static_cast<T*>(cat), H2, W2, 32,
      total);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace rodt

// f32 eval (bf16 goes to hgstem_tc_nhwc). x (B, H, W, 3); k1 (3,3,3,32),
// k2a (2,2,32,16), k2b (2,2,16,32), k3 (3,3,64,32) HWIO in the working
// dtype; g*, b* the folded BN vectors, f32;
// a1 (B, H/2, W/2, 32), a2a (B, H/2, W/2, 16) and cat (B, H/2, W/2, 64) are
// scratch in the working dtype; y3 (B, H/4, W/4, 32). H and W are
// multiples of 4.
extern "C" int hgstem_nhwc(const void* x, const void* k1, const void* g1,
                           const void* b1, const void* k2a, const void* g2a,
                           const void* b2a, const void* k2b, const void* g2b,
                           const void* b2b, const void* k3, void* a1,
                           void* a2a, void* cat, void* y3, int B, int H,
                           int W, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B <= 0 || B > 65535 || H <= 0 || W <= 0 || H % 4 || W % 4 ||
      dtype != rodt::DTYPE_F32)
    return static_cast<int>(cudaErrorInvalidValue);
  const int H2 = H / 2, W2 = W / 2;
  rodt::ConvOpts p1;
  p1.out_scale = static_cast<const float*>(g1);
  p1.out_bias = static_cast<const float*>(b1);
  int err = rodt::launch_conv3x3_dtype<2, rodt::ACT_RELU>(
      dtype, x, k1, a1, p1, B, H, W, 3, 32, st);
  if (err != 0) return err;
  const float* fg2a = static_cast<const float*>(g2a);
  const float* fb2a = static_cast<const float*>(b2a);
  const float* fg2b = static_cast<const float*>(g2b);
  const float* fb2b = static_cast<const float*>(b2b);
  err = rodt::launch_mid_stages<float>(a1, k2a, fg2a, fb2a, k2b, fg2b, fb2b,
                                       a2a, cat, B, H2, W2, st);
  if (err != 0) return err;
  // no epilogue asked for, so the activation is never applied; the ReLU
  // instantiation is stem1's, reused
  return rodt::launch_conv3x3_dtype<2, rodt::ACT_RELU>(
      dtype, cat, k3, y3, rodt::ConvOpts(), B, H2, W2, 64, 32, st);
}

// f32 train-mode forward (bf16 goes to hgstem_train_tc_nhwc). x and the
// filters as hgstem_nhwc; sc*, bi* the BN
// affines, f32. Outputs in the working dtype, all pre-BN: y1 (B, H/2, W/2,
// 32), y2a (.., 16), y2b (.., 32), y3 (B, H/4, W/4, 32), and cat (B, H/2,
// W/2, 64) = [pool(a1), a2b]. stats: scratch of 2 * B *
// tile_count(H/2, W/2) * 32 floats. vecs: 14 slots of 32 floats, written
// here: per BN (1, 2a, 2b) mean, var and the fold g, b in slots 4 i .. 4 i +
// 3 (BN2a fills 16 of each), then mean3, var3 in slots 12, 13. sync (a
// rodt::SyncFn, or null) averages each BN's batch sums over a data-parallel
// group before its statistics are taken; sync_buf is its scratch of 64
// floats.
extern "C" int hgstem_train_nhwc(
    const void* x, const void* k1, const void* sc1, const void* bi1,
    const void* k2a, const void* sc2a, const void* bi2a, const void* k2b,
    const void* sc2b, const void* bi2b, const void* k3, void* y1, void* y2a,
    void* y2b, void* cat, void* y3, void* stats, void* vecs, int B, int H,
    int W, int dtype, void* sync, void* sync_buf, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B <= 0 || B > 65535 || H <= 0 || W <= 0 || H % 4 || W % 4 ||
      dtype != rodt::DTYPE_F32)
    return static_cast<int>(cudaErrorInvalidValue);
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  const int H2 = H / 2, W2 = W / 2, H4 = H / 4, W4 = W / 4;
  float* v = static_cast<float*>(vecs);
  float* sp = static_cast<float*>(stats);
  rodt::ConvOpts p1;
  p1.stats = sp;
  int err = rodt::launch_conv3x3_dtype<2, rodt::ACT_RELU>(
      dtype, x, k1, y1, p1, B, H, W, 3, 32, st);
  if (err != 0) return err;
  float* sb = static_cast<float*>(sync_buf);
  err = rodt::launch_finalize_synced(sp, B * rodt::tile_count(H2, W2), 32,
                                     (float)B * H2 * W2, sync, sb, v, v + 32,
                                     f(sc1), f(bi1), v + 2 * 32, v + 3 * 32,
                                     st);
  if (err != 0) return err;
  err = rodt::launch_mid_stages_train<float>(
      y1, k2a, f(sc2a), f(bi2a), k2b, f(sc2b), f(bi2b), y2a, y2b, cat, sp, v,
      B, H2, W2, sync, sb, st);
  if (err != 0) return err;
  rodt::ConvOpts p3;
  p3.stats = sp;
  err = rodt::launch_conv3x3_dtype<2, rodt::ACT_RELU>(
      dtype, cat, k3, y3, p3, B, H2, W2, 64, 32, st);
  if (err != 0) return err;
  return rodt::launch_finalize_synced(sp, B * rodt::tile_count(H4, W4), 32,
                                      (float)B * H4 * W4, sync, sb,
                                      v + 12 * 32, v + 13 * 32, nullptr,
                                      nullptr, nullptr, nullptr, st);
}

namespace {

using rodt::stc::bf16;

// The plan of kernels.stem_plan for one call: persistent blocks and
// 16-byte staging of stem1, stem2a, stem2b and stem3.
struct StemPlan {
  int blocks[4];
  int vec[4];
};

bool stem_tc_ok(int B, int H, int W, const StemPlan& p) {
  for (int i = 0; i < 4; ++i)
    if (p.blocks[i] <= 0) return false;
  return B > 0 && H > 0 && W > 0 && H % 4 == 0 && W % 4 == 0 &&
         !(p.vec[0] && W % 8 != 0);
}

const bf16* h(const void* p) { return static_cast<const bf16*>(p); }
bf16* hm(void* p) { return static_cast<bf16*>(p); }
const float* f(const void* p) { return static_cast<const float*>(p); }

}  // namespace

// bf16 eval: the arguments of hgstem_nhwc without dtype, then the plan of
// kernels.stem_plan: blocks of stem1, stem2a, stem2b, stem3 and their
// 16-byte staging flags.
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
  if (!stem_tc_ok(B, H, W, p)) return static_cast<int>(cudaErrorInvalidValue);
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

// bf16 train mode: the arguments of hgstem_train_nhwc without dtype, then
// the plan as hgstem_tc_nhwc's. stats holds 2 * max(blocks1 * 32, blocks2a
// * 16, blocks2b * 32, blocks3 * 32) floats (one partial row per
// persistent block of each conv); vecs as hgstem_train_nhwc's.
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
  if (!stem_tc_ok(B, H, W, p)) return static_cast<int>(cudaErrorInvalidValue);
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
