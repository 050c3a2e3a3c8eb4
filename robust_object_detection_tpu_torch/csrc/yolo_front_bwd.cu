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
//   * f32: yolo_front_bwd_nhwc, the CUDA-core kernels: step 2 a gather
//     tiled over y1 pixels (each y1 pixel reads 1, 2 or 4 y2 pixels, fixed
//     by its row and column parity), steps 3 and 5 the chunked
//     weight-gradient kernel of conv_wgrad.cuh.
// Every cross-block sum goes through fixed-order partials, so a repeated
// run gives identical bits.

#include "conv_wgrad.cuh"
#include "front_tc.cuh"

namespace {

using namespace rodt;

constexpr int DA_C2 = 16;  // y2 channels staged per pass

// Step 2. Block: a TILE x TILE tile of y1 pixels (a 9 x 9 patch of y2) and
// CO_T = 16 of the C1 channels; thread layout as conv3x3_tile_kernel, each
// thread 4 pixels (rows ty0 + 4j: one row parity) x 4 channels.
template <typename T>
__global__ void __launch_bounds__(THREADS)
front_da1_kernel(const T* __restrict__ dy2, const T* __restrict__ y2,
                 const float* __restrict__ ds2,
                 const float* __restrict__ dss2, const T* __restrict__ k2,
                 const T* __restrict__ y1, const float* __restrict__ g1,
                 const float* __restrict__ b1, T* __restrict__ dy1,
                 float* __restrict__ gpart, int H2, int W2, int C1, int C2,
                 int H4, int W4, int tiles_x, int n_tiles) {
  __shared__ float s_d[DA_C2][9][9];
  __shared__ __align__(16) float s_k[9][DA_C2][CO_T];

  const int tid = threadIdx.x;
  const int cg = tid & 3;
  const int pg = tid >> 2;
  const int tx = pg & (TILE - 1);
  const int ty0 = pg >> 4;
  const int iy0 = (blockIdx.x / tiles_x) * TILE;
  const int ix0 = (blockIdx.x % tiles_x) * TILE;
  const int c10 = blockIdx.y * CO_T;
  const int b = blockIdx.z;
  const int oyb = iy0 / 2, oxb = ix0 / 2;   // patch origin in y2
  // y1 row iy takes tap ky from y2 row (iy + 1 - ky) / 2 when that is
  // even; iy0 is even, so the parity is that of ty0 (and tx for columns)
  const int py = ty0 & 1, px = tx & 1;

  float acc[4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int k = 0; k < 4; ++k) acc[j][k] = 0.f;

  for (int c20 = 0; c20 < C2; c20 += DA_C2) {
    const int nc = min(DA_C2, C2 - c20);
    __syncthreads();
    for (int idx = tid; idx < DA_C2 * 81; idx += THREADS) {
      const int c = idx % DA_C2;
      const int pix = idx / DA_C2;
      const int ly = pix / 9, lx = pix % 9;
      const int oy = oyb + ly, ox = oxb + lx;
      float v = 0.f;
      if (c < nc && oy < H4 && ox < W4) {
        const size_t off = (((size_t)b * H4 + oy) * W4 + ox) * C2 + c20 + c;
        v = round_to<T>(to_f(dy2[off]) + ds2[c20 + c]
                        + 2.f * to_f(y2[off]) * dss2[c20 + c]);
      }
      s_d[c][ly][lx] = v;
    }
    for (int idx = tid; idx < 9 * DA_C2 * CO_T; idx += THREADS) {
      const int c1 = idx % CO_T;
      const int r = idx / CO_T;
      const int c = r % DA_C2, tap = r / DA_C2;
      float v = 0.f;
      if (c < nc && c10 + c1 < C1)
        v = to_f(k2[((size_t)tap * C1 + c10 + c1) * C2 + c20 + c]);
      s_k[tap][c][c1] = v;
    }
    __syncthreads();
    for (int c = 0; c < nc; ++c) {
#pragma unroll
      for (int ky = 0; ky < 3; ++ky) {
        if ((py + 1 - ky) & 1) continue;
#pragma unroll
        for (int kx = 0; kx < 3; ++kx) {
          if ((px + 1 - kx) & 1) continue;
          const float4 wv =
              *reinterpret_cast<const float4*>(&s_k[ky * 3 + kx][c][cg * 4]);
          const int lx = (tx + 1 - kx) / 2;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float dv = s_d[c][(ty0 + 4 * j + 1 - ky) / 2][lx];
            acc[j][0] = fmaf(wv.x, dv, acc[j][0]);
            acc[j][1] = fmaf(wv.y, dv, acc[j][1]);
            acc[j][2] = fmaf(wv.z, dv, acc[j][2]);
            acc[j][3] = fmaf(wv.w, dv, acc[j][3]);
          }
        }
      }
    }
  }

  float dg[4] = {0.f, 0.f, 0.f, 0.f}, db[4] = {0.f, 0.f, 0.f, 0.f};
  const int ix = ix0 + tx;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int iy = iy0 + ty0 + 4 * j;
    if (iy >= H2 || ix >= W2) continue;
    const size_t off = (((size_t)b * H2 + iy) * W2 + ix) * C1;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int c1 = c10 + cg * 4 + k;
      if (c1 >= C1) continue;
      const float yv = to_f(y1[off + c1]);
      const float z = yv * g1[c1] + b1[c1];
      const float sg = 1.f / (1.f + expf(-z));
      const float dpre = acc[j][k] * (sg * (1.f + z * (1.f - sg)));
      dy1[off + c1] = from_f<T>(dpre * g1[c1]);
      dg[k] = fmaf(dpre, yv, dg[k]);
      db[k] += dpre;
    }
  }
  block_channel_partials(dg, db, gpart, (size_t)gridDim.z * n_tiles,
                         (size_t)b * n_tiles + blockIdx.x, c10, C1);
}

// Steps 1 and 4 are stat_cotangent_kernel and bn_chain_kernel of
// conv_wgrad.cuh.

template <typename T>
int front_bwd(const void* x, const void* k2, const void* y1, const void* y2,
              const void* dy2, const float* sc1, const float* mean1,
              const float* var1, const float* g1, const float* b1,
              const float* mean2, const float* dmean1, const float* dvar1,
              const float* dmean2, const float* dvar2, void* dy1,
              float* gpart, float* wpart, float* vecs, float* dk1,
              float* dk2, float* dsc1, float* dbi1, int B, int H, int W,
              int C1, int C2, int chunks1, int chunks2, void* sync,
              cudaStream_t st) {
  const int H2 = out_size(H, 2), W2 = out_size(W, 2);
  const int H4 = out_size(H2, 2), W4 = out_size(W2, 2);
  const float n1 = (float)B * H2 * W2, n2 = (float)B * H4 * W4;
  float* ds2 = vecs;
  float* dss2 = ds2 + C2;
  float* sums = dss2 + C2;
  float* ds1 = sums + 2 * C1;
  float* dss1 = ds1 + C1;

  stat_cotangent_kernel<<<1, THREADS, 0, st>>>(dmean2, dvar2, mean2, n2, C2,
                                                ds2, dss2);
  int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;

  const int tiles_x = (W2 + TILE - 1) / TILE;
  const int n_tiles = tile_count(H2, W2);
  dim3 grid(n_tiles, (C1 + CO_T - 1) / CO_T, B);
  front_da1_kernel<T><<<grid, THREADS, 0, st>>>(
      static_cast<const T*>(dy2), static_cast<const T*>(y2), ds2, dss2,
      static_cast<const T*>(k2), static_cast<const T*>(y1), g1, b1,
      static_cast<T*>(dy1), gpart, H2, W2, C1, C2, H4, W4, tiles_x, n_tiles);
  err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;

  WgradOpts o2;
  o2.in_scale = g1;
  o2.in_bias = b1;
  o2.y = y2;
  o2.dsum = ds2;
  o2.dsq = dss2;
  err = launch_wgrad<T>(2, y1, dy2, o2, wpart, dk2, B, H2, W2, C1, C2,
                        chunks2, st);
  if (err != 0) return err;

  err = launch_finalize(gpart, B * n_tiles, C1, 1.f, sums, nullptr, nullptr,
                        nullptr, nullptr, nullptr, nullptr, st);
  if (err != 0) return err;
  err = sync_sums(sync, sums, C1);
  if (err != 0) return err;
  bn_chain_kernel<<<1, THREADS, 0, st>>>(sums, sc1, mean1, var1, n1, dmean1,
                                          dvar1, C1, dsc1, dbi1, ds1, dss1);
  err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;

  WgradOpts o1;
  o1.y = y1;
  o1.dsum = ds1;
  o1.dsq = dss1;
  return launch_wgrad<T>(2, x, dy1, o1, wpart, dk1, B, H, W, 3, C1, chunks1,
                         st);
}

}  // namespace

// x (B,H,W,3), y1 (B,H/2,W/2,C1), y2 / dy2 (B,H/4,W/4,C2) and k2
// (3,3,C1,C2) in the working dtype; the BN vectors f32. Scratch: dy1 like
// y1; gpart 2 * B * tile_count(H/2, W/2) * C1 floats; wpart
// max(chunks1 * 27 * C1, chunks2 * 9 * C1 * C2) floats; vecs 2 * C2 + 4 * C1
// floats. Outputs f32: dk1 (3,3,3,C1), dk2 (3,3,C1,C2), dsc1, dbi1 (C1).
// sync (a rodt::SyncFn, or null) averages BN1's batch sums over a
// data-parallel group before its chain rule; the stat cotangents dmean*,
// dvar* come in averaged already.
extern "C" int yolo_front_bwd_nhwc(
    const void* x, const void* k2, const void* y1, const void* y2,
    const void* dy2, const void* sc1, const void* mean1, const void* var1,
    const void* g1, const void* b1, const void* mean2, const void* dmean1,
    const void* dvar1, const void* dmean2, const void* dvar2, void* dy1,
    void* gpart, void* wpart, void* vecs, void* dk1, void* dk2, void* dsc1,
    void* dbi1, int B, int H, int W, int C1, int C2, int chunks1,
    int chunks2, int dtype, void* sync, void* stream) {
  if (B <= 0 || B > 65535 || H < 2 || W < 2 || C1 <= 0 || C2 <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype != rodt::DTYPE_F32)  // bf16 goes to yolo_front_bwd_tc_nhwc
    return static_cast<int>(cudaErrorInvalidValue);
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto m = [](void* p) { return static_cast<float*>(p); };
  return front_bwd<float>(x, k2, y1, y2, dy2, f(sc1), f(mean1), f(var1),
                          f(g1), f(b1), f(mean2), f(dmean1), f(dvar1),
                          f(dmean2), f(dvar2), dy1, m(gpart), m(wpart),
                          m(vecs), m(dk1), m(dk2), m(dsc1), m(dbi1), B, H, W,
                          C1, C2, chunks1, chunks2, sync,
                          static_cast<cudaStream_t>(stream));
}

// bf16: arguments as yolo_front_bwd_nhwc, plus the scratch e2 (like y2) and
// the plan of kernels.front_bwd_plan: da_blocks persistent blocks of dA1
// (gpart holds 2 * da_blocks * C1 floats), dk2_chunks and dk1_chunks pixel
// chunks (wpart holds max(dk2_chunks * 9 * C1 * C2, dk1_chunks * 27 * C1)
// floats), vec (16-byte staging of y1, y2, dy2, e2, dy1 and k2) and vec_x
// (also of x, for dk1).
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
