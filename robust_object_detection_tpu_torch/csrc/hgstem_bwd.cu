// K4-b: backward of the train-mode HGNetv2 stem (hgstem_train_nhwc), NHWC.
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
//   * f32: hgstem_bwd_nhwc, the CUDA-core kernels below: the weight
//     gradients through the chunked kernel of conv_wgrad.cuh (a 2x2 conv
//     with zero pad right/bottom is the taps ky, kx in {1, 2} of a 3x3
//     pad-1 conv, so its gradient is a corner of that kernel's result, at
//     2.25x the work), the input gradients gather kernels tiled over
//     pixels.

#include "conv_wgrad.cuh"
#include "stem_tc.cuh"

namespace {

using namespace rodt;

constexpr int DC_C = 16;  // y3 channels staged per pass of stem3_dx_kernel

using stc::sel;  // maximum-VJP weight, shared with the bf16 route

// (a) d(cat)[b, iy, ix, c] = sum over taps (ky, kx) with iy + 1 - ky and
// ix + 1 - kx even, and co: e3[b, (iy+1-ky)/2, (ix+1-kx)/2, co]
// * k3[ky, kx, c, co]. Block: a TILE x TILE tile of cat pixels (a 9 x 9
// patch of y3) and CO_T = 16 of the CC cat channels; each thread 4 pixels
// (rows ty0 + 4 j: one row parity) x 4 channels.
template <typename T>
__global__ void __launch_bounds__(THREADS)
stem3_dx_kernel(const T* __restrict__ dy3, const T* __restrict__ y3,
                const float* __restrict__ ds3, const float* __restrict__ dss3,
                const T* __restrict__ k3, T* __restrict__ dcat, int H2,
                int W2, int CC, int C3, int H4, int W4, int tiles_x) {
  __shared__ float s_d[DC_C][9][9];
  __shared__ __align__(16) float s_k[9][DC_C][CO_T];

  const int tid = threadIdx.x;
  const int cg = tid & 3;
  const int pg = tid >> 2;
  const int tx = pg & (TILE - 1);
  const int ty0 = pg >> 4;
  const int iy0 = (blockIdx.x / tiles_x) * TILE;
  const int ix0 = (blockIdx.x % tiles_x) * TILE;
  const int c0 = blockIdx.y * CO_T;
  const int b = blockIdx.z;
  const int oyb = iy0 / 2, oxb = ix0 / 2;
  const int py = ty0 & 1, px = tx & 1;

  float acc[4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int k = 0; k < 4; ++k) acc[j][k] = 0.f;

  for (int c30 = 0; c30 < C3; c30 += DC_C) {
    const int nc = min(DC_C, C3 - c30);
    __syncthreads();
    for (int idx = tid; idx < DC_C * 81; idx += THREADS) {
      const int c = idx % DC_C;
      const int pix = idx / DC_C;
      const int ly = pix / 9, lx = pix % 9;
      const int oy = oyb + ly, ox = oxb + lx;
      float v = 0.f;
      if (c < nc && oy < H4 && ox < W4) {
        const size_t off = (((size_t)b * H4 + oy) * W4 + ox) * C3 + c30 + c;
        v = round_to<T>(to_f(dy3[off]) + ds3[c30 + c]
                        + 2.f * to_f(y3[off]) * dss3[c30 + c]);
      }
      s_d[c][ly][lx] = v;
    }
    for (int idx = tid; idx < 9 * DC_C * CO_T; idx += THREADS) {
      const int cc = idx % CO_T;
      const int r = idx / CO_T;
      const int c = r % DC_C, tap = r / DC_C;
      float v = 0.f;
      if (c < nc && c0 + cc < CC)
        v = to_f(k3[((size_t)tap * CC + c0 + cc) * C3 + c30 + c]);
      s_k[tap][c][cc] = v;
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

  const int ix = ix0 + tx;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int iy = iy0 + ty0 + 4 * j;
    if (iy >= H2 || ix >= W2) continue;
    const size_t off = (((size_t)b * H2 + iy) * W2 + ix) * CC;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int c = c0 + cg * 4 + k;
      if (c < CC) dcat[off + c] = from_f<T>(acc[j][k]);
    }
  }
}

// (b) per (pixel, channel c < C): dy2b = dcat[.., C + c] * [z2b > 0] * g2b
// with the BN2b partials sum(dpre * y2b), sum(dpre); da1p = the pool half
// dcat[.., c] of the (up to) four windows that hold this a1 pixel, routed
// by the maximum's gradient. Block: TILE x TILE pixels x 16 channels,
// thread layout of conv3x3_tile_kernel.
template <typename T>
__global__ void __launch_bounds__(THREADS)
assemble_bwd_kernel(const T* __restrict__ y1, const T* __restrict__ y2b,
                    const T* __restrict__ dcat, const float* __restrict__ g1,
                    const float* __restrict__ b1,
                    const float* __restrict__ g2b,
                    const float* __restrict__ b2b, T* __restrict__ da1p,
                    T* __restrict__ dy2b, float* __restrict__ gpart, int H,
                    int W, int C, int tiles_x, int n_tiles) {
  const int tid = threadIdx.x;
  const int cg = tid & 3;
  const int pg = tid >> 2;
  const int tx = pg & (TILE - 1);
  const int ty0 = pg >> 4;
  const int iy0 = (blockIdx.x / tiles_x) * TILE;
  const int ix0 = (blockIdx.x % tiles_x) * TILE;
  const int c0 = blockIdx.y * CO_T;
  const int b = blockIdx.z;
  const T* y1b = y1 + (size_t)b * H * W * C;
  const T* dcb = dcat + (size_t)b * H * W * 2 * C;

  float dg[4] = {0.f, 0.f, 0.f, 0.f}, db[4] = {0.f, 0.f, 0.f, 0.f};
  const int ix = ix0 + tx;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int iy = iy0 + ty0 + 4 * j;
    if (iy >= H || ix >= W) continue;
    const size_t pix = (size_t)iy * W + ix;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int c = c0 + cg * 4 + k;
      if (c >= C) continue;
      // the a2b half
      const size_t off = ((size_t)b * H * W + pix) * C + c;
      const float yv = to_f(y2b[off]);
      const float z = yv * g2b[c] + b2b[c];
      const float dpre = z > 0.f ? to_f(dcb[pix * 2 * C + C + c]) : 0.f;
      dy2b[off] = from_f<T>(dpre * g2b[c]);
      dg[k] = fmaf(dpre, yv, dg[k]);
      db[k] += dpre;
      // the pool half: a1 on the 3 x 3 neighbourhood, zero outside
      const float g = g1[c], bb = b1[c];
      float a[3][3];
#pragma unroll
      for (int r = 0; r < 3; ++r)
#pragma unroll
        for (int s = 0; s < 3; ++s) {
          const int yy = iy + r - 1, xx = ix + s - 1;
          a[r][s] = (yy >= 0 && yy < H && xx >= 0 && xx < W)
              ? round_to<T>(fmaxf(
                    to_f(y1b[((size_t)yy * W + xx) * C + c]) * g + bb, 0.f))
              : 0.f;
        }
      // window at (iy + r - 1, ix + s - 1), r, s in {0, 1}: upper row
      // a[r][s], a[r][s+1]; lower row a[r+1][s], a[r+1][s+1]; this pixel
      // is a[1][1]
      float d = 0.f;
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int s = 0; s < 2; ++s) {
          const int wy = iy + r - 1, wx = ix + s - 1;
          if (wy < 0 || wx < 0) continue;
          const float top = fmaxf(a[r][s], a[r][s + 1]);
          const float bot = fmaxf(a[r + 1][s], a[r + 1][s + 1]);
          const float mine_row = r == 0 ? sel(bot, top) : sel(top, bot);
          const float other = a[1][s == 0 ? 0 : 2];
          d = fmaf(to_f(dcb[((size_t)wy * W + wx) * 2 * C + c]),
                   mine_row * sel(a[1][1], other), d);
        }
      da1p[off] = from_f<T>(d);
    }
  }
  block_channel_partials(dg, db, gpart, (size_t)gridDim.z * n_tiles,
                         (size_t)b * n_tiles + blockIdx.x, c0, C);
}

// (c) input gradient of a 2x2 conv (zero pad right/bottom) chained through
// the BN + ReLU below it:
//   dA[b, i, j, ca] = sum_{dy, dx in {0,1}, ce} e[b, i-dy, j-dx, ce]
//                                                * k[dy, dx, ca, ce]
//   e = round(dyc + ds + 2 yout dss), zero outside the image,
//   dpre = (dA + add) * [g yin + b > 0]   (add: a second gradient of the
//          same activation, or nullptr), dyin = dpre * g,
// with the partials sum(dpre * yin), sum(dpre) in gpart[2][P][CA].
// One block: a TILE x TILE pixel tile, all CA channels; 64 pixel groups x
// 4 channel groups, a thread 4 pixels x CA/4 channels.
template <typename T, int CE, int CA>
__global__ void __launch_bounds__(THREADS)
conv2x2_dx_kernel(const T* __restrict__ dyc, const T* __restrict__ yout,
                  const float* __restrict__ ds, const float* __restrict__ dss,
                  const T* __restrict__ k, const T* __restrict__ yin,
                  const float* __restrict__ g, const float* __restrict__ bv,
                  const T* __restrict__ add, T* __restrict__ dyin,
                  float* __restrict__ gpart, int H, int W, int tiles_x) {
  constexpr int IN_T = TILE + 1;
  constexpr int CPT = CA / 4;
  static_assert(CPT % 4 == 0, "CA must be a multiple of 16");
  __shared__ float s_e[CE][IN_T][IN_T];
  __shared__ __align__(16) float s_w[4][CE][CA];

  const int tid = threadIdx.x;
  const int cg = tid & 3;
  const int pg = tid >> 2;
  const int tx = pg & (TILE - 1);
  const int ty0 = pg >> 4;
  const int iy0 = (blockIdx.x / tiles_x) * TILE;
  const int ix0 = (blockIdx.x % tiles_x) * TILE;
  const int bi = blockIdx.y;

  // patch origin (iy0 - 1, ix0 - 1): local (ly, lx) is pixel (iy0 - 1 + ly,
  // ix0 - 1 + lx)
  for (int idx = tid; idx < CE * IN_T * IN_T; idx += THREADS) {
    const int c = idx % CE;
    const int pix = idx / CE;
    const int ly = pix / IN_T, lx = pix % IN_T;
    const int gy = iy0 - 1 + ly, gx = ix0 - 1 + lx;
    float v = 0.f;
    if (gy >= 0 && gy < H && gx >= 0 && gx < W) {
      const size_t off = (((size_t)bi * H + gy) * W + gx) * CE + c;
      v = round_to<T>(to_f(dyc[off]) + ds[c] + 2.f * to_f(yout[off]) * dss[c]);
    }
    s_e[c][ly][lx] = v;
  }
  for (int idx = tid; idx < 4 * CE * CA; idx += THREADS) {
    const int ca = idx % CA;
    const int r = idx / CA;
    const int ce = r % CE, tap = r / CE;
    s_w[tap][ce][ca] = to_f(k[((size_t)tap * CA + ca) * CE + ce]);
  }
  __syncthreads();

  float acc[4][CPT];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int q = 0; q < CPT; ++q) acc[j][q] = 0.f;

  for (int c = 0; c < CE; ++c) {
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
          // pixel (ty0 + 4 j, tx) of the tile is local (.. + 1, tx + 1)
          const float ev = s_e[c][ty0 + 4 * j + 1 - dy][tx + 1 - dx];
#pragma unroll
          for (int q = 0; q < CPT; ++q)
            acc[j][q] = fmaf(ev, wv[q], acc[j][q]);
        }
      }
    }
  }

  float dg[CPT], db[CPT];
#pragma unroll
  for (int q = 0; q < CPT; ++q) dg[q] = db[q] = 0.f;
  const int ix = ix0 + tx;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int iy = iy0 + ty0 + 4 * j;
    if (iy >= H || ix >= W) continue;
    const size_t off = (((size_t)bi * H + iy) * W + ix) * CA + cg * CPT;
#pragma unroll
    for (int q = 0; q < CPT; ++q) {
      const int ca = cg * CPT + q;
      const float yv = to_f(yin[off + q]);
      const float z = yv * g[ca] + bv[ca];
      float tot = acc[j][q];
      if (add != nullptr) tot += to_f(add[off + q]);
      const float dpre = z > 0.f ? tot : 0.f;
      dyin[off + q] = from_f<T>(dpre * g[ca]);
      dg[q] = fmaf(dpre, yv, dg[q]);
      db[q] += dpre;
    }
  }
  block_partials<CPT>(dg, db, gpart, (size_t)gridDim.y * gridDim.x,
                      (size_t)bi * gridDim.x + blockIdx.x);
}

// Slots of 32 floats in the forward's statistics buffer (hgstem.cu)
constexpr int F_MEAN = 0, F_VAR = 1, F_G = 2, F_B = 3;
inline const float* fslot(const float* v, int bn, int which) {
  return v + (4 * bn + which) * 32;
}

template <typename T>
int stem_bwd(const void* x, const void* y1, const void* y2a, const void* y2b,
             const void* cat, const void* y3, const void* k2a,
             const void* k2b, const void* k3, const float* sc1,
             const float* sc2a, const float* sc2b, const float* fv,
             const void* dy3, const float* dstat, void* dcat, void* da1p,
             void* dy2b, void* dy2a, void* dy1, float* gpart, float* wpart,
             float* work, float* dk1, float* dk2a9, float* dk2b9, float* dk3,
             float* dvec, int B, int H, int W, int ch1, int ch2a, int ch2b,
             int ch3, cudaStream_t st) {
  const int H2 = H / 2, W2 = W / 2, H4 = H / 4, W4 = W / 4;
  const float n1 = (float)B * H2 * W2, n3 = (float)B * H4 * W4;
  const int tiles_x = (W2 + TILE - 1) / TILE;
  const int n_tiles = tile_count(H2, W2);
  const int P = B * n_tiles;
  // dstat: dmean of BN1, 2a, 2b, 3 in slots 0..3, dvar in slots 4..7
  auto dmean = [&](int bn) { return dstat + bn * 32; };
  auto dvar = [&](int bn) { return dstat + (4 + bn) * 32; };
  // work: ds, dss of the stage in hand, and the reduced (dg, db)
  float* ds = work;
  float* dss = work + 32;
  float* sums = work + 64;
  auto T_ = [](const void* p) { return static_cast<const T*>(p); };
  auto M_ = [](void* p) { return static_cast<T*>(p); };

  // (a)
  stat_cotangent_kernel<<<1, 32, 0, st>>>(dmean(3), dvar(3), fv + 12 * 32,
                                          n3, 32, ds, dss);
  int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  {
    dim3 grid(n_tiles, 64 / CO_T, B);
    stem3_dx_kernel<T><<<grid, THREADS, 0, st>>>(
        T_(dy3), T_(y3), ds, dss, T_(k3), M_(dcat), H2, W2, 64, 32, H4, W4,
        tiles_x);
    err = static_cast<int>(cudaGetLastError());
    if (err != 0) return err;
  }
  WgradOpts o3;
  o3.y = y3;
  o3.dsum = ds;
  o3.dsq = dss;
  err = launch_wgrad<T>(2, cat, dy3, o3, wpart, dk3, B, H2, W2, 64, 32, ch3,
                        st);
  if (err != 0) return err;

  // (b)
  {
    dim3 grid(n_tiles, 32 / CO_T, B);
    assemble_bwd_kernel<T><<<grid, THREADS, 0, st>>>(
        T_(y1), T_(y2b), T_(dcat), fslot(fv, 0, F_G), fslot(fv, 0, F_B),
        fslot(fv, 2, F_G), fslot(fv, 2, F_B), M_(da1p), M_(dy2b), gpart, H2,
        W2, 32, tiles_x, n_tiles);
    err = static_cast<int>(cudaGetLastError());
    if (err != 0) return err;
  }
  err = launch_finalize(gpart, P, 32, 1.f, sums, nullptr, nullptr, nullptr,
                        nullptr, nullptr, nullptr, st);
  if (err != 0) return err;
  // dvec: dsc1, dbi1, dsc2a, dbi2a, dsc2b, dbi2b in slots 0..5
  bn_chain_kernel<<<1, 32, 0, st>>>(sums, sc2b, fslot(fv, 2, F_MEAN),
                                    fslot(fv, 2, F_VAR), n1, dmean(2),
                                    dvar(2), 32, dvec + 4 * 32, dvec + 5 * 32,
                                    ds, dss);
  err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;

  // (c) stem2b: its weight gradient and the gradient into y2a
  WgradOpts o2b;
  o2b.in_scale = fslot(fv, 1, F_G);
  o2b.in_bias = fslot(fv, 1, F_B);
  o2b.y = y2b;
  o2b.dsum = ds;
  o2b.dsq = dss;
  err = launch_wgrad<T, ACT_RELU>(1, y2a, dy2b, o2b, wpart, dk2b9, B, H2, W2,
                                  16, 32, ch2b, st);
  if (err != 0) return err;
  {
    dim3 grid(n_tiles, B);
    conv2x2_dx_kernel<T, 32, 16><<<grid, THREADS, 0, st>>>(
        T_(dy2b), T_(y2b), ds, dss, T_(k2b), T_(y2a), fslot(fv, 1, F_G),
        fslot(fv, 1, F_B), nullptr, M_(dy2a), gpart, H2, W2, tiles_x);
    err = static_cast<int>(cudaGetLastError());
    if (err != 0) return err;
  }
  err = launch_finalize(gpart, P, 16, 1.f, sums, nullptr, nullptr, nullptr,
                        nullptr, nullptr, nullptr, st);
  if (err != 0) return err;
  // (ds, dss) of BN2b are read by the two launches above, which precede
  // this overwrite on the stream
  bn_chain_kernel<<<1, 32, 0, st>>>(sums, sc2a, fslot(fv, 1, F_MEAN),
                                    fslot(fv, 1, F_VAR), n1, dmean(1),
                                    dvar(1), 16, dvec + 2 * 32, dvec + 3 * 32,
                                    ds, dss);
  err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;

  // stem2a: its weight gradient and the gradient into y1 (plus the pool's)
  WgradOpts o2a;
  o2a.in_scale = fslot(fv, 0, F_G);
  o2a.in_bias = fslot(fv, 0, F_B);
  o2a.y = y2a;
  o2a.dsum = ds;
  o2a.dsq = dss;
  err = launch_wgrad<T, ACT_RELU>(1, y1, dy2a, o2a, wpart, dk2a9, B, H2, W2,
                                  32, 16, ch2a, st);
  if (err != 0) return err;
  {
    dim3 grid(n_tiles, B);
    conv2x2_dx_kernel<T, 16, 32><<<grid, THREADS, 0, st>>>(
        T_(dy2a), T_(y2a), ds, dss, T_(k2a), T_(y1), fslot(fv, 0, F_G),
        fslot(fv, 0, F_B), T_(da1p), M_(dy1), gpart, H2, W2, tiles_x);
    err = static_cast<int>(cudaGetLastError());
    if (err != 0) return err;
  }
  err = launch_finalize(gpart, P, 32, 1.f, sums, nullptr, nullptr, nullptr,
                        nullptr, nullptr, nullptr, st);
  if (err != 0) return err;
  bn_chain_kernel<<<1, 32, 0, st>>>(sums, sc1, fslot(fv, 0, F_MEAN),
                                    fslot(fv, 0, F_VAR), n1, dmean(0),
                                    dvar(0), 32, dvec, dvec + 32, ds, dss);
  err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;

  // (d)
  WgradOpts o1;
  o1.y = y1;
  o1.dsum = ds;
  o1.dsq = dss;
  return launch_wgrad<T>(2, x, dy1, o1, wpart, dk1, B, H, W, 3, 32, ch1, st);
}

}  // namespace

// f32 only. The tensors hgstem_train_nhwc read and wrote (x, y1, y2a, y2b, cat, y3,
// the filters k2a, k2b, k3, all in the working dtype; sc1, sc2a, sc2b f32;
// fvecs its statistics buffer), dy3 (B, H/4, W/4, 32) in the working dtype
// and dstat (8 slots of 32 floats: dmean of BN1, 2a, 2b, 3, then dvar).
// Scratch in the working dtype: dcat (B, H/2, W/2, 64), da1p, dy2b, dy1
// (.., 32), dy2a (.., 16); f32: gpart 2 * B * tile_count(H/2, W/2) * 32,
// wpart the largest chunks * 9 * Cin * Cout of the four weight gradients,
// work 128. Outputs f32: dk1 (3,3,3,32), dk3 (3,3,64,32), dk2a9 (3,3,32,16)
// and dk2b9 (3,3,16,32) whose [1:, 1:] corners are dk2a and dk2b, and dvec
// (6 slots of 32: dsc1, dbi1, dsc2a, dbi2a, dsc2b, dbi2b).
extern "C" int hgstem_bwd_nhwc(
    const void* x, const void* y1, const void* y2a, const void* y2b,
    const void* cat, const void* y3, const void* k2a, const void* k2b,
    const void* k3, const void* sc1, const void* sc2a, const void* sc2b,
    const void* fvecs, const void* dy3, const void* dstat, void* dcat,
    void* da1p, void* dy2b, void* dy2a, void* dy1, void* gpart, void* wpart,
    void* work, void* dk1, void* dk2a9, void* dk2b9, void* dk3, void* dvec,
    int B, int H, int W, int ch1, int ch2a, int ch2b, int ch3, int dtype,
    void* stream) {
  if (B <= 0 || B > 65535 || H <= 0 || W <= 0 || H % 4 || W % 4)
    return static_cast<int>(cudaErrorInvalidValue);
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto m = [](void* p) { return static_cast<float*>(p); };
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype != rodt::DTYPE_F32)  // bf16 goes to hgstem_bwd_tc_nhwc
    return static_cast<int>(cudaErrorInvalidValue);
  return stem_bwd<float>(x, y1, y2a, y2b, cat, y3, k2a, k2b, k3, f(sc1),
                         f(sc2a), f(sc2b), f(fvecs), dy3, f(dstat), dcat,
                         da1p, dy2b, dy2a, dy1, m(gpart), m(wpart), m(work),
                         m(dk1), m(dk2a9), m(dk2b9), m(dk3), m(dvec), B, H, W,
                         ch1, ch2a, ch2b, ch3, st);
}

// bf16: the tensors hgstem_train_tc_nhwc read and wrote and the
// cotangents, as hgstem_bwd_nhwc's, plus the scratch e3 (like y3); dk2a
// (2,2,32,16) and dk2b (2,2,16,32) are written directly. Then the plan of
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
    int dx2a_blocks, int dk1_chunks, int vec, int vec_x, void* stream) {
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
