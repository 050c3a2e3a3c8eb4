// f32 kernels of the HGNetv2 stem's 2x2 convs (stem2a, 32 -> 16, and
// stem2b, 16 -> 32; zero pad right/bottom, stride 1) on the tensor cores in
// split ("3x") TF32, and the f32 elementwise stages, for the f32 route of
// hgstem.cu (K4-f) and hgstem_bwd.cu (K4-b). The split-TF32 counterparts
// of stem_tc.cuh's kernels, with the arithmetic of conv3x3_tf32.cuh (hi =
// tf32(a) with cvt.rna's rounding, lo = tf32(a - hi); lo*hi, hi*lo, hi*hi
// on mma.sync.m16n8k8.tf32 into one f32 accumulator; the non-finite guard).
// The stride-2 convs (stem1, stem3) and their gradients run front_tf32.cuh's
// kernels at K4's widths.
//
//   stem2x2_tf32_kernel        y = conv2x2(x, k): M = 128 pixels (an 8 x 16
//                              tile), N = COUT, K = 4 taps x CIN from one
//                              staged (TH + 1) x (TW + 1) halo, a tap being
//                              a per-lane ldmatrix row shift. Eval: BN +
//                              ReLU in the epilogue; train: the BN + ReLU
//                              of the layer below applied to the halo as it
//                              is split, raw y stored and the batch
//                              statistics partials from the accumulators.
//   stem2x2_dx_tf32_kernel     dA = the transposed 2x2 conv of e (taps from
//                              pixels up and left), chained through the BN
//                              + ReLU below in the epilogue with a second
//                              gradient of the same activation added (the
//                              pool's, for a1), dgamma / dbeta partials.
//   stem2x2_wgrad_tf32_kernel  dk (2, 2, Cin, Cout) = sum over pixels of a
//                              (x) e over the 2x2 tap range itself, a =
//                              relu(g y + b) formed as the halo is split;
//                              per-chunk partials summed in a fixed order.
//   pool2x2_f32_kernel, assemble_train_f32_kernel, assemble_bwd_f32_kernel
//                              the pool / concat of eval and train mode and
//                              the concat's backward (pool routing, BN2b
//                              chain), 4 channels a thread by 16-byte loads
//                              and stores.
//
// What bounds them on an H100 at (8, 1024, 1024, 3), stem2 maps 8 x 512 x
// 512: each 2x2 conv does 8.6 GFLOP (26 GFLOP of TF32 MMAs with the split,
// 0.052 ms at 495 TFLOP/s) against 0.40 GB (stem2a: a1 in, a2a out; 0.12
// ms at 3.35 TB/s), its input gradient up to 0.94 GB: bytes, with K = 64
// or 128 and N = 16 or 32 too small for the MMAs to matter. So each staged value is split once,
// into shared memory, where the train transform is applied too: the A
// operand (the halo) is read by four taps and the filter by every tile,
// and splitting them per ldmatrix would cost 8 CUDA-core instructions a
// value each time (the filters, 8 KB, are split once a block). Layouts
// (f32 doubles every staged byte of the bf16 kernels):
//   * forward: the raw halo in two cp.async stages (the next tile's copy
//     under this tile's split and MMAs), its hi / lo planes (rows of CIN +
//     4 floats: an odd number of 16-byte units, so an ldmatrix phase meets
//     8 bank groups) and the split filter [tap][co][ci]: 106 KB for stem2a
//     (two blocks an SM), 69 KB for stem2b (three).
//   * input gradient: the same for e's halo and the filter as stored
//     ([tap][ca][ce], ce contiguous: B by plain ldmatrix); yin and the
//     added gradient are read from memory in the epilogue (prefetched into
//     L2 with the tile's copies) rather than staged, which keeps 107 KB
//     (stem2b's dX: two blocks) and 69 KB (stem2a's: three).
//   * filter gradient: K3-b's scheme (conv3x3_tf32.cuh): raw yin halo and
//     e tile, then one pass forms a and splits both into (hi c, hi c+1, lo
//     c, lo c+1) quads of channel pairs read by 128-bit loads. 8 warps: tap
//     w % 4 over tile rows 4 (w / 4) .. + 3, each half writing its own
//     partial (the chunk sum adds 2 x chunks partials in order). 111-120
//     KB, one or two blocks an SM.
//
// Every cross-block sum goes through per-block or per-chunk partials
// reduced in a fixed order (no atomics): the same bits run to run.
#pragma once

#include "front_tf32.cuh"
#include "stem_tc.cuh"

namespace rodt {
namespace stf {

using ftf::add_stat;
using ftf::FWD_PASSES;
using ftf::put_quad;
using ftf::warp_sum_s;
using ftf::store_tile;
using ftc::set_smem;
using ftc::tiles_of;
using stc::halo2_offset;
using stc::HALO;
using stc::HC;
using stc::PIX;
using stc::sel;
using stc::TH;
using stc::tile_offset;
using stc::TW;
using tc::cp_async_commit;
using tc::cp_async_wait_prev;
using tc::ldsm_x4;
using tc::smem_addr;
using tc::stage_rows;
using tc32::mma_grid_3xtf32;
using tc32::split_tf32;

constexpr int C2_THREADS = 128;  // 4 warps (forward, dX)
constexpr int WG_THREADS = 256;  // 8 warps: 4 taps x 2 row halves
constexpr int E = sizeof(float);

// Per-block channel partials [2][n_blk][8 NT] of a 4-warp block whose lanes
// hold f64 sums s1, s2[NT][2] for channels 8 j + 2 t4 + e: summed over the
// lane groups by shuffles, then over the warps in order, and rounded to
// f32 once (stem_tc.cuh's four_warp_partials in f64: a persistent block's
// thread sums a value of each of its tiles, and the statistics'
// cotangents amplify the rounding of a long f32 chain). Every thread
// calls it.
template <int NT>
__device__ __forceinline__ void four_warp_partials_f64(
    double s1[NT][2], double s2[NT][2], float* __restrict__ out, int n_blk,
    int blk) {
  constexpr int C = 8 * NT;
  __shared__ double red[4][2][C];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  warp_sum_s<NT, double>(s1);
  warp_sum_s<NT, double>(s2);
  if (g == 0)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        red[warp][0][8 * j + 2 * t4 + e] = s1[j][e];
        red[warp][1][8 * j + 2 * t4 + e] = s2[j][e];
      }
  __syncthreads();
  if (tid < 2 * C) {
    const int which = tid / C, c = tid - which * C;
    double t = 0.0;
    for (int w = 0; w < 4; ++w) t += red[w][which][c];
    out[((size_t)which * n_blk + blk) * C + c] = (float)t;
  }
}

// hi and lo of four values: the split of conv3x3_tf32.cuh
__device__ __forceinline__ void split_store(float* hi, float* lo,
                                            float4 v) {
  uint32_t h[4], l[4];
  split_tf32(v.x, h[0], l[0]);
  split_tf32(v.y, h[1], l[1]);
  split_tf32(v.z, h[2], l[2]);
  split_tf32(v.w, h[3], l[3]);
  *reinterpret_cast<uint4*>(hi) = make_uint4(h[0], h[1], h[2], h[3]);
  *reinterpret_cast<uint4*>(lo) = make_uint4(l[0], l[1], l[2], l[3]);
}

// The filter of a 2x2 conv split once a block into fh / fl [4][N][S]: row
// (tap, n), K channels; k is read at k[(tap * K + kk) * N + n] when
// TRANSPOSE (HWIO with N the output channels: the forward), else at
// k[(tap * N + n) * K + kk] (the dX filter as stored).
template <int N, int K, bool TRANSPOSE>
__device__ __forceinline__ void split_filter(float* fh, float* fl,
                                             const float* __restrict__ k,
                                             int tid, int nthreads) {
  constexpr int S = K + 4;
  for (int i = tid; i < 4 * N * K; i += nthreads) {
    int tap, n, kk;
    if (TRANSPOSE) {  // read along n (coalesced)
      n = i % N;
      const int r = i / N;
      kk = r % K, tap = r / K;
    } else {          // read along kk
      kk = i % K;
      const int r = i / K;
      n = r % N, tap = r / N;
    }
    const float v =
        TRANSPOSE ? k[((long long)tap * K + kk) * N + n]
                  : k[((long long)tap * N + n) * K + kk];
    uint32_t h, l;
    split_tf32(v, h, l);
    fh[(tap * N + n) * S + kk] = __uint_as_float(h);
    fl[(tap * N + n) * S + kk] = __uint_as_float(l);
  }
}

// One 8 x 16 tile's 2 x NT m16n8 accumulators of a warp (tile rows 2 warp,
// + 1; a_lane holds the warp's row) over 4 taps x K channels: A from the
// split halo planes (rows of S floats, HC pixels a halo row; al_off bytes
// from hi to lo), B from the split filter [tap][n][S] (bl_off). Output
// pixel (r, c) at tap (dy, dx) reads halo pixel (r + O + SIGN dy, c + O +
// SIGN dx): O 0, SIGN +1 for the forward (halo origin at the tile), O 1,
// SIGN -1 for dX (origin one row and column before it).
template <int K, int NT, int O, int SIGN>
__device__ __forceinline__ void mma_2x2(float (&acc)[2][NT][4],
                                        uint32_t a_lane, uint32_t al_off,
                                        uint32_t b_lane, uint32_t bl_off) {
  constexpr int S = K + 4, N = 8 * NT;
#pragma unroll
  for (int k0 = 0; k0 < K; k0 += 8) {
#pragma unroll
    for (int tap = 0; tap < 4; ++tap) {
      const int dy = tap >> 1, dx = tap & 1;
      uint32_t ah[2][4], al[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const uint32_t a =
            a_lane + (((i + O + SIGN * dy) * HC + O + SIGN * dx) * S + k0) * E;
        ldsm_x4(ah[i], a);
        ldsm_x4(al[i], a + al_off);
      }
      uint32_t bh[NT][2], bl[NT][2];
#pragma unroll
      for (int jj = 0; jj < NT / 2; ++jj) {
        uint32_t h[4], l[4];
        const uint32_t b = b_lane + ((tap * N + 16 * jj) * S + k0) * E;
        ldsm_x4(h, b);
        ldsm_x4(l, b + bl_off);
#pragma unroll
        for (int e = 0; e < 2; ++e) {  // n8 tiles 2 jj, 2 jj + 1
          bh[2 * jj + e][0] = h[2 * e], bh[2 * jj + e][1] = h[2 * e + 1];
          bl[2 * jj + e][0] = l[2 * e], bl[2 * jj + e][1] = l[2 * e + 1];
        }
      }
      mma_grid_3xtf32<2, NT, FWD_PASSES>(acc, ah, al, bh, bl);
    }
  }
}

// ---- stem2a / stem2b forward ----------------------------------------------
//
// y[b, i, j, off + co] = sum_{dy, dx in {0, 1}, ci} x[b, i + dy, j + dx, ci]
// k[dy, dx, ci, co], x zero outside (channel stride ldo of y). Per 8 x 16
// tile: M = 128 pixels, N = COUT, K = 4 x CIN; 4 warps, warp w owns tile
// rows 2w, 2w + 1 x COUT / 8 n8 tiles. Persistent: block i walks tiles i, i
// + gridDim.x, ...; the next tile's halo lands by cp.async while this one
// is split and multiplied. Eval (g, b: this conv's BN fold): y = relu(g acc
// + b). TRAIN (g, b: the fold of the BN below): x = relu(g x + b) for the
// halo pixels inside the image, applied before the split; y = acc, and the
// block's sums and sums of squares of y over its pixels inside the image
// into stats[2][gridDim.x][COUT].
template <int CIN, int COUT>
__host__ __device__ constexpr size_t c2_smem() {
  return sizeof(float) * (size_t)(4 * HALO * (CIN + 4) +
                                  2 * 4 * COUT * (CIN + 4));
}

template <int CIN, int COUT, bool TRAIN, bool VEC>
__global__ void __launch_bounds__(C2_THREADS)
stem2x2_tf32_kernel(const float* __restrict__ x, const float* __restrict__ k,
                    const float* __restrict__ g, const float* __restrict__ bv,
                    float* __restrict__ y, float* __restrict__ stats, int H,
                    int W, int ldo, int off, int tiles_x, int tiles_per_img,
                    int n_tiles) {
  constexpr int S = CIN + 4, NT = COUT / 8, Q = CIN / 4;
  static_assert(CIN % 8 == 0 && COUT % 16 == 0, "stem2x2 tiles");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* raw = reinterpret_cast<float*>(smem_raw);  // [2][HALO][S]
  float* ah = raw + 2 * HALO * S;                   // [HALO][S]
  float* al = ah + HALO * S;                        // [HALO][S]
  float* fh = al + HALO * S;                        // [4][COUT][S]
  float* fl = fh + 4 * COUT * S;                    // [4][COUT][S]
  __shared__ float gs[CIN], bs[CIN];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, t4 = lane & 3;
  const int blk = blockIdx.x, n_blk = gridDim.x;
  const int my_tiles = blk < n_tiles ? (n_tiles - 1 - blk) / n_blk + 1 : 0;

  auto tile_of = [&](int s, int& b, int& oy0, int& ox0) {
    const int t = blk + s * n_blk;
    b = t / tiles_per_img;
    const int r = t - b * tiles_per_img;
    oy0 = (r / tiles_x) * TH;
    ox0 = (r % tiles_x) * TW;
  };
  auto load_halo = [&](int s) {
    int b, oy0, ox0;
    tile_of(s, b, oy0, ox0);
    stage_rows<VEC>(
        raw + (s & 1) * HALO * S, S, x, HALO, CIN, 0, CIN,
        [&](int p) { return halo2_offset(p, b, oy0, ox0, H, W, CIN); }, tid,
        C2_THREADS);
  };

  if (my_tiles > 0) load_halo(0);
  cp_async_commit();
  split_filter<COUT, CIN, true>(fh, fl, k, tid, C2_THREADS);
  if (TRAIN && tid < CIN) {
    gs[tid] = g[tid];
    bs[tid] = bv[tid];
  }

  // this thread's channels 8 j + 2 t4 + e: the eval fold, the statistics
  float gv[NT][2], bb[NT][2];
  double s1[NT][2], s2[NT][2];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int c = 8 * j + 2 * t4 + e;
      gv[j][e] = TRAIN ? 0.f : g[c];
      bb[j][e] = TRAIN ? 0.f : bv[c];
      s1[j][e] = s2[j][e] = 0.f;
    }

  // A rows: halo pixels (lanes 0-15 pixels 0-15 at k0 .. + 3, lanes 16-31
  // at k0 + 4 .. + 7); B rows: (tap, co) at k0 (lanes 0-7, 16-23) or k0 +
  // 4 (8-15, 24-31), conv3x3_tf32.cuh's K3-f fragments
  const int a_px = lane & 15, a_k = (lane >> 4) * 4;
  const int b_n = (lane & 7) + (lane >> 4) * 8, b_k = ((lane >> 3) & 1) * 4;
  const uint32_t a_lane = smem_addr(ah + (2 * warp * HC + a_px) * S + a_k);
  const uint32_t b_lane = smem_addr(fh + b_n * S + b_k);

  for (int s = 0; s < my_tiles; ++s) {
    if (s + 1 < my_tiles) load_halo(s + 1);
    cp_async_commit();
    cp_async_wait_prev();
    __syncthreads();  // tile s landed; the split planes are free
    int b, oy0, ox0;
    tile_of(s, b, oy0, ox0);
    const float* cur = raw + (s & 1) * HALO * S;
    for (int i = tid; i < HALO * Q; i += C2_THREADS) {
      const int p = i / Q, c = 4 * (i - p * Q);
      float4 v = *reinterpret_cast<const float4*>(cur + p * S + c);
      if (TRAIN && halo2_offset(p, b, oy0, ox0, H, W, 1) >= 0) {
        v.x = fmaxf(v.x * gs[c] + bs[c], 0.f);
        v.y = fmaxf(v.y * gs[c + 1] + bs[c + 1], 0.f);
        v.z = fmaxf(v.z * gs[c + 2] + bs[c + 2], 0.f);
        v.w = fmaxf(v.w * gs[c + 3] + bs[c + 3], 0.f);
      }
      split_store(ah + p * S + c, al + p * S + c, v);
    }
    __syncthreads();  // split planes ready

    float acc[2][NT][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.f;
    mma_2x2<CIN, NT, 0, 1>(acc, a_lane, HALO * S * E, b_lane,
                           4 * COUT * S * E);

#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int oy = oy0 + 2 * warp + i;
      const bool row_ok = oy < H;
      const long long pix0 = ((long long)b * H + oy) * W + ox0;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int e = q & 1;
          if (!TRAIN) {
            acc[i][j][q] = fmaxf(acc[i][j][q] * gv[j][e] + bb[j][e], 0.f);
          } else if (row_ok && ox0 + gq + 8 * (q >> 1) < W) {
            add_stat<double>(s1[j][e], s2[j][e], acc[i][j][q]);
          }
        }
        store_tile(y + off, acc[i][j], pix0, row_ok, ox0, W, ldo, 8 * j,
                   lane);
      }
    }
  }

  if (TRAIN) four_warp_partials_f64<NT>(s1, s2, stats, n_blk, blk);
}

// ---- stem2b / stem2a input gradient and the BN + ReLU chain below ---------
//
// dA[b, i, j, ca] = sum_{dy, dx in {0, 1}, ce} e[b, i - dy, j - dx, ce]
// k[dy, dx, ca, ce], e zero outside; then dpre = (dA + add) [g yin + b >
// 0] (add: a second gradient of the same activation, or none), dyin = dpre
// g, and the block's partials sum(dpre yin), sum(dpre) over its pixels
// inside the image into gpart[2][gridDim.x][CA]. Per 8 x 16 tile: M = 128
// pixels, N = CA, K = 4 x CE, over a halo of e whose origin is one row and
// one column before the tile (tap (dy, dx) of output pixel (r, c) reads
// halo pixel (r + 1 - dy, c + 1 - dx)); B = k as stored, rows (tap, ca)
// with ce contiguous. The epilogue loads yin (and add) at the lane's two
// channels (8-byte loads), all of a tile's in flight together; the tile's
// rows were prefetched into L2 with its halo.
template <int CE, int CA>
__host__ __device__ constexpr size_t dx2_smem() {
  return sizeof(float) * (size_t)(4 * HALO * (CE + 4) +
                                  2 * 4 * CA * (CE + 4));
}

template <int CE, int CA, bool ADD, bool VEC>
__global__ void __launch_bounds__(C2_THREADS)
stem2x2_dx_tf32_kernel(const float* __restrict__ e,
                       const float* __restrict__ k,
                       const float* __restrict__ yin,
                       const float* __restrict__ add,
                       const float* __restrict__ g,
                       const float* __restrict__ bv,
                       float* __restrict__ dyin, float* __restrict__ gpart,
                       int H, int W, int tiles_x, int tiles_per_img,
                       int n_tiles) {
  constexpr int S = CE + 4, NT = CA / 8, Q = CE / 4;
  static_assert(CE % 8 == 0 && CA % 16 == 0, "stem2x2_dx tiles");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* raw = reinterpret_cast<float*>(smem_raw);  // [2][HALO][S]
  float* eh = raw + 2 * HALO * S;                   // [HALO][S]
  float* el = eh + HALO * S;                        // [HALO][S]
  float* fh = el + HALO * S;                        // [4][CA][S]
  float* fl = fh + 4 * CA * S;                      // [4][CA][S]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, t4 = lane & 3;
  const int blk = blockIdx.x, n_blk = gridDim.x;
  const int my_tiles = blk < n_tiles ? (n_tiles - 1 - blk) / n_blk + 1 : 0;

  auto tile_of = [&](int s, int& b, int& oy0, int& ox0) {
    const int t = blk + s * n_blk;
    b = t / tiles_per_img;
    const int r = t - b * tiles_per_img;
    oy0 = (r / tiles_x) * TH;
    ox0 = (r % tiles_x) * TW;
  };
  auto load_tile = [&](int s) {
    int b, oy0, ox0;
    tile_of(s, b, oy0, ox0);
    stage_rows<VEC>(
        raw + (s & 1) * HALO * S, S, e, HALO, CE, 0, CE,
        [&](int p) {
          return halo2_offset(p, b, oy0 - 1, ox0 - 1, H, W, CE);
        },
        tid, C2_THREADS);
    // the tile's yin (and add) rows into L2 for the epilogue
    const int rows = min(TH, H - oy0);
    const int lines = (min(ox0 + TW, W) - ox0) * CA * E / 128;
    for (int i = tid; i < (ADD ? 2 : 1) * rows * lines; i += C2_THREADS) {
      const int which = i / (rows * lines), rl = i - which * rows * lines;
      const int r = rl / lines, l = rl - r * lines;
      const float* p = (which ? add : yin) +
                       (((long long)b * H + oy0 + r) * W + ox0) * CA + 32 * l;
      asm volatile("prefetch.global.L2 [%0];\n" ::"l"(p));
    }
  };

  if (my_tiles > 0) load_tile(0);
  cp_async_commit();
  split_filter<CA, CE, false>(fh, fl, k, tid, C2_THREADS);

  // this thread's channels 8 j + 2 t4 + e (dgamma, dbeta in f64, as the
  // forward's statistics)
  float gv[NT][2], bb[NT][2];
  double dg[NT][2], db[NT][2];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      gv[j][q] = g[8 * j + 2 * t4 + q];
      bb[j][q] = bv[8 * j + 2 * t4 + q];
      dg[j][q] = db[j][q] = 0.f;
    }

  const int a_px = lane & 15, a_k = (lane >> 4) * 4;
  const int b_n = (lane & 7) + (lane >> 4) * 8, b_k = ((lane >> 3) & 1) * 4;
  const uint32_t a_lane = smem_addr(eh + (2 * warp * HC + a_px) * S + a_k);
  const uint32_t b_lane = smem_addr(fh + b_n * S + b_k);

  for (int s = 0; s < my_tiles; ++s) {
    if (s + 1 < my_tiles) load_tile(s + 1);
    cp_async_commit();
    cp_async_wait_prev();
    __syncthreads();  // tile s landed; the split planes are free
    const float* cur = raw + (s & 1) * HALO * S;
    for (int i = tid; i < HALO * Q; i += C2_THREADS) {
      const int p = i / Q, c = 4 * (i - p * Q);
      split_store(eh + p * S + c, el + p * S + c,
                  *reinterpret_cast<const float4*>(cur + p * S + c));
    }
    __syncthreads();  // split planes ready

    float acc[2][NT][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.f;
    mma_2x2<CE, NT, 1, -1>(acc, a_lane, HALO * S * E, b_lane,
                           4 * CA * S * E);

    int b, oy0, ox0;
    tile_of(s, b, oy0, ox0);
    // yin and add at (row 2 warp + i, column gq + 8 h, channels 8 j + 2
    // t4, + 1), all loads first
    float2 yv[2][NT][2], av[2][NT][2];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int oy = oy0 + 2 * warp + i, ox = ox0 + gq + 8 * h;
          const long long o =
              (((long long)b * H + oy) * W + ox) * CA + 8 * j + 2 * t4;
          const bool ok = oy < H && ox < W;
          yv[i][j][h] = ok ? *reinterpret_cast<const float2*>(yin + o)
                           : make_float2(0.f, 0.f);
          av[i][j][h] = ADD && ok
                            ? *reinterpret_cast<const float2*>(add + o)
                            : make_float2(0.f, 0.f);
        }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int oy = oy0 + 2 * warp + i;
      const bool row_ok = oy < H;
      const long long pix0 = ((long long)b * H + oy) * W + ox0;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const bool pix_ok = row_ok && ox0 + gq + 8 * h < W;
          const float2 y2 = yv[i][j][h];
          float t0 = acc[i][j][2 * h], t1 = acc[i][j][2 * h + 1];
          if (ADD) {
            t0 += av[i][j][h].x;
            t1 += av[i][j][h].y;
          }
          const float d0 = y2.x * gv[j][0] + bb[j][0] > 0.f ? t0 : 0.f;
          const float d1 = y2.y * gv[j][1] + bb[j][1] > 0.f ? t1 : 0.f;
          acc[i][j][2 * h] = d0 * gv[j][0];
          acc[i][j][2 * h + 1] = d1 * gv[j][1];
          if (pix_ok) {
            dg[j][0] = fma((double)d0, (double)y2.x, dg[j][0]);
            db[j][0] += d0;
            dg[j][1] = fma((double)d1, (double)y2.y, dg[j][1]);
            db[j][1] += d1;
          }
        }
        store_tile(dyin, acc[i][j], pix0, row_ok, ox0, W, CA, 8 * j, lane);
      }
    }
  }

  four_warp_partials_f64<NT>(dg, db, gpart, n_blk, blk);
}

// ---- stem2b / stem2a filter gradient over the 2x2 tap range -------------
//
// dk[dy, dx, ci, co] = sum over pixels p of a[p + (dy, dx), ci] e[p, co],
// a = relu(g yin + b) (zero outside the image), e zero outside. Per tap a
// GEMM of M = CI, N = CO, K = the pixels, the pixels cut into 8 x 16 tiles
// split into n_chunks fixed strided sets. A tile's (9 x 17)-pixel halo of
// yin and its e rows land by cp.async in raw buffers (two stages); one
// pass forms a for the halo pixels inside the image and splits both into
// quads of channel pairs (front_tf32.cuh's put_quad), read by 128-bit
// loads with each fragment row standing for one channel of a pair (K3-b's
// fragments; rows of 2 C + 8 floats put an 8-lane phase in 8 bank groups).
// 8 warps: warp w takes tap w % 4 over tile rows 4 (w / 4) .. + 3 (two k8
// steps a row), CI / 16 x CO / 8 m16n8 tiles of f32 sums. Warp w's sums go
// to part[2 chunk + w / 4][tap][ci][co]; sum_chunks_tc_kernel adds the 2
// n_chunks partials in order.
template <int CI, int CO>
__host__ __device__ constexpr size_t wg2_smem() {
  return sizeof(float) * (size_t)(2 * (HALO * CI + PIX * CO) +
                                  HALO * (2 * CI + 8) + PIX * (2 * CO + 8));
}

template <int CI, int CO, bool VEC>
__global__ void __launch_bounds__(WG_THREADS)
stem2x2_wgrad_tf32_kernel(const float* __restrict__ yin,
                          const float* __restrict__ e,
                          const float* __restrict__ g,
                          const float* __restrict__ bv,
                          float* __restrict__ part, int H, int W,
                          int tiles_x, int tiles_per_img, int n_tiles,
                          int n_chunks) {
  constexpr int MT = CI / 16, NT = CO / 8;
  constexpr int XS = 2 * CI + 8, DS = 2 * CO + 8;  // split rows (floats)
  constexpr int RAW = HALO * CI + PIX * CO;         // a raw stage
  constexpr int PX = CI / 2, PD = CO / 2;           // channel pairs a row
  static_assert(CI % 16 == 0 && CO % 16 == 0, "stem2x2_wgrad tiles");
  static_assert(WG_THREADS % PX == 0 && WG_THREADS % PD == 0,
                "stem2x2_wgrad split pass");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* raw = reinterpret_cast<float*>(smem_raw);  // [2][RAW]
  float* sx = raw + 2 * RAW;                        // [HALO][XS]
  float* sd = sx + HALO * XS;                       // [PIX][DS]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tap = warp & 3, rh = warp >> 2;
  const int dy = tap >> 1, dx = tap & 1;
  const int chunk = blockIdx.x;
  const int my_tiles =
      chunk < n_tiles ? (n_tiles - 1 - chunk) / n_chunks + 1 : 0;

  auto tile_of = [&](int s, int& b, int& oy0, int& ox0) {
    const int t = chunk + s * n_chunks;
    b = t / tiles_per_img;
    const int r = t - b * tiles_per_img;
    oy0 = (r / tiles_x) * TH;
    ox0 = (r % tiles_x) * TW;
  };
  auto load_tile = [&](int s) {
    int b, oy0, ox0;
    tile_of(s, b, oy0, ox0);
    float* sb = raw + (s & 1) * RAW;
    stage_rows<VEC>(
        sb, CI, yin, HALO, CI, 0, CI,
        [&](int p) { return halo2_offset(p, b, oy0, ox0, H, W, CI); }, tid,
        WG_THREADS);
    stage_rows<VEC>(
        sb + HALO * CI, CO, e, PIX, CO, 0, CO,
        [&](int p) { return tile_offset(p, b, oy0, ox0, H, W, CO); }, tid,
        WG_THREADS);
  };

  float acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.f;

  if (my_tiles > 0) load_tile(0);
  cp_async_commit();

  // the split pass: this thread's channel pairs px, pd of every staged
  // pixel, with a's fold
  const int px = tid % PX, pd = tid % PD;
  float gx[2], bx[2];
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    gx[q] = __ldg(g + 2 * px + q);
    bx[q] = __ldg(bv + 2 * px + q);
  }
  // this lane's k = t4 of 8 pixels (k = t4 + 4 is 4 pixels on) and its
  // channel pair gq of each 16 channels
  const int gq = lane >> 2, t4 = lane & 3;
  const float* xa0 = sx + ((4 * rh + dy) * HC + dx + t4) * XS + 4 * gq;
  const float* db0 = sd + (4 * rh * TW + t4) * DS + 4 * gq;

  for (int s = 0; s < my_tiles; ++s) {
    if (s + 1 < my_tiles) load_tile(s + 1);
    cp_async_commit();
    cp_async_wait_prev();
    __syncthreads();  // tile s landed; the split buffers are free
    int b, oy0, ox0;
    tile_of(s, b, oy0, ox0);
    const float* rx = raw + (s & 1) * RAW;
    const float* rd = rx + HALO * CI;
    for (int p = tid / PX; p < HALO; p += WG_THREADS / PX) {
      float2 v = *reinterpret_cast<const float2*>(rx + p * CI + 2 * px);
      if (halo2_offset(p, b, oy0, ox0, H, W, 1) >= 0) {
        v.x = fmaxf(v.x * gx[0] + bx[0], 0.f);
        v.y = fmaxf(v.y * gx[1] + bx[1], 0.f);
      }
      put_quad(sx + p * XS + 4 * px, v.x, v.y);
    }
    for (int p = tid / PD; p < PIX; p += WG_THREADS / PD) {
      const float2 v = *reinterpret_cast<const float2*>(rd + p * CO + 2 * pd);
      put_quad(sd + p * DS + 4 * pd, v.x, v.y);
    }
    __syncthreads();  // split buffers ready

#pragma unroll 2
    for (int r = 0; r < TH / 2; ++r) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {  // one k8 step: columns 8h .. 8h + 7
        const float* xa = xa0 + (r * HC + 8 * h) * XS;
        const float* db = db0 + (r * TW + 8 * h) * DS;
        uint32_t ah[MT][4], al[MT][4];
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          const uint4 v0 = *reinterpret_cast<const uint4*>(xa + 32 * i);
          const uint4 v1 =
              *reinterpret_cast<const uint4*>(xa + 4 * XS + 32 * i);
          ah[i][0] = v0.x, ah[i][1] = v0.y, ah[i][2] = v1.x;
          ah[i][3] = v1.y;
          al[i][0] = v0.z, al[i][1] = v0.w, al[i][2] = v1.z;
          al[i][3] = v1.w;
        }
        uint32_t bh[NT][2], bl[NT][2];
#pragma unroll
        for (int jt = 0; jt < NT; ++jt) {
          const int quad = jt >> 1;
          const uint4 u0 = *reinterpret_cast<const uint4*>(db + 32 * quad);
          const uint4 u1 =
              *reinterpret_cast<const uint4*>(db + 4 * DS + 32 * quad);
          const bool odd = jt & 1;
          bh[jt][0] = odd ? u0.y : u0.x, bh[jt][1] = odd ? u1.y : u1.x;
          bl[jt][0] = odd ? u0.w : u0.z, bl[jt][1] = odd ? u1.w : u1.z;
        }
        mma_grid_3xtf32(acc, ah, al, bh, bl);
      }
    }
  }

  // this warp's partial: acc[i][jt][q] is channel pair row ci = 16 i + 2
  // gq + (q >> 1), co = 16 (jt >> 1) + 4 t4 + 2 (q & 1) + (jt & 1)
  float* pc = part + ((size_t)(2 * chunk + rh) * 4 + tap) * CI * CO;
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int jt = 0; jt < NT; ++jt)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int ci = 16 * i + 2 * gq + (q >> 1);
        const int co = 16 * (jt >> 1) + 4 * t4 + 2 * (q & 1) + (jt & 1);
        pc[ci * CO + co] = acc[i][jt][q];
      }
}

// ---- the elementwise stages, 4 channels a thread --------------------------

__device__ __forceinline__ float4 relu_fold(float4 v, float4 g, float4 b) {
  return make_float4(fmaxf(v.x * g.x + b.x, 0.f), fmaxf(v.y * g.y + b.y, 0.f),
                     fmaxf(v.z * g.z + b.z, 0.f), fmaxf(v.w * g.w + b.w, 0.f));
}

__device__ __forceinline__ float4 max4(float4 a, float4 b) {
  return make_float4(fmaxf(a.x, b.x), fmaxf(a.y, b.y), fmaxf(a.z, b.z),
                     fmaxf(a.w, b.w));
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 ldg4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

// Eval: cat[pix, c] (channel stride ldo) = the 2x2 stride-1 max (zero pad
// right/bottom) of a (B, H, W, C); an item is 4 channels of one pixel.
template <int C>
__global__ void __launch_bounds__(256)
pool2x2_f32_kernel(const float* __restrict__ a, float* __restrict__ cat,
                   int H, int W, int ldo, long long items) {
  constexpr int G = C / 4;
  for (long long i = (long long)blockIdx.x * 256 + threadIdx.x; i < items;
       i += (long long)gridDim.x * 256) {
    const int c0 = 4 * (int)(i % G);
    const long long pix = i / G;
    const int xq = (int)(pix % W), yq = (int)((pix / W) % H);
    const bool right = xq + 1 < W, below = yq + 1 < H;
    const float* p = a + pix * C + c0;
    const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
    float4 m = ld4(p);
    m = max4(m, right ? ld4(p + C) : z);
    m = max4(m, below ? ld4(p + (long long)W * C) : z);
    m = max4(m, right && below ? ld4(p + (long long)W * C + C) : z);
    *reinterpret_cast<float4*>(cat + pix * ldo + c0) = m;
  }
}

// Train: cat[.., 0:C] = the 2x2 max of a1 = relu(g1 y1 + b1), cat[..,
// C:2C] = relu(g2b y2b + b2b).
template <int C>
__global__ void __launch_bounds__(256)
assemble_train_f32_kernel(const float* __restrict__ y1,
                          const float* __restrict__ y2b,
                          const float* __restrict__ g1,
                          const float* __restrict__ b1,
                          const float* __restrict__ g2b,
                          const float* __restrict__ b2b,
                          float* __restrict__ cat, int H, int W,
                          long long items) {
  constexpr int G = C / 4;
  for (long long i = (long long)blockIdx.x * 256 + threadIdx.x; i < items;
       i += (long long)gridDim.x * 256) {
    const int c0 = 4 * (int)(i % G);
    const long long pix = i / G;
    const int xq = (int)(pix % W), yq = (int)((pix / W) % H);
    const bool right = xq + 1 < W, below = yq + 1 < H;
    const float* p = y1 + pix * C + c0;
    const float4 g = ldg4(g1 + c0), b = ldg4(b1 + c0);
    const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
    float4 m = relu_fold(ld4(p), g, b);
    m = max4(m, right ? relu_fold(ld4(p + C), g, b) : z);
    m = max4(m, below ? relu_fold(ld4(p + (long long)W * C), g, b) : z);
    m = max4(m, right && below
                    ? relu_fold(ld4(p + (long long)W * C + C), g, b)
                    : z);
    *reinterpret_cast<float4*>(cat + pix * 2 * C + c0) = m;
    *reinterpret_cast<float4*>(cat + pix * 2 * C + C + c0) =
        relu_fold(ld4(y2b + pix * C + c0), ldg4(g2b + c0), ldg4(b2b + c0));
  }
}

// K4-b (b): per (pixel, 4 channels): dy2b = dcat[.., C + c] [z2b > 0] g2b
// with the BN2b partials sum(dpre y2b), sum(dpre); da1p = the pool half
// dcat[.., c] of the (up to) four windows that hold this a1 pixel, routed
// by the maximum's gradient (a tie splits 0.5 / 0.5, the pool being max(max
// of the upper row, max of the lower row)), a1 recomputed on the 3 x 3
// neighbourhood as the forward formed it. Persistent: block i takes items
// i 256 + t, + gridDim.x 256, ..., so a thread keeps one channel group;
// partials [2][gridDim.x][C].
template <int C>
__global__ void __launch_bounds__(256)
assemble_bwd_f32_kernel(const float* __restrict__ y1,
                        const float* __restrict__ y2b,
                        const float* __restrict__ dcat,
                        const float* __restrict__ g1,
                        const float* __restrict__ b1,
                        const float* __restrict__ g2b,
                        const float* __restrict__ b2b,
                        float* __restrict__ da1p, float* __restrict__ dy2b,
                        float* __restrict__ gpart, int H, int W,
                        long long items) {
  constexpr int G = C / 4;
  static_assert(256 % G == 0 && G <= 32, "a thread keeps one channel group");
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int c0 = 4 * (tid % G);
  const float4 ga = ldg4(g1 + c0), ba = ldg4(b1 + c0);
  const float4 gb = ldg4(g2b + c0), bb = ldg4(b2b + c0);
  const float gbv[4] = {gb.x, gb.y, gb.z, gb.w};
  const float bbv[4] = {bb.x, bb.y, bb.z, bb.w};
  double dg[4], db[4];  // f64, as the forward's statistics
#pragma unroll
  for (int k = 0; k < 4; ++k) dg[k] = db[k] = 0.0;

  for (long long i = (long long)blockIdx.x * 256 + tid; i < items;
       i += (long long)gridDim.x * 256) {
    const long long pix = i / G;
    const int xq = (int)(pix % W), yq = (int)((pix / W) % H);
    const long long off = pix * C + c0;
    // the a2b half
    {
      const float4 y4 = ld4(y2b + off);
      const float4 d4 = ld4(dcat + pix * 2 * C + C + c0);
      const float yv[4] = {y4.x, y4.y, y4.z, y4.w};
      const float dc[4] = {d4.x, d4.y, d4.z, d4.w};
      float out[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float z = yv[k] * gbv[k] + bbv[k];
        const float dpre = z > 0.f ? dc[k] : 0.f;
        out[k] = dpre * gbv[k];
        dg[k] = fma((double)dpre, (double)yv[k], dg[k]);
        db[k] += dpre;
      }
      *reinterpret_cast<float4*>(dy2b + off) =
          make_float4(out[0], out[1], out[2], out[3]);
    }
    // the pool half: a1 on the 3 x 3 neighbourhood, zero outside
    float a[3][3][4];
#pragma unroll
    for (int r = 0; r < 3; ++r)
#pragma unroll
      for (int s = 0; s < 3; ++s) {
        const int yy = yq + r - 1, xx = xq + s - 1;
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (yy >= 0 && yy < H && xx >= 0 && xx < W)
          v = relu_fold(
              ld4(y1 + off + ((long long)(r - 1) * W + (s - 1)) * C), ga, ba);
        a[r][s][0] = v.x, a[r][s][1] = v.y, a[r][s][2] = v.z;
        a[r][s][3] = v.w;
      }
    // window at (yq + r - 1, xq + s - 1), r, s in {0, 1}: upper row
    // a[r][s], a[r][s+1]; lower row a[r+1][s], a[r+1][s+1]; this pixel is
    // a[1][1]
    float d[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        if (yq + r - 1 < 0 || xq + s - 1 < 0) continue;
        const float4 w4 = ld4(dcat + (pix + (long long)(r - 1) * W + (s - 1)) *
                                         2 * C + c0);
        const float dw[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const float top = fmaxf(a[r][s][k], a[r][s + 1][k]);
          const float bot = fmaxf(a[r + 1][s][k], a[r + 1][s + 1][k]);
          const float mine_row = r == 0 ? sel(bot, top) : sel(top, bot);
          const float other = a[1][s == 0 ? 0 : 2][k];
          d[k] = fmaf(dw[k], mine_row * sel(a[1][1][k], other), d[k]);
        }
      }
    *reinterpret_cast<float4*>(da1p + off) = make_float4(d[0], d[1], d[2],
                                                         d[3]);
  }

  // the block's channel sums: lanes of one channel group (lane % G) by
  // shuffles, then the warps in order
  __shared__ double red[8][2][C];
#pragma unroll
  for (int k = 0; k < 4; ++k)
#pragma unroll
    for (int o = G; o < 32; o <<= 1) {
      dg[k] += __shfl_xor_sync(0xffffffffu, dg[k], o);
      db[k] += __shfl_xor_sync(0xffffffffu, db[k], o);
    }
  if (lane < G)
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      red[warp][0][c0 + k] = dg[k];
      red[warp][1][c0 + k] = db[k];
    }
  __syncthreads();
  if (tid < 2 * C) {
    const int which = tid / C, c = tid - which * C;
    double t = 0.0;
    for (int w = 0; w < 8; ++w) t += red[w][which][c];
    gpart[((size_t)which * gridDim.x + blockIdx.x) * C + c] = (float)t;
  }
}

// ---- launchers: the wrapper's plan in, cudaGetLastError() out ------------

template <int CIN, int COUT, bool TRAIN>
inline int launch_c2(const float* x, const float* k, const float* g,
                     const float* b, float* y, float* stats, int B, int H,
                     int W, int ldo, int off, int blocks, int vec,
                     cudaStream_t st) {
  int tiles_x;
  const int per_img = tiles_of(H, W, TH, TW, tiles_x);
  auto kern = vec ? stem2x2_tf32_kernel<CIN, COUT, TRAIN, true>
                  : stem2x2_tf32_kernel<CIN, COUT, TRAIN, false>;
  constexpr size_t smem = c2_smem<CIN, COUT>();
  int err = set_smem(kern, smem);
  if (err != 0) return err;
  kern<<<blocks, C2_THREADS, smem, st>>>(x, k, g, b, y, stats, H, W, ldo, off,
                                         tiles_x, per_img, B * per_img);
  return static_cast<int>(cudaGetLastError());
}

template <int CE, int CA, bool ADD>
inline int launch_dx2(const float* e, const float* k, const float* yin,
                      const float* add, const float* g, const float* b,
                      float* dyin, float* gpart, int B, int H, int W,
                      int blocks, int vec, cudaStream_t st) {
  int tiles_x;
  const int per_img = tiles_of(H, W, TH, TW, tiles_x);
  auto kern = vec ? stem2x2_dx_tf32_kernel<CE, CA, ADD, true>
                  : stem2x2_dx_tf32_kernel<CE, CA, ADD, false>;
  constexpr size_t smem = dx2_smem<CE, CA>();
  int err = set_smem(kern, smem);
  if (err != 0) return err;
  kern<<<blocks, C2_THREADS, smem, st>>>(e, k, yin, add, g, b, dyin, gpart, H,
                                         W, tiles_x, per_img, B * per_img);
  return static_cast<int>(cudaGetLastError());
}

// dk (2, 2, CI, CO) f32 = the in-order sum of the 2 n_chunks partials in
// part
template <int CI, int CO>
inline int launch_wg2(const float* yin, const float* e, const float* g,
                      const float* b, float* part, float* dk, int B, int H,
                      int W, int n_chunks, int vec, cudaStream_t st) {
  int tiles_x;
  const int per_img = tiles_of(H, W, TH, TW, tiles_x);
  auto kern = vec ? stem2x2_wgrad_tf32_kernel<CI, CO, true>
                  : stem2x2_wgrad_tf32_kernel<CI, CO, false>;
  constexpr size_t smem = wg2_smem<CI, CO>();
  int err = set_smem(kern, smem);
  if (err != 0) return err;
  kern<<<n_chunks, WG_THREADS, smem, st>>>(yin, e, g, b, part, H, W, tiles_x,
                                           per_img, B * per_img, n_chunks);
  err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  const int n = 4 * CI * CO;
  tc::sum_chunks_tc_kernel<<<(n + 31) / 32, 256, 0, st>>>(part, 2 * n_chunks,
                                                          n, dk);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace stf
}  // namespace rodt
