// bf16 kernels of the HGNetv2 stem's 2x2 convs (stem2a, 32 -> 16, and
// stem2b, 16 -> 32; zero pad right/bottom, stride 1) and of its elementwise
// stages, for the tensor-core route of hgstem.cu (K4-f) and hgstem_bwd.cu
// (K4-b). The stride-2 convs (stem1, stem3) and their gradients run the
// kernels of front_tc.cuh; the f32 route runs the split-TF32 kernels of
// front_tf32.cuh and stem_tf32.cuh.
//
//   stem2x2_tc_kernel        y = conv2x2(x, k): an implicit GEMM over 4
//                            taps, M = 128 pixels (an 8 x 16 tile), N = Cout,
//                            K = 4 x Cin, from a (TH + 1) x (TW + 1) halo
//                            staged once for the four taps, a tap being a
//                            per-lane ldmatrix row shift (K3-f's). Eval:
//                            BN + ReLU in the epilogue; train: BN + ReLU
//                            of the layer below applied in place to the
//                            staged halo, raw y rounded to bf16 and the
//                            batch-statistics partials from the
//                            accumulator fragments.
//   stem2x2_dx_tc_kernel     dA = the transposed 2x2 conv of e (taps from
//                            pixels up and left: the halo's origin one row
//                            and column before the tile), chained through
//                            the BN + ReLU below in the epilogue with a
//                            second gradient of the same activation added
//                            (the pool's, for a1), dgamma / dbeta partials.
//   stem2x2_wgrad_tc_kernel  dk (2, 2, Cin, Cout) = sum over pixels of
//                            a (x) e over the 2x2 tap range itself (4
//                            warps = 4 taps), a = round(relu(g y + b))
//                            formed in place in the staged halo; per-chunk
//                            partials summed in a fixed order.
//   pool2x2_vec_kernel, assemble_train_vec_kernel, assemble_bwd_vec_kernel
//                            the pool / concat of eval and train mode and
//                            the concat's backward (pool routing, BN2b
//                            chain), 8 channels a thread by 16-byte loads;
//                            the same arithmetic as the f32 ones of
//                            stem_tf32.cuh.
//
// Every cross-block sum goes through per-block or per-chunk partials
// whose counts the Python plan fixes for a shape and a card
// (kernels.stem_plan, kernels.stem_bwd_plan), reduced in a fixed order: no
// atomics, identical bits run to run.
#pragma once

#include "front_tc.cuh"

namespace rodt {
namespace stc {

using ftc::act_in_place;
using ftc::set_smem;
using ftc::store_rows;
using ftc::tiles_of;
using ftc::warp_sum_g;
using tc::bf16;
using tc::cp_async_commit;
using tc::cp_async_wait_prev;
using tc::ldsm_x4;
using tc::ldsm_x4_t;
using tc::mma_bf16;
using tc::padded;
using tc::smem_addr;
using tc::stage_rows;

constexpr int TH = 8;                  // output tile rows
constexpr int TW = 16;                 // output tile columns (one m16 / k16)
constexpr int HC = TW + 1;             // halo columns
constexpr int HALO = (TH + 1) * HC;    // halo pixels, 153
constexpr int PIX = TH * TW;           // tile pixels
constexpr int C2_THREADS = 128;        // 4 warps
constexpr int E = sizeof(bf16);

// Global element offset of halo pixel p of an (H, W, C) image b whose halo
// origin is (y0, x0), or -1 outside the image.
__device__ __forceinline__ long long halo2_offset(int p, int b, int y0,
                                                  int x0, int H, int W,
                                                  int C) {
  const int gy = y0 + p / HC, gx = x0 + p % HC;
  if (gy < 0 || gy >= H || gx < 0 || gx >= W) return -1;
  return (((long long)b * H + gy) * W + gx) * C;
}

// Offset of tile pixel p (row-major TH x TW from (oy0, ox0)), or -1.
__device__ __forceinline__ long long tile_offset(int p, int b, int oy0,
                                                 int ox0, int H, int W,
                                                 int C) {
  const int oy = oy0 + p / TW, ox = ox0 + p % TW;
  if (oy >= H || ox >= W) return -1;
  return (((long long)b * H + oy) * W + ox) * C;
}

// Per-block channel partials [2][n_blk][C] of a 4-warp block whose lanes
// hold s1, s2[NT][2] for channels 8 j + 2 t4 + e: summed over the lane
// groups by shuffles, then over the warps in order. Every thread calls it.
template <int NT>
__device__ __forceinline__ void four_warp_partials(float s1[NT][2],
                                                   float s2[NT][2],
                                                   float* __restrict__ out,
                                                   int n_blk, int blk) {
  constexpr int C = 8 * NT;
  __shared__ float red[4][2][C];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  warp_sum_g<NT>(s1);
  warp_sum_g<NT>(s2);
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
    float t = 0.f;
    for (int w = 0; w < 4; ++w) t += red[w][which][c];
    out[((size_t)which * n_blk + blk) * C + c] = t;
  }
}

// ---- stem2a / stem2b forward ----------------------------------------------
//
// y[b, i, j, off + co] = sum_{dy, dx in {0, 1}, ci} x[b, i + dy, j + dx, ci]
// k[dy, dx, ci, co], x zero outside (channel stride ldo of y). Per 8 x 16
// tile: M = 128 pixels, N = COUT, K = 4 x CIN. 4 warps, warp w owns tile
// rows 2w, 2w + 1 (two m16 tiles) x COUT / 8 n8 tiles. Persistent: block i
// walks tiles i, i + gridDim.x, ...; the filter (4 x CIN x COUT) is staged
// once, the next tile's halo by cp.async during this tile's MMAs. Eval
// (g, b: this conv's BN fold): y = round(relu(g acc + b)). TRAIN (g, b: the
// fold of the BN below): x = round(relu(g x + b)) in place on the staged
// halo for the pixels inside the image, y = round(acc), and the block's
// sums and sums of squares of the rounded y of its pixels inside the image
// into stats[2][gridDim.x][COUT].
template <int CIN, int COUT>
__host__ __device__ constexpr size_t c2_smem() {
  return sizeof(bf16) * (size_t)(2 * HALO * padded(CIN) +
                                 4 * CIN * padded(COUT) +
                                 4 * 2 * TW * padded(COUT));
}

template <int CIN, int COUT, bool TRAIN, bool VEC>
__global__ void __launch_bounds__(C2_THREADS)
stem2x2_tc_kernel(const bf16* __restrict__ x, const bf16* __restrict__ k,
                  const float* __restrict__ g, const float* __restrict__ bv,
                  bf16* __restrict__ y, float* __restrict__ stats, int H,
                  int W, int ldo, int off, int tiles_x, int tiles_per_img,
                  int n_tiles) {
  constexpr int CS = padded(CIN), NPS = padded(COUT), NT = COUT / 8;
  static_assert(CIN % 16 == 0 && COUT % 16 == 0, "stem2x2 tiles");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* halo = reinterpret_cast<bf16*>(smem_raw);  // [2][HALO][CS]
  bf16* filt = halo + 2 * HALO * CS;               // [4][CIN][NPS]
  bf16* outs = filt + 4 * CIN * NPS;               // [4][2 TW][NPS]

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
        halo + (s & 1) * HALO * CS, CS, x, HALO, CIN, 0, CIN,
        [&](int p) { return halo2_offset(p, b, oy0, ox0, H, W, CIN); }, tid,
        C2_THREADS);
  };

  // filter rows (tap, ci) of k (HWIO), COUT channels each
  stage_rows<VEC>(
      filt, NPS, k, 4 * CIN, COUT, 0, COUT,
      [&](int r) -> long long { return (long long)r * COUT; }, tid,
      C2_THREADS);
  if (my_tiles > 0) load_halo(0);
  cp_async_commit();

  // this thread's channels 8 j + 2 t4 + e: the eval fold, the statistics
  float gv[NT][2], bb[NT][2], s1[NT][2], s2[NT][2];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int c = 8 * j + 2 * t4 + e;
      gv[j][e] = TRAIN ? 0.f : g[c];
      bb[j][e] = TRAIN ? 0.f : bv[c];
      s1[j][e] = s2[j][e] = 0.f;
    }

  // A rows: halo pixels (channels contiguous); B rows: (tap, ci), read
  // transposed
  const int a_px = lane & 15, a_k = (lane >> 4) * 8;
  const int b_k = (lane & 7) + ((lane >> 3) & 1) * 8, b_n = (lane >> 4) * 8;
  const uint32_t a_lane = smem_addr(halo + (2 * warp * HC + a_px) * CS + a_k);
  const uint32_t b_lane = smem_addr(filt + b_k * NPS + b_n);

  for (int s = 0; s < my_tiles; ++s) {
    if (s + 1 < my_tiles) load_halo(s + 1);
    cp_async_commit();
    cp_async_wait_prev();
    __syncthreads();
    int b, oy0, ox0;
    tile_of(s, b, oy0, ox0);
    if (TRAIN) {
      act_in_place<ACT_RELU>(
          halo + (s & 1) * HALO * CS, CS, HALO, CIN, 0, CIN, g, bv,
          [&](int p) { return halo2_offset(p, b, oy0, ox0, H, W, 1) >= 0; },
          tid, C2_THREADS);
      __syncthreads();
    }

    float acc[2][NT][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.f;
    const uint32_t a_base = a_lane + (s & 1) * HALO * CS * E;
#pragma unroll
    for (int k0 = 0; k0 < CIN; k0 += 16) {
#pragma unroll
      for (int tap = 0; tap < 4; ++tap) {
        const int dy = tap >> 1, dx = tap & 1;
        uint32_t af[2][4];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          ldsm_x4(af[i], a_base + (((i + dy) * HC + dx) * CS + k0) * E);
#pragma unroll
        for (int jj = 0; jj < NT / 2; ++jj) {
          uint32_t bq[4];
          ldsm_x4_t(bq, b_lane + ((tap * CIN + k0) * NPS + 16 * jj) * E);
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            mma_bf16(acc[i][2 * jj], af[i], bq[0], bq[1]);
            mma_bf16(acc[i][2 * jj + 1], af[i], bq[2], bq[3]);
          }
        }
      }
    }

    bf16* st = outs + warp * 2 * TW * NPS;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const bool row_ok = oy0 + 2 * warp + i < H;
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float v0 = acc[i][j][2 * h], v1 = acc[i][j][2 * h + 1];
          if (!TRAIN) {
            v0 = fmaxf(v0 * gv[j][0] + bb[j][0], 0.f);
            v1 = fmaxf(v1 * gv[j][1] + bb[j][1], 0.f);
          }
          const __nv_bfloat162 t = __floats2bfloat162_rn(v0, v1);
          *reinterpret_cast<__nv_bfloat162*>(
              st + (i * TW + gq + 8 * h) * NPS + 8 * j + 2 * t4) = t;
          if (TRAIN && row_ok && ox0 + gq + 8 * h < W) {
            const float r0 = __bfloat162float(t.x);
            const float r1 = __bfloat162float(t.y);
            s1[j][0] += r0;
            s2[j][0] = fmaf(r0, r0, s2[j][0]);
            s1[j][1] += r1;
            s2[j][1] = fmaf(r1, r1, s2[j][1]);
          }
        }
    }
    __syncwarp();
    store_rows(y, st, NPS, b, oy0 + 2 * warp, ox0, H, W, ldo, off, COUT,
               lane);
    __syncthreads();  // the halo stage and outs free for the next tile
  }

  if (TRAIN) four_warp_partials<NT>(s1, s2, stats, n_blk, blk);
}

// ---- stem2b / stem2a input gradient and the BN + ReLU chain below ---------
//
// dA[b, i, j, ca] = sum_{dy, dx in {0, 1}, ce} e[b, i - dy, j - dx, ce]
// k[dy, dx, ca, ce], e zero outside; then dpre = (dA + add) [g yin + b >
// 0] (add: a second gradient of the same activation, or none), dyin =
// round(dpre g), and the block's partials sum(dpre yin), sum(dpre) over its
// pixels inside the image into gpart[2][gridDim.x][CA]. Per 8 x 16 tile: M
// = 128 pixels, N = CA, K = 4 x CE, over a halo of e whose origin is one
// row and one column before the tile (tap (dy, dx) of output pixel (r, c)
// reads halo pixel (r + 1 - dy, c + 1 - dx)); B = k as stored, rows (tap,
// ca) with ce contiguous, read by ldmatrix without transposition (dA1's).
// yin and add of the tile's pixels are staged with the halo by cp.async;
// dyin is written over yin's staged rows and stored by 16-byte pieces.
template <int CE, int CA, bool ADD>
__host__ __device__ constexpr int dx2_stage() {
  return HALO * padded(CE) + (ADD ? 2 : 1) * PIX * padded(CA);
}

template <int CE, int CA, bool ADD>
__host__ __device__ constexpr size_t dx2_smem() {
  return sizeof(bf16) *
         (size_t)(2 * dx2_stage<CE, CA, ADD>() + 4 * CA * padded(CE));
}

template <int CE, int CA, bool ADD, bool VEC>
__global__ void __launch_bounds__(C2_THREADS)
stem2x2_dx_tc_kernel(const bf16* __restrict__ e, const bf16* __restrict__ k,
                     const bf16* __restrict__ yin,
                     const bf16* __restrict__ add,
                     const float* __restrict__ g,
                     const float* __restrict__ bv, bf16* __restrict__ dyin,
                     float* __restrict__ gpart, int H, int W, int tiles_x,
                     int tiles_per_img, int n_tiles) {
  constexpr int ES = padded(CE), YS = padded(CA), NT = CA / 8;
  constexpr int STAGE = dx2_stage<CE, CA, ADD>();
  static_assert(CE % 16 == 0 && CA % 16 == 0, "stem2x2_dx tiles");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* stage_buf = reinterpret_cast<bf16*>(smem_raw);  // [2][STAGE]
  bf16* filt = stage_buf + 2 * STAGE;                    // [4][CA][ES]
  __shared__ float gs[CA], bs[CA];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, t4 = lane & 3;
  const int blk = blockIdx.x, n_blk = gridDim.x;
  const int my_tiles = blk < n_tiles ? (n_tiles - 1 - blk) / n_blk + 1 : 0;
  if (tid < CA) {
    gs[tid] = g[tid];
    bs[tid] = bv[tid];
  }

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
    bf16* sb = stage_buf + (s & 1) * STAGE;
    stage_rows<VEC>(
        sb, ES, e, HALO, CE, 0, CE,
        [&](int p) {
          return halo2_offset(p, b, oy0 - 1, ox0 - 1, H, W, CE);
        },
        tid, C2_THREADS);
    auto pix = [&](int p) { return tile_offset(p, b, oy0, ox0, H, W, CA); };
    stage_rows<VEC>(sb + HALO * ES, YS, yin, PIX, CA, 0, CA, pix, tid,
                    C2_THREADS);
    if (ADD)
      stage_rows<VEC>(sb + HALO * ES + PIX * YS, YS, add, PIX, CA, 0, CA,
                      pix, tid, C2_THREADS);
  };

  // filter rows (tap, ca) of k (HWIO: (2, 2, CA, CE)), CE channels each
  stage_rows<VEC>(
      filt, ES, k, 4 * CA, CE, 0, CE,
      [&](int r) -> long long { return (long long)r * CE; }, tid,
      C2_THREADS);
  if (my_tiles > 0) load_tile(0);
  cp_async_commit();

  float dg[NT][2], db[NT][2];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int q = 0; q < 2; ++q) dg[j][q] = db[j][q] = 0.f;

  // A rows: halo pixels (ce contiguous); B rows: (tap, ca), ce contiguous
  const int a_px = lane & 15, a_k = (lane >> 4) * 8;
  const int b_n = (lane & 7) + (lane >> 4) * 8, b_k = ((lane >> 3) & 1) * 8;
  const uint32_t a_lane =
      smem_addr(stage_buf + (2 * warp * HC + a_px) * ES + a_k);
  const uint32_t b_lane = smem_addr(filt + b_n * ES + b_k);

  for (int s = 0; s < my_tiles; ++s) {
    if (s + 1 < my_tiles) load_tile(s + 1);
    cp_async_commit();
    cp_async_wait_prev();
    __syncthreads();

    float acc[2][NT][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.f;
    const uint32_t a_base = a_lane + (s & 1) * STAGE * E;
#pragma unroll
    for (int k0 = 0; k0 < CE; k0 += 16) {
#pragma unroll
      for (int tap = 0; tap < 4; ++tap) {
        const int dy = tap >> 1, dx = tap & 1;
        uint32_t af[2][4];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          ldsm_x4(af[i],
                  a_base + (((i + 1 - dy) * HC + 1 - dx) * ES + k0) * E);
#pragma unroll
        for (int jj = 0; jj < NT / 2; ++jj) {
          uint32_t bq[4];
          ldsm_x4(bq, b_lane + ((tap * CA + 16 * jj) * ES + k0) * E);
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            mma_bf16(acc[i][2 * jj], af[i], bq[0], bq[1]);
            mma_bf16(acc[i][2 * jj + 1], af[i], bq[2], bq[3]);
          }
        }
      }
    }

    int b, oy0, ox0;
    tile_of(s, b, oy0, ox0);
    bf16* yrow = stage_buf + (s & 1) * STAGE + HALO * ES;  // [PIX][YS]
    const bf16* arow = yrow + PIX * YS;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const bool row_ok = oy0 + 2 * warp + i < H;
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int p = (2 * warp + i) * TW + gq + 8 * h;
          const int c = 8 * j + 2 * t4;
          const bool pix_ok = row_ok && ox0 + gq + 8 * h < W;
          __nv_bfloat162* yp =
              reinterpret_cast<__nv_bfloat162*>(yrow + p * YS + c);
          const float2 yv = __bfloat1622float2(*yp);
          float2 tot = make_float2(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
          if (ADD) {
            const float2 av = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(arow + p * YS + c));
            tot.x += av.x;
            tot.y += av.y;
          }
          const float d0 = yv.x * gs[c] + bs[c] > 0.f ? tot.x : 0.f;
          const float d1 = yv.y * gs[c + 1] + bs[c + 1] > 0.f ? tot.y : 0.f;
          *yp = __floats2bfloat162_rn(d0 * gs[c], d1 * gs[c + 1]);
          if (pix_ok) {
            dg[j][0] = fmaf(d0, yv.x, dg[j][0]);
            db[j][0] += d0;
            dg[j][1] = fmaf(d1, yv.y, dg[j][1]);
            db[j][1] += d1;
          }
        }
    }
    __syncwarp();
    store_rows(dyin, yrow + 2 * warp * TW * YS, YS, b, oy0 + 2 * warp, ox0,
               H, W, CA, 0, CA, lane);
    __syncthreads();  // the stage buffer free for the next copies
  }

  four_warp_partials<NT>(dg, db, gpart, n_blk, blk);
}

// ---- stem2b / stem2a filter gradient over the 2x2 tap range -------------
//
// dk[dy, dx, ci, co] = sum over pixels p of a[p + (dy, dx), ci] e[p, co],
// a = round(relu(g yin + b)) (zero outside the image), e zero outside. Per
// tap a GEMM of M = CI, N = CO, K = the pixels: 4 warps, warp = tap, each
// holding CI / 16 x CO / 8 m16n8 tiles of f32 sums. The pixels are cut into
// 8 x 16 tiles (k16 = one tile row) split into n_chunks fixed strided sets;
// a tile stages its (9 x 17)-pixel halo of yin and its e rows by cp.async
// and forms a in place for the pixels inside the image. A = a^T through
// ldmatrix.trans (rows: the tap-shifted halo pixels), B = e through
// ldmatrix.trans (K3-b's fragments). Each block writes its partial to
// part[chunk][tap][ci][co]; sum_chunks_tc_kernel adds them in order.
template <int CI, int CO>
__host__ __device__ constexpr int wg2_stage() {
  return HALO * padded(CI) + PIX * padded(CO);
}

template <int CI, int CO>
__host__ __device__ constexpr size_t wg2_smem() {
  return sizeof(bf16) * 2 * (size_t)wg2_stage<CI, CO>();
}

template <int CI, int CO, bool VEC>
__global__ void __launch_bounds__(C2_THREADS)
stem2x2_wgrad_tc_kernel(const bf16* __restrict__ yin,
                        const bf16* __restrict__ e,
                        const float* __restrict__ g,
                        const float* __restrict__ bv,
                        float* __restrict__ part, int H, int W, int tiles_x,
                        int tiles_per_img, int n_tiles, int n_chunks) {
  constexpr int MT = CI / 16, NT = CO / 8;
  constexpr int AS = padded(CI), BS = padded(CO);
  constexpr int STAGE = wg2_stage<CI, CO>();
  static_assert(CI % 16 == 0 && CO % 16 == 0, "stem2x2_wgrad tiles");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* stage_buf = reinterpret_cast<bf16*>(smem_raw);  // [2][STAGE]

  const int tid = threadIdx.x, lane = tid & 31, tap = tid >> 5;
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
    bf16* sb = stage_buf + (s & 1) * STAGE;
    stage_rows<VEC>(
        sb, AS, yin, HALO, CI, 0, CI,
        [&](int p) { return halo2_offset(p, b, oy0, ox0, H, W, CI); }, tid,
        C2_THREADS);
    stage_rows<VEC>(
        sb + HALO * AS, BS, e, PIX, CO, 0, CO,
        [&](int p) { return tile_offset(p, b, oy0, ox0, H, W, CO); }, tid,
        C2_THREADS);
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

  const int a_px = (lane & 7) + (lane >> 4) * 8, a_m = ((lane >> 3) & 1) * 8;
  const int b_px = (lane & 7) + ((lane >> 3) & 1) * 8, b_n = (lane >> 4) * 8;
  const uint32_t a_lane =
      smem_addr(stage_buf + (dy * HC + dx + a_px) * AS + a_m);
  const uint32_t b_lane =
      smem_addr(stage_buf + HALO * AS + b_px * BS + b_n);

  for (int s = 0; s < my_tiles; ++s) {
    if (s + 1 < my_tiles) load_tile(s + 1);
    cp_async_commit();
    cp_async_wait_prev();
    __syncthreads();
    int b, oy0, ox0;
    tile_of(s, b, oy0, ox0);
    act_in_place<ACT_RELU>(
        stage_buf + (s & 1) * STAGE, AS, HALO, CI, 0, CI, g, bv,
        [&](int p) { return halo2_offset(p, b, oy0, ox0, H, W, 1) >= 0; },
        tid, C2_THREADS);
    __syncthreads();

    const uint32_t off = (s & 1) * STAGE * E;
#pragma unroll 2
    for (int r = 0; r < TH; ++r) {  // one k16 step: a tile row of pixels
      uint32_t a[MT][4];
#pragma unroll
      for (int i = 0; i < MT; ++i)
        ldsm_x4_t(a[i], a_lane + off + (r * HC * AS + 16 * i) * E);
#pragma unroll
      for (int jj = 0; jj < NT / 2; ++jj) {
        uint32_t bq[4];
        ldsm_x4_t(bq, b_lane + off + (r * TW * BS + 16 * jj) * E);
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          mma_bf16(acc[i][2 * jj], a[i], bq[0], bq[1]);
          mma_bf16(acc[i][2 * jj + 1], a[i], bq[2], bq[3]);
        }
      }
    }
    __syncthreads();  // stage buffer free for the next copies
  }

  const int gq = lane >> 2, t4 = lane & 3;
  float* pc = part + ((size_t)chunk * 4 + tap) * CI * CO;
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q)
        pc[(16 * i + gq + (q >> 1) * 8) * CO + 8 * j + 2 * t4 + (q & 1)] =
            acc[i][j][q];
}

// ---- the elementwise stages, 8 channels a thread --------------------------

struct V8 {
  float v[8];
};

__device__ __forceinline__ V8 load8(const bf16* p) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const bf16* h = reinterpret_cast<const bf16*>(&u);
  V8 r;
#pragma unroll
  for (int k = 0; k < 8; ++k) r.v[k] = __bfloat162float(h[k]);
  return r;
}

__device__ __forceinline__ void store8(bf16* p, const float* v) {
  uint4 u;
  bf16* h = reinterpret_cast<bf16*>(&u);
#pragma unroll
  for (int k = 0; k < 8; ++k) h[k] = __float2bfloat16(v[k]);
  *reinterpret_cast<uint4*>(p) = u;
}

// Eval: cat[pix, c] (channel stride ldo) = the 2x2 stride-1 max (zero pad
// right/bottom) of a (B, H, W, C); an item is 8 channels of one pixel.
template <int C>
__global__ void __launch_bounds__(256)
pool2x2_vec_kernel(const bf16* __restrict__ a, bf16* __restrict__ cat,
                   int H, int W, int ldo, long long items) {
  constexpr int G = C / 8;
  for (long long i = (long long)blockIdx.x * 256 + threadIdx.x; i < items;
       i += (long long)gridDim.x * 256) {
    const int c0 = 8 * (int)(i % G);
    const long long pix = i / G;
    const int xq = (int)(pix % W), yq = (int)((pix / W) % H);
    const bool right = xq + 1 < W, below = yq + 1 < H;
    const bf16* p = a + pix * C + c0;
    V8 m = load8(p);
#pragma unroll
    for (int q = 1; q < 4; ++q) {
      const bool in = (q & 1 ? right : true) && (q & 2 ? below : true);
      if (in) {
        const V8 o = load8(p + ((q & 2) ? (long long)W * C : 0) +
                           ((q & 1) ? C : 0));
#pragma unroll
        for (int k = 0; k < 8; ++k) m.v[k] = fmaxf(m.v[k], o.v[k]);
      } else {
#pragma unroll
        for (int k = 0; k < 8; ++k) m.v[k] = fmaxf(m.v[k], 0.f);
      }
    }
    store8(cat + pix * ldo + c0, m.v);
  }
}

// Train: cat[.., 0:C] = the 2x2 max of a1 = round(relu(g1 y1 + b1)),
// cat[.., C:2C] = round(relu(g2b y2b + b2b)).
template <int C>
__global__ void __launch_bounds__(256)
assemble_train_vec_kernel(const bf16* __restrict__ y1,
                          const bf16* __restrict__ y2b,
                          const float* __restrict__ g1,
                          const float* __restrict__ b1,
                          const float* __restrict__ g2b,
                          const float* __restrict__ b2b,
                          bf16* __restrict__ cat, int H, int W,
                          long long items) {
  constexpr int G = C / 8;
  for (long long i = (long long)blockIdx.x * 256 + threadIdx.x; i < items;
       i += (long long)gridDim.x * 256) {
    const int c0 = 8 * (int)(i % G);
    const long long pix = i / G;
    const int xq = (int)(pix % W), yq = (int)((pix / W) % H);
    const bool right = xq + 1 < W, below = yq + 1 < H;
    const bf16* p = y1 + pix * C + c0;
    float m[8];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const bool in = (q & 1 ? right : true) && (q & 2 ? below : true);
      V8 o;
      if (in)
        o = load8(p + ((q & 2) ? (long long)W * C : 0) + ((q & 1) ? C : 0));
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const float v = in ? round_to<bf16>(fmaxf(
                                 o.v[k] * g1[c0 + k] + b1[c0 + k], 0.f))
                           : 0.f;
        m[k] = q == 0 ? v : fmaxf(m[k], v);
      }
    }
    store8(cat + pix * 2 * C + c0, m);
    const V8 z = load8(y2b + pix * C + c0);
    float a2[8];
#pragma unroll
    for (int k = 0; k < 8; ++k)
      a2[k] = fmaxf(z.v[k] * g2b[c0 + k] + b2b[c0 + k], 0.f);
    store8(cat + pix * 2 * C + C + c0, a2);
  }
}

// maximum-VJP weight of u against v: 1 if u > v, 0.5 at a tie, else 0
__device__ __forceinline__ float sel(float u, float v) {
  return u > v ? 1.f : (u == v ? 0.5f : 0.f);
}

// K4-b (b): per (pixel, 8 channels): dy2b = dcat[.., C + c] [z2b > 0] g2b
// with the BN2b partials sum(dpre y2b), sum(dpre); da1p = the pool half
// dcat[.., c] of the (up to) four windows that hold this a1 pixel, routed
// by the maximum's gradient (hgstem_bwd.cu's assemble_bwd_kernel).
// Persistent: block i takes items i 256 + t, + gridDim.x 256, ..., so a
// thread keeps one channel group; partials [2][gridDim.x][C].
template <int C>
__global__ void __launch_bounds__(256)
assemble_bwd_vec_kernel(const bf16* __restrict__ y1,
                        const bf16* __restrict__ y2b,
                        const bf16* __restrict__ dcat,
                        const float* __restrict__ g1,
                        const float* __restrict__ b1,
                        const float* __restrict__ g2b,
                        const float* __restrict__ b2b,
                        bf16* __restrict__ da1p, bf16* __restrict__ dy2b,
                        float* __restrict__ gpart, int H, int W,
                        long long items) {
  constexpr int G = C / 8;
  static_assert(256 % G == 0, "a thread keeps one channel group");
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int c0 = 8 * (tid % G);
  float dg[8], db[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) dg[k] = db[k] = 0.f;

  for (long long i = (long long)blockIdx.x * 256 + tid; i < items;
       i += (long long)gridDim.x * 256) {
    const long long pix = i / G;
    const int xq = (int)(pix % W), yq = (int)((pix / W) % H);
    const long long off = pix * C + c0;
    // the a2b half
    {
      const V8 yv = load8(y2b + off);
      const V8 dc = load8(dcat + pix * 2 * C + C + c0);
      float out[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const float z = yv.v[k] * g2b[c0 + k] + b2b[c0 + k];
        const float dpre = z > 0.f ? dc.v[k] : 0.f;
        out[k] = dpre * g2b[c0 + k];
        dg[k] = fmaf(dpre, yv.v[k], dg[k]);
        db[k] += dpre;
      }
      store8(dy2b + off, out);
    }
    // the pool half: a1 on the 3 x 3 neighbourhood, zero outside
    float a[3][3][8];
#pragma unroll
    for (int r = 0; r < 3; ++r)
#pragma unroll
      for (int s = 0; s < 3; ++s) {
        const int yy = yq + r - 1, xx = xq + s - 1;
        const bool in = yy >= 0 && yy < H && xx >= 0 && xx < W;
        V8 o;
        if (in) o = load8(y1 + off + ((long long)(r - 1) * W + (s - 1)) * C);
#pragma unroll
        for (int k = 0; k < 8; ++k)
          a[r][s][k] = in ? round_to<bf16>(fmaxf(
                                o.v[k] * g1[c0 + k] + b1[c0 + k], 0.f))
                          : 0.f;
      }
    // window at (yq + r - 1, xq + s - 1), r, s in {0, 1}: upper row
    // a[r][s], a[r][s+1]; lower row a[r+1][s], a[r+1][s+1]; this pixel is
    // a[1][1]
    float d[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) d[k] = 0.f;
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        if (yq + r - 1 < 0 || xq + s - 1 < 0) continue;
        const V8 dw = load8(dcat + (pix + (long long)(r - 1) * W + (s - 1)) *
                                       2 * C + c0);
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const float top = fmaxf(a[r][s][k], a[r][s + 1][k]);
          const float bot = fmaxf(a[r + 1][s][k], a[r + 1][s + 1][k]);
          const float mine_row = r == 0 ? sel(bot, top) : sel(top, bot);
          const float other = a[1][s == 0 ? 0 : 2][k];
          d[k] = fmaf(dw.v[k], mine_row * sel(a[1][1][k], other), d[k]);
        }
      }
    store8(da1p + off, d);
  }

  // the block's channel sums: lanes of one channel group (lane % G) by
  // shuffles, then the warps in order
  __shared__ float red[8][2][C];
#pragma unroll
  for (int k = 0; k < 8; ++k)
#pragma unroll
    for (int o = G; o < 32; o <<= 1) {
      dg[k] += __shfl_xor_sync(0xffffffffu, dg[k], o);
      db[k] += __shfl_xor_sync(0xffffffffu, db[k], o);
    }
  if (lane < G)
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      red[warp][0][c0 + k] = dg[k];
      red[warp][1][c0 + k] = db[k];
    }
  __syncthreads();
  if (tid < 2 * C) {
    const int which = tid / C, c = tid - which * C;
    float t = 0.f;
    for (int w = 0; w < 8; ++w) t += red[w][which][c];
    gpart[((size_t)which * gridDim.x + blockIdx.x) * C + c] = t;
  }
}

// ---- launchers: the wrapper's plan in, cudaGetLastError() out ------------

template <int CIN, int COUT, bool TRAIN>
inline int launch_c2(const bf16* x, const bf16* k, const float* g,
                     const float* b, bf16* y, float* stats, int B, int H,
                     int W, int ldo, int off, int blocks, int vec,
                     cudaStream_t st) {
  int tiles_x;
  const int per_img = tiles_of(H, W, TH, TW, tiles_x);
  auto kern = vec ? stem2x2_tc_kernel<CIN, COUT, TRAIN, true>
                  : stem2x2_tc_kernel<CIN, COUT, TRAIN, false>;
  constexpr size_t smem = c2_smem<CIN, COUT>();
  int err = set_smem(kern, smem);
  if (err != 0) return err;
  kern<<<blocks, C2_THREADS, smem, st>>>(x, k, g, b, y, stats, H, W, ldo, off,
                                         tiles_x, per_img, B * per_img);
  return static_cast<int>(cudaGetLastError());
}

template <int CE, int CA, bool ADD>
inline int launch_dx2(const bf16* e, const bf16* k, const bf16* yin,
                      const bf16* add, const float* g, const float* b,
                      bf16* dyin, float* gpart, int B, int H, int W,
                      int blocks, int vec, cudaStream_t st) {
  int tiles_x;
  const int per_img = tiles_of(H, W, TH, TW, tiles_x);
  auto kern = vec ? stem2x2_dx_tc_kernel<CE, CA, ADD, true>
                  : stem2x2_dx_tc_kernel<CE, CA, ADD, false>;
  constexpr size_t smem = dx2_smem<CE, CA, ADD>();
  int err = set_smem(kern, smem);
  if (err != 0) return err;
  kern<<<blocks, C2_THREADS, smem, st>>>(e, k, yin, add, g, b, dyin, gpart, H,
                                         W, tiles_x, per_img, B * per_img);
  return static_cast<int>(cudaGetLastError());
}

// dk (2, 2, CI, CO) f32 = the in-order sum of n_chunks partials in part
template <int CI, int CO>
inline int launch_wg2(const bf16* yin, const bf16* e, const float* g,
                      const float* b, float* part, float* dk, int B, int H,
                      int W, int n_chunks, int vec, cudaStream_t st) {
  int tiles_x;
  const int per_img = tiles_of(H, W, TH, TW, tiles_x);
  auto kern = vec ? stem2x2_wgrad_tc_kernel<CI, CO, true>
                  : stem2x2_wgrad_tc_kernel<CI, CO, false>;
  constexpr size_t smem = wg2_smem<CI, CO>();
  int err = set_smem(kern, smem);
  if (err != 0) return err;
  kern<<<n_chunks, C2_THREADS, smem, st>>>(yin, e, g, b, part, H, W, tiles_x,
                                           per_img, B * per_img, n_chunks);
  err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  const int n = 4 * CI * CO;
  tc::sum_chunks_tc_kernel<<<(n + 31) / 32, 256, 0, st>>>(part, n_chunks, n,
                                                          dk);
  return static_cast<int>(cudaGetLastError());
}

inline unsigned elementwise_blocks(long long items) {
  const long long b = (items + 255) / 256;
  return static_cast<unsigned>(b < (1 << 20) ? b : (1 << 20));
}

}  // namespace stc
}  // namespace rodt
