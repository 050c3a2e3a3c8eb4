// f32 kernels of the YOLOv8 P1/P2 front (K2-f, K2-b) and of the stride-2
// convs of the HGNetv2 stem (K4-f, K4-b) on the tensor cores in split
// ("3x") TF32: implicit GEMMs on mma.sync.m16n8k8.tf32, NHWC in, f32 out,
// with the split, the MMA grid and the fragment rules of conv3x3_tf32.cuh
// (hi = tf32(a), lo = tf32(a - hi); lo*hi, hi*lo, hi*hi into one f32
// accumulator; the non-finite guard) and the stride-2 geometry of
// front_tc.cuh (column-parity planes, halo_offset, the parity classes of
// dA1). Used by yolo_front.cu, yolo_front_bwd.cu, hgstem.cu and
// hgstem_bwd.cu for f32; bf16 runs front_tc.cuh's m16n8k16 kernels. As
// there, the channel tiles, the activation (SiLU for the front, ReLU for
// the stem) and the input transforms are template parameters, and the
// launchers default to the front's instantiation (whose code they keep).
// The stem runs P1 as stem1 (3 -> 32), P2 as stem3 (64 -> 32, no
// transform), dA1 as d(cat) (no chain), dk2 as dk3 (no transform) and dk1
// at 32 channels.
//
//   front_p1_tf32_kernel   P1: conv3x3/2, 3 -> C1, K = 27 taps x channels
//                          (padded to 32, four k8 steps) from an im2col
//                          tile split once into hi / lo as it is built; the
//                          filter split once a block. Eval: BN1 + SiLU
//                          epilogue; train: BN1 statistics partials.
//   front_p2_tf32_kernel   P2: conv3x3/2, C1 -> C2 on a stride-2 halo
//                          staged 8 input channels a stage, the filter
//                          whole in shared memory; train: a1 = silu(g1 y1
//                          + b1) in place on each staged stage, BN2
//                          partials.
//   e2_prep_f32_kernel     e2 = dy2 + ds2 + 2 y2 dss2, once, for dA1 and
//                          dk2.
//   front_da1_tf32_kernel  dA1: the four parity classes of the y1 pixel
//                          as stride-1 GEMMs over one staged e2 patch, 32
//                          e2 channels a stage; the BN1 + SiLU chain and
//                          dgamma / dbeta partials in the epilogue.
//   front_dk2_tf32_kernel  dk2 = sum a1 (x) e2 at stride 2: K3-b's f32
//                          scheme (18 warps, split once into shared memory)
//                          with a1 formed from y1 in the same pass.
//   front_dk1_tf32_kernel  dk1 = sum im2col(x) (x) e1, e1 = dy1 + ds1 + 2
//                          y1 dss1 formed and split in one pass.
//
// What bounds them on an H100 at (16, 1024, 1024, 3) -> 48 -> 96: P2, dA1
// and dk2 each do 87 GFLOP, 261 GFLOP of TF32 MMAs (0.53 ms at 495
// TFLOP/s dense; mma.sync reaches about 319, 0.82 ms); P1 and dk1 11 GFLOP
// (35 of TF32 with K padded to 32) against 1.0 GB (x read, y1 written) and
// 1.8 GB (x, y1, dy1 read): bytes. The split costs 8 CUDA-core
// instructions a value; where one warp alone reads an operand (P1's and
// P2's A, dA1's), it is split in registers after ldmatrix, as K3-f does;
// where every warp reads every staged value (dk2, dk1) it is split once
// into shared memory, as K3-b does; the filters of P1 are split once a
// block.
//
// Shared memory (f32 doubles every staged byte of the bf16 kernels):
//   * P2 (48 -> 96, 8 x 16 outputs). Three layouts were weighed, at batch
//     16 (8192 tiles, y1 805 MB): (a) two 48-channel output slices, each
//     with one 120 KB halo stage and a 90 KB filter slice: y1 read twice
//     (+805 MB, 0.24 ms) and no room for a second stage, so no copy
//     overlaps the MMAs; (b) 16-channel stages with the filter slice of
//     those channels re-staged each stage (2 x 46 + 69 KB): 1.4 GB of
//     filter reads from L2 a call, copied while no MMA runs; (c) 4-row
//     tiles (64 KB a stage): the whole filter (166 KB) does not fit beside
//     two. Taken: (b) with the filter staged once, whole (9 x 96 x 48 f32,
//     166 KB, rows unpadded and swizzled), and the halo in 8-channel
//     stages of 27.7 KB (rows padded to 3 units), two of them: 221 KB, one
//     block an SM. y1 is read once and the filter once a block; a tile
//     takes 6 stages of 9 taps x 36 MMAs a warp between barriers, each warp
//     K3-f's 2 x 6 tile grid.
//   * dA1: the filter is [tap][c1][c2] as stored (c2 contiguous: B read by
//     plain ldmatrix), 96 c2 a group, swizzled (166 KB, staged once when
//     C2 <= 96); the e2 patch in 32-channel stages (22 KB, two).
//   * dk2: raw y1 halo and e2 (71 KB) beside their split quads (154 KB):
//     225 KB, one block of 18 warps an SM. dk1: two raw stages (112 KB)
//     beside the split tiles (90 KB), 202 KB.
//   * K4's widths (32 output channels, 64 -> 32) are smaller, and each
//     kernel takes its own tiles rather than masking MMA columns of K2's:
//     stem1's P1 at 4 n8 tiles (60 KB, three blocks an SM); stem3's P2 at
//     32 output channels with the whole 64-channel filter (74 KB) and two
//     16-channel halo stages (46 KB each), 166 KB: a stage holds twice the
//     MMAs of an 8-channel one between its barriers (the filter beside
//     three stages, or two blocks an SM, would need 212 or 258 KB);
//     d(cat)'s dA1 at 32 e3 channels a stage and a filter group, 32 concat
//     channels a block (two slices): 81 KB, two blocks an SM, so one
//     block's copies and epilogue run under the other's MMAs; dk3's dk2 at
//     32 x 32 channels (the quads of 64 concat channels would take 252 KB),
//     154 KB; dk1 at 32 channels, 154 KB.
//
// The train transform a1 = silu(g1 y1 + b1) is applied where each value is
// staged once: in place on P2's 8-channel stage (one pass over 4.6 K
// values a stage, its barrier beside the stage's own), and in dk2's split
// pass (transform, then split). Nothing is rounded in f32.
//
// Every cross-block sum goes through per-block or per-chunk partials
// summed in a fixed order (no atomics), as in front_tc.cuh.
#pragma once

#include "conv3x3_tf32.cuh"
#include "front_tc.cuh"

namespace rodt {
namespace ftf {

using ftc::act_fast;
using ftc::act_grad;
using ftc::DK_HALO;
using ftc::DK_TH;
using ftc::DU;
using ftc::DV;
using ftc::HALO2;
using ftc::halo_offset;
using ftc::HROW;
using ftc::PATCH;
using ftc::PC;
using ftc::PL;
using ftc::set_smem;
using ftc::TH;
using ftc::tiles_of;
using ftc::TW;
using ftc::warp_sum_g;
using ftc::XROWS;
using tc::cp_async16;
using tc::cp_async_commit;
using tc::cp_async_wait_prev;
using tc::ldsm_x4;
using tc::smem_addr;
using tc::stage_rows;
using tc32::cp_async_wait_all;
using tc32::mma_grid_3xtf32;
using tc32::split4;
using tc32::split_tf32;

// products a forward (P1, P2) accumulates: the last FWD_PASSES of lo*hi,
// hi*lo, hi*hi
constexpr int FWD_PASSES = 3;

__device__ __forceinline__ void ldsm_x2(uint32_t r[2], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(addr));
}

// s += v, ss += v v in the statistics' sum type: f32 (K2's P1 and P2: one
// FFMA) or f64 (K4's: a persistent block's thread adds a value of each of
// its tiles, and the batch statistics' cotangents amplify the rounding of
// a long f32 chain; the per-block partial is rounded to f32 once)
template <typename SUM>
__device__ __forceinline__ void add_stat(SUM& s, SUM& ss, float v) {
  if constexpr (std::is_same<SUM, float>::value) {
    s += v;
    ss = fmaf(v, v, ss);
  } else {
    s += (double)v;
    ss = fma((double)v, (double)v, ss);
  }
}

// warp_sum_g in either sum type
template <int NT, typename SUM>
__device__ __forceinline__ void warp_sum_s(SUM s[NT][2]) {
  if constexpr (std::is_same<SUM, float>::value) {
    warp_sum_g<NT>(s);
  } else {
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e)
#pragma unroll
        for (int off = 4; off < 32; off <<= 1)
          s[j][e] += __shfl_xor_sync(0xffffffffu, s[j][e], off);
  }
}

// The channel pair (a, b) split into one 16-byte quad (hi a, hi b, lo a,
// lo b): the shared layout that dk2 and dk1 read with 128-bit loads
// (conv3x3_tf32.cuh, K3-b).
__device__ __forceinline__ void put_quad(float* dst, float a, float b) {
  uint32_t h0, l0, h1, l1;
  split_tf32(a, h0, l0);
  split_tf32(b, h1, l1);
  *reinterpret_cast<uint4*>(dst) = make_uint4(h0, h1, l0, l1);
}

// Float offset of channel c in row `row` of a swizzled filter with rows of
// 48 floats (12 16-byte units): unit c / 4 XOR (row / 2) % 4, so that the
// 8 rows an ldmatrix phase reads (8 consecutive rows at one unit) fall in 8
// different bank groups (rows 12 units apart alternate between two).
__device__ __forceinline__ int swz48(int row, int c) {
  return row * 48 + ((((c >> 2) ^ ((row >> 1) & 3))) << 2) + (c & 3);
}

// The same for rows of N floats, N / 4 units a multiple of 8 (96: K2's
// dA1 filter; 64 and 32: K4's stem3 and d(cat) filters): unit c / 4 XOR
// row % 8.
template <int N>
__device__ __forceinline__ int swz_rows(int row, int c) {
  static_assert(N % 32 == 0, "swz_rows: 8 units a group");
  return row * N + ((((c >> 2) ^ (row & 7))) << 2) + (c & 3);
}

// A filter row of N floats swizzled by whichever of the two fits N
template <int N>
__device__ __forceinline__ int swz_filter(int row, int c) {
  if constexpr (N == 48)
    return swz48(row, c);
  else
    return swz_rows<N>(row, c);
}

// Stores the m16n8 f32 accumulator tile c (rows: the pixels g and g + 8
// from pixel index pix0, an output row of ox0 .. ox0 + 15; columns:
// channels c0 + 2 t4, + 1) to y (., C). C a multiple of 4: lanes t4 = 2m
// and 2m + 1 swap half a fragment (one shuffle pair), so that each stores
// 4 channels of one pixel as one 16-byte piece; element stores otherwise.
// Every lane of the warp calls it.
__device__ __forceinline__ void store_tile(float* __restrict__ y,
                                           const float c[4], long long pix0,
                                           bool row_ok, int ox0, int Wo,
                                           int C, int c0, int lane) {
  const int g = lane >> 2, t4 = lane & 3;
  if (C % 4 == 0) {
    const bool odd = t4 & 1;
    const float s0 = odd ? c[0] : c[2], s1 = odd ? c[1] : c[3];
    const float r0 = __shfl_xor_sync(0xffffffffu, s0, 1);
    const float r1 = __shfl_xor_sync(0xffffffffu, s1, 1);
    const float4 v = odd ? make_float4(r0, r1, c[2], c[3])
                         : make_float4(c[0], c[1], r0, r1);
    const int px = g + (odd ? 8 : 0), n = c0 + 4 * (t4 >> 1);
    if (row_ok && ox0 + px < Wo && n < C)
      *reinterpret_cast<float4*>(y + (pix0 + px) * C + n) = v;
  } else {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int px = g + 8 * (q >> 1), n = c0 + 2 * t4 + (q & 1);
      if (row_ok && ox0 + px < Wo && n < C) y[(pix0 + px) * C + n] = c[q];
    }
  }
}

// ---- x rows and the im2col tile of P1 and dk1 ----------------------------
//
// A tile stages, for each of its 2 TH + 1 input rows, the x elements from
// 4 before its first input column's, (6 ox0 - 4), in 25 16-byte pieces
// (pieces outside the row are zero: VEC needs W a multiple of 4, so a
// piece never straddles two rows); halo column c, channel ci is element
// 3 c + ci + 1 of the staged row. The im2col row of output pixel p is its
// 27 inputs in the HWIO filter's row order (tap-major, channel-minor),
// zero padded to 32.
constexpr int XRF = 100;           // staged x floats a row (25 pieces)
constexpr int KC1 = 32;            // 27 taps x channels, padded

template <bool VEC>
__device__ __forceinline__ void stage_x_rows(float* xs,
                                             const float* __restrict__ x,
                                             int b, int oy0, int ox0, int H,
                                             int W, int tid, int nthreads) {
  const long long W3 = 3LL * W;
  const long long a = 6LL * ox0 - 4;
  if (VEC) {
    constexpr int PIECES = XRF / 4;
    for (int i = tid; i < XROWS * PIECES; i += nthreads) {
      const int r = i / PIECES, j = i - r * PIECES;
      const int gy = 2 * oy0 - 1 + r;
      const long long e = a + 4 * j;
      const bool valid = gy >= 0 && gy < H && e >= 0 && e + 4 <= W3;
      cp_async16(xs + r * XRF + 4 * j,
                 valid ? x + ((long long)b * H + gy) * W3 + e : x, valid);
    }
  } else {
    for (int i = tid; i < XROWS * XRF; i += nthreads) {
      const int r = i / XRF, j = i - r * XRF;
      const int gy = 2 * oy0 - 1 + r;
      const long long e = a + j;
      xs[r * XRF + j] = (gy >= 0 && gy < H && e >= 0 && e < W3)
                            ? x[((long long)b * H + gy) * W3 + e]
                            : 0.f;
    }
  }
}

// the 32 im2col values of tile pixel (ty, tx) from the staged x rows
__device__ __forceinline__ void im2col_row(float v[KC1], const float* xs,
                                           int ty, int tx) {
#pragma unroll
  for (int ky = 0; ky < 3; ++ky)
#pragma unroll
    for (int i = 0; i < 9; ++i)
      v[ky * 9 + i] = xs[(2 * ty + ky) * XRF + 6 * tx + 1 + i];
#pragma unroll
  for (int i = 27; i < KC1; ++i) v[i] = 0.f;
}

// ---- P1: y1 = conv3x3/2(x, k1), 3 -> C1 ----------------------------------
//
// GEMM per 8 x 16 tile of y1: M = 128 pixels, N = 8 NT1 output channels
// (48 for K2, 32 for K4's stem1; a block owns one such slice, blockIdx.y),
// K = 32. 4 warps, warp w owns tile rows 2w, 2w + 1 (two m16 tiles) x NT1
// n8 tiles. Persistent, the next
// tile's x rows in flight while this one runs. The im2col tile is split
// as it is built, into hi and lo tiles of rows padded to 9 units, and the
// filter (transposed: output channels as rows) once a block, so the MMA
// loop is ldmatrix and MMAs only. 64 KB (60 KB at 32 channels): three
// blocks an SM. Eval: y = act(g1 acc + b1) (SiLU for K2, ReLU for K4);
// train: y = acc and the block's per-channel sum and sum of squares from
// the accumulator fragments, as front_tc.cuh's P1.
constexpr int P1_THREADS = 128;
constexpr int P1_KS = KC1 + 4;     // im2col / filter row pitch: 9 units

template <int NT1>
__host__ __device__ constexpr size_t p1_smem() {
  return sizeof(float) * (size_t)(2 * XROWS * XRF + 2 * TH * TW * P1_KS +
                                  2 * 8 * NT1 * P1_KS);
}

template <bool TRAIN, bool VEC, int NT1, int ACT, typename SUM>
__global__ void __launch_bounds__(P1_THREADS, 3)
front_p1_tf32_kernel(const float* __restrict__ x, const float* __restrict__ k1,
                     const float* __restrict__ g1,
                     const float* __restrict__ b1, float* __restrict__ y,
                     float* __restrict__ stats, int H, int W, int Ho, int Wo,
                     int C1, int tiles_x, int tiles_per_img, int n_tiles) {
  constexpr int NT = NT1, P1_NP = 8 * NT1, KS = P1_KS, E = sizeof(float);
  static_assert(NT1 % 2 == 0, "P1: n8 tiles in pairs");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* xs = reinterpret_cast<float*>(smem_raw);  // [2][XROWS][XRF]
  float* colh = xs + 2 * XROWS * XRF;              // [TH TW][KS]
  float* coll = colh + TH * TW * KS;               // [TH TW][KS]
  float* fh = coll + TH * TW * KS;                 // [P1_NP][KS]
  float* fl = fh + P1_NP * KS;                     // [P1_NP][KS]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int co0 = blockIdx.y * P1_NP;
  const int blk = blockIdx.x, n_blk = gridDim.x;
  const int my_tiles = blk < n_tiles ? (n_tiles - 1 - blk) / n_blk + 1 : 0;

  auto tile_of = [&](int s, int& b, int& oy0, int& ox0) {
    const int t = blk + s * n_blk;
    b = t / tiles_per_img;
    const int r = t - b * tiles_per_img;
    oy0 = (r / tiles_x) * TH;
    ox0 = (r % tiles_x) * TW;
  };
  auto load_x = [&](int s) {
    int b, oy0, ox0;
    tile_of(s, b, oy0, ox0);
    stage_x_rows<VEC>(xs + (s & 1) * XROWS * XRF, x, b, oy0, ox0, H, W, tid,
                      P1_THREADS);
  };

  // the filter transposed and split: f[co][k] = k1[k][co0 + co] (HWIO rows
  // k = (ky 3 + kx) 3 + ci; zero past 27 and past C1), read along co
  for (int i = tid; i < P1_NP * KC1; i += P1_THREADS) {
    const int co = i % P1_NP, k = i / P1_NP;
    const int c = co0 + co;
    uint32_t h, l;
    split_tf32((k < 27 && c < C1) ? k1[(long long)k * C1 + c] : 0.f, h, l);
    fh[co * KS + k] = __uint_as_float(h);
    fl[co * KS + k] = __uint_as_float(l);
  }
  if (my_tiles > 0) load_x(0);
  cp_async_commit();

  // this thread's channels 8 j + 2 t4 + e: the eval fold, the statistics
  float gv[NT][2], bv[NT][2];
  SUM s1[NT][2], s2[NT][2];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int c = co0 + 8 * j + 2 * t4 + e;
      gv[j][e] = (!TRAIN && c < C1) ? g1[c] : 0.f;
      bv[j][e] = (!TRAIN && c < C1) ? b1[c] : 0.f;
      s1[j][e] = 0.f;
      s2[j][e] = 0.f;
    }

  // ldmatrix row addresses (conv3x3_tf32.cuh's K3-f): A lanes 0-15 pixels
  // 0-15 at k0..+3, lanes 16-31 at k0+4..+7; B lanes 0-7 / 8-15 output
  // channels 0-7 at k0 / k0+4 (n8 tile 2jj), lanes 16-31 channels 8-15
  const int a_px = lane & 15, a_k = (lane >> 4) * 4;
  const int b_n = (lane & 7) + (lane >> 4) * 8, b_k = ((lane >> 3) & 1) * 4;
  const uint32_t ah_lane =
      smem_addr(colh + (2 * warp * TW + a_px) * KS + a_k);
  const uint32_t al_lane = ah_lane + TH * TW * KS * E;
  const uint32_t bh_lane = smem_addr(fh + b_n * KS + b_k);
  const uint32_t bl_lane = bh_lane + P1_NP * KS * E;

  for (int s = 0; s < my_tiles; ++s) {
    if (s + 1 < my_tiles) load_x(s + 1);
    cp_async_commit();
    cp_async_wait_prev();
    __syncthreads();
    const float* xcur = xs + (s & 1) * XROWS * XRF;
    for (int p = tid; p < TH * TW; p += P1_THREADS) {
      float v[KC1];
      im2col_row(v, xcur, p / TW, p % TW);
#pragma unroll
      for (int q = 0; q < KC1 / 4; ++q) {
        uint32_t h[4], l[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) split_tf32(v[4 * q + e], h[e], l[e]);
        *reinterpret_cast<uint4*>(colh + p * KS + 4 * q) =
            make_uint4(h[0], h[1], h[2], h[3]);
        *reinterpret_cast<uint4*>(coll + p * KS + 4 * q) =
            make_uint4(l[0], l[1], l[2], l[3]);
      }
    }
    __syncthreads();

    float acc[2][NT][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.f;
#pragma unroll
    for (int k0 = 0; k0 < KC1; k0 += 8) {
      uint32_t ah[2][4], al[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        ldsm_x4(ah[i], ah_lane + (i * TW * KS + k0) * E);
        ldsm_x4(al[i], al_lane + (i * TW * KS + k0) * E);
      }
      uint32_t bh[NT][2], bl[NT][2];
#pragma unroll
      for (int jj = 0; jj < NT / 2; ++jj) {
        uint32_t h[4], l[4];
        ldsm_x4(h, bh_lane + (16 * jj * KS + k0) * E);
        ldsm_x4(l, bl_lane + (16 * jj * KS + k0) * E);
#pragma unroll
        for (int e = 0; e < 2; ++e) {  // n8 tiles 2jj, 2jj + 1
          bh[2 * jj + e][0] = h[2 * e], bh[2 * jj + e][1] = h[2 * e + 1];
          bl[2 * jj + e][0] = l[2 * e], bl[2 * jj + e][1] = l[2 * e + 1];
        }
      }
      mma_grid_3xtf32<2, NT, FWD_PASSES>(acc, ah, al, bh, bl);
    }

    int b, oy0, ox0;
    tile_of(s, b, oy0, ox0);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int oy = oy0 + 2 * warp + i;
      const bool row_ok = oy < Ho;
      const long long pix0 = ((long long)b * Ho + oy) * Wo + ox0;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int e = q & 1;
          const float v = acc[i][j][q];
          if (!TRAIN) {
            acc[i][j][q] = act_fast<ACT>(v * gv[j][e] + bv[j][e]);
          } else if (row_ok && ox0 + g + 8 * (q >> 1) < Wo &&
                     co0 + 8 * j + 2 * t4 + e < C1) {
            add_stat<SUM>(s1[j][e], s2[j][e], v);
          }
        }
        store_tile(y, acc[i][j], pix0, row_ok, ox0, Wo, C1, co0 + 8 * j,
                   lane);
      }
    }
    __syncthreads();  // the im2col tiles and the x stage free
  }

  if (TRAIN) {
    __shared__ SUM red[4][2][P1_NP];
    warp_sum_s<NT, SUM>(s1);
    warp_sum_s<NT, SUM>(s2);
    if (g == 0)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          red[warp][0][8 * j + 2 * t4 + e] = s1[j][e];
          red[warp][1][8 * j + 2 * t4 + e] = s2[j][e];
        }
    __syncthreads();
    if (tid < 2 * P1_NP) {
      const int which = tid / P1_NP, c = tid - which * P1_NP;
      SUM t = 0.f;
      for (int w = 0; w < 4; ++w) t += red[w][which][c];
      if (co0 + c < C1)
        stats[((size_t)which * n_blk + blk) * C1 + co0 + c] = (float)t;
    }
  }
}

// ---- P2: y2 = conv3x3/2(a1, k2), C1 -> C2 --------------------------------
//
// Per 8 x 16 tile of y2: M = 128 pixels, N = NP output channels (a block
// owns one NP-channel slice, blockIdx.y), K = 9 taps x Cin, taken CK input
// channels (CK / 8 k8 steps) a stage. 8 warps: warp w owns tile rows 2 (w
// & 3), + 1 (two m16 tiles) x the NP / 16 n8 tiles of channel half w >> 2,
// so a stage is staged (and transformed) once for all NP channels. A tap
// (ky, kx) is a constant offset of the lanes' row addresses into the
// parity-plane halo (pixel rows of CK / 4 + 1 units, odd: conflict-free).
// The filter, transposed ([tap][co][ci], FCI input channels: a group), is
// staged once a block when Cin <= FCI and once a group otherwise; its rows
// are swizzled (swz_filter). Fragments split in registers after each
// ldmatrix. Persistent, the next stage's copies in flight under this
// one's MMAs. TRANSFORM (train): a1 = act(g1 y1 + b1) in place on each
// landed stage for the pixels inside the image; STATS: the batch
// statistics of y2 from the accumulators. K2: CK 8, FCI 48, NP 96 (one
// block an SM, above). K4's stem3 (64 -> 32, the concat stored activated,
// so no transform): CK 16, FCI 64, NP 32: the whole filter (74 KB) and two
// 46 KB halo stages, 166 KB, one block an SM; a stage is 9 taps x 2 k8
// steps x 12 MMAs a warp between barriers, twice K2's CK-8 stages would
// give at this width.
constexpr int P2_THREADS = 256;

template <int CK, int FCI, int NP>
__host__ __device__ constexpr size_t p2_smem() {
  return sizeof(float) * (size_t)(2 * HALO2 * (CK + 4) + 9 * NP * FCI);
}

template <bool TRANSFORM, bool STATS, bool VEC, int CK, int FCI, int NP,
          int ACT, typename SUM>
__global__ void __launch_bounds__(P2_THREADS, 1)
front_p2_tf32_kernel(const float* __restrict__ a, const float* __restrict__ k2,
                     const float* __restrict__ g1,
                     const float* __restrict__ b1, float* __restrict__ y,
                     float* __restrict__ stats, int H, int W, int Ho, int Wo,
                     int Cin, int Cout, int tiles_x, int tiles_per_img,
                     int n_tiles) {
  constexpr int P2_CK = CK, P2_HS = CK + 4, P2_FCI = FCI, P2_NP = NP;
  constexpr int HALF = P2_NP / 2, NT = HALF / 8, E = sizeof(float);
  constexpr int PER_FG = P2_FCI / P2_CK;  // stages a filter group
  static_assert(CK % 8 == 0 && FCI % CK == 0 && NP % 32 == 0, "P2 tiles");
  static_assert(!TRANSFORM || CK == 8, "P2: the transform takes 8-channel "
                "stages");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* halo = reinterpret_cast<float*>(smem_raw);  // [2][HALO2][P2_HS]
  float* filt = halo + 2 * HALO2 * P2_HS;            // [9][P2_NP][P2_FCI]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp & 3, wn = warp >> 2;
  const int g = lane >> 2, t4 = lane & 3;
  const int co0 = blockIdx.y * P2_NP;
  const int cw0 = co0 + HALF * wn;  // this warp's first output channel
  const int n_ci = (Cin + P2_CK - 1) / P2_CK;
  const int n_fg = (Cin + P2_FCI - 1) / P2_FCI;
  const int blk = blockIdx.x, n_blk = gridDim.x;
  const int my_tiles = blk < n_tiles ? (n_tiles - 1 - blk) / n_blk + 1 : 0;
  const int stages = my_tiles * n_ci;

  auto tile_of = [&](int s, int& b, int& oy0, int& ox0) {
    const int t = blk + (s / n_ci) * n_blk;
    b = t / tiles_per_img;
    const int r = t - b * tiles_per_img;
    oy0 = (r / tiles_x) * TH;
    ox0 = (r % tiles_x) * TW;
  };
  auto load_halo = [&](int s) {
    int b, oy0, ox0;
    tile_of(s, b, oy0, ox0);
    stage_rows<VEC>(
        halo + (s & 1) * HALO2 * P2_HS, P2_HS, a, HALO2, P2_CK,
        (s % n_ci) * P2_CK, Cin,
        [&](int p) { return halo_offset(p, b, oy0, ox0, H, W, Cin); }, tid,
        P2_THREADS);
  };
  // filter group fg, transposed: filt[tap][co][ci] = k2[tap][48 fg + ci]
  // [co0 + co] (zero outside), read along co (coalesced)
  auto load_filter = [&](int fg) {
    for (int i = tid; i < 9 * P2_FCI * P2_NP; i += P2_THREADS) {
      const int co = i % P2_NP, r = i / P2_NP;
      const int ci = r % P2_FCI, tap = r / P2_FCI;
      const int gci = fg * P2_FCI + ci, gco = co0 + co;
      filt[tap * P2_NP * P2_FCI + swz_filter<P2_FCI>(co, ci)] =
          (gci < Cin && gco < Cout)
              ? k2[((long long)tap * Cin + gci) * Cout + gco]
              : 0.f;
    }
  };

  float acc[2][NT][4];
  SUM s1[NT][2], s2[NT][2];
#pragma unroll
  for (int j = 0; j < NT; ++j) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.f;
#pragma unroll
    for (int e = 0; e < 2; ++e) s1[j][e] = s2[j][e] = 0.f;
  }

  if (n_fg == 1) load_filter(0);
  if (stages > 0) load_halo(0);
  cp_async_commit();

  // A: lanes 0-15 halo slots of output columns 0-15 at channels 0-3 of the
  // k8 step, lanes 16-31 at 4-7; output row 2 wm + i, tap ky reads halo row
  // 4 wm + 2 i + ky. B: output channel rows HALF wn + 16 jj + b_n, the
  // swizzled unit of (stage channel / 4 + b_u), whose swizzle depends on
  // the row's low three bits only (lane & 7)
  const int a_px = lane & 15, a_u = lane >> 4;
  const uint32_t a_lane =
      smem_addr(halo + (4 * wm * HROW + a_px) * P2_HS + 4 * a_u);
  const int b_n = (lane & 7) + (lane >> 4) * 8, b_u = (lane >> 3) & 1;
  const int b_sw = P2_FCI == 48 ? ((lane & 7) >> 1) & 3 : lane & 7;
  const uint32_t b_row = smem_addr(filt + (HALF * wn + b_n) * P2_FCI);
  // TRANSFORM: bit k set where this thread's halo slot tid / 2 + 128 k of
  // the current tile lies inside the image
  constexpr int SLOTS = (HALO2 + P2_THREADS / 2 - 1) / (P2_THREADS / 2);
  static_assert(SLOTS <= 32, "P2 transform slots");
  uint32_t inside = 0;

  for (int s = 0; s < stages; ++s) {
    const int sc = s % n_ci;  // the tile's channel stage
    if (n_fg > 1 && sc % PER_FG == 0)
      load_filter(sc / PER_FG);  // free since the last stage's barrier
    if (s + 1 < stages) load_halo(s + 1);
    cp_async_commit();
    cp_async_wait_prev();
    __syncthreads();

    int b, oy0, ox0;
    tile_of(s, b, oy0, ox0);
    float* cur = halo + (s & 1) * HALO2 * P2_HS;
    if (TRANSFORM) {
      // this thread's 4 channels of the stage and its halo slots tid / 2
      // + 128 k are fixed (P2_THREADS is even); which of those slots lie
      // inside the image is worked out once a tile. Past Cin g = b = 0
      // keeps the staged zeros (silu(0) = 0)
      const int hq = tid & 1, c0 = sc * P2_CK + 4 * hq;
      if (sc == 0) {
        inside = 0;
#pragma unroll
        for (int k = 0; k < SLOTS; ++k) {
          const int p = (tid >> 1) + k * (P2_THREADS / 2);
          if (p < HALO2 && halo_offset(p, b, oy0, ox0, H, W, 1) >= 0)
            inside |= 1u << k;
        }
      }
      float gq[4], bq[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        gq[k] = c0 + k < Cin ? __ldg(g1 + c0 + k) : 0.f;
        bq[k] = c0 + k < Cin ? __ldg(b1 + c0 + k) : 0.f;
      }
#pragma unroll
      for (int k = 0; k < SLOTS; ++k) {
        if (!((inside >> k) & 1)) continue;
        const int p = (tid >> 1) + k * (P2_THREADS / 2);
        float4* q = reinterpret_cast<float4*>(cur + p * P2_HS + 4 * hq);
        float4 v = *q;
        v.x = act_fast<ACT>(v.x * gq[0] + bq[0]);
        v.y = act_fast<ACT>(v.y * gq[1] + bq[1]);
        v.z = act_fast<ACT>(v.z * gq[2] + bq[2]);
        v.w = act_fast<ACT>(v.w * gq[3] + bq[3]);
        *q = v;
      }
      __syncthreads();
    }

#pragma unroll
    for (int k8 = 0; k8 < P2_CK / 8; ++k8) {
      const uint32_t a_base =
          a_lane + ((s & 1) * HALO2 * P2_HS + 8 * k8) * E;
      const int unit = (sc % PER_FG) * (P2_CK / 4) + 2 * k8 + b_u;
      const uint32_t b_base = b_row + ((unit ^ b_sw) << 4);
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        const int ky = tap / 3, kx = tap % 3;
        uint32_t ah[2][4], al[2][4];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          uint32_t r[4];
          ldsm_x4(r, a_base + (((2 * i + ky) * HROW + (kx & 1) * PL +
                                (kx >> 1)) * P2_HS) * E);
          split4(r, ah[i], al[i]);
        }
        uint32_t bh[NT][2], bl[NT][2];
#pragma unroll
        for (int jj = 0; jj < NT / 2; ++jj) {
          uint32_t r[4], h[4], l[4];
          ldsm_x4(r, b_base + ((tap * P2_NP + 16 * jj) * P2_FCI) * E);
          split4(r, h, l);
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            bh[2 * jj + e][0] = h[2 * e], bh[2 * jj + e][1] = h[2 * e + 1];
            bl[2 * jj + e][0] = l[2 * e], bl[2 * jj + e][1] = l[2 * e + 1];
          }
        }
        mma_grid_3xtf32<2, NT, FWD_PASSES>(acc, ah, al, bh, bl);
      }
    }

    if (sc == n_ci - 1) {  // the tile's last stage: store
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int oy = oy0 + 2 * wm + i;
        const bool row_ok = oy < Ho;
        const long long pix0 = ((long long)b * Ho + oy) * Wo + ox0;
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          if (STATS) {
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              const int e = q & 1;
              if (row_ok && ox0 + g + 8 * (q >> 1) < Wo &&
                  cw0 + 8 * j + 2 * t4 + e < Cout) {
                add_stat<SUM>(s1[j][e], s2[j][e], acc[i][j][q]);
              }
            }
          }
          store_tile(y, acc[i][j], pix0, row_ok, ox0, Wo, Cout, cw0 + 8 * j,
                     lane);
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.f;
        }
      }
    }
    __syncthreads();  // stage buffer (and filter) free for the next copies
  }

  if (STATS) {
    __shared__ SUM red[8][2][HALF];
    warp_sum_s<NT, SUM>(s1);
    warp_sum_s<NT, SUM>(s2);
    if (g == 0)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          red[warp][0][8 * j + 2 * t4 + e] = s1[j][e];
          red[warp][1][8 * j + 2 * t4 + e] = s2[j][e];
        }
    __syncthreads();
    if (tid < 2 * P2_NP) {
      const int which = tid / P2_NP, c = tid - which * P2_NP;
      const int h = c / HALF, cc = c - HALF * h;
      SUM t = 0.f;
      for (int w = 0; w < 4; ++w) t += red[4 * h + w][which][cc];
      if (co0 + c < Cout)
        stats[((size_t)which * n_blk + blk) * Cout + co0 + c] = (float)t;
    }
  }
}

// ---- K2-b: e2 = dy2 + ds2 + 2 y2 dss2 -------------------------------------
// The BN2 statistics cotangent folded into y2's, formed once so that dA1
// and dk2 both stage it by cp.async. VEC: 4 channels a thread, 16-byte
// loads and stores.
template <bool VEC>
__global__ void __launch_bounds__(256)
e2_prep_f32_kernel(const float* __restrict__ dy2, const float* __restrict__ y2,
                   const float* __restrict__ ds2,
                   const float* __restrict__ dss2, float* __restrict__ e2,
                   long long n, int C2) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long i0 = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (VEC) {
    for (long long i = i0; i < n / 4; i += stride) {
      const float4 d = reinterpret_cast<const float4*>(dy2)[i];
      const float4 yv = reinterpret_cast<const float4*>(y2)[i];
      const int c = (int)((4 * i) % C2);
      reinterpret_cast<float4*>(e2)[i] = make_float4(
          d.x + ds2[c] + 2.f * yv.x * dss2[c],
          d.y + ds2[c + 1] + 2.f * yv.y * dss2[c + 1],
          d.z + ds2[c + 2] + 2.f * yv.z * dss2[c + 2],
          d.w + ds2[c + 3] + 2.f * yv.w * dss2[c + 3]);
    }
  } else {
    for (long long i = i0; i < n; i += stride) {
      const int c = (int)(i % C2);
      e2[i] = dy2[i] + ds2[c] + 2.f * y2[i] * dss2[c];
    }
  }
}

// ---- K2-b: dA1, the transposed stride-2 conv, and the BN1 + SiLU chain ---
//
// front_tc.cuh's parity classes: a block's y1 tile of 2 DU x 2 DV pixels
// splits into four classes (row, column parity) of DU x DV pixels, each a
// stride-1 GEMM over one (DU + 1) x (DV + 1) patch of e2 with 1, 2, 2 or 4
// taps: M = DV pixels a class row, N = 48 y1 channels (blockIdx.y slice),
// K = taps x C2, taken 32 e2 channels a stage. 8 warps: warp w owns class
// rows 2 (w & 3), + 1 of all four classes x the 3 n8 tiles of channel half
// w >> 2 (24 channels; 96 f32 sums a thread). A tap reads the patch at a
// shift (ky == 0, kx == 0) of which there are four, so each k8 step loads
// and splits one A fragment a shift and row (4 of the 9 taps share shift
// (0, 0)), and one B fragment (x4 for n8 tiles 0-1, x2 for tile 2) a tap.
// B = k2 as stored ([tap][c1][c2], c2 contiguous), staged by cp.async in
// groups of 96 c2 with rows swizzled (swz_rows): once a block when C2 <= 96.
// Epilogue per class from the fragments: y1 at the lane's two channels
// (8-byte loads when C1 is even), dpre = dA1 act'(z1), z1 = g1 y1 + b1,
// dy1 = dpre g1, dgamma += dpre y1, dbeta += dpre over the pixels inside
// the image, summed as P1's statistics into gpart[2][gridDim.x][C1]. The
// template takes the stage (KD), the filter group (FK) and the block's
// channels (ND): K2 32, 96, 48 (210 KB, one block an SM). CHAIN false
// (K4's d(cat), the transposed stem3, 64 concat channels from 32 e3
// channels): dA1 is stored as it is, no y1, no partials; 32, 32, 32, two
// channel slices (81 KB: two blocks an SM, so one block's copies and
// epilogue run under the other's MMAs).
constexpr int DA_THREADS = 256;

template <int KD, int FK, int ND>
__host__ __device__ constexpr size_t da1_smem() {
  return sizeof(float) * (size_t)(2 * PATCH * (KD + 4) + 9 * ND * FK);
}

// blocks an SM that a kernel's shared memory leaves room for (one or two)
__host__ __device__ constexpr int blocks_for(size_t smem) {
  return smem <= 113 * 1024 ? 2 : 1;
}

template <bool CHAIN, bool VEC, int KD, int FK, int ND, int ACT>
__global__ void __launch_bounds__(DA_THREADS,
                                  blocks_for(da1_smem<KD, FK, ND>()))
front_da1_tf32_kernel(const float* __restrict__ e2,
                      const float* __restrict__ k2,
                      const float* __restrict__ y1,
                      const float* __restrict__ g1,
                      const float* __restrict__ b1, float* __restrict__ dy1,
                      float* __restrict__ gpart, int H2, int W2, int H4,
                      int W4, int C1, int C2, int tiles_x, int tiles_per_img,
                      int n_tiles) {
  constexpr int DA_KD = KD, DA_KS = KD + 4, DA_FK = FK, DA_ND = ND;
  // a warp's channels: half the block's
  constexpr int NW = ND / 2, NT = NW / 8, E = sizeof(float);
  constexpr int PER_FG = DA_FK / DA_KD;  // stages a filter group
  static_assert(KD % 8 == 0 && FK % KD == 0 && ND % 16 == 0, "dA1 tiles");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* patch = reinterpret_cast<float*>(smem_raw);  // [2][PATCH][DA_KS]
  float* filt = patch + 2 * PATCH * DA_KS;            // [9][DA_ND][DA_FK]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp & 3, wn = warp >> 2;
  const int g = lane >> 2, t4 = lane & 3;
  const int c10 = blockIdx.y * DA_ND;
  const int cw0 = c10 + NW * wn;  // this warp's first y1 channel
  const int n_c2 = (C2 + DA_KD - 1) / DA_KD;
  const int n_fg = (C2 + DA_FK - 1) / DA_FK;
  const int blk = blockIdx.x, n_blk = gridDim.x;
  const int my_tiles = blk < n_tiles ? (n_tiles - 1 - blk) / n_blk + 1 : 0;
  const int stages = my_tiles * n_c2;

  auto tile_of = [&](int s, int& b, int& iy0, int& ix0) {
    const int t = blk + (s / n_c2) * n_blk;
    b = t / tiles_per_img;
    const int r = t - b * tiles_per_img;
    iy0 = (r / tiles_x) * (2 * DU);
    ix0 = (r % tiles_x) * (2 * DV);
  };
  auto load_patch = [&](int s) {
    int b, iy0, ix0;
    tile_of(s, b, iy0, ix0);
    const int oy0 = iy0 / 2, ox0 = ix0 / 2;
    stage_rows<VEC>(
        patch + (s & 1) * PATCH * DA_KS, DA_KS, e2, PATCH, DA_KD,
        (s % n_c2) * DA_KD, C2,
        [&](int p) -> long long {
          const int oy = oy0 + p / PC, ox = ox0 + p % PC;
          if (oy >= H4 || ox >= W4) return -1;
          return (((long long)b * H4 + oy) * W4 + ox) * C2;
        },
        tid, DA_THREADS);
  };
  // filter group fg: filt[tap][c1][c] = k2[tap][c10 + c1][96 fg + c]
  auto load_filter = [&](int fg) {
    const int f0 = fg * DA_FK;
    if (VEC) {
      for (int i = tid; i < 9 * DA_ND * (DA_FK / 4); i += DA_THREADS) {
        const int r = i / (DA_FK / 4), j = i - r * (DA_FK / 4);
        const int tap = r / DA_ND, c1 = c10 + r % DA_ND, c = f0 + 4 * j;
        const bool valid = c1 < C1 && c < C2;
        cp_async16(filt + swz_rows<DA_FK>(r, 4 * j),
                   valid ? k2 + ((long long)tap * C1 + c1) * C2 + c : k2,
                   valid);
      }
    } else {
      for (int i = tid; i < 9 * DA_ND * DA_FK; i += DA_THREADS) {
        const int r = i / DA_FK, j = i - r * DA_FK;
        const int tap = r / DA_ND, c1 = c10 + r % DA_ND, c = f0 + j;
        filt[swz_rows<DA_FK>(r, j)] =
            (c1 < C1 && c < C2) ? k2[((long long)tap * C1 + c1) * C2 + c]
                                : 0.f;
      }
    }
  };

  // the tile's y1 rows (from pixel ix0, all channels) into L2 with its
  // first stage, so that the epilogue's loads, three stages on, meet L2
  // and not device memory
  auto prefetch_y1 = [&](int s) {
    int b, iy0, ix0;
    tile_of(s, b, iy0, ix0);
    const int rows = min(2 * DU, H2 - iy0);
    const int lines =
        (int)(((long long)(min(ix0 + 2 * DV, W2) - ix0) * C1 * 4 + 127) / 128);
    for (int i = tid; i < rows * lines; i += DA_THREADS) {
      const int r = i / lines, l = i - r * lines;
      const float* p =
          y1 + (((long long)b * H2 + iy0 + r) * W2 + ix0) * C1 + 32 * l;
      asm volatile("prefetch.global.L2 [%0];\n" ::"l"(p));
    }
  };

  // this thread's channels 8 j + 2 t4 + e of the warp's NW
  float gv[NT][2], bv[NT][2], dg[NT][2], db[NT][2];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int c = cw0 + 8 * j + 2 * t4 + e;
      gv[j][e] = CHAIN && c < C1 ? g1[c] : 0.f;
      bv[j][e] = CHAIN && c < C1 ? b1[c] : 0.f;
      dg[j][e] = db[j][e] = 0.f;
    }
  float acc[4][2][NT][4];  // [class][class row][n8 tile]
#pragma unroll
  for (int k = 0; k < 4; ++k)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[k][i][j][q] = 0.f;

  if (n_fg == 1) load_filter(0);
  if (stages > 0) load_patch(0);
  cp_async_commit();

  // A: lanes 0-15 patch pixels of class columns 0-15, lanes 16-31 the
  // same at the next 4 channels; class row 2 wm + i at shift dr reads
  // patch row 2 wm + i + dr. B: rows (tap, 24 wn + b_n), unit swizzled by
  // the row's low three bits (lane & 7)
  const int a_px = lane & 15, a_u = lane >> 4;
  const uint32_t a_lane =
      smem_addr(patch + (2 * wm * PC + a_px) * DA_KS + 4 * a_u);
  const int b_n = (lane & 7) + (lane >> 4) * 8, b_u = (lane >> 3) & 1;
  const int b_sw = lane & 7;
  const uint32_t b_row = smem_addr(filt + (NW * wn + b_n) * DA_FK);
  // for an odd NT (K2: 3), the x2 of the last n8 tile (rows NW wn + 16
  // (NT / 2) + lane % 8; lanes 16-31 repeat lanes 0-15's rows, which
  // ldmatrix .x2 does not read)
  const uint32_t b_row2 =
      smem_addr(filt + (NW * wn + 16 * (NT / 2) + (lane & 7)) * DA_FK);

  for (int s = 0; s < stages; ++s) {
    const int sc = s % n_c2;
    if (n_fg > 1 && sc % PER_FG == 0) load_filter(sc / PER_FG);
    cp_async_commit();
    if (s + 1 < stages) load_patch(s + 1);
    cp_async_commit();
    if (CHAIN && sc == 0) prefetch_y1(s);
    cp_async_wait_prev();
    __syncthreads();

    const uint32_t a_base = a_lane + (s & 1) * PATCH * DA_KS * E;
    const int u0 = (sc % PER_FG) * (DA_KD / 4);  // the stage's first unit
#pragma unroll 1
    for (int k8 = 0; k8 < DA_KD / 8; ++k8) {
      const uint32_t b_off = ((u0 + 2 * k8 + b_u) ^ b_sw) << 4;
#pragma unroll
      for (int shift = 0; shift < 4; ++shift) {
        const int dr = shift >> 1, dc = shift & 1;
        uint32_t ah[2][4], al[2][4];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          uint32_t r[4];
          ldsm_x4(r, a_base + (((i + dr) * PC + dc) * DA_KS + 8 * k8) * E);
          split4(r, ah[i], al[i]);
        }
#pragma unroll
        for (int tap = 0; tap < 9; ++tap) {
          const int ky = tap / 3, kx = tap % 3;
          if ((ky == 0) != dr || (kx == 0) != dc) continue;
          const int cls = (ky != 1) * 2 + (kx != 1);  // (row, col) parity
          uint32_t bh[NT][2], bl[NT][2];
#pragma unroll
          for (int jj = 0; jj < NT / 2; ++jj) {  // n8 tiles 2 jj, 2 jj + 1
            uint32_t r[4], h[4], l[4];
            ldsm_x4(r, b_row + b_off +
                           (tap * DA_ND * DA_FK + 16 * jj * DA_FK) * E);
            split4(r, h, l);
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              bh[2 * jj + e][0] = h[2 * e], bh[2 * jj + e][1] = h[2 * e + 1];
              bl[2 * jj + e][0] = l[2 * e], bl[2 * jj + e][1] = l[2 * e + 1];
            }
          }
          if constexpr (NT % 2 == 1) {
            uint32_t r2[2];
            ldsm_x2(r2, b_row2 + b_off + (tap * DA_ND * DA_FK) * E);
            split_tf32(__uint_as_float(r2[0]), bh[NT - 1][0], bl[NT - 1][0]);
            split_tf32(__uint_as_float(r2[1]), bh[NT - 1][1], bl[NT - 1][1]);
          }
          mma_grid_3xtf32(acc[cls], ah, al, bh, bl);
        }
      }
    }

    if (!CHAIN && sc == n_c2 - 1) {  // the tile's last stage: store dA1
      int b, iy0, ix0;
      tile_of(s, b, iy0, ix0);
#pragma unroll
      for (int cls = 0; cls < 4; ++cls)
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < NT; ++j)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int iy = iy0 + 2 * (2 * wm + i) + (cls >> 1);
              const int ix = ix0 + 2 * (g + 8 * h) + (cls & 1);
              const int c = cw0 + 8 * j + 2 * t4;
              const long long off =
                  (((long long)b * H2 + iy) * W2 + ix) * C1 + c;
              float* a = &acc[cls][i][j][2 * h];
              if (iy < H2 && ix < W2) {
                if (C1 % 2 == 0 && c < C1) {
                  *reinterpret_cast<float2*>(dy1 + off) =
                      make_float2(a[0], a[1]);
                } else if (C1 % 2 != 0) {
#pragma unroll
                  for (int e = 0; e < 2; ++e)
                    if (c + e < C1) dy1[off + e] = a[e];
                }
              }
              a[0] = a[1] = 0.f;
            }
    }
    if (CHAIN && sc == n_c2 - 1) {  // the tile's last stage: the epilogue
      int b, iy0, ix0;
      tile_of(s, b, iy0, ix0);
#pragma unroll
      for (int cls = 0; cls < 4; ++cls) {
        const int py = cls >> 1, px = cls & 1;
        // this class's y1 values first, all loads in flight together
        // (L2 hits: prefetched with the tile's first stage), then the
        // chain; pixel (class row 2 wm + i, class column g + 8 h),
        // channels c, c + 1
        auto at = [&](int i, int j, int h, long long& off) {
          const int iy = iy0 + 2 * (2 * wm + i) + py;
          const int ix = ix0 + 2 * (g + 8 * h) + px;
          const int c = cw0 + 8 * j + 2 * t4;
          off = (((long long)b * H2 + iy) * W2 + ix) * C1 + c;
          return iy < H2 && ix < W2;
        };
        float yv[2][NT][2][2];
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < NT; ++j)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              long long off;
              const bool ok = at(i, j, h, off);
              const int c = cw0 + 8 * j + 2 * t4;
#pragma unroll
              for (int e = 0; e < 2; ++e) yv[i][j][h][e] = 0.f;
              if (ok && C1 % 2 == 0 && c < C1) {
                const float2 t = *reinterpret_cast<const float2*>(y1 + off);
                yv[i][j][h][0] = t.x, yv[i][j][h][1] = t.y;
              } else if (ok && C1 % 2 != 0) {
#pragma unroll
                for (int e = 0; e < 2; ++e)
                  if (c + e < C1) yv[i][j][h][e] = y1[off + e];
              }
            }
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < NT; ++j)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              long long off;
              const bool ok = at(i, j, h, off);
              const int c = cw0 + 8 * j + 2 * t4;
              float* a = &acc[cls][i][j][2 * h];
              float d[2];
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const float y = yv[i][j][h][e];
                const float dpre =
                    a[e] * act_grad<ACT>(y * gv[j][e] + bv[j][e]);
                d[e] = dpre * gv[j][e];
                if (ok && c + e < C1) {
                  dg[j][e] = fmaf(dpre, y, dg[j][e]);
                  db[j][e] += dpre;
                }
                a[e] = 0.f;
              }
              if (ok && C1 % 2 == 0 && c < C1) {
                *reinterpret_cast<float2*>(dy1 + off) = make_float2(d[0], d[1]);
              } else if (ok && C1 % 2 != 0) {
#pragma unroll
                for (int e = 0; e < 2; ++e)
                  if (c + e < C1) dy1[off + e] = d[e];
              }
            }
      }
    }
    __syncthreads();  // patch buffer (and filter) free for the next copies
  }

  if (!CHAIN) return;
  __shared__ float red[8][2][NW];
  warp_sum_g<NT>(dg);
  warp_sum_g<NT>(db);
  if (g == 0)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        red[warp][0][8 * j + 2 * t4 + e] = dg[j][e];
        red[warp][1][8 * j + 2 * t4 + e] = db[j][e];
      }
  __syncthreads();
  if (tid < 2 * DA_ND) {
    const int which = tid / DA_ND, c = tid - which * DA_ND;
    const int h = c / NW, cc = c - NW * h;
    float t = 0.f;
    for (int w = 0; w < 4; ++w) t += red[4 * h + w][which][cc];
    if (c10 + c < C1) gpart[((size_t)which * n_blk + blk) * C1 + c10 + c] = t;
  }
}

// ---- K2-b: dk2 = sum over y2 pixels of a1 (x) e2 at stride 2 -------------
//
// K3-b's f32 scheme (conv3x3_tf32.cuh wgrad_tf32_kernel) on a stride-2
// halo: per tap M = 48 y1 channels (blockIdx.y slice), N = 48 y2 channels
// (blockIdx.z slice), K = the y2 pixels of 4 x 16 tiles, split into
// n_chunks fixed strided sets. 18 warps: warp w takes tap w % 9 and half w
// / 9 of the 6 n8 tiles (36 f32 sums a thread). A tile's y1 halo (in
// parity planes) and e2 rows land by cp.async in raw buffers; one pass
// then forms a1 = silu(g1 y1 + b1) for the pixels inside the image and
// splits both operands into (hi c, hi c+1, lo c, lo c+1) quads of channel
// pairs, read by 128-bit loads with each fragment row standing for one
// channel of a pair (no 32-bit ldmatrix.trans exists; rows of 26 units put
// an 8-lane phase in 8 bank groups). Each block writes its partial to
// part[chunk][tap][c1][c2]; sum_chunks_tc_kernel adds them in a fixed
// order. The block's channels each way (MC y1 channels, NC y2 channels):
// K2 48 x 48 (225 KB); K4's dk3 (the concat (x) e3, no transform) 32 x 32,
// two slices of the concat's 64 channels (154 KB; 64 x 32 would take 252
// KB with the split quads), one block of 18 warps an SM either way.
constexpr int DK_THREADS = 18 * 32;
constexpr int DK_PIX = DK_TH * TW;     // y2 pixels a tile

template <int MC, int NC>
__host__ __device__ constexpr size_t dk2_smem() {
  return sizeof(float) * (size_t)(DK_HALO * MC + DK_PIX * NC +
                                  DK_HALO * (2 * MC + 8) +
                                  DK_PIX * (2 * NC + 8));
}

template <bool TRANSFORM, bool VEC, int MC, int NC, int ACT>
__global__ void __launch_bounds__(DK_THREADS, 1)
front_dk2_tf32_kernel(const float* __restrict__ y1,
                      const float* __restrict__ e2,
                      const float* __restrict__ g1,
                      const float* __restrict__ b1, float* __restrict__ part,
                      int H2, int W2, int H4, int W4, int C1, int C2,
                      int tiles_x, int tiles_per_img, int n_tiles,
                      int n_chunks) {
  // m16 tiles; n8 tiles a warp (half the block's)
  constexpr int MT = MC / 16, NH = NC / 16;
  constexpr int XS = 2 * MC + 8, DS = 2 * NC + 8;  // split rows (floats)
  static_assert(MC % 16 == 0 && NC % 16 == 0, "dk2 tiles");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* raw_x = reinterpret_cast<float*>(smem_raw);  // [DK_HALO][MC]
  float* raw_d = raw_x + DK_HALO * MC;                // [DK_PIX][NC]
  float* sx = raw_d + DK_PIX * NC;                    // [DK_HALO][XS]
  float* sd = sx + DK_HALO * XS;                      // [DK_PIX][DS]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tap = warp % 9, half = warp / 9;
  const int ky = tap / 3, kx = tap % 3;
  const int chunk = blockIdx.x;
  const int ci0 = blockIdx.y * MC, co0 = blockIdx.z * NC;
  const int my_tiles =
      chunk < n_tiles ? (n_tiles - 1 - chunk) / n_chunks + 1 : 0;

  auto tile_of = [&](int s, int& b, int& oy0, int& ox0) {
    const int t = chunk + s * n_chunks;
    b = t / tiles_per_img;
    const int r = t - b * tiles_per_img;
    oy0 = (r / tiles_x) * DK_TH;
    ox0 = (r % tiles_x) * TW;
  };
  auto load_tile = [&](int s) {
    int b, oy0, ox0;
    tile_of(s, b, oy0, ox0);
    stage_rows<VEC>(
        raw_x, MC, y1, DK_HALO, MC, ci0, C1,
        [&](int p) { return halo_offset(p, b, oy0, ox0, H2, W2, C1); }, tid,
        DK_THREADS);
    stage_rows<VEC>(
        raw_d, NC, e2, DK_PIX, NC, co0, C2,
        [&](int p) -> long long {
          const int oy = oy0 + p / TW, ox = ox0 + p % TW;
          if (oy >= H4 || ox >= W4) return -1;
          return (((long long)b * H4 + oy) * W4 + ox) * C2;
        },
        tid, DK_THREADS);
  };

  float acc[MT][NH][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NH; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.f;

  if (my_tiles > 0) load_tile(0);
  cp_async_commit();

  // this lane's k = t4 of 8 output columns (slots t4 of the tap's plane;
  // k = t4 + 4 is 4 slots on) and its channel pair g of each 16 channels
  // the split pass: this thread's channel pair pq of every staged pixel
  // (DK_THREADS is a multiple of the pairs a row)
  constexpr int PAIRS = MC / 2, DPAIRS = NC / 2;
  static_assert(DK_THREADS % PAIRS == 0 && DK_THREADS % DPAIRS == 0,
                "dk2 split pass");
  const int pq = tid % PAIRS, pd = tid % DPAIRS;

  const int g = lane >> 2, t4 = lane & 3;
  const float* xa0 =
      sx + (ky * HROW + (kx & 1) * PL + (kx >> 1) + t4) * XS + 4 * g;
  const float* db0 = sd + t4 * DS + 4 * g;

  for (int s = 0; s < my_tiles; ++s) {
    cp_async_wait_all();
    __syncthreads();  // the raw tile landed; the split buffers are free
    int b, oy0, ox0;
    tile_of(s, b, oy0, ox0);
    float gq[2], bq[2];  // a1's fold; g = b = 0 past C1 keeps the zeros
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int c = ci0 + 2 * pq + e;
      gq[e] = TRANSFORM && c < C1 ? __ldg(g1 + c) : 0.f;
      bq[e] = TRANSFORM && c < C1 ? __ldg(b1 + c) : 0.f;
    }
#pragma unroll 4
    for (int p = tid / PAIRS; p < DK_HALO; p += DK_THREADS / PAIRS) {
      float2 v = *reinterpret_cast<const float2*>(raw_x + p * MC + 2 * pq);
      if (TRANSFORM && halo_offset(p, b, oy0, ox0, H2, W2, 1) >= 0) {
        v.x = act_fast<ACT>(v.x * gq[0] + bq[0]);
        v.y = act_fast<ACT>(v.y * gq[1] + bq[1]);
      }
      put_quad(sx + p * XS + 4 * pq, v.x, v.y);
    }
    for (int p = tid / DPAIRS; p < DK_PIX; p += DK_THREADS / DPAIRS) {
      const float2 v =
          *reinterpret_cast<const float2*>(raw_d + p * NC + 2 * pd);
      put_quad(sd + p * DS + 4 * pd, v.x, v.y);
    }
    __syncthreads();  // split buffers ready, raw stage free
    if (s + 1 < my_tiles) load_tile(s + 1);
    cp_async_commit();

    // the MMAs of this tile, with this warp's half of the n8 tiles known
    // at compile time (n8 tile HALF NH + j is element (HALF NH + j) & 1 of
    // quad (HALF NH + j) / 2)
    auto mmas = [&](auto half_c) {
      constexpr int HALF = decltype(half_c)::value;
#pragma unroll 1
      for (int r = 0; r < DK_TH; ++r) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {  // one k8 step: columns 8h .. 8h + 7
          const float* xa = xa0 + (2 * r * HROW + 8 * h) * XS;
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
          uint32_t bh[NH][2], bl[NH][2];
#pragma unroll
          for (int j = 0; j < NH; ++j) {
            constexpr int J0 = HALF * NH;
            const int jt = J0 + j, quad = jt >> 1;
            const uint4 u0 = *reinterpret_cast<const uint4*>(db + 32 * quad);
            const uint4 u1 =
                *reinterpret_cast<const uint4*>(db + 4 * DS + 32 * quad);
            const bool odd = jt & 1;
            bh[j][0] = odd ? u0.y : u0.x, bh[j][1] = odd ? u1.y : u1.x;
            bl[j][0] = odd ? u0.w : u0.z, bl[j][1] = odd ? u1.w : u1.z;
          }
          mma_grid_3xtf32(acc, ah, al, bh, bl);
        }
      }
    };
    if (half == 0)
      mmas(std::integral_constant<int, 0>());
    else
      mmas(std::integral_constant<int, 1>());
  }

  // this chunk's partial, part[chunk][tap][c1][c2]: acc[i][j][q] is row
  // m = g + 8 (q >> 1), column n = 2 t4 + (q & 1) of tiles (i, half NH + j)
  float* pc = part + ((size_t)chunk * 9 + tap) * C1 * C2;
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NH; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int jt = half * NH + j;
        const int ci = ci0 + 16 * i + 2 * g + (q >> 1);
        const int co = co0 + 16 * (jt >> 1) + 4 * t4 + 2 * (q & 1) + (jt & 1);
        if (ci < C1 && co < C2) pc[(size_t)ci * C2 + co] = acc[i][j][q];
      }
}

// ---- K2-b: dk1 = sum over y1 pixels of im2col(x) (x) e1 -------------------
//
// M = 32 (the 27 im2col columns, padded), N = 48 y1 channels (blockIdx.y
// slice), K = the y1 pixels, in 8 x 16 tiles split into n_chunks fixed
// strided sets. A tile's x rows, dy1 and y1 land by cp.async in one of two
// raw stages (the next tile's copies are in flight under this one's
// passes: the kernel reads 1.8 GB at batch 16, its bound); one pass
// builds the im2col rows and forms e1 = dy1 + ds1 + 2 y1 dss1 (zero
// outside the image), both split into quads of column (or channel) pairs
// as dk2's. 202 KB, one block an SM. 8 warps,
// warp w takes tile row w (two k8 steps) and keeps 2 x 6 m16n8 tiles of f32
// sums; at the end the eight warps' sums are added in order and the block
// writes part[chunk][27][C1], summed by sum_chunks_tc_kernel. NC y1
// channels a block: 48 for K2 (202 KB), 32 for K4 (154 KB).
constexpr int K1_THREADS = 256;
constexpr int K1_PIX = TH * TW;        // y1 pixels a tile
constexpr int K1_CS = 2 * KC1 + 8;     // split im2col row (floats)

template <int NC>  // a raw stage
__host__ __device__ constexpr int k1_raw() {
  return XROWS * XRF + 2 * K1_PIX * NC;
}

template <int NC>
__host__ __device__ constexpr size_t dk1_smem() {
  return sizeof(float) * (size_t)(2 * k1_raw<NC>() + K1_PIX * K1_CS +
                                  K1_PIX * (2 * NC + 8));
}

template <bool VEC, int K1_NC>
__global__ void __launch_bounds__(K1_THREADS, 1)
front_dk1_tf32_kernel(const float* __restrict__ x,
                      const float* __restrict__ dy1,
                      const float* __restrict__ y1,
                      const float* __restrict__ ds1,
                      const float* __restrict__ dss1,
                      float* __restrict__ part, int H, int W, int H2, int W2,
                      int C1, int tiles_x, int tiles_per_img, int n_tiles,
                      int n_chunks) {
  constexpr int NT = K1_NC / 8, NC = K1_NC, PIX = K1_PIX;
  constexpr int K1_ES = 2 * NC + 8;      // split e1 row (floats)
  constexpr int K1_RAW = k1_raw<NC>();
  static_assert(NC % 16 == 0, "dk1 tiles");
  static_assert(8 * 32 * NC <= PIX * (K1_CS + K1_ES), "dk1 reduction");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // raw stage: x rows [XROWS][XRF], dy1 [PIX][NC], y1 [PIX][NC]
  float* raw = reinterpret_cast<float*>(smem_raw);  // [2][K1_RAW]
  float* scol = raw + 2 * K1_RAW;                   // [PIX][K1_CS]
  float* se = scol + PIX * K1_CS;                   // [PIX][K1_ES]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int chunk = blockIdx.x, c10 = blockIdx.y * NC;
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
    float* xs = raw + (s & 1) * K1_RAW;
    stage_x_rows<VEC>(xs, x, b, oy0, ox0, H, W, tid, K1_THREADS);
    auto pix = [&](int p) -> long long {
      const int oy = oy0 + p / TW, ox = ox0 + p % TW;
      if (oy >= H2 || ox >= W2) return -1;
      return (((long long)b * H2 + oy) * W2 + ox) * C1;
    };
    float* rdy = xs + XROWS * XRF;
    stage_rows<VEC>(rdy, NC, dy1, PIX, NC, c10, C1, pix, tid, K1_THREADS);
    stage_rows<VEC>(rdy + PIX * NC, NC, y1, PIX, NC, c10, C1, pix, tid,
                    K1_THREADS);
  };

  float acc[2][NT][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.f;

  if (my_tiles > 0) load_tile(0);
  cp_async_commit();

  // this lane's pixel k = t4 (and t4 + 4) of a k8 step and its pair g of
  // each 16 im2col columns (or channels)
  const int g = lane >> 2, t4 = lane & 3;
  const float* xa0 = scol + (warp * TW + t4) * K1_CS + 4 * g;
  const float* db0 = se + (warp * TW + t4) * K1_ES + 4 * g;

  // the e1 pass: threads below 240 take channel pair pq of every tenth
  // pixel, with its ds1, dss1 (0 past C1: e1 stays 0 there)
  constexpr int PAIRS = NC / 2, E_THREADS = K1_THREADS / PAIRS * PAIRS;
  const int pq = tid % PAIRS;
  float dsq[2], dssq[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int c = c10 + 2 * pq + e;
    dsq[e] = c < C1 ? ds1[c] : 0.f;
    dssq[e] = c < C1 ? dss1[c] : 0.f;
  }

  for (int s = 0; s < my_tiles; ++s) {
    if (s + 1 < my_tiles) load_tile(s + 1);  // its stage was read by s - 1
    cp_async_commit();
    cp_async_wait_prev();
    __syncthreads();  // tile s landed; the split buffers are free
    int b, oy0, ox0;
    tile_of(s, b, oy0, ox0);
    const float* xs = raw + (s & 1) * K1_RAW;
    const float* rdy = xs + XROWS * XRF;
    const float* ry = rdy + PIX * NC;
    for (int p = tid; p < PIX; p += K1_THREADS) {
      float v[KC1];
      im2col_row(v, xs, p / TW, p % TW);
#pragma unroll
      for (int q = 0; q < KC1 / 2; ++q)
        put_quad(scol + p * K1_CS + 4 * q, v[2 * q], v[2 * q + 1]);
    }
    if (tid < E_THREADS) {
#pragma unroll 4
      for (int p = tid / PAIRS; p < PIX; p += E_THREADS / PAIRS) {
        const bool ok = oy0 + p / TW < H2 && ox0 + p % TW < W2;
        const float2 d =
            *reinterpret_cast<const float2*>(rdy + p * NC + 2 * pq);
        const float2 yv =
            *reinterpret_cast<const float2*>(ry + p * NC + 2 * pq);
        put_quad(se + p * K1_ES + 4 * pq,
                 ok ? d.x + dsq[0] + 2.f * yv.x * dssq[0] : 0.f,
                 ok ? d.y + dsq[1] + 2.f * yv.y * dssq[1] : 0.f);
      }
    }
    __syncthreads();  // split buffers ready

#pragma unroll
    for (int h = 0; h < 2; ++h) {  // one k8 step: pixels 8h .. 8h + 7
      const float* xa = xa0 + 8 * h * K1_CS;
      const float* db = db0 + 8 * h * K1_ES;
      uint32_t ah[2][4], al[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const uint4 v0 = *reinterpret_cast<const uint4*>(xa + 32 * i);
        const uint4 v1 =
            *reinterpret_cast<const uint4*>(xa + 4 * K1_CS + 32 * i);
        ah[i][0] = v0.x, ah[i][1] = v0.y, ah[i][2] = v1.x, ah[i][3] = v1.y;
        al[i][0] = v0.z, al[i][1] = v0.w, al[i][2] = v1.z, al[i][3] = v1.w;
      }
      uint32_t bh[NT][2], bl[NT][2];
#pragma unroll
      for (int jt = 0; jt < NT; ++jt) {
        const int quad = jt >> 1;
        const uint4 u0 = *reinterpret_cast<const uint4*>(db + 32 * quad);
        const uint4 u1 =
            *reinterpret_cast<const uint4*>(db + 4 * K1_ES + 32 * quad);
        const bool odd = jt & 1;
        bh[jt][0] = odd ? u0.y : u0.x, bh[jt][1] = odd ? u1.y : u1.x;
        bl[jt][0] = odd ? u0.w : u0.z, bl[jt][1] = odd ? u1.w : u1.z;
      }
      mma_grid_3xtf32(acc, ah, al, bh, bl);
    }
  }

  // the eight warps' sums in order, then this chunk's partial: acc[i][jt]
  // [q] is im2col column 16 i + 2 g + (q >> 1), channel 16 (jt >> 1) + 4
  // t4 + 2 (q & 1) + (jt & 1)
  __syncthreads();
  float* red = scol;  // [8][32][NC]
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int jt = 0; jt < NT; ++jt)
#pragma unroll
      for (int q = 0; q < 4; ++q)
        red[(warp * 32 + 16 * i + 2 * g + (q >> 1)) * NC + 16 * (jt >> 1) +
            4 * t4 + 2 * (q & 1) + (jt & 1)] = acc[i][jt][q];
  __syncthreads();
  for (int idx = tid; idx < 27 * NC; idx += K1_THREADS) {
    const int m = idx / NC, n = idx - m * NC;
    float t = 0.f;
    for (int w = 0; w < 8; ++w) t += red[(w * 32 + m) * NC + n];
    if (c10 + n < C1) part[((size_t)chunk * 27 + m) * C1 + c10 + n] = t;
  }
}

// ---- launchers: the wrapper's plan in, cudaGetLastError() out ------------

// Template arguments default to the YOLOv8 front's instantiation.
template <bool TRAIN, int NT1 = 6, int ACT = ACT_SILU, typename SUM = float>
inline int launch_p1(const float* x, const float* k1, const float* g1,
                     const float* b1, float* y, float* stats, int B, int H,
                     int W, int C1, int blocks, int vec, cudaStream_t st) {
  const int Ho = out_size(H, 2), Wo = out_size(W, 2);
  int tiles_x;
  const int per_img = tiles_of(Ho, Wo, TH, TW, tiles_x);
  dim3 grid(blocks, (C1 + 8 * NT1 - 1) / (8 * NT1));
  auto kern = vec ? front_p1_tf32_kernel<TRAIN, true, NT1, ACT, SUM>
                  : front_p1_tf32_kernel<TRAIN, false, NT1, ACT, SUM>;
  constexpr size_t smem = p1_smem<NT1>();
  int err = set_smem(kern, smem);
  if (err != 0) return err;
  kern<<<grid, P1_THREADS, smem, st>>>(x, k1, g1, b1, y, stats, H, W, Ho, Wo,
                                       C1, tiles_x, per_img, B * per_img);
  return static_cast<int>(cudaGetLastError());
}

template <bool TRANSFORM, bool STATS = TRANSFORM, int CK = 8, int FCI = 48,
          int NP = 96, int ACT = ACT_SILU, typename SUM = float>
inline int launch_p2(const float* a, const float* k2, const float* g1,
                     const float* b1, float* y, float* stats, int B, int H,
                     int W, int Cin, int Cout, int blocks, int vec,
                     cudaStream_t st) {
  const int Ho = out_size(H, 2), Wo = out_size(W, 2);
  int tiles_x;
  const int per_img = tiles_of(Ho, Wo, TH, TW, tiles_x);
  dim3 grid(blocks, (Cout + NP - 1) / NP);
  auto kern = vec ? front_p2_tf32_kernel<TRANSFORM, STATS, true, CK, FCI, NP,
                                         ACT, SUM>
                  : front_p2_tf32_kernel<TRANSFORM, STATS, false, CK, FCI, NP,
                                         ACT, SUM>;
  constexpr size_t smem = p2_smem<CK, FCI, NP>();
  int err = set_smem(kern, smem);
  if (err != 0) return err;
  kern<<<grid, P2_THREADS, smem, st>>>(a, k2, g1, b1, y, stats, H, W, Ho, Wo,
                                       Cin, Cout, tiles_x, per_img,
                                       B * per_img);
  return static_cast<int>(cudaGetLastError());
}

inline int launch_e2(const float* dy2, const float* y2, const float* ds2,
                     const float* dss2, float* e2, long long n, int C2,
                     int vec, cudaStream_t st) {
  const long long items = vec ? n / 4 : n;
  const int blocks = static_cast<int>(
      (items + 255) / 256 < 65535 ? (items + 255) / 256 : 65535);
  if (vec)
    e2_prep_f32_kernel<true><<<blocks, 256, 0, st>>>(dy2, y2, ds2, dss2, e2,
                                                     n, C2);
  else
    e2_prep_f32_kernel<false><<<blocks, 256, 0, st>>>(dy2, y2, ds2, dss2, e2,
                                                      n, C2);
  return static_cast<int>(cudaGetLastError());
}

template <bool CHAIN = true, int KD = 32, int FK = 96, int ND = 48,
          int ACT = ACT_SILU>
inline int launch_da1(const float* e2, const float* k2, const float* y1,
                      const float* g1, const float* b1, float* dy1,
                      float* gpart, int B, int H2, int W2, int C1, int C2,
                      int blocks, int vec, cudaStream_t st) {
  const int H4 = out_size(H2, 2), W4 = out_size(W2, 2);
  int tiles_x;
  const int per_img = tiles_of(H2, W2, 2 * DU, 2 * DV, tiles_x);
  dim3 grid(blocks, (C1 + ND - 1) / ND);
  auto kern = vec ? front_da1_tf32_kernel<CHAIN, true, KD, FK, ND, ACT>
                  : front_da1_tf32_kernel<CHAIN, false, KD, FK, ND, ACT>;
  constexpr size_t smem = da1_smem<KD, FK, ND>();
  int err = set_smem(kern, smem);
  if (err != 0) return err;
  kern<<<grid, DA_THREADS, smem, st>>>(e2, k2, y1, g1, b1, dy1, gpart, H2, W2,
                                       H4, W4, C1, C2, tiles_x, per_img,
                                       B * per_img);
  return static_cast<int>(cudaGetLastError());
}

// dk2 (3, 3, C1, C2) = the in-order sum of n_chunks partials in part
template <bool TRANSFORM = true, int MC = 48, int NC = 48,
          int ACT = ACT_SILU>
inline int launch_dk2(const float* y1, const float* e2, const float* g1,
                      const float* b1, float* part, float* dk2, int B, int H2,
                      int W2, int C1, int C2, int n_chunks, int vec,
                      cudaStream_t st) {
  const int H4 = out_size(H2, 2), W4 = out_size(W2, 2);
  int tiles_x;
  const int per_img = tiles_of(H4, W4, DK_TH, TW, tiles_x);
  dim3 grid(n_chunks, (C1 + MC - 1) / MC, (C2 + NC - 1) / NC);
  auto kern = vec ? front_dk2_tf32_kernel<TRANSFORM, true, MC, NC, ACT>
                  : front_dk2_tf32_kernel<TRANSFORM, false, MC, NC, ACT>;
  constexpr size_t smem = dk2_smem<MC, NC>();
  int err = set_smem(kern, smem);
  if (err != 0) return err;
  kern<<<grid, DK_THREADS, smem, st>>>(y1, e2, g1, b1, part, H2, W2, H4, W4,
                                       C1, C2, tiles_x, per_img, B * per_img,
                                       n_chunks);
  err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  const int n = 9 * C1 * C2;
  tc::sum_chunks_tc_kernel<<<(n + 31) / 32, 256, 0, st>>>(part, n_chunks, n,
                                                          dk2);
  return static_cast<int>(cudaGetLastError());
}

// dk1 (3, 3, 3, C1) = the in-order sum of n_chunks partials in part
template <int NC = 48>
inline int launch_dk1(const float* x, const float* dy1, const float* y1,
                      const float* ds1, const float* dss1, float* part,
                      float* dk1, int B, int H, int W, int C1, int n_chunks,
                      int vec, cudaStream_t st) {
  const int H2 = out_size(H, 2), W2 = out_size(W, 2);
  int tiles_x;
  const int per_img = tiles_of(H2, W2, TH, TW, tiles_x);
  dim3 grid(n_chunks, (C1 + NC - 1) / NC);
  auto kern = vec ? front_dk1_tf32_kernel<true, NC>
                  : front_dk1_tf32_kernel<false, NC>;
  constexpr size_t smem = dk1_smem<NC>();
  int err = set_smem(kern, smem);
  if (err != 0) return err;
  kern<<<grid, K1_THREADS, smem, st>>>(x, dy1, y1, ds1, dss1, part, H, W, H2,
                                       W2, C1, tiles_x, per_img, B * per_img,
                                       n_chunks);
  err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  const int n = 27 * C1;
  tc::sum_chunks_tc_kernel<<<(n + 31) / 32, 256, 0, st>>>(part, n_chunks, n,
                                                          dk1);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace ftf
}  // namespace rodt
