// f32 3x3 stride-1 SAME convolution (K3-f, and K3-f as dX) and its filter
// gradient (K3-b) on the tensor cores in split ("3x") TF32: implicit GEMMs
// on mma.sync.m16n8k8.tf32, NHWC in, f32 out. Used by conv3x3.cu and
// conv3x3_wgrad.cu for float32; bf16 runs the m16n8k16 kernels of
// conv3x3_tc.cuh, whose PTX wrappers, staging pattern and ordered chunk
// sum this file reuses.
//
// The arithmetic. One TF32 product keeps 11 significant bits of each
// operand (about 1e-3 relative), too coarse for the f32 checks (1e-4 x
// max|ref| over 432-term sums). So each f32 operand a is split into hi =
// tf32(a) and lo = tf32(a - hi), tf32() being cvt.rna.tf32.f32's rounding
// (nearest, ties away: add 0x1000 to the bits, clear the low 13), and
// every product is hi*hi + hi*lo + lo*hi, three MMAs into one f32
// accumulator, the two small ones first; lo*lo (below 2^-22 of the product)
// is dropped. Where tf32(a) is not finite (an Inf or NaN a, or one that
// rounds past FLT_MAX) the split is hi = 0, lo = a instead: lo = tf32(Inf
// - Inf) would be NaN, and keeping hi = Inf would meet the other operand's
// lo, which is 0 for a TF32 value (Inf * 0 = NaN) or of either sign. So the
// non-finite value meets only the other operand's hi, which has its sign
// and is 0 only where it is, and an Inf input gives what an f32 FFMA sum
// gives. The split runs on the CUDA cores, 8 instructions a value (ptxas
// expands each cvt.rna into an add, a mask, a compare and a select; the
// one compare here serves both halves and the guard). K3-f splits in
// registers after each fragment load; K3-b splits each staged value once
// into shared memory (see there).
//
// Fragments. ldmatrix moves 16-bit elements, but its non-transposed form
// still hands lane l the 32-bit element (row l / 4, column l % 4) of an
// 8 x 4 f32 tile: the m16n8k8 tf32 A layout, and the B layout when B is
// stored k-contiguous. There is no 32-bit .trans, so K3-f stages its HWIO
// filter transposed (output channels as rows, input channels contiguous)
// once per block; K3-b, whose operands are both k = pixel major, reads
// them with 128-bit shared loads of split channel pairs instead (see
// there).
//
// What bounds them on an H100 (700 W): at (8, 256, 256, 48) -> 48, K3-f
// does 21.7 GFLOP, 65.2 GFLOP of TF32 MMAs (0.132 ms at 495 TFLOP/s dense;
// mma.sync reaches about 0.59 m16n8k8 an SM a clock, 315 TFLOP/s, so 0.21
// ms) and moves 201 MB (0.060 ms at 3.35 TB/s): operations bound it.
#pragma once

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include <type_traits>

#include "conv3x3_tc.cuh"

namespace rodt {
namespace tc32 {

using tc::cp_async16;
using tc::cp_async_commit;
using tc::cp_async_wait_prev;
using tc::ldsm_x4;
using tc::smem_addr;
using tc::stage_rows;

constexpr int TW = 16;  // output tile columns (one m16 of pixels)

// ---- the split and the MMA ----------------------------------------------

// a = hi + lo, both TF32 (cvt.rna.tf32.f32's rounding: the add carries
// into the exponent exactly when that rounds up); hi = 0 and lo = a where
// tf32(a) is not finite: |a| at or past 0x7f7ff000's value, Inf or NaN
__device__ __forceinline__ void split_tf32(float a, uint32_t& hi,
                                           uint32_t& lo) {
  const bool finite = fabsf(a) < __uint_as_float(0x7f7ff000u);
  const uint32_t h = (__float_as_uint(a) + 0x1000u) & 0xffffe000u;
  const float l = a - __uint_as_float(h);  // exact
  hi = finite ? h : 0u;
  lo = finite ? (__float_as_uint(l) + 0x1000u) & 0xffffe000u
              : __float_as_uint(a);
}

__device__ __forceinline__ void split4(const uint32_t r[4], uint32_t hi[4],
                                       uint32_t lo[4]) {
#pragma unroll
  for (int q = 0; q < 4; ++q) split_tf32(__uint_as_float(r[q]), hi[q], lo[q]);
}

// c += a (16 x 8, row) * b (8 x 8, col), TF32 in, f32 accumulate
__device__ __forceinline__ void mma_tf32(float c[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The products of split TF32, in this order into every accumulator: lo*hi,
// hi*lo, then hi*hi (the last SPLIT_PASSES of the three).
constexpr int SPLIT_PASSES = 3;

// acc[i][j] += a[i] * b[j] over an M x N grid of m16n8 tiles (b[j] = b0,
// b1 of n8 tile j), pass by pass: consecutive MMAs go to different
// accumulators, and an accumulator's next product is M x N MMAs later, so
// no MMA waits on the one before it. PASSES: the last PASSES products
// (front_tf32.cuh keeps its own count for K2's forward).
template <int M, int N, int PASSES = SPLIT_PASSES>
__device__ __forceinline__ void mma_grid_3xtf32(
    float (&acc)[M][N][4], const uint32_t (&ah)[M][4],
    const uint32_t (&al)[M][4], const uint32_t (&bh)[N][2],
    const uint32_t (&bl)[N][2]) {
#pragma unroll
  for (int p = 3 - PASSES; p < 3; ++p)
#pragma unroll
    for (int i = 0; i < M; ++i)
#pragma unroll
      for (int j = 0; j < N; ++j) {
        const uint32_t* a = p == 0 ? al[i] : ah[i];
        const uint32_t* b = p == 1 ? bl[j] : bh[j];
        mma_tf32(acc[i][j], a, b[0], b[1]);
      }
}

// ---- K3-f: y = conv3x3(x, w) ---------------------------------------------
//
// The bf16 kernel's structure at f32 width. GEMM per tile: M = F_TH x 16
// pixels, N = NP = 8 NT output channels (a block owns one such slice of
// Cout, blockIdx.y), K = 9 taps x Cin, taken F_CK = 48 input channels a
// pass (zero-filled past Cin). The staged (F_TH + 2) x 18 halo serves all
// nine taps through shifted ldmatrix row addresses. Warp w owns tile rows
// 2w and 2w + 1 (two m16 tiles) for all NT n8 tiles: 2 x NT x 4 f32 sums a
// thread. Persistent: gridDim.x blocks walk the tiles t = blockIdx.x,
// + gridDim.x, ...; the next tile's halo is copied by 16-byte cp.async
// while this tile's MMAs run.
//
// Shared memory sets the shape: at f32 a 48-channel halo stage of 18 x 18
// pixels is 67 KB and the whole 48 x 48 filter (staged once per block when
// Cin <= 48, as [tap][co][ci]) 90 KB, 225 KB in all, so one block an SM.
// F_WARPS = 8 warps with 16 x 16 tiles (not the bf16 kernel's 4 warps and
// 8 x 16) give each of the SM's four schedulers two warps to hide the
// ldmatrix -> split -> mma chains with. The epilogue swaps half a fragment
// between neighbouring lanes (one shuffle pair) so that every lane stores
// 4 channels of one pixel as one 16-byte NHWC piece (element stores when
// Cout is not a multiple of 4).
constexpr int F_WARPS = 8;
constexpr int F_THREADS = 32 * F_WARPS;
constexpr int F_TH = 2 * F_WARPS;          // output tile rows
constexpr int F_HW = TW + 2;               // halo columns
constexpr int F_HALO = (F_TH + 2) * F_HW;  // halo pixels
constexpr int F_CK = 48;                   // input channels a pass
constexpr int F_CKS = F_CK + 4;  // a shared row: 13 (odd) 16-byte units

template <int NT>
__host__ __device__ constexpr size_t conv_tf32_smem() {
  return sizeof(float) *
         (size_t)(2 * F_HALO * F_CKS + 9 * 8 * NT * F_CKS);
}

template <int NT, bool VEC>
__global__ void __launch_bounds__(F_THREADS, 1)
conv3x3_tf32_kernel(const float* __restrict__ x, const float* __restrict__ w,
                    float* __restrict__ y, int H, int W, int Cin, int Cout,
                    int tiles_x, int tiles_per_img, int n_tiles) {
  constexpr int NP = 8 * NT;
  constexpr int CK = F_CK, CKS = F_CKS, E = sizeof(float);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* halo = reinterpret_cast<float*>(smem_raw);  // [2][F_HALO][CKS]
  float* filt = halo + 2 * F_HALO * CKS;             // [9][NP][CKS]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int co0 = blockIdx.y * NP;
  const int n_ci = (Cin + CK - 1) / CK;
  const int blk = blockIdx.x, n_blk = gridDim.x;
  const int my_tiles = blk < n_tiles ? (n_tiles - 1 - blk) / n_blk + 1 : 0;
  const int stages = my_tiles * n_ci;

  auto tile_of = [&](int s, int& b, int& oy0, int& ox0) {
    const int t = blk + (s / n_ci) * n_blk;
    b = t / tiles_per_img;
    const int r = t - b * tiles_per_img;
    oy0 = (r / tiles_x) * F_TH;
    ox0 = (r % tiles_x) * TW;
  };
  auto load_halo = [&](int s) {
    int b, oy0, ox0;
    tile_of(s, b, oy0, ox0);
    const int ci0 = (s % n_ci) * CK;
    stage_rows<VEC>(
        halo + (s & 1) * F_HALO * CKS, CKS, x, F_HALO, CK, ci0, Cin,
        [&](int p) -> long long {
          const int gy = oy0 - 1 + p / F_HW, gx = ox0 - 1 + p % F_HW;
          if (gy < 0 || gy >= H || gx < 0 || gx >= W) return -1;
          return (((long long)b * H + gy) * W + gx) * Cin;
        },
        tid, F_THREADS);
  };
  // the filter of this channel pass, transposed: filt[tap][co][ci] =
  // w[tap][ci0 + ci][co0 + co] (zero outside), read along co (coalesced)
  auto load_filter = [&](int ci0) {
    for (int i = tid; i < 9 * CK * NP; i += F_THREADS) {
      const int co = i % NP, r = i / NP;
      const int ci = r % CK, tap = r / CK;
      const int gci = ci0 + ci, gco = co0 + co;
      filt[(tap * NP + co) * CKS + ci] =
          (gci < Cin && gco < Cout)
              ? w[((long long)tap * Cin + gci) * Cout + gco]
              : 0.f;
    }
  };

  float acc[2][NT][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.f;

  if (n_ci == 1) load_filter(0);
  if (stages > 0) load_halo(0);
  cp_async_commit();

  // per-lane ldmatrix row addresses, one 16-byte row = 4 f32 channels. A
  // (pixels x input channels): lanes 0-15 pixels 0-15 at channels k0..+3
  // (a0, a1), lanes 16-31 the same pixels at k0+4..+7 (a2, a3). B (output
  // channels x input channels): lanes 0-7 / 8-15 output channels 0-7 at
  // k0..+3 / k0+4..+7 (b0, b1 of n8 tile 2jj), lanes 16-31 channels 8-15
  // (tile 2jj + 1)
  const int a_px = lane & 15, a_k = (lane >> 4) * 4;
  const int b_n = (lane & 7) + (lane >> 4) * 8, b_k = ((lane >> 3) & 1) * 4;
  const uint32_t a_lane = smem_addr(halo + (2 * warp * F_HW + a_px) * CKS +
                                    a_k);
  const uint32_t b_lane = smem_addr(filt + b_n * CKS + b_k);

  for (int s = 0; s < stages; ++s) {
    if (n_ci > 1) load_filter((s % n_ci) * CK);  // free since the last
    if (s + 1 < stages) load_halo(s + 1);        // stage's barrier
    cp_async_commit();
    cp_async_wait_prev();
    __syncthreads();

    const uint32_t a_base = a_lane + (s & 1) * F_HALO * CKS * E;
#pragma unroll 1
    for (int k0 = 0; k0 < CK; k0 += 8) {
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        const int ky = tap / 3, kx = tap % 3;
        uint32_t ah[2][4], al[2][4];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          uint32_t r[4];
          ldsm_x4(r, a_base + (((i + ky) * F_HW + kx) * CKS + k0) * E);
          split4(r, ah[i], al[i]);
        }
        uint32_t bh[NT][2], bl[NT][2];
#pragma unroll
        for (int jj = 0; jj < NT / 2; ++jj) {
          uint32_t r[4], h[4], l[4];
          ldsm_x4(r, b_lane + ((tap * NP + 16 * jj) * CKS + k0) * E);
          split4(r, h, l);
#pragma unroll
          for (int e = 0; e < 2; ++e) {  // n8 tiles 2jj, 2jj + 1
            bh[2 * jj + e][0] = h[2 * e], bh[2 * jj + e][1] = h[2 * e + 1];
            bl[2 * jj + e][0] = l[2 * e], bl[2 * jj + e][1] = l[2 * e + 1];
          }
        }
        mma_grid_3xtf32(acc, ah, al, bh, bl);
      }
    }

    if (s % n_ci == n_ci - 1) {  // the tile's last channel pass: store
      int b, oy0, ox0;
      tile_of(s, b, oy0, ox0);
      const int g = lane >> 2, t4 = lane & 3;
      const bool odd = t4 & 1;
      const int nco = min(NP, Cout - co0);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int oy = oy0 + 2 * warp + i;
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          float* c = acc[i][j];
          if (Cout % 4 == 0) {
            // lanes t4 = 2m and 2m + 1 swap halves: the even one then holds
            // pixel g, the odd one pixel g + 8, channels 8j + 4m .. + 3
            const float s0 = odd ? c[0] : c[2], s1 = odd ? c[1] : c[3];
            const float r0 = __shfl_xor_sync(0xffffffffu, s0, 1);
            const float r1 = __shfl_xor_sync(0xffffffffu, s1, 1);
            const float4 v = odd ? make_float4(r0, r1, c[2], c[3])
                                 : make_float4(c[0], c[1], r0, r1);
            const int ox = ox0 + g + (odd ? 8 : 0), n = 8 * j + 4 * (t4 >> 1);
            if (n < nco && oy < H && ox < W)
              *reinterpret_cast<float4*>(
                  y + (((size_t)b * H + oy) * W + ox) * Cout + co0 + n) = v;
          } else {
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              const int ox = ox0 + g + 8 * (q >> 1);
              const int n = 8 * j + 2 * t4 + (q & 1);
              if (n < nco && oy < H && ox < W)
                y[(((size_t)b * H + oy) * W + ox) * Cout + co0 + n] = c[q];
            }
          }
#pragma unroll
          for (int q = 0; q < 4; ++q) c[q] = 0.f;
        }
      }
    }
    __syncthreads();  // stage buffer (and filter) free for the next copies
  }
}

template <int NT, bool VEC>
inline int launch_conv_tf32_t(const float* x, const float* w, float* y,
                              int B, int H, int W, int Cin, int Cout,
                              int blocks, cudaStream_t stream) {
  const size_t smem = conv_tf32_smem<NT>();
  cudaError_t err = cudaFuncSetAttribute(
      conv3x3_tf32_kernel<NT, VEC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles_x = (W + TW - 1) / TW;
  const int tiles_per_img = tiles_x * ((H + F_TH - 1) / F_TH);
  const int n_tiles = B * tiles_per_img;
  dim3 grid(blocks, (Cout + 8 * NT - 1) / (8 * NT));
  conv3x3_tf32_kernel<NT, VEC><<<grid, F_THREADS, smem, stream>>>(
      x, w, y, H, W, Cin, Cout, tiles_x, tiles_per_img, n_tiles);
  return static_cast<int>(cudaGetLastError());
}

// ---- K3-b: dk = sum over pixels of shifted x^T . dy ----------------------
//
// The bf16 kernel's scheme: per tap a GEMM of M = Cin, N = Cout, K = the
// pixels; a block owns all nine taps of a CK = 16 MT input-channel by NP =
// 8 NT output-channel slice of dk, so x and dy are read once; the pixels
// are split into n_chunks fixed strided sets of 8 x 16 tiles, each block
// writes its chunk's partial dk, and sum_chunks_tc_kernel adds the chunks
// in a fixed order (no atomics, the same bits every run). 18 warps: warp w
// takes tap w % 9 and half w / 9 of the NT n8 tiles (MT x NT / 2 tiles,
// 36 f32 sums a thread at 48 x 48). Nine warps, one a tap as in bf16, put
// three on one of the SM's four schedulers, and at three MMAs a product
// that scheduler paced the kernel; 18 spread 5, 5, 4, 4.
//
// Split once, in shared memory. All nine warps read every staged dy value
// and every x value (at nine shifts), so a split in registers would be
// made nine times over; here each staged value is split once. A tile's x
// halo and dy land by 16-byte cp.async in a raw stage; after a barrier the
// block splits them into hi / lo buffers, a barrier frees the raw stage,
// the next tile's copies start, and the MMAs run from the split buffers
// with no arithmetic but the MMAs (raw 58 KB + split 125 KB at 48 x 48:
// one block an SM).
//
// Fragments. Both operands are k = pixel major ([pixel][channel]) and the
// MMA wants A = x^T with m = channel rows: the transpose that the bf16
// kernel gets from ldmatrix.trans, which has no 32-bit form. Rather than
// staging transposed, the kernel chooses which channel each fragment row
// stands for: row m = g of an m16 tile is channel 2g, row g + 8 channel
// 2g + 1; column n of n8 tiles 2jj and 2jj + 1 is output channel 16 jj +
// 2n and 16 jj + 2n + 1. The split buffers keep each pair of neighbouring
// channels of a pixel as one 16-byte quad (hi c, hi c+1, lo c, lo c+1), so
// a0, a1 in both halves are one 128-bit load, a2, a3 another, and b0 (b1)
// of both n8 tiles of a pair one more. The partial's store undoes the
// permutation. Rows of 2 x 16 MT + 8 and 2 x 8 NT + 8 floats (8 mod 32
// banks) put the four pixels t4 and two quads g of each 8-lane phase in
// eight different 16-byte bank groups: no bank conflicts.
constexpr int B_TH = 8;                    // pixel tile rows
constexpr int B_HW = TW + 2;
constexpr int B_HALO = (B_TH + 2) * B_HW;
constexpr int B_THREADS = 18 * 32;

template <int MT, int NT>
__host__ __device__ constexpr size_t wgrad_tf32_smem() {
  // raw x halo and dy, then their split quads
  return sizeof(float) * (size_t)(B_HALO * 16 * MT + B_TH * TW * 8 * NT +
                                  B_HALO * (32 * MT + 8) +
                                  B_TH * TW * (16 * NT + 8));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// rows x `pairs` channel pairs of raw [rows][2 pairs] f32 -> split quads
// (hi c, hi c+1, lo c, lo c+1) in [rows][stride]
__device__ __forceinline__ void split_rows(const float* raw, float* out,
                                           int rows, int pairs, int stride,
                                           int tid, int nthreads) {
  for (int i = tid; i < rows * pairs; i += nthreads) {
    const int r = i / pairs, q = i - r * pairs;
    const float2 v = *reinterpret_cast<const float2*>(raw + 2 * i);
    uint32_t h0, l0, h1, l1;
    split_tf32(v.x, h0, l0);
    split_tf32(v.y, h1, l1);
    *reinterpret_cast<uint4*>(out + r * stride + 4 * q) =
        make_uint4(h0, h1, l0, l1);
  }
}

template <int MT, int NT, bool VEC>
__global__ void __launch_bounds__(B_THREADS, 1)
wgrad_tf32_kernel(const float* __restrict__ x, const float* __restrict__ dy,
                  float* __restrict__ part, int H, int W, int Cin, int Cout,
                  int tiles_x, int tiles_per_img, int n_tiles,
                  int n_chunks) {
  constexpr int CK = 16 * MT, NP = 8 * NT;
  constexpr int XS = 2 * CK + 8, DS = 2 * NP + 8;  // split rows (floats)
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* raw_x = reinterpret_cast<float*>(smem_raw);  // [B_HALO][CK]
  float* raw_d = raw_x + B_HALO * CK;                 // [B_TH TW][NP]
  float* sx = raw_d + B_TH * TW * NP;                 // [B_HALO][XS]
  float* sd = sx + B_HALO * XS;                       // [B_TH TW][DS]

  constexpr int NH = NT / 2;  // n8 tiles a warp
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tap = warp % 9, half = warp / 9;
  const int ky = tap / 3, kx = tap % 3;
  const int chunk = blockIdx.x;
  const int ci0 = blockIdx.y * CK, co0 = blockIdx.z * NP;
  const int my_tiles =
      chunk < n_tiles ? (n_tiles - 1 - chunk) / n_chunks + 1 : 0;

  auto load_tile = [&](int s) {
    const int t = chunk + s * n_chunks;
    const int b = t / tiles_per_img, r = t - b * tiles_per_img;
    const int oy0 = (r / tiles_x) * B_TH, ox0 = (r % tiles_x) * TW;
    stage_rows<VEC>(
        raw_x, CK, x, B_HALO, CK, ci0, Cin,
        [&](int p) -> long long {
          const int gy = oy0 - 1 + p / B_HW, gx = ox0 - 1 + p % B_HW;
          if (gy < 0 || gy >= H || gx < 0 || gx >= W) return -1;
          return (((long long)b * H + gy) * W + gx) * Cin;
        },
        tid, B_THREADS);
    stage_rows<VEC>(
        raw_d, NP, dy, B_TH * TW, NP, co0, Cout,
        [&](int p) -> long long {
          const int oy = oy0 + p / TW, ox = ox0 + p % TW;
          if (oy >= H || ox >= W) return -1;
          return (((long long)b * H + oy) * W + ox) * Cout;
        },
        tid, B_THREADS);
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

  // this lane's k = t4 of a group of 8 pixels in a tile row (k = t4 + 4 is
  // 4 pixels on) and its channel pair g of each 16 channels
  const int g = lane >> 2, t4 = lane & 3;
  const float* xa0 = sx + (ky * B_HW + kx + t4) * XS + 4 * g;
  const float* db0 = sd + t4 * DS + 4 * g;

  for (int s = 0; s < my_tiles; ++s) {
    cp_async_wait_all();
    __syncthreads();  // the raw tile landed; the split buffers are free
    split_rows(raw_x, sx, B_HALO, CK / 2, XS, tid, B_THREADS);
    split_rows(raw_d, sd, B_TH * TW, NP / 2, DS, tid, B_THREADS);
    __syncthreads();  // split buffers ready, raw stage free
    if (s + 1 < my_tiles) load_tile(s + 1);
    cp_async_commit();

    // the MMAs of this tile, with this warp's half of the n8 tiles known
    // at compile time (n8 tile HALF NH + j is element (HALF NH + j) & 1 of
    // quad (HALF NH + j) / 2)
    auto mmas = [&](auto half_c) {
      constexpr int HALF = decltype(half_c)::value;
#pragma unroll 1
      for (int r = 0; r < B_TH; ++r) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {  // one k8 step: pixels 8h .. 8h + 7
          const float* xa = xa0 + (r * B_HW + 8 * h) * XS;
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

  // this chunk's partial, part[chunk][tap][ci][co]: acc[i][j][q] is row
  // m = g + 8 (q >> 1), column n = 2 t4 + (q & 1) of tiles (i, half NH + j)
  float* pc = part + ((size_t)chunk * 9 + tap) * Cin * Cout;
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NH; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int jt = half * NH + j;
        const int ci = ci0 + 16 * i + 2 * g + (q >> 1);
        const int co = co0 + 16 * (jt >> 1) + 4 * t4 + 2 * (q & 1) + (jt & 1);
        if (ci < Cin && co < Cout) pc[(size_t)ci * Cout + co] = acc[i][j][q];
      }
}

template <int MT, int NT, bool VEC>
inline int launch_wgrad_tf32_t(const float* x, const float* dy, float* part,
                               int B, int H, int W, int Cin, int Cout,
                               int n_chunks, cudaStream_t stream) {
  const size_t smem = wgrad_tf32_smem<MT, NT>();
  cudaError_t err = cudaFuncSetAttribute(
      wgrad_tf32_kernel<MT, NT, VEC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles_x = (W + TW - 1) / TW;
  const int tiles_per_img = tiles_x * ((H + B_TH - 1) / B_TH);
  const int n_tiles = B * tiles_per_img;
  dim3 grid(n_chunks, (Cin + 16 * MT - 1) / (16 * MT),
            (Cout + 8 * NT - 1) / (8 * NT));
  wgrad_tf32_kernel<MT, NT, VEC><<<grid, B_THREADS, smem, stream>>>(
      x, dy, part, H, W, Cin, Cout, tiles_x, tiles_per_img, n_tiles,
      n_chunks);
  return static_cast<int>(cudaGetLastError());
}

template <int MT, int NT>
inline int launch_wgrad_tf32_v(int vec, const float* x, const float* dy,
                               float* part, int B, int H, int W, int Cin,
                               int Cout, int n_chunks, cudaStream_t stream) {
  return vec ? launch_wgrad_tf32_t<MT, NT, true>(x, dy, part, B, H, W, Cin,
                                                 Cout, n_chunks, stream)
             : launch_wgrad_tf32_t<MT, NT, false>(x, dy, part, B, H, W, Cin,
                                                  Cout, n_chunks, stream);
}

}  // namespace tc32
}  // namespace rodt
