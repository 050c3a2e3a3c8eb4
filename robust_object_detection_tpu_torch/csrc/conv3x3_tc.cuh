// bf16 3x3 stride-1 SAME convolution (K3-f) and its filter gradient (K3-b)
// on the tensor cores: implicit GEMMs on mma.sync.m16n8k16 (bf16 x bf16 ->
// f32), NHWC in, operands staged in shared memory by 16-byte cp.async and
// read into fragments by ldmatrix. Used by conv3x3.cu and conv3x3_wgrad.cu
// for bf16; their f32 route is the split-TF32 kernels of conv3x3_tf32.cuh.
// front_tc.cuh (K2) and conv3x3_tf32.cuh build on its PTX wrappers,
// stage_rows and sum_chunks_tc_kernel.
//
// Both kernels walk 8 x 16 output-pixel tiles (TH x TW) of an image and
// read each tile's input halo, (TH+2) x (TW+2) pixels, with no im2col
// buffer: a tap (ky, kx) is a shift of the per-lane row addresses that
// ldmatrix takes, so one staged halo serves all nine taps.
//
// Staging. VEC (a template flag the wrapper sets when the channel counts
// are multiples of 8 and the base pointers 16-byte aligned): every 16-byte
// piece (8 channels of one pixel) is one cp.async, with a source size of 0
// for a piece outside the image or past the channel count, which writes
// zeros. Otherwise the same kernel stages element by element with plain
// loads. Shared rows are padded to an odd number of 16-byte units, so the 8
// row addresses of each ldmatrix phase fall in 8 different bank groups.
// Two stage buffers: the next tile's copies are in flight while this
// tile's MMAs run.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stddef.h>
#include <stdint.h>

namespace rodt {
namespace tc {

typedef __nv_bfloat16 bf16;

constexpr int TH = 8;             // output tile rows
constexpr int TW = 16;            // output tile columns (one m16 / k16)
constexpr int HW_ = TW + 2;       // halo columns
constexpr int HALO = (TH + 2) * HW_;  // halo pixels

// ---- PTX wrappers --------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; valid == false writes 16 zero bytes
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// every committed group but the newest one has landed
__device__ __forceinline__ void cp_async_wait_prev() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

__device__ __forceinline__ void ldsm_x4(uint32_t r[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t r[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// c += a (16 x 16, row) * b (16 x 8, col), bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A row of `c` bf16 channels padded to an odd number of 16-byte units.
__host__ __device__ constexpr int padded(int c) {
  return ((c / 8) % 2 == 0) ? c + 8 : c;
}

// Stages rows x `cols` channels (from channel c0 of a row of `C`) into a
// shared [rows][stride] array of T (bf16, or f32 for conv3x3_tf32.cuh);
// src_row(r) is the row's global element offset or -1 outside the image;
// channels >= C are zero. VEC: one cp.async a 16-byte piece (8 bf16 or 4
// f32 channels).
template <bool VEC, typename T, typename RowFn>
__device__ __forceinline__ void stage_rows(T* dst, int stride,
                                           const T* __restrict__ src,
                                           int rows, int cols, int c0, int C,
                                           RowFn src_row, int tid,
                                           int nthreads) {
  constexpr int P = 16 / sizeof(T);  // channels a piece
  if (VEC) {
    const int pieces = cols / P;
    for (int i = tid; i < rows * pieces; i += nthreads) {
      const int r = i / pieces, j = i - r * pieces;
      const long long off = src_row(r);
      const int c = c0 + P * j;
      const bool valid = off >= 0 && c < C;
      cp_async16(dst + r * stride + P * j, valid ? src + off + c : src,
                 valid);
    }
  } else {
    for (int i = tid; i < rows * cols; i += nthreads) {
      const int r = i / cols, j = i - r * cols;
      const long long off = src_row(r);
      const int c = c0 + j;
      dst[r * stride + j] = (off >= 0 && c < C) ? src[off + c] : T(0.f);
    }
  }
}

// ---- K3-f: y = conv3x3(x, w) ---------------------------------------------
//
// GEMM per tile: M = 128 pixels, N = NP = 8 NT output channels (a block
// owns one such slice of Cout, blockIdx.y), K = 9 taps x Cin, taken F_CK =
// 48 input channels at a time (zero-filled past Cin). 4 warps, warp w owns
// tile rows 2w and 2w + 1 (two m16 tiles) for all NT n8 tiles: 2 x NT x 4
// f32 sums a thread. The 27 k16 steps of a 48-channel pass (3 channel
// slices x 9 taps) are unrolled, so ptxas can schedule the next step's
// ldmatrix under this step's MMAs. Persistent: gridDim.x blocks (about two
// per SM) walk the tiles t = blockIdx.x, + gridDim.x, ...; with one channel
// pass (Cin <= 48) the block's filter slice (9 x 48 x NP bf16, 48 KB at NP
// 48) is staged once and stays in shared memory. Epilogue: the f32 sums
// rounded once to bf16, through a per-warp shared tile, stored as 16-byte
// pieces of NHWC rows (element stores when Cout is not a multiple of 8).
constexpr int F_WARPS = 4;
constexpr int F_THREADS = 32 * F_WARPS;
constexpr int F_CK = 48;                  // input channels a pass
constexpr int F_CKS = padded(F_CK);       // their shared row, 56

template <int NT>
__host__ __device__ constexpr size_t conv_tc_smem() {
  return sizeof(bf16) * (size_t)(2 * HALO * F_CKS + 9 * F_CK * padded(8 * NT)
                                 + F_WARPS * 2 * TW * padded(8 * NT));
}

template <int NT, bool VEC>
__global__ void __launch_bounds__(F_THREADS, 2)
conv3x3_tc_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                  bf16* __restrict__ y, int H, int W, int Cin, int Cout,
                  int tiles_x, int tiles_per_img, int n_tiles) {
  constexpr int NP = 8 * NT;
  constexpr int NPS = padded(NP);
  constexpr int CK = F_CK, CKS = F_CKS;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* halo = reinterpret_cast<bf16*>(smem_raw);  // [2][HALO][CKS]
  bf16* filt = halo + 2 * HALO * CKS;              // [9][CK][NPS]
  bf16* outs = filt + 9 * CK * NPS;                // [4][2 TW][NPS]

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
    oy0 = (r / tiles_x) * TH;
    ox0 = (r % tiles_x) * TW;
  };
  auto load_halo = [&](int s) {
    int b, oy0, ox0;
    tile_of(s, b, oy0, ox0);
    const int ci0 = (s % n_ci) * CK;
    stage_rows<VEC>(
        halo + (s & 1) * HALO * CKS, CKS, x, HALO, CK, ci0, Cin,
        [&](int p) -> long long {
          const int gy = oy0 - 1 + p / HW_, gx = ox0 - 1 + p % HW_;
          if (gy < 0 || gy >= H || gx < 0 || gx >= W) return -1;
          return (((long long)b * H + gy) * W + gx) * Cin;
        },
        tid, F_THREADS);
  };
  // filter rows (tap, ci) of this channel pass; columns co0 .. co0 + NP
  auto load_filter = [&](int ci0) {
    stage_rows<VEC>(
        filt, NPS, w, 9 * CK, NP, co0, Cout,
        [&](int r) -> long long {
          const int tap = r / CK, ci = ci0 + r % CK;
          if (ci >= Cin) return -1;
          return ((long long)tap * Cin + ci) * Cout;
        },
        tid, F_THREADS);
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

  // per-lane parts of the ldmatrix row addresses (see the fragment layouts
  // of mma.m16n8k16): A rows are pixels, 8 channels a 16-byte row; B rows
  // are input channels, 8 output channels a row (read transposed)
  const int a_px = lane & 15, a_k = (lane >> 4) * 8;
  const int b_k = (lane & 7) + ((lane >> 3) & 1) * 8, b_n = (lane >> 4) * 8;
  const uint32_t a_lane = smem_addr(halo + (2 * warp * HW_ + a_px) * CKS +
                                    a_k);
  const uint32_t b_lane = smem_addr(filt + b_k * NPS + b_n);

  for (int s = 0; s < stages; ++s) {
    if (n_ci > 1) load_filter((s % n_ci) * CK);  // filter free since the
    cp_async_commit();                           // last stage's barrier
    if (s + 1 < stages) load_halo(s + 1);
    cp_async_commit();
    cp_async_wait_prev();
    __syncthreads();

    const uint32_t a_base = a_lane + (s & 1) * HALO * CKS * sizeof(bf16);
#pragma unroll
    for (int k0 = 0; k0 < CK; k0 += 16) {
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        // the tap shifts this lane's pixel by (ky, kx): a constant offset
        constexpr int kROW = HW_ * CKS * (int)sizeof(bf16);
        const int ky = tap / 3, kx = tap % 3;
        uint32_t a[2][4];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          ldsm_x4(a[i], a_base + (i + ky) * kROW +
                            (kx * CKS + k0) * (int)sizeof(bf16));
#pragma unroll
        for (int jj = 0; jj < NT / 2; ++jj) {
          uint32_t bq[4];
          ldsm_x4_t(bq, b_lane + ((tap * CK + k0) * NPS + 16 * jj) *
                                     (int)sizeof(bf16));
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            mma_bf16(acc[i][2 * jj], a[i], bq[0], bq[1]);
            mma_bf16(acc[i][2 * jj + 1], a[i], bq[2], bq[3]);
          }
        }
      }
    }

    if (s % n_ci == n_ci - 1) {  // the tile's last channel pass: store
      int b, oy0, ox0;
      tile_of(s, b, oy0, ox0);
      bf16* st = outs + warp * 2 * TW * NPS;  // this warp's two rows
      const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const int p = i * 16 + g, n = j * 8 + 2 * t4;
          *reinterpret_cast<__nv_bfloat162*>(st + p * NPS + n) =
              __floats2bfloat162_rn(acc[i][j][0], acc[i][j][1]);
          *reinterpret_cast<__nv_bfloat162*>(st + (p + 8) * NPS + n) =
              __floats2bfloat162_rn(acc[i][j][2], acc[i][j][3]);
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.f;
        }
      __syncwarp();
      const int nco = min(NP, Cout - co0);
      if (Cout % 8 == 0) {
#pragma unroll
        for (int idx = lane; idx < 2 * TW * NT; idx += 32) {
          const int p = idx / NT, j = idx - p * NT;
          const int oy = oy0 + 2 * warp + p / TW, ox = ox0 + p % TW;
          if (8 * j < nco && oy < H && ox < W)
            *reinterpret_cast<uint4*>(
                y + (((size_t)b * H + oy) * W + ox) * Cout + co0 + 8 * j) =
                *reinterpret_cast<const uint4*>(st + p * NPS + 8 * j);
        }
      } else {
        for (int idx = lane; idx < 2 * TW * nco; idx += 32) {
          const int p = idx / nco, j = idx - p * nco;
          const int oy = oy0 + 2 * warp + p / TW, ox = ox0 + p % TW;
          if (oy < H && ox < W)
            y[(((size_t)b * H + oy) * W + ox) * Cout + co0 + j] =
                st[p * NPS + j];
        }
      }
      __syncwarp();
    }
    __syncthreads();  // stage buffer (and filter) free for the next copies
  }
}

template <int NT, bool VEC>
inline int launch_conv_tc_t(const bf16* x, const bf16* w, bf16* y, int B,
                            int H, int W, int Cin, int Cout, int blocks,
                            cudaStream_t stream) {
  const size_t smem = conv_tc_smem<NT>();
  cudaError_t err = cudaFuncSetAttribute(
      conv3x3_tc_kernel<NT, VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles_x = (W + TW - 1) / TW;
  const int tiles_per_img = tiles_x * ((H + TH - 1) / TH);
  const int n_tiles = B * tiles_per_img;
  dim3 grid(blocks, (Cout + 8 * NT - 1) / (8 * NT));
  conv3x3_tc_kernel<NT, VEC><<<grid, F_THREADS, smem, stream>>>(
      x, w, y, H, W, Cin, Cout, tiles_x, tiles_per_img, n_tiles);
  return static_cast<int>(cudaGetLastError());
}

// ---- K3-b: dk = sum over pixels of shifted x^T . dy ----------------------
//
// Per tap a GEMM of M = Cin, N = Cout, K = B x H x W pixels. A block owns
// all nine taps of a CK = 16 MT input-channel by NP = 8 NT output-channel
// slice of dk (blockIdx.y, blockIdx.z; one slice at 48 -> 48): 9 warps, warp
// = tap, each holding MT x NT m16n8 tiles of f32 sums (72 registers at 48 ->
// 48), so x and dy are read once. The pixels are split into n_chunks fixed
// strided sets of 8 x 16 tiles (chunk c: tiles c, c + n_chunks, ...); each
// block walks its chunk with the next tile's copies in flight, then writes
// its partial dk to part[chunk]; sum_chunks_tc_kernel adds the chunks in a
// fixed order. No atomics: a repeated run gives identical bits.
// Fragments: A = x^T through ldmatrix.trans from the halo (rows = pixels
// shifted by the tap, 8 input channels a row), B = dy through
// ldmatrix.trans (rows = pixels, 8 output channels a row); k16 = one tile
// row of 16 pixels. Pixels outside the image have dy = 0, so a ragged tile
// adds exact zeros.
constexpr int B_THREADS = 9 * 32;

template <int MT, int NT>
__host__ __device__ constexpr size_t wgrad_tc_smem() {
  return sizeof(bf16) * 2 *
         (size_t)(HALO * padded(16 * MT) + TH * TW * padded(8 * NT));
}

template <int MT, int NT, bool VEC>
__global__ void __launch_bounds__(B_THREADS, 2)
wgrad_tc_kernel(const bf16* __restrict__ x, const bf16* __restrict__ dy,
                float* __restrict__ part, int H, int W, int Cin, int Cout,
                int tiles_x, int tiles_per_img, int n_tiles, int n_chunks) {
  constexpr int CK = 16 * MT, NP = 8 * NT;
  constexpr int CKS = padded(CK), NPS = padded(NP);
  constexpr int STAGE = HALO * CKS + TH * TW * NPS;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* stage_buf = reinterpret_cast<bf16*>(smem_raw);  // [2][STAGE]

  const int tid = threadIdx.x, lane = tid & 31, tap = tid >> 5;
  const int ky = tap / 3, kx = tap % 3;
  const int chunk = blockIdx.x;
  const int ci0 = blockIdx.y * CK, co0 = blockIdx.z * NP;
  const int my_tiles =
      chunk < n_tiles ? (n_tiles - 1 - chunk) / n_chunks + 1 : 0;

  auto load_tile = [&](int s) {
    const int t = chunk + s * n_chunks;
    const int b = t / tiles_per_img, r = t - b * tiles_per_img;
    const int oy0 = (r / tiles_x) * TH, ox0 = (r % tiles_x) * TW;
    bf16* hx = stage_buf + (s & 1) * STAGE;
    stage_rows<VEC>(
        hx, CKS, x, HALO, CK, ci0, Cin,
        [&](int p) -> long long {
          const int gy = oy0 - 1 + p / HW_, gx = ox0 - 1 + p % HW_;
          if (gy < 0 || gy >= H || gx < 0 || gx >= W) return -1;
          return (((long long)b * H + gy) * W + gx) * Cin;
        },
        tid, B_THREADS);
    stage_rows<VEC>(
        hx + HALO * CKS, NPS, dy, TH * TW, NP, co0, Cout,
        [&](int p) -> long long {
          const int oy = oy0 + p / TW, ox = ox0 + p % TW;
          if (oy >= H || ox >= W) return -1;
          return (((long long)b * H + oy) * W + ox) * Cout;
        },
        tid, B_THREADS);
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

  // per-lane parts of the ldmatrix.trans row addresses: A rows are pixels
  // (k) with 8 input channels (m) each, shifted by this warp's tap; B rows
  // pixels with 8 output channels (n) each
  const int a_px = (lane & 7) + (lane >> 4) * 8, a_m = ((lane >> 3) & 1) * 8;
  const int b_px = (lane & 7) + ((lane >> 3) & 1) * 8, b_n = (lane >> 4) * 8;
  const uint32_t a_lane =
      smem_addr(stage_buf + (ky * HW_ + kx + a_px) * CKS + a_m);
  const uint32_t b_lane =
      smem_addr(stage_buf + HALO * CKS + b_px * NPS + b_n);
  constexpr int E = sizeof(bf16);

  for (int s = 0; s < my_tiles; ++s) {
    if (s + 1 < my_tiles) load_tile(s + 1);
    cp_async_commit();
    cp_async_wait_prev();
    __syncthreads();

    const uint32_t off = (s & 1) * STAGE * E;
#pragma unroll 1  // unrolled, the 72 sums spill; measured no faster
    for (int r = 0; r < TH; ++r) {  // one k16 step: a tile row of pixels
      uint32_t a[MT][4];
#pragma unroll
      for (int i = 0; i < MT; ++i)
        ldsm_x4_t(a[i], a_lane + off + (r * HW_ * CKS + 16 * i) * E);
#pragma unroll
      for (int jj = 0; jj < NT / 2; ++jj) {
        uint32_t bq[4];
        ldsm_x4_t(bq, b_lane + off + (r * TW * NPS + 16 * jj) * E);
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          mma_bf16(acc[i][2 * jj], a[i], bq[0], bq[1]);
          mma_bf16(acc[i][2 * jj + 1], a[i], bq[2], bq[3]);
        }
      }
    }
    __syncthreads();  // stage buffer free for the next copies
  }

  // this chunk's partial: part[chunk][tap][ci][co]
  const int g = lane >> 2, t4 = lane & 3;
  float* pc = part + ((size_t)chunk * 9 + tap) * Cin * Cout;
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int ci = ci0 + 16 * i + g + (q >> 1) * 8;
        const int co = co0 + 8 * j + 2 * t4 + (q & 1);
        if (ci < Cin && co < Cout) pc[(size_t)ci * Cout + co] = acc[i][j][q];
      }
}

// out[i] = sum over chunks of part[chunk][i] in a fixed order: warp q of a
// block adds chunks q, q + 8, ... for 32 consecutive outputs (coalesced),
// then the eight warp sums are added in warp order.
static __global__ void __launch_bounds__(256)
sum_chunks_tc_kernel(const float* __restrict__ part, int n_chunks, int n,
                     float* __restrict__ out) {
  __shared__ float red[8][32];
  const int lane = threadIdx.x & 31, q = threadIdx.x >> 5;
  const int i = blockIdx.x * 32 + lane;
  float s = 0.f;
  if (i < n)
#pragma unroll 4
    for (int c = q; c < n_chunks; c += 8) s += part[(size_t)c * n + i];
  red[q][lane] = s;
  __syncthreads();
  if (q == 0 && i < n) {
    float t = 0.f;
#pragma unroll
    for (int k = 0; k < 8; ++k) t += red[k][lane];
    out[i] = t;
  }
}

template <int MT, int NT, bool VEC>
inline int launch_wgrad_tc_t(const bf16* x, const bf16* dy, float* part,
                             int B, int H, int W, int Cin, int Cout,
                             int n_chunks, cudaStream_t stream) {
  const size_t smem = wgrad_tc_smem<MT, NT>();
  cudaError_t err = cudaFuncSetAttribute(
      wgrad_tc_kernel<MT, NT, VEC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles_x = (W + TW - 1) / TW;
  const int tiles_per_img = tiles_x * ((H + TH - 1) / TH);
  const int n_tiles = B * tiles_per_img;
  dim3 grid(n_chunks, (Cin + 16 * MT - 1) / (16 * MT),
            (Cout + 8 * NT - 1) / (8 * NT));
  wgrad_tc_kernel<MT, NT, VEC><<<grid, B_THREADS, smem, stream>>>(
      x, dy, part, H, W, Cin, Cout, tiles_x, tiles_per_img, n_tiles,
      n_chunks);
  return static_cast<int>(cudaGetLastError());
}

template <int MT, int NT>
inline int launch_wgrad_tc_v(int vec, const bf16* x, const bf16* dy,
                             float* part, int B, int H, int W, int Cin,
                             int Cout, int n_chunks, cudaStream_t stream) {
  return vec ? launch_wgrad_tc_t<MT, NT, true>(x, dy, part, B, H, W, Cin,
                                               Cout, n_chunks, stream)
             : launch_wgrad_tc_t<MT, NT, false>(x, dy, part, B, H, W, Cin,
                                                Cout, n_chunks, stream);
}

}  // namespace tc
}  // namespace rodt
