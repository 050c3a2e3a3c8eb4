// bf16 kernels of the YOLOv8 P1/P2 front (K2-f, K2-b) and of the stride-2
// convs of the HGNetv2 stem (K4-f, K4-b) on the tensor cores: implicit
// GEMMs on mma.sync.m16n8k16 (bf16 x bf16 -> f32), NHWC in, operands
// staged in shared memory by 16-byte cp.async and read into fragments by
// ldmatrix, with the primitives of conv3x3_tc.cuh. Used by yolo_front.cu,
// yolo_front_bwd.cu, hgstem.cu and hgstem_bwd.cu for bf16; K2's f32 route
// and K4's stride-2 convs run the split-TF32 kernels of front_tf32.cuh
// (which reuse this file's stride-2 geometry) for f32. The channel tiles,
// the activation (SiLU for the front, ReLU for the stem) and the input
// transforms are template parameters; the launchers default to the front's
// instantiation.
//
//   front_p1_kernel      P1: conv3x3/2, 3 -> C1, K = 27 taps x channels
//                        (padded to 32) from an im2col tile built in shared
//                        memory; eval: BN1 + act epilogue; train: y1
//                        rounded to bf16 plus BN1 statistics partials.
//                        The stem's stem1 at C1 = 32.
//   front_p2_kernel      P2: conv3x3/2, C1 -> C2, K3-f's GEMM on a stride-2
//                        halo; train: a1 = round(silu(g1 y1 + b1)) applied
//                        in place to the staged halo, BN2 partials. The
//                        stem's stem3 (64 -> 32, no transform).
//   e2_prep_kernel       e2 = round(dy2 + ds2 + 2 y2 dss2), once, so that
//                        dA1 and dk2 both stage it by cp.async (the stem:
//                        e3, and in place e of its two 2x2 convs).
//   front_da1_tc_kernel  dA1: the transposed stride-2 conv split by the
//                        parity of the y1 pixel into four stride-1 GEMMs
//                        with 1, 2, 2 and 4 taps; BN1 + SiLU chain and
//                        dgamma / dbeta partials in the epilogue (the
//                        stem's d(cat): raw, no chain).
//   front_dk2_tc_kernel  dk2 = sum a1 (x) e2 at stride 2 (K3-b's GEMM);
//                        the stem's dk3 without the input transform.
//   front_dk1_tc_kernel  dk1 = sum im2col(x) (x) e1, e1 = round(dy1 + ds1 +
//                        2 y1 dss1) formed in place in shared memory.
//
// Stride-2 halos. Eight consecutive output columns of one tap read every
// other input column; with one row pitch for all pixels their ldmatrix
// rows would be an even number of 16-byte units apart (2-way bank
// conflicts). So a halo row is stored as two column-parity planes of
// TW + 1 pixels (even columns, then odd ones, the TPU kernel's phase
// split): the eight rows of a phase are consecutive pixels of one plane,
// an odd number of units apart. Pixels outside the image are zero in the
// staged operand, and stay zero after the input transform (zero padding
// in a-space), which touches only pixels inside the image.
//
// Every cross-block sum (statistics, dgamma / dbeta, filter gradients)
// goes through per-block or per-chunk partials whose count P the Python
// plan fixes for a shape and a card (kernels.front_plan,
// kernels.front_bwd_plan), summed in a fixed order: no atomics, identical
// bits run to run.
#pragma once

#include "conv3x3_tc.cuh"
#include "conv_tile.cuh"

namespace rodt {
namespace ftc {

using tc::bf16;
using tc::cp_async16;
using tc::cp_async_commit;
using tc::cp_async_wait_prev;
using tc::ldsm_x4;
using tc::ldsm_x4_t;
using tc::mma_bf16;
using tc::padded;
using tc::smem_addr;
using tc::stage_rows;

constexpr int TH = 8;             // output tile rows (P1, P2, dk1)
constexpr int TW = 16;            // output tile columns (one m16 / k16)
constexpr int PL = TW + 1;        // pixels of a column-parity plane
constexpr int HROW = 2 * PL;      // halo slots a row: even plane, odd plane

// halo column of slot q (0 .. HROW-1) of a row; 2 TW + 1 is a dead slot
__host__ __device__ constexpr int halo_col(int q) {
  return q < PL ? 2 * q : 2 * (q - PL) + 1;
}

// Global element offset of halo slot p of a stride-2 tile whose output
// origin is (oy0, ox0) in image b of an (H, W, C) input, or -1 outside it.
__device__ __forceinline__ long long halo_offset(int p, int b, int oy0,
                                                 int ox0, int H, int W,
                                                 int C) {
  const int r = p / HROW, c = halo_col(p - r * HROW);
  const int gy = 2 * oy0 - 1 + r, gx = 2 * ox0 - 1 + c;
  if (c > 2 * TW || gy < 0 || gy >= H || gx < 0 || gx >= W) return -1;
  return (((long long)b * H + gy) * W + gx) * C;
}

// sigmoid(z) on the SFU (ex2, rcp): within about 1e-6 relative of 1 / (1 +
// expf(-z)) for the |z| < 20 of a BN output, far below the bf16 rounding
// that follows each use; 0 and 1 at the ends.
// The IEEE expf and division cost about five times the instructions, and
// the input transforms below run once for every staged element.
__device__ __forceinline__ float fast_sigmoid(float z) {
  return __fdividef(1.f, 1.f + __expf(-z));
}

// act(z): SiLU on the SFU (fast_sigmoid) or ReLU.
template <int ACT>
__device__ __forceinline__ float act_fast(float z) {
  return ACT == ACT_RELU ? fmaxf(z, 0.f) : z * fast_sigmoid(z);
}

// d act(z) / dz (ReLU: 1 for z > 0, else 0).
template <int ACT>
__device__ __forceinline__ float act_grad(float z) {
  if (ACT == ACT_RELU) return z > 0.f ? 1.f : 0.f;
  const float sg = fast_sigmoid(z);
  return sg * (1.f + z * (1.f - sg));
}

// a = round(act(g y + b)) in place over `rows` staged rows of `ck`
// channels (a multiple of 8; channel c0 + j of C), for the rows that
// valid(r) accepts (pixels inside the image) and the channels below C.
template <int ACT, typename ValidFn>
__device__ __forceinline__ void act_in_place(bf16* buf, int stride,
                                              int rows, int ck, int c0,
                                              int C,
                                              const float* __restrict__ g,
                                              const float* __restrict__ b,
                                              ValidFn valid, int tid,
                                              int nthreads) {
  const int pieces = ck / 8;
  const bool aligned = ((reinterpret_cast<uintptr_t>(g) |
                         reinterpret_cast<uintptr_t>(b)) & 15) == 0;
  for (int i = tid; i < rows * pieces; i += nthreads) {
    const int r = i / pieces, j = i - r * pieces;
    if (!valid(r)) continue;
    const int cb = c0 + 8 * j;
    float gv[8], bv[8];
    if (aligned && cb + 8 <= C) {
      const float4* g4 = reinterpret_cast<const float4*>(g + cb);
      const float4* b4 = reinterpret_cast<const float4*>(b + cb);
      const float4 ga = __ldg(g4), gb = __ldg(g4 + 1);
      const float4 ba = __ldg(b4), bb = __ldg(b4 + 1);
      gv[0] = ga.x; gv[1] = ga.y; gv[2] = ga.z; gv[3] = ga.w;
      gv[4] = gb.x; gv[5] = gb.y; gv[6] = gb.z; gv[7] = gb.w;
      bv[0] = ba.x; bv[1] = ba.y; bv[2] = ba.z; bv[3] = ba.w;
      bv[4] = bb.x; bv[5] = bb.y; bv[6] = bb.z; bv[7] = bb.w;
    } else {
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        gv[k] = cb + k < C ? g[cb + k] : 0.f;
        bv[k] = cb + k < C ? b[cb + k] : 0.f;
      }
    }
    uint4* p = reinterpret_cast<uint4*>(buf + r * stride + 8 * j);
    uint4 u = *p;
    bf16* e = reinterpret_cast<bf16*>(&u);
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      if (cb + k < C) {
        e[k] = __float2bfloat16(
            act_fast<ACT>(__bfloat162float(e[k]) * gv[k] + bv[k]));
      }
    }
    *p = u;
  }
}

// Sums s[NT][2] over the 8 lane groups g of a warp (lanes 4 g + t4), so
// that the lanes with g = 0 hold the warp's sums for channels 8 j + 2 t4 +
// e; fixed order.
template <int NT>
__device__ __forceinline__ void warp_sum_g(float s[NT][2]) {
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e)
#pragma unroll
      for (int off = 4; off < 32; off <<= 1)
        s[j][e] += __shfl_xor_sync(0xffffffffu, s[j][e], off);
}

// ---- x rows and the im2col tile of P1 and dk1 ----------------------------
//
// The 3-channel x rows are 6 bytes a pixel, so ldmatrix cannot read a tap
// in place. A tile stages, for each of its 2 TH + 1 input rows, the x
// elements from 8 before the tile's first input column, (6 ox0 - 8), in
// 13 16-byte pieces (pieces outside the row are zero: VEC needs W a
// multiple of 8, so a piece never straddles two rows); halo column c,
// channel ci is element 3 c + ci + 5 of the staged row. The im2col row of
// output pixel p is its 27 inputs in the HWIO filter's row order (tap-major,
// channel-minor), zero padded to 32.
constexpr int XROWS = 2 * TH + 1;   // staged x rows a tile
constexpr int XR = 104;             // staged x elements a row (13 pieces)
constexpr int KC1 = 32;             // 27 taps x channels, padded
constexpr int KS1 = padded(KC1);    // im2col row pitch, 40

template <bool VEC>
__device__ __forceinline__ void stage_x_rows(bf16* xs,
                                             const bf16* __restrict__ x,
                                             int b, int oy0, int ox0, int H,
                                             int W, int tid, int nthreads) {
  const long long W3 = 3LL * W;
  const long long a = 6LL * ox0 - 8;
  if (VEC) {
    constexpr int PIECES = XR / 8;
    for (int i = tid; i < XROWS * PIECES; i += nthreads) {
      const int r = i / PIECES, j = i - r * PIECES;
      const int gy = 2 * oy0 - 1 + r;
      const long long e = a + 8 * j;
      const bool valid = gy >= 0 && gy < H && e >= 0 && e + 8 <= W3;
      cp_async16(xs + r * XR + 8 * j,
                 valid ? x + ((long long)b * H + gy) * W3 + e : x, valid);
    }
  } else {
    for (int i = tid; i < XROWS * XR; i += nthreads) {
      const int r = i / XR, j = i - r * XR;
      const int gy = 2 * oy0 - 1 + r;
      const long long e = a + j;
      xs[r * XR + j] = (gy >= 0 && gy < H && e >= 0 && e < W3)
                           ? x[((long long)b * H + gy) * W3 + e]
                           : __float2bfloat16(0.f);
    }
  }
}

__device__ __forceinline__ void build_im2col(bf16* col, const bf16* xs,
                                             int tid, int nthreads) {
  const unsigned short* xu = reinterpret_cast<const unsigned short*>(xs);
  for (int p = tid; p < TH * TW; p += nthreads) {
    const int ty = p / TW, tx = p - ty * TW;
    unsigned int v[KC1];
#pragma unroll
    for (int ky = 0; ky < 3; ++ky)
#pragma unroll
      for (int i = 0; i < 9; ++i)
        v[ky * 9 + i] = xu[(2 * ty + ky) * XR + 6 * tx + 5 + i];
#pragma unroll
    for (int i = 27; i < KC1; ++i) v[i] = 0u;
    uint4* dst = reinterpret_cast<uint4*>(col + p * KS1);
#pragma unroll
    for (int q = 0; q < KC1 / 8; ++q)
      dst[q] = make_uint4(v[8 * q] | (v[8 * q + 1] << 16),
                          v[8 * q + 2] | (v[8 * q + 3] << 16),
                          v[8 * q + 4] | (v[8 * q + 5] << 16),
                          v[8 * q + 6] | (v[8 * q + 7] << 16));
  }
}

// Stores a warp's staged [2 TW][pitch] bf16 rows (tile rows row0, row0 + 1;
// channels c0 .. c0 + n - 1 of C) to y (B, Ho, Wo, C): 16-byte pieces when
// C is a multiple of 8, elements otherwise.
__device__ __forceinline__ void store_rows(bf16* __restrict__ y,
                                           const bf16* st, int pitch, int b,
                                           int oy, int ox0, int Ho, int Wo,
                                           int C, int c0, int n, int lane) {
  if (C % 8 == 0) {
    const int pieces = (n + 7) / 8;
    for (int idx = lane; idx < 2 * TW * pieces; idx += 32) {
      const int p = idx / pieces, j = idx - p * pieces;
      const int yy = oy + p / TW, xx = ox0 + p % TW;
      if (yy < Ho && xx < Wo)
        *reinterpret_cast<uint4*>(
            y + (((size_t)b * Ho + yy) * Wo + xx) * C + c0 + 8 * j) =
            *reinterpret_cast<const uint4*>(st + p * pitch + 8 * j);
    }
  } else {
    for (int idx = lane; idx < 2 * TW * n; idx += 32) {
      const int p = idx / n, j = idx - p * n;
      const int yy = oy + p / TW, xx = ox0 + p % TW;
      if (yy < Ho && xx < Wo)
        y[(((size_t)b * Ho + yy) * Wo + xx) * C + c0 + j] = st[p * pitch + j];
    }
  }
}

// ---- P1: y1 = conv3x3/2(x, k1), 3 -> C1 ----------------------------------
//
// GEMM per 8 x 16 tile of y1: M = 128 pixels, N = 8 NT1 output channels
// (a block owns one such slice, blockIdx.y: 48 for the YOLOv8 front, 32
// for the HGNetv2 stem), K = 32. 4 warps, warp w owns tile rows 2w, 2w + 1
// (two m16 tiles) x NT1 n8 tiles. Persistent:
// block i walks tiles i, i + gridDim.x, ...; the filter slice is staged
// once, the next tile's x rows are copied while this tile runs. Eval: y =
// act(g1 acc + b1), the folded BN1 and the activation ACT, in bf16.
// Train: y = round(acc), and
// the block's per-channel sum and sum of squares of the rounded values of
// its pixels inside the image, read from the accumulator fragments (rows
// g, g + 8, columns 2 t4, 2 t4 + 1 of each m16n8 tile), summed over g by
// shuffles and over the warps in order into stats[2][gridDim.x][C1].
constexpr int P1_THREADS = 128;

template <int NT1>
__host__ __device__ constexpr size_t p1_smem() {
  return sizeof(bf16) * (size_t)(2 * XROWS * XR + TH * TW * KS1 +
                                 KC1 * padded(8 * NT1) +
                                 4 * 2 * TW * padded(8 * NT1));
}

template <bool TRAIN, bool VEC, int NT1, int ACT>
__global__ void __launch_bounds__(P1_THREADS)
front_p1_kernel(const bf16* __restrict__ x, const bf16* __restrict__ k1,
                const float* __restrict__ g1, const float* __restrict__ b1,
                bf16* __restrict__ y, float* __restrict__ stats, int H, int W,
                int Ho, int Wo, int C1, int tiles_x, int tiles_per_img,
                int n_tiles) {
  constexpr int NP1 = 8 * NT1;       // output channels a block
  constexpr int NPS1 = padded(NP1);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* xs = reinterpret_cast<bf16*>(smem_raw);  // [2][XROWS][XR]
  bf16* col = xs + 2 * XROWS * XR;                // [TH TW][KS1]
  bf16* filt = col + TH * TW * KS1;               // [KC1][NPS1]
  bf16* outs = filt + KC1 * NPS1;                 // [4][2 TW][NPS1]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int co0 = blockIdx.y * NP1;
  const int nco = min(NP1, C1 - co0);
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
    stage_x_rows<VEC>(xs + (s & 1) * XROWS * XR, x, b, oy0, ox0, H, W, tid,
                      P1_THREADS);
  };

  // filter rows k = (ky 3 + kx) 3 + ci of k1 (HWIO), rows 27..31 zero
  stage_rows<VEC>(
      filt, NPS1, k1, KC1, NP1, co0, C1,
      [&](int r) -> long long { return r < 27 ? (long long)r * C1 : -1; },
      tid, P1_THREADS);
  if (my_tiles > 0) load_x(0);
  cp_async_commit();

  // this thread's channels 8 j + 2 t4 + e: the eval fold, the statistics
  float gv[NT1][2], bv[NT1][2], s1[NT1][2], s2[NT1][2];
#pragma unroll
  for (int j = 0; j < NT1; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int c = co0 + 8 * j + 2 * t4 + e;
      gv[j][e] = (!TRAIN && c < C1) ? g1[c] : 0.f;
      bv[j][e] = (!TRAIN && c < C1) ? b1[c] : 0.f;
      s1[j][e] = 0.f;
      s2[j][e] = 0.f;
    }

  // per-lane ldmatrix row addresses: A rows are pixels (k contiguous), B
  // rows are k (8 output channels a row, read transposed)
  const int a_px = lane & 15, a_k = (lane >> 4) * 8;
  const int b_k = (lane & 7) + ((lane >> 3) & 1) * 8, b_n = (lane >> 4) * 8;
  const uint32_t a_lane = smem_addr(col + (2 * warp * TW + a_px) * KS1 + a_k);
  const uint32_t b_lane = smem_addr(filt + b_k * NPS1 + b_n);
  constexpr int E = sizeof(bf16);

  for (int s = 0; s < my_tiles; ++s) {
    if (s + 1 < my_tiles) load_x(s + 1);
    cp_async_commit();
    cp_async_wait_prev();
    __syncthreads();
    build_im2col(col, xs + (s & 1) * XROWS * XR, tid, P1_THREADS);
    __syncthreads();

    float acc[2][NT1][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < NT1; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.f;
#pragma unroll
    for (int k0 = 0; k0 < KC1; k0 += 16) {
      uint32_t a[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        ldsm_x4(a[i], a_lane + (i * TW * KS1 + k0) * E);
#pragma unroll
      for (int jj = 0; jj < NT1 / 2; ++jj) {
        uint32_t bq[4];
        ldsm_x4_t(bq, b_lane + (k0 * NPS1 + 16 * jj) * E);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          mma_bf16(acc[i][2 * jj], a[i], bq[0], bq[1]);
          mma_bf16(acc[i][2 * jj + 1], a[i], bq[2], bq[3]);
        }
      }
    }

    int b, oy0, ox0;
    tile_of(s, b, oy0, ox0);
    bf16* st = outs + warp * 2 * TW * NPS1;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const bool row_ok = oy0 + 2 * warp + i < Ho;
#pragma unroll
      for (int j = 0; j < NT1; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float v0 = acc[i][j][2 * h], v1 = acc[i][j][2 * h + 1];
          if (!TRAIN) {
            v0 = act_fast<ACT>(v0 * gv[j][0] + bv[j][0]);
            v1 = act_fast<ACT>(v1 * gv[j][1] + bv[j][1]);
          }
          const __nv_bfloat162 t = __floats2bfloat162_rn(v0, v1);
          *reinterpret_cast<__nv_bfloat162*>(
              st + (i * TW + g + 8 * h) * NPS1 + 8 * j + 2 * t4) = t;
          if (TRAIN && row_ok && ox0 + g + 8 * h < Wo) {
            const float r0 = __bfloat162float(t.x);
            const float r1 = __bfloat162float(t.y);
            if (8 * j + 2 * t4 < nco) {
              s1[j][0] += r0;
              s2[j][0] = fmaf(r0, r0, s2[j][0]);
            }
            if (8 * j + 2 * t4 + 1 < nco) {
              s1[j][1] += r1;
              s2[j][1] = fmaf(r1, r1, s2[j][1]);
            }
          }
        }
    }
    __syncwarp();
    store_rows(y, st, NPS1, b, oy0 + 2 * warp, ox0, Ho, Wo, C1, co0, nco,
               lane);
    __syncthreads();  // col, the x stage and outs free for the next tile
  }

  if (TRAIN) {
    __shared__ float red[4][2][NP1];
    warp_sum_g<NT1>(s1);
    warp_sum_g<NT1>(s2);
    if (g == 0)
#pragma unroll
      for (int j = 0; j < NT1; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          red[warp][0][8 * j + 2 * t4 + e] = s1[j][e];
          red[warp][1][8 * j + 2 * t4 + e] = s2[j][e];
        }
    __syncthreads();
    if (tid < 2 * NP1) {
      const int which = tid / NP1, c = tid - which * NP1;
      float t = 0.f;
      for (int w = 0; w < 4; ++w) t += red[w][which][c];
      if (c < nco)
        stats[((size_t)which * n_blk + blk) * C1 + co0 + c] = t;
    }
  }
}

// ---- P2: y2 = conv3x3/2(a1, k2), C1 -> C2 --------------------------------
//
// K3-f's GEMM (conv3x3_tc.cuh) on a stride-2 halo: per 8 x 16 tile of y2,
// M = 128 pixels, N = NP output channels (a block owns one NP-channel
// slice, blockIdx.y), K = 9 taps x Cin, taken CK input channels a pass. 8
// warps: warp w owns tile rows 2 (w & 3), 2 (w & 3) + 1 (two m16 tiles) x
// the NP / 16 n8 tiles of channel half w >> 2, so the halo is staged (and
// transformed) once for all NP channels. A tap (ky, kx) is a constant
// offset of the per-lane row addresses into the parity-plane halo.
// Persistent, one block an SM (two halo stages and the filter slice), the
// next stage's halo in flight under this one's MMAs. TRANSFORM: after a
// stage lands, a1 = round(act(g1 y1 + b1)) in place for the pixels inside
// the image (the YOLOv8 front's train mode; the stem's concat is stored
// activated). STATS: the batch statistics of the rounded y2 come out of
// the epilogue as in P1. The epilogue stages its rows in the halo buffer
// the MMAs just finished with. Instantiations: the YOLOv8 front, CK 48, NP
// 96, SiLU (TRANSFORM = STATS = train mode); the stem's stem3, 64 -> 32,
// CK 64, NP 32, no transform, STATS in train mode.
constexpr int P2_THREADS = 256;
constexpr int HALO2 = (2 * TH + 1) * HROW;  // 578 slots

template <int CK, int NP>
__host__ __device__ constexpr size_t p2_smem() {
  return sizeof(bf16) *
         (size_t)(2 * HALO2 * padded(CK) + 9 * CK * padded(NP));
}

template <bool TRANSFORM, bool STATS, bool VEC, int CK, int NP, int ACT>
__global__ void __launch_bounds__(P2_THREADS, 1)
front_p2_kernel(const bf16* __restrict__ a, const bf16* __restrict__ k2,
                const float* __restrict__ g1, const float* __restrict__ b1,
                bf16* __restrict__ y, float* __restrict__ stats, int H, int W,
                int Ho, int Wo, int Cin, int Cout, int tiles_x,
                int tiles_per_img, int n_tiles) {
  constexpr int CKS = padded(CK), NPS = padded(NP);
  constexpr int HALF = NP / 2;   // output channels a warp
  constexpr int NT = HALF / 8;   // n8 tiles a warp
  static_assert(CK % 16 == 0 && NP % 32 == 0 && HALF <= CKS, "P2 tiles");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* halo = reinterpret_cast<bf16*>(smem_raw);  // [2][HALO2][CKS]
  bf16* filt = halo + 2 * HALO2 * CKS;              // [9][CK][NPS]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp & 3, wn = warp >> 2;
  const int g = lane >> 2, t4 = lane & 3;
  const int co0 = blockIdx.y * NP;
  const int cw0 = co0 + HALF * wn;  // this warp's first output channel
  const int nco = max(0, min(HALF, Cout - cw0));
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
    stage_rows<VEC>(
        halo + (s & 1) * HALO2 * CKS, CKS, a, HALO2, CK, (s % n_ci) * CK,
        Cin, [&](int p) { return halo_offset(p, b, oy0, ox0, H, W, Cin); },
        tid, P2_THREADS);
  };
  auto load_filter = [&](int ci0) {
    stage_rows<VEC>(
        filt, NPS, k2, 9 * CK, NP, co0, Cout,
        [&](int r) -> long long {
          const int tap = r / CK, ci = ci0 + r % CK;
          if (ci >= Cin) return -1;
          return ((long long)tap * Cin + ci) * Cout;
        },
        tid, P2_THREADS);
  };

  float acc[2][NT][4], s1[NT][2], s2[NT][2];
#pragma unroll
  for (int j = 0; j < NT; ++j) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.f;
#pragma unroll
    for (int e = 0; e < 2; ++e) s1[j][e] = s2[j][e] = 0.f;
  }

  if (n_ci == 1) load_filter(0);
  if (stages > 0) load_halo(0);
  cp_async_commit();

  const int a_px = lane & 15, a_k = (lane >> 4) * 8;
  const int b_k = (lane & 7) + ((lane >> 3) & 1) * 8, b_n = (lane >> 4) * 8;
  // output row 2 wm + i, tap ky reads halo row 4 wm + 2 i + ky
  const uint32_t a_lane =
      smem_addr(halo + (4 * wm * HROW + a_px) * CKS + a_k);
  const uint32_t b_lane = smem_addr(filt + b_k * NPS + HALF * wn + b_n);
  constexpr int E = sizeof(bf16);

  for (int s = 0; s < stages; ++s) {
    if (n_ci > 1) load_filter((s % n_ci) * CK);  // free since the last
    cp_async_commit();                           // stage's barrier
    if (s + 1 < stages) load_halo(s + 1);
    cp_async_commit();
    cp_async_wait_prev();
    __syncthreads();

    int b, oy0, ox0;
    tile_of(s, b, oy0, ox0);
    bf16* cur = halo + (s & 1) * HALO2 * CKS;
    if (TRANSFORM) {
      act_in_place<ACT>(
          cur, CKS, HALO2, CK, (s % n_ci) * CK, Cin, g1, b1,
          [&](int p) { return halo_offset(p, b, oy0, ox0, H, W, 1) >= 0; },
          tid, P2_THREADS);
      __syncthreads();
    }

    const uint32_t a_base = a_lane + (s & 1) * HALO2 * CKS * E;
#pragma unroll
    for (int k0 = 0; k0 < CK; k0 += 16) {
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        const int ky = tap / 3, kx = tap % 3;
        uint32_t af[2][4];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          ldsm_x4(af[i], a_base + (((2 * i + ky) * HROW + (kx & 1) * PL +
                                    (kx >> 1)) * CKS + k0) * E);
#pragma unroll
        for (int jj = 0; jj < NT / 2; ++jj) {
          uint32_t bq[4];
          ldsm_x4_t(bq, b_lane + ((tap * CK + k0) * NPS + 16 * jj) * E);
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            mma_bf16(acc[i][2 * jj], af[i], bq[0], bq[1]);
            mma_bf16(acc[i][2 * jj + 1], af[i], bq[2], bq[3]);
          }
        }
      }
    }

    if (s % n_ci == n_ci - 1) {  // the tile's last channel pass: store
      __syncthreads();            // every warp is done reading `cur`
      bf16* st = cur + warp * 2 * TW * CKS;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const bool row_ok = oy0 + 2 * wm + i < Ho;
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const __nv_bfloat162 t = __floats2bfloat162_rn(
                acc[i][j][2 * h], acc[i][j][2 * h + 1]);
            *reinterpret_cast<__nv_bfloat162*>(
                st + (i * TW + g + 8 * h) * CKS + 8 * j + 2 * t4) = t;
            if (STATS && row_ok && ox0 + g + 8 * h < Wo) {
              const float r0 = __bfloat162float(t.x);
              const float r1 = __bfloat162float(t.y);
              if (8 * j + 2 * t4 < nco) {
                s1[j][0] += r0;
                s2[j][0] = fmaf(r0, r0, s2[j][0]);
              }
              if (8 * j + 2 * t4 + 1 < nco) {
                s1[j][1] += r1;
                s2[j][1] = fmaf(r1, r1, s2[j][1]);
              }
            }
#pragma unroll
            for (int q = 0; q < 2; ++q) acc[i][j][2 * h + q] = 0.f;
          }
      }
      __syncwarp();
      if (nco > 0)
        store_rows(y, st, CKS, b, oy0 + 2 * wm, ox0, Ho, Wo, Cout, cw0, nco,
                   lane);
    }
    __syncthreads();  // stage buffer (and filter) free for the next copies
  }

  if (STATS) {
    __shared__ float red[8][2][HALF];
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
    if (tid < 2 * NP) {
      const int which = tid / NP, c = tid - which * NP;
      const int h = c / HALF, cc = c - HALF * h;
      float t = 0.f;
      for (int w = 0; w < 4; ++w) t += red[4 * h + w][which][cc];
      if (co0 + c < Cout)
        stats[((size_t)which * n_blk + blk) * Cout + co0 + c] = t;
    }
  }
}

// ---- K2-b: e2 = round(dy2 + ds2 + 2 y2 dss2) ------------------------------
// The BN2 statistics cotangent folded into y2's, rounded once to bf16.
// VEC: 8 channels a thread with 16-byte loads and stores.
template <bool VEC>
__global__ void __launch_bounds__(256)
e2_prep_kernel(const bf16* __restrict__ dy2, const bf16* __restrict__ y2,
               const float* __restrict__ ds2, const float* __restrict__ dss2,
               bf16* __restrict__ e2, long long n, int C2) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long i0 = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (VEC) {
    for (long long i = i0; i < n / 8; i += stride) {
      const uint4 du = reinterpret_cast<const uint4*>(dy2)[i];
      const uint4 yu = reinterpret_cast<const uint4*>(y2)[i];
      const bf16* d = reinterpret_cast<const bf16*>(&du);
      const bf16* yv = reinterpret_cast<const bf16*>(&yu);
      uint4 out;
      bf16* o = reinterpret_cast<bf16*>(&out);
      const int c0 = (int)((8 * i) % C2);
#pragma unroll
      for (int k = 0; k < 8; ++k)
        o[k] = __float2bfloat16(__bfloat162float(d[k]) + ds2[c0 + k] +
                                2.f * __bfloat162float(yv[k]) * dss2[c0 + k]);
      reinterpret_cast<uint4*>(e2)[i] = out;
    }
  } else {
    for (long long i = i0; i < n; i += stride) {
      const int c = (int)(i % C2);
      e2[i] = __float2bfloat16(__bfloat162float(dy2[i]) + ds2[c] +
                               2.f * __bfloat162float(y2[i]) * dss2[c]);
    }
  }
}

// ---- K2-b: dA1, the transposed stride-2 conv, and the BN1 + SiLU chain ---
//
// dA1[iy, ix, c1] = sum over taps and c2 of e2[oy, ox, c2] k2[ky, kx, c1, c2]
// with iy = 2 oy - 1 + ky (columns likewise). By the parity of iy, an even
// row takes tap ky = 1 from e2 row iy / 2, an odd one taps 0 and 2 from
// rows (iy + 1) / 2 and (iy - 1) / 2: so a block's y1 tile of 2 DU x 2 DV
// pixels splits into four classes (row parity, column parity) of DU x DV
// pixels, each a stride-1 GEMM over one shared (DU + 1) x (DV + 1) patch of
// e2 with 1, 2, 2 or 4 taps: M = DV pixels a class row, N = ND y1 channels
// (blockIdx.y slice), K = taps x C2, taken KD e2 channels a pass. 8 warps,
// warp u owns class row u of all four classes (4 x ND / 8 n8 tiles: 96 f32
// sums a thread at ND 48); B = k2 as stored, rows (tap, c1) with c2
// contiguous, read by ldmatrix without transposition. Persistent, the next
// patch in flight under this one's MMAs; the filter slice is staged once
// when C2 <= KD. Epilogue per class through a per-warp buffer of 16 pixels
// stored by 16-byte pieces. CHAIN (the YOLOv8 front: KD 96, ND 48, SiLU):
// y1 at its 16 pixels by 16-byte loads into that buffer, dpre = dA1
// act'(z1), z1 = g1 y1 + b1, dy1 = round(dpre g1) written back in place,
// dgamma += dpre y1, dbeta += dpre over the pixels inside the image, summed
// as P1's statistics into gpart[2][gridDim.x][C1]. Without CHAIN (the
// stem's stem3: d(cat) from e3, KD 32, ND 32, two slices of the 64 concat
// channels) the rounded dA1 itself is stored.
constexpr int DA_THREADS = 256;
constexpr int DU = 8, DV = 16;            // class rows, class columns
constexpr int PC = DV + 1;                // patch columns
constexpr int PATCH = (DU + 1) * PC;      // patch pixels, 153

template <int KD, int ND>
__host__ __device__ constexpr size_t da1_smem() {
  return sizeof(bf16) * (size_t)(2 * PATCH * padded(KD) +
                                 9 * ND * padded(KD) + 8 * DV * padded(ND));
}

template <bool CHAIN, bool VEC, int KD, int ND, int ACT>
__global__ void __launch_bounds__(DA_THREADS, 1)
front_da1_tc_kernel(const bf16* __restrict__ e2, const bf16* __restrict__ k2,
                    const bf16* __restrict__ y1, const float* __restrict__ g1,
                    const float* __restrict__ b1, bf16* __restrict__ dy1,
                    float* __restrict__ gpart, int H2, int W2, int H4, int W4,
                    int C1, int C2, int tiles_x, int tiles_per_img,
                    int n_tiles) {
  constexpr int NT = ND / 8;
  constexpr int KDS = padded(KD), YS = padded(ND);
  static_assert(KD % 16 == 0 && ND % 16 == 0, "dA1 tiles");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* patch = reinterpret_cast<bf16*>(smem_raw);  // [2][PATCH][KDS]
  bf16* filt = patch + 2 * PATCH * KDS;              // [9][ND][KDS]
  bf16* ybuf = filt + 9 * ND * KDS;                  // [8][DV][YS]
  __shared__ float gs[ND], bs[ND];

  const int tid = threadIdx.x, lane = tid & 31, u = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int c10 = blockIdx.y * ND;
  const int nc1 = min(ND, C1 - c10);
  const int n_c2 = (C2 + KD - 1) / KD;
  const int blk = blockIdx.x, n_blk = gridDim.x;
  const int my_tiles = blk < n_tiles ? (n_tiles - 1 - blk) / n_blk + 1 : 0;
  const int stages = my_tiles * n_c2;
  if (CHAIN && tid < ND) {
    gs[tid] = tid < nc1 ? g1[c10 + tid] : 0.f;
    bs[tid] = tid < nc1 ? b1[c10 + tid] : 0.f;
  }

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
        patch + (s & 1) * PATCH * KDS, KDS, e2, PATCH, KD, (s % n_c2) * KD,
        C2,
        [&](int p) -> long long {
          const int oy = oy0 + p / PC, ox = ox0 + p % PC;
          if (oy >= H4 || ox >= W4) return -1;
          return (((long long)b * H4 + oy) * W4 + ox) * C2;
        },
        tid, DA_THREADS);
  };
  auto load_filter = [&](int c20) {
    stage_rows<VEC>(
        filt, KDS, k2, 9 * ND, KD, c20, C2,
        [&](int r) -> long long {
          const int tap = r / ND, c1 = c10 + r % ND;
          if (c1 >= C1) return -1;
          return ((long long)tap * C1 + c1) * C2;
        },
        tid, DA_THREADS);
  };

  float acc[4][NT][4], dg[NT][2], db[NT][2];
#pragma unroll
  for (int j = 0; j < NT; ++j) {
#pragma unroll
    for (int k = 0; k < 4; ++k)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[k][j][q] = 0.f;
#pragma unroll
    for (int e = 0; e < 2; ++e) dg[j][e] = db[j][e] = 0.f;
  }

  if (n_c2 == 1) load_filter(0);
  if (stages > 0) load_patch(0);
  cp_async_commit();

  // A rows: patch pixels (c2 contiguous); B rows: (tap, c1), c2 contiguous
  const int a_px = lane & 15, a_k = (lane >> 4) * 8;
  const int b_n = (lane & 7) + (lane >> 4) * 8, b_k = ((lane >> 3) & 1) * 8;
  const uint32_t a_lane = smem_addr(patch + (u * PC + a_px) * KDS + a_k);
  const uint32_t b_lane = smem_addr(filt + b_n * KDS + b_k);
  constexpr int E = sizeof(bf16);
  bf16* yb = ybuf + u * DV * YS;

  for (int s = 0; s < stages; ++s) {
    if (n_c2 > 1) load_filter((s % n_c2) * KD);
    cp_async_commit();
    if (s + 1 < stages) load_patch(s + 1);
    cp_async_commit();
    cp_async_wait_prev();
    __syncthreads();

    const uint32_t a_base = a_lane + (s & 1) * PATCH * KDS * E;
#pragma unroll
    for (int k0 = 0; k0 < KD; k0 += 16) {
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        const int ky = tap / 3, kx = tap % 3;
        const int cls = (ky != 1) * 2 + (kx != 1);  // (row, column) parity
        const int dr = ky == 0, dc = kx == 0;       // patch shift
        uint32_t af[4];
        ldsm_x4(af, a_base + ((dr * PC + dc) * KDS + k0) * E);
#pragma unroll
        for (int jj = 0; jj < NT / 2; ++jj) {
          uint32_t bq[4];
          ldsm_x4(bq, b_lane + ((tap * ND + 16 * jj) * KDS + k0) * E);
          mma_bf16(acc[cls][2 * jj], af, bq[0], bq[1]);
          mma_bf16(acc[cls][2 * jj + 1], af, bq[2], bq[3]);
        }
      }
    }

    if (s % n_c2 == n_c2 - 1) {  // the tile's last pass: the epilogue
      int b, iy0, ix0;
      tile_of(s, b, iy0, ix0);
#pragma unroll
      for (int cls = 0; cls < 4; ++cls) {
        const int py = cls >> 1, px = cls & 1;
        const int iy = iy0 + 2 * u + py;
        const size_t row = ((size_t)b * H2 + iy) * W2;
        if (CHAIN) {
          if (VEC) {
            for (int idx = lane; idx < DV * NT; idx += 32) {
              const int v = idx / NT, j = idx - v * NT;
              const int ix = ix0 + 2 * v + px;
              uint4 val = make_uint4(0u, 0u, 0u, 0u);
              if (iy < H2 && ix < W2 && 8 * j < nc1)
                val = *reinterpret_cast<const uint4*>(
                    y1 + (row + ix) * C1 + c10 + 8 * j);
              *reinterpret_cast<uint4*>(yb + v * YS + 8 * j) = val;
            }
          } else {
            for (int idx = lane; idx < DV * ND; idx += 32) {
              const int v = idx / ND, c = idx - v * ND;
              const int ix = ix0 + 2 * v + px;
              yb[v * YS + c] = (iy < H2 && ix < W2 && c < nc1)
                                   ? y1[(row + ix) * C1 + c10 + c]
                                   : __float2bfloat16(0.f);
            }
          }
          __syncwarp();
        }
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int v = g + 8 * h;
            const bool pix_ok = iy < H2 && ix0 + 2 * v + px < W2;
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int c = 8 * j + 2 * t4 + e;
              if (CHAIN) {
                const float yv = __bfloat162float(yb[v * YS + c]);
                const float z = yv * gs[c] + bs[c];
                const float dpre = acc[cls][j][2 * h + e] * act_grad<ACT>(z);
                yb[v * YS + c] = __float2bfloat16(dpre * gs[c]);
                if (pix_ok && c < nc1) {
                  dg[j][e] = fmaf(dpre, yv, dg[j][e]);
                  db[j][e] += dpre;
                }
              } else {
                yb[v * YS + c] = __float2bfloat16(acc[cls][j][2 * h + e]);
              }
              acc[cls][j][2 * h + e] = 0.f;
            }
          }
        __syncwarp();
        if (VEC) {
          for (int idx = lane; idx < DV * NT; idx += 32) {
            const int v = idx / NT, j = idx - v * NT;
            const int ix = ix0 + 2 * v + px;
            if (iy < H2 && ix < W2 && 8 * j < nc1)
              *reinterpret_cast<uint4*>(dy1 + (row + ix) * C1 + c10 + 8 * j) =
                  *reinterpret_cast<const uint4*>(yb + v * YS + 8 * j);
          }
        } else {
          for (int idx = lane; idx < DV * ND; idx += 32) {
            const int v = idx / ND, c = idx - v * ND;
            const int ix = ix0 + 2 * v + px;
            if (iy < H2 && ix < W2 && c < nc1)
              dy1[(row + ix) * C1 + c10 + c] = yb[v * YS + c];
          }
        }
        __syncwarp();
      }
    }
    __syncthreads();  // patch buffer (and filter) free for the next copies
  }

  if (CHAIN) {
    __shared__ float red[8][2][ND];
    warp_sum_g<NT>(dg);
    warp_sum_g<NT>(db);
    if (g == 0)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          red[u][0][8 * j + 2 * t4 + e] = dg[j][e];
          red[u][1][8 * j + 2 * t4 + e] = db[j][e];
        }
    __syncthreads();
    if (tid < 2 * ND) {
      const int which = tid / ND, c = tid - which * ND;
      float t = 0.f;
      for (int w = 0; w < 8; ++w) t += red[w][which][c];
      if (c < nc1) gpart[((size_t)which * n_blk + blk) * C1 + c10 + c] = t;
    }
  }
}

// ---- K2-b: dk2 = sum over y2 pixels of a1 (x) e2 at stride 2 -------------
//
// K3-b's GEMM (conv3x3_tc.cuh wgrad_tc_kernel) on a stride-2 halo: per tap
// M = 16 MT y1 channels (blockIdx.y slice), N = 8 NT y2 channels
// (blockIdx.z slice), K = the y2 pixels. 9 warps, warp = tap, MT x NT
// m16n8 tiles of f32 sums each. The pixels are cut into 4 x 16 tiles of y2
// (4 k16 steps) split into n_chunks fixed strided sets; a tile stages its
// (9 x 33)-pixel halo of y1 in parity planes and its e2 rows by cp.async,
// then, with TRANSFORM, a1 = round(act(g1 y1 + b1)) in place for the pixels
// inside the image. Each block writes its partial to
// part[chunk][tap][c1][c2]; sum_chunks_tc_kernel adds the chunks in a fixed
// order. Instantiations: the YOLOv8 front's dk2 (MT 3, NT 6: 48 x 48
// slices, SiLU transform) and the stem's dk3 (MT 4, NT 4: all 64 concat x
// 32 y3 channels in one block, no transform: the concat is stored
// activated).
constexpr int DK_THREADS = 9 * 32;
constexpr int DK_TH = 4;                       // y2 rows a tile
constexpr int DK_HALO = (2 * DK_TH + 1) * HROW;  // 306 slots

template <int MT, int NT>
__host__ __device__ constexpr int dk2_stage() {
  return DK_HALO * padded(16 * MT) + DK_TH * TW * padded(8 * NT);
}

template <int MT, int NT>
__host__ __device__ constexpr size_t dk2_smem() {
  return sizeof(bf16) * 2 * (size_t)dk2_stage<MT, NT>();
}

template <bool TRANSFORM, bool VEC, int MT, int NT, int ACT>
__global__ void __launch_bounds__(DK_THREADS, 2)
front_dk2_tc_kernel(const bf16* __restrict__ y1, const bf16* __restrict__ e2,
                    const float* __restrict__ g1, const float* __restrict__ b1,
                    float* __restrict__ part, int H2, int W2, int H4, int W4,
                    int C1, int C2, int tiles_x, int tiles_per_img,
                    int n_tiles, int n_chunks) {
  constexpr int CA = 16 * MT, CB = 8 * NT;   // channels a block, each way
  constexpr int CAS = padded(CA), CBS = padded(CB);
  constexpr int STAGE = dk2_stage<MT, NT>();
  static_assert(NT % 2 == 0, "dk2 tiles");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* stage_buf = reinterpret_cast<bf16*>(smem_raw);  // [2][STAGE]

  const int tid = threadIdx.x, lane = tid & 31, tap = tid >> 5;
  const int ky = tap / 3, kx = tap % 3;
  const int chunk = blockIdx.x;
  const int ci0 = blockIdx.y * CA, co0 = blockIdx.z * CB;
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
    bf16* hx = stage_buf + (s & 1) * STAGE;
    stage_rows<VEC>(
        hx, CAS, y1, DK_HALO, CA, ci0, C1,
        [&](int p) { return halo_offset(p, b, oy0, ox0, H2, W2, C1); }, tid,
        DK_THREADS);
    stage_rows<VEC>(
        hx + DK_HALO * CAS, CBS, e2, DK_TH * TW, CB, co0, C2,
        [&](int p) -> long long {
          const int oy = oy0 + p / TW, ox = ox0 + p % TW;
          if (oy >= H4 || ox >= W4) return -1;
          return (((long long)b * H4 + oy) * W4 + ox) * C2;
        },
        tid, DK_THREADS);
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

  // A = a1^T through ldmatrix.trans: rows are the tap-shifted halo pixels
  // of 8 consecutive output columns (consecutive slots of one plane); B =
  // e2 through ldmatrix.trans, rows pixels
  const int a_px = (lane & 7) + (lane >> 4) * 8, a_m = ((lane >> 3) & 1) * 8;
  const int b_px = (lane & 7) + ((lane >> 3) & 1) * 8, b_n = (lane >> 4) * 8;
  const uint32_t a_lane = smem_addr(
      stage_buf + (ky * HROW + (kx & 1) * PL + (kx >> 1) + a_px) * CAS +
      a_m);
  const uint32_t b_lane =
      smem_addr(stage_buf + DK_HALO * CAS + b_px * CBS + b_n);
  constexpr int E = sizeof(bf16);

  for (int s = 0; s < my_tiles; ++s) {
    if (s + 1 < my_tiles) load_tile(s + 1);
    cp_async_commit();
    cp_async_wait_prev();
    __syncthreads();
    if (TRANSFORM) {
      int b, oy0, ox0;
      tile_of(s, b, oy0, ox0);
      act_in_place<ACT>(
          stage_buf + (s & 1) * STAGE, CAS, DK_HALO, CA, ci0, C1, g1, b1,
          [&](int p) { return halo_offset(p, b, oy0, ox0, H2, W2, 1) >= 0; },
          tid, DK_THREADS);
      __syncthreads();
    }

    const uint32_t off = (s & 1) * STAGE * E;
#pragma unroll 1
    for (int r = 0; r < DK_TH; ++r) {  // one k16 step: a tile row of y2
      uint32_t a[MT][4];
#pragma unroll
      for (int i = 0; i < MT; ++i)
        ldsm_x4_t(a[i], a_lane + off + (2 * r * HROW * CAS + 16 * i) * E);
#pragma unroll
      for (int jj = 0; jj < NT / 2; ++jj) {
        uint32_t bq[4];
        ldsm_x4_t(bq, b_lane + off + (r * TW * CBS + 16 * jj) * E);
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          mma_bf16(acc[i][2 * jj], a[i], bq[0], bq[1]);
          mma_bf16(acc[i][2 * jj + 1], a[i], bq[2], bq[3]);
        }
      }
    }
    __syncthreads();  // stage buffer free for the next copies
  }

  const int g = lane >> 2, t4 = lane & 3;
  float* pc = part + ((size_t)chunk * 9 + tap) * C1 * C2;
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int ci = ci0 + 16 * i + g + (q >> 1) * 8;
        const int co = co0 + 8 * j + 2 * t4 + (q & 1);
        if (ci < C1 && co < C2) pc[(size_t)ci * C2 + co] = acc[i][j][q];
      }
}

// ---- K2-b: dk1 = sum over y1 pixels of im2col(x) (x) e1 -------------------
//
// M = 32 (the 27 im2col columns, padded), N = NC y1 channels (blockIdx.y
// slice: 48 for the YOLOv8 front, 32 for the stem), K = the y1 pixels, in 8 x 16 tiles split into n_chunks fixed
// strided sets. A tile stages its x rows, dy1 and y1 by 16-byte cp.async,
// builds the im2col tile as P1 does, and forms e1 = round(dy1 + ds1 + 2 y1
// dss1) in place over dy1's rows (zero outside the image). 4 warps, warp w
// takes tile rows 2w, 2w + 1 (two k16 steps) and keeps 2 x NC / 8 m16n8
// tiles of f32 sums; at the end the four warps' sums are added in order and the
// block writes part[chunk][27][C1], summed by sum_chunks_tc_kernel.
constexpr int K1_THREADS = 128;

template <int NC>
__host__ __device__ constexpr size_t dk1_smem() {
  return sizeof(bf16) * (size_t)(2 * XROWS * XR + TH * TW * KS1 +
                                 2 * 2 * TH * TW * padded(NC));
}

template <bool VEC, int NC>
__global__ void __launch_bounds__(K1_THREADS)
front_dk1_tc_kernel(const bf16* __restrict__ x, const bf16* __restrict__ dy1,
                    const bf16* __restrict__ y1,
                    const float* __restrict__ ds1,
                    const float* __restrict__ dss1, float* __restrict__ part,
                    int H, int W, int H2, int W2, int C1, int tiles_x,
                    int tiles_per_img, int n_tiles, int n_chunks) {
  constexpr int NT = NC / 8, PIX = TH * TW, K1_CS = padded(NC);
  static_assert(NC % 16 == 0 && 4 * 32 * NC * 4 <= 2 * 2 * PIX * K1_CS * 2,
                "dk1 tiles");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* xs = reinterpret_cast<bf16*>(smem_raw);  // [2][XROWS][XR]
  bf16* col = xs + 2 * XROWS * XR;                // [PIX][KS1]
  bf16* db = col + PIX * KS1;                     // [2][PIX][K1_CS] dy1, e1
  bf16* yb = db + 2 * PIX * K1_CS;                // [2][PIX][K1_CS] y1

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
    stage_x_rows<VEC>(xs + (s & 1) * XROWS * XR, x, b, oy0, ox0, H, W, tid,
                      K1_THREADS);
    auto pix = [&](int p) -> long long {
      const int oy = oy0 + p / TW, ox = ox0 + p % TW;
      if (oy >= H2 || ox >= W2) return -1;
      return (((long long)b * H2 + oy) * W2 + ox) * C1;
    };
    stage_rows<VEC>(db + (s & 1) * PIX * K1_CS, K1_CS, dy1, PIX, NC, c10,
                    C1, pix, tid, K1_THREADS);
    stage_rows<VEC>(yb + (s & 1) * PIX * K1_CS, K1_CS, y1, PIX, NC, c10, C1,
                    pix, tid, K1_THREADS);
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

  // A = im2col^T through ldmatrix.trans (rows pixels, 8 im2col columns
  // each), B = e1 through ldmatrix.trans (rows pixels, 8 channels each)
  const int a_px = (lane & 7) + (lane >> 4) * 8, a_m = ((lane >> 3) & 1) * 8;
  const int b_px = (lane & 7) + ((lane >> 3) & 1) * 8, b_n = (lane >> 4) * 8;
  const uint32_t a_lane = smem_addr(col + a_px * KS1 + a_m);
  const uint32_t b_lane = smem_addr(db + b_px * K1_CS + b_n);
  constexpr int E = sizeof(bf16);

  for (int s = 0; s < my_tiles; ++s) {
    if (s + 1 < my_tiles) load_tile(s + 1);
    cp_async_commit();
    cp_async_wait_prev();
    __syncthreads();
    int b, oy0, ox0;
    tile_of(s, b, oy0, ox0);
    build_im2col(col, xs + (s & 1) * XROWS * XR, tid, K1_THREADS);
    bf16* dcur = db + (s & 1) * PIX * K1_CS;
    const bf16* ycur = yb + (s & 1) * PIX * K1_CS;
    for (int i = tid; i < PIX * NT; i += K1_THREADS) {
      const int p = i / NT, j = i - p * NT;
      const bool ok = oy0 + p / TW < H2 && ox0 + p % TW < W2;
      uint4* dp = reinterpret_cast<uint4*>(dcur + p * K1_CS + 8 * j);
      uint4 du = *dp;
      const uint4 yu =
          *reinterpret_cast<const uint4*>(ycur + p * K1_CS + 8 * j);
      bf16* d = reinterpret_cast<bf16*>(&du);
      const bf16* yv = reinterpret_cast<const bf16*>(&yu);
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int c = c10 + 8 * j + k;
        d[k] = (ok && c < C1)
                   ? __float2bfloat16(__bfloat162float(d[k]) + ds1[c] +
                                      2.f * __bfloat162float(yv[k]) * dss1[c])
                   : __float2bfloat16(0.f);
      }
      *dp = du;
    }
    __syncthreads();

    const uint32_t off = (s & 1) * PIX * K1_CS * E;
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int r = 2 * warp + rr;  // one k16 step: a tile row of pixels
      uint32_t a[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        ldsm_x4_t(a[i], a_lane + (r * TW * KS1 + 16 * i) * E);
#pragma unroll
      for (int jj = 0; jj < NT / 2; ++jj) {
        uint32_t bq[4];
        ldsm_x4_t(bq, b_lane + off + (r * TW * K1_CS + 16 * jj) * E);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          mma_bf16(acc[i][2 * jj], a[i], bq[0], bq[1]);
          mma_bf16(acc[i][2 * jj + 1], a[i], bq[2], bq[3]);
        }
      }
    }
    __syncthreads();  // col and the stage buffers free for the next tile
  }

  // the four warps' sums in order, then this chunk's partial
  float* red = reinterpret_cast<float*>(db);  // [4][32][NC]
  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q)
        red[(warp * 32 + 16 * i + g + (q >> 1) * 8) * NC + 8 * j + 2 * t4 +
            (q & 1)] = acc[i][j][q];
  __syncthreads();
  for (int idx = tid; idx < 27 * NC; idx += K1_THREADS) {
    const int m = idx / NC, n = idx - m * NC;
    float t = 0.f;
    for (int w = 0; w < 4; ++w) t += red[(w * 32 + m) * NC + n];
    if (c10 + n < C1) part[((size_t)chunk * 27 + m) * C1 + c10 + n] = t;
  }
}

// ---- launchers: the wrapper's plan in, cudaGetLastError() out ------------
// Template arguments default to the YOLOv8 front's instantiation.

template <typename K>
inline int set_smem(K kernel, size_t bytes) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes)));
}

inline int tiles_of(int H, int W, int th, int tw, int& tiles_x) {
  tiles_x = (W + tw - 1) / tw;
  return tiles_x * ((H + th - 1) / th);
}

// P1 on x (B, H, W, 3) -> y (B, H/2, W/2, C1); TRAIN writes the statistics
// partials [2][blocks][C1], eval applies act(g1 acc + b1).
template <bool TRAIN, int NT1 = 6, int ACT = ACT_SILU>
inline int launch_p1(const bf16* x, const bf16* k1, const float* g1,
                     const float* b1, bf16* y, float* stats, int B, int H,
                     int W, int C1, int blocks, int vec, cudaStream_t st) {
  const int Ho = out_size(H, 2), Wo = out_size(W, 2);
  int tiles_x;
  const int per_img = tiles_of(Ho, Wo, TH, TW, tiles_x);
  dim3 grid(blocks, (C1 + 8 * NT1 - 1) / (8 * NT1));
  auto kern = vec ? front_p1_kernel<TRAIN, true, NT1, ACT>
                  : front_p1_kernel<TRAIN, false, NT1, ACT>;
  constexpr size_t smem = p1_smem<NT1>();
  int err = set_smem(kern, smem);
  if (err != 0) return err;
  kern<<<grid, P1_THREADS, smem, st>>>(x, k1, g1, b1, y, stats, H, W, Ho, Wo,
                                       C1, tiles_x, per_img, B * per_img);
  return static_cast<int>(cudaGetLastError());
}

// P2 on a (B, H, W, Cin) -> y (B, H/2, W/2, Cout); TRANSFORM applies the
// BN1 fold + act to the staged input, STATS writes [2][blocks][Cout]
// partials.
template <bool TRANSFORM, bool STATS = TRANSFORM, int CK = 48, int NP = 96,
          int ACT = ACT_SILU>
inline int launch_p2(const bf16* a, const bf16* k2, const float* g1,
                     const float* b1, bf16* y, float* stats, int B, int H,
                     int W, int Cin, int Cout, int blocks, int vec,
                     cudaStream_t st) {
  const int Ho = out_size(H, 2), Wo = out_size(W, 2);
  int tiles_x;
  const int per_img = tiles_of(Ho, Wo, TH, TW, tiles_x);
  dim3 grid(blocks, (Cout + NP - 1) / NP);
  auto kern = vec ? front_p2_kernel<TRANSFORM, STATS, true, CK, NP, ACT>
                  : front_p2_kernel<TRANSFORM, STATS, false, CK, NP, ACT>;
  constexpr size_t smem = p2_smem<CK, NP>();
  int err = set_smem(kern, smem);
  if (err != 0) return err;
  kern<<<grid, P2_THREADS, smem, st>>>(a, k2, g1, b1, y, stats, H, W, Ho, Wo,
                                       Cin, Cout, tiles_x, per_img,
                                       B * per_img);
  return static_cast<int>(cudaGetLastError());
}

inline int launch_e2(const bf16* dy2, const bf16* y2, const float* ds2,
                     const float* dss2, bf16* e2, long long n, int C2, int vec,
                     cudaStream_t st) {
  const long long items = vec ? n / 8 : n;
  const int blocks = static_cast<int>(
      (items + 255) / 256 < 65535 ? (items + 255) / 256 : 65535);
  if (vec)
    e2_prep_kernel<true><<<blocks, 256, 0, st>>>(dy2, y2, ds2, dss2, e2, n,
                                                 C2);
  else
    e2_prep_kernel<false><<<blocks, 256, 0, st>>>(dy2, y2, ds2, dss2, e2, n,
                                                  C2);
  return static_cast<int>(cudaGetLastError());
}

// dA1 (+ the BN1 chain when CHAIN): dy1 (B, H2, W2, C1) and gpart
// [2][blocks][C1]
template <bool CHAIN = true, int KD = 96, int ND = 48, int ACT = ACT_SILU>
inline int launch_da1(const bf16* e2, const bf16* k2, const bf16* y1,
                      const float* g1, const float* b1, bf16* dy1,
                      float* gpart, int B, int H2, int W2, int C1, int C2,
                      int blocks, int vec, cudaStream_t st) {
  const int H4 = out_size(H2, 2), W4 = out_size(W2, 2);
  int tiles_x;
  const int per_img = tiles_of(H2, W2, 2 * DU, 2 * DV, tiles_x);
  dim3 grid(blocks, (C1 + ND - 1) / ND);
  auto kern = vec ? front_da1_tc_kernel<CHAIN, true, KD, ND, ACT>
                  : front_da1_tc_kernel<CHAIN, false, KD, ND, ACT>;
  constexpr size_t smem = da1_smem<KD, ND>();
  int err = set_smem(kern, smem);
  if (err != 0) return err;
  kern<<<grid, DA_THREADS, smem, st>>>(e2, k2, y1, g1, b1, dy1, gpart, H2, W2,
                                       H4, W4, C1, C2, tiles_x, per_img,
                                       B * per_img);
  return static_cast<int>(cudaGetLastError());
}

// dk2 (3, 3, C1, C2) f32 = the in-order sum of n_chunks partials in part
template <bool TRANSFORM = true, int MT = 3, int NT = 6, int ACT = ACT_SILU>
inline int launch_dk2(const bf16* y1, const bf16* e2, const float* g1,
                      const float* b1, float* part, float* dk2, int B, int H2,
                      int W2, int C1, int C2, int n_chunks, int vec,
                      cudaStream_t st) {
  const int H4 = out_size(H2, 2), W4 = out_size(W2, 2);
  int tiles_x;
  const int per_img = tiles_of(H4, W4, DK_TH, TW, tiles_x);
  dim3 grid(n_chunks, (C1 + 16 * MT - 1) / (16 * MT),
            (C2 + 8 * NT - 1) / (8 * NT));
  auto kern = vec ? front_dk2_tc_kernel<TRANSFORM, true, MT, NT, ACT>
                  : front_dk2_tc_kernel<TRANSFORM, false, MT, NT, ACT>;
  constexpr size_t smem = dk2_smem<MT, NT>();
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

// dk1 (3, 3, 3, C1) f32 = the in-order sum of n_chunks partials in part
template <int NC = 48>
inline int launch_dk1(const bf16* x, const bf16* dy1, const bf16* y1,
                      const float* ds1, const float* dss1, float* part,
                      float* dk1, int B, int H, int W, int C1, int n_chunks,
                      int vec, cudaStream_t st) {
  const int H2 = out_size(H, 2), W2 = out_size(W, 2);
  int tiles_x;
  const int per_img = tiles_of(H2, W2, TH, TW, tiles_x);
  dim3 grid(n_chunks, (C1 + NC - 1) / NC);
  auto kern = vec ? front_dk1_tc_kernel<true, NC>
                  : front_dk1_tc_kernel<false, NC>;
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

}  // namespace ftc
}  // namespace rodt
