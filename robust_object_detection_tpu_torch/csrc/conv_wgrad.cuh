// Shared 3x3 (pad 1, stride 1 or 2) weight gradient, NHWC, f32 result:
//   dk[ky, kx, ci, co] = sum_{b, oy, ox} a[b, oy*S-1+ky, ox*S-1+kx, ci]
//                                        * e[b, oy, ox, co]
// with a = x (zero outside the image) or the input transform
// round(act(x * in_scale + in_bias)) (act a template parameter, SiLU or
// ReLU), and e = d or the statistics fold
// round(d + dsum + 2 * y * dsq) of a train-mode BatchNorm that follows the
// conv (the mean / sum-of-squares cotangents of its batch statistics).
// Used by yolo_front_bwd.cu (K2-b, f32) and hgstem_bwd.cu (K4-b, f32 and
// bf16; its 2x2 convs with zero pad right/bottom are the taps ky, kx in
// {1, 2} of this 3x3 pad-1 gradient); K3-b runs the tensor-core kernels of
// conv3x3_tc.cuh (bf16) and conv3x3_tf32.cuh (f32), the bf16 K2-b those of
// front_tc.cuh. Also holds the two tiny per-channel kernels of a
// train-mode BN's backward that K2-b (both routes) and K4-b share.
//
// On the TPU the grid runs in order and one output block accumulates dk
// across grid steps. Here blocks run in parallel, so the reduction over
// B x Ho x Wo is split in two deterministic passes: wgrad_partial_kernel
// gives each of n_chunks blocks a fixed, strided set of 8 x 16 output-pixel
// tiles and writes its partial dk to part[chunk]; sum_chunks_kernel adds
// the chunks in order. No atomics, so a repeated run gives identical bits.
//
// A block owns 16 output channels x CI_W input channels x 9 taps; each of
// its 256 threads keeps 9 taps x 4 output channels of one input channel in
// registers and walks 1/PG of the tile's pixels (PG = 256 / (4 CI_W) pixel
// groups, summed in shared memory at the end). Per pixel a thread loads 9
// staged inputs and one float4 of e for 36 FMAs, on the CUDA cores.
#pragma once

#include "conv_tile.cuh"

namespace rodt {

constexpr int WG_TH = 8;    // output rows per tile
constexpr int WG_TW = 16;   // output columns per tile
constexpr int WG_CO = 16;   // output channels per block

struct WgradOpts {
  const float* in_scale = nullptr;  // input transform (with in_bias)
  const float* in_bias = nullptr;
  const void* y = nullptr;          // statistics fold (with dsum, dsq)
  const float* dsum = nullptr;
  const float* dsq = nullptr;
};

template <int S, int CI_W>
struct WgradSmem {
  static constexpr int IN_H = (WG_TH - 1) * S + 3;
  static constexpr int IN_W = (WG_TW - 1) * S + 3;
  static constexpr int X = IN_H * IN_W * CI_W;
  static constexpr int D = WG_TH * WG_TW * WG_CO;
  static constexpr int PG = THREADS / (CI_W * 4);
  static constexpr int RED = PG * 9 * CI_W * WG_CO;
  static constexpr int N = (X + D > RED) ? X + D : RED;
};

template <typename T, int S, int CI_W, int ACT>
__global__ void __launch_bounds__(THREADS)
wgrad_partial_kernel(const T* __restrict__ x, const T* __restrict__ d,
                     WgradOpts o, float* __restrict__ part, int H, int W,
                     int Cin, int Cout, int Ho, int Wo, int tiles_x,
                     int tiles_per_img, int n_tiles, int n_chunks) {
  using M = WgradSmem<S, CI_W>;
  static_assert(M::X % 4 == 0, "s_d must stay 16-byte aligned");
  __shared__ __align__(16) float smem[M::N];
  float* s_x = smem;          // [IN_H][IN_W][CI_W]
  float* s_d = smem + M::X;   // [WG_TH * WG_TW][WG_CO]

  const int tid = threadIdx.x;
  const int coq = tid & 3;                // output channels coq*4 .. +3
  const int ci = (tid >> 2) % CI_W;       // input channel in the block
  const int pg = tid / (4 * CI_W);        // pixel group
  const int chunk = blockIdx.x;
  const int co0 = blockIdx.y * WG_CO;
  const int ci0 = blockIdx.z * CI_W;
  const T* yv = static_cast<const T*>(o.y);

  float acc[9][4];
#pragma unroll
  for (int t = 0; t < 9; ++t)
#pragma unroll
    for (int k = 0; k < 4; ++k) acc[t][k] = 0.f;

  for (int t = chunk; t < n_tiles; t += n_chunks) {
    const int b = t / tiles_per_img;
    const int r = t % tiles_per_img;
    const int oy0 = (r / tiles_x) * WG_TH, ox0 = (r % tiles_x) * WG_TW;
    const int iy0 = oy0 * S - 1, ix0 = ox0 * S - 1;
    __syncthreads();  // the previous tile is done reading shared memory
    for (int idx = tid; idx < M::X; idx += THREADS) {
      const int c = idx % CI_W;  // fastest: contiguous in NHWC
      const int pix = idx / CI_W;
      const int gy = iy0 + pix / M::IN_W, gx = ix0 + pix % M::IN_W;
      const int gc = ci0 + c;
      float v = 0.f;
      if (gc < Cin && gy >= 0 && gy < H && gx >= 0 && gx < W) {
        v = to_f(x[(((size_t)b * H + gy) * W + gx) * Cin + gc]);
        if (o.in_scale != nullptr)
          v = round_to<T>(
              activate<ACT>(v * o.in_scale[gc] + o.in_bias[gc]));
      }
      s_x[idx] = v;
    }
    for (int idx = tid; idx < M::D; idx += THREADS) {
      const int co = idx % WG_CO;
      const int pix = idx / WG_CO;
      const int oy = oy0 + pix / WG_TW, ox = ox0 + pix % WG_TW;
      const int gco = co0 + co;
      float v = 0.f;
      if (gco < Cout && oy < Ho && ox < Wo) {
        const size_t off = (((size_t)b * Ho + oy) * Wo + ox) * Cout + gco;
        v = to_f(d[off]);
        if (o.dsum != nullptr)
          v = round_to<T>(v + o.dsum[gco] + 2.f * to_f(yv[off]) * o.dsq[gco]);
      }
      s_d[idx] = v;
    }
    __syncthreads();
    for (int pix = pg; pix < WG_TH * WG_TW; pix += M::PG) {
      const int py = pix / WG_TW, px = pix % WG_TW;
      const float4 dv =
          *reinterpret_cast<const float4*>(&s_d[pix * WG_CO + coq * 4]);
#pragma unroll
      for (int ky = 0; ky < 3; ++ky) {
#pragma unroll
        for (int kx = 0; kx < 3; ++kx) {
          const float xv =
              s_x[((py * S + ky) * M::IN_W + px * S + kx) * CI_W + ci];
          float* a = acc[ky * 3 + kx];
          a[0] = fmaf(xv, dv.x, a[0]);
          a[1] = fmaf(xv, dv.y, a[1]);
          a[2] = fmaf(xv, dv.z, a[2]);
          a[3] = fmaf(xv, dv.w, a[3]);
        }
      }
    }
  }

  // sum the PG pixel groups in order, then write this chunk's partial
  __syncthreads();
  float* red = smem;  // [PG][9][CI_W][WG_CO]
#pragma unroll
  for (int tap = 0; tap < 9; ++tap)
#pragma unroll
    for (int k = 0; k < 4; ++k)
      red[((pg * 9 + tap) * CI_W + ci) * WG_CO + coq * 4 + k] = acc[tap][k];
  __syncthreads();
  constexpr int PER_PG = 9 * CI_W * WG_CO;
  for (int idx = tid; idx < PER_PG; idx += THREADS) {
    float s = 0.f;
    for (int q = 0; q < M::PG; ++q) s += red[q * PER_PG + idx];
    const int co = idx % WG_CO;
    const int c = (idx / WG_CO) % CI_W;
    const int tap = idx / (WG_CO * CI_W);
    if (ci0 + c < Cin && co0 + co < Cout)
      part[(((size_t)chunk * 9 + tap) * Cin + ci0 + c) * Cout + co0 + co] = s;
  }
}

// out[i] = sum over chunks of part[chunk][i], in chunk order.
static __global__ void sum_chunks_kernel(const float* __restrict__ part,
                                         int n_chunks, int n,
                                         float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
  for (int c = 0; c < n_chunks; ++c) s += part[(size_t)c * n + i];
  out[i] = s;
}

template <typename T, int S, int ACT>
inline int launch_wgrad_t(const void* x, const void* d, const WgradOpts& o,
                          float* part, float* dk, int B, int H, int W,
                          int Cin, int Cout, int n_chunks,
                          cudaStream_t stream) {
  const int Ho = out_size(H, S), Wo = out_size(W, S);
  const int tiles_x = (Wo + WG_TW - 1) / WG_TW;
  const int tiles_per_img = tiles_x * ((Ho + WG_TH - 1) / WG_TH);
  const int n_tiles = B * tiles_per_img;
  const int co_tiles = (Cout + WG_CO - 1) / WG_CO;
  if (Cin <= 4) {
    dim3 grid(n_chunks, co_tiles, (Cin + 3) / 4);
    wgrad_partial_kernel<T, S, 4, ACT><<<grid, THREADS, 0, stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(d), o, part, H, W,
        Cin, Cout, Ho, Wo, tiles_x, tiles_per_img, n_tiles, n_chunks);
  } else {
    dim3 grid(n_chunks, co_tiles, (Cin + 15) / 16);
    wgrad_partial_kernel<T, S, 16, ACT><<<grid, THREADS, 0, stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(d), o, part, H, W,
        Cin, Cout, Ho, Wo, tiles_x, tiles_per_img, n_tiles, n_chunks);
  }
  int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  const int n = 9 * Cin * Cout;
  sum_chunks_kernel<<<(n + THREADS - 1) / THREADS, THREADS, 0, stream>>>(
      part, n_chunks, n, dk);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int ACT = ACT_SILU>
inline int launch_wgrad(int stride, const void* x, const void* d,
                        const WgradOpts& o, float* part, float* dk, int B,
                        int H, int W, int Cin, int Cout, int n_chunks,
                        cudaStream_t stream) {
  if (B <= 0 || H <= 0 || W <= 0 || Cin <= 0 || Cout <= 0 ||
      n_chunks <= 0 || (Cout + WG_CO - 1) / WG_CO > 65535 ||
      (Cin + 3) / 4 > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (stride == 1)
    return launch_wgrad_t<T, 1, ACT>(x, d, o, part, dk, B, H, W, Cin, Cout,
                                n_chunks, stream);
  if (stride == 2)
    return launch_wgrad_t<T, 2, ACT>(x, d, o, part, dk, B, H, W, Cin, Cout,
                                n_chunks, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The cotangent of a batch-statistics pair (mean, var) of n values as the
// per-element terms of e = d + ds + 2 y dss.
static __global__ void stat_cotangent_kernel(const float* dmean,
                                             const float* dvar,
                                             const float* mean, float n,
                                             int C, float* ds, float* dss) {
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    ds[c] = dmean[c] / n - 2.f * mean[c] * dvar[c] / n;
    dss[c] = dvar[c] / n;
  }
}

// Folded-BN backward (pallas_stem._bn_chain). sums = (dg, db), the
// gradients by the fold g = sc * rsqrt(var + eps), b = bi - mean * g.
static __global__ void bn_chain_kernel(const float* sums, const float* sc,
                                       const float* mean, const float* var,
                                       float n, const float* dmean_in,
                                       const float* dvar_in, int C,
                                       float* dsc, float* dbi, float* ds,
                                       float* dss) {
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    const float dgc = sums[c], dbc = sums[C + c];
    const float r = 1.f / sqrtf(var[c] + BN_EPS);
    dsc[c] = dgc * r - dbc * mean[c] * r;
    dbi[c] = dbc;
    const float dm = -dbc * sc[c] * r + dmean_in[c];
    const float dv = (dgc - dbc * mean[c]) * sc[c] * (-0.5f) * r * r * r
                     + dvar_in[c];
    ds[c] = dm / n - 2.f * mean[c] * dv / n;
    dss[c] = dv / n;
  }
}

}  // namespace rodt
