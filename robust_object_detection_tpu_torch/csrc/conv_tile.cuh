// Shared tiled direct 3x3 convolution (pad 1, stride 1 or 2), NHWC in and
// out, HWIO filter, f32 accumulation, with optional pieces:
//   * an input transform a = round(act(x * in_scale + in_bias)) applied
//     while staging (train-mode BN + activation of the layer below, whose
//     batch statistics exist only after that layer covered the whole batch);
//     the zero padding stays zero in a-space;
//   * an output epilogue y = act(y * out_scale + out_bias) (eval BN fold);
//     act is a template parameter, SiLU (the YOLO front) or ReLU (HGStem);
//   * a statistics epilogue: per-block per-channel sum and sum of squares
//     of the STORED (rounded) outputs, as deterministic partials
//     stats[2][P][Cout], P = B * tiles; finalize_partials_kernel reduces
//     them.
// Used by yolo_front.cu (K2-f eval and train, f32) and hgstem.cu (K4-f:
// stem1 and stem3, f32 and bf16); K3-f runs the tensor-core kernels of
// conv3x3_tc.cuh (bf16) and conv3x3_tf32.cuh (f32), the bf16 K2-f those of
// front_tc.cuh,
// and K2-f's bf16 route still reduces its statistics partials with
// finalize_partials_kernel below.
//
// One block computes a TILE x TILE output tile for CO_T output channels of
// one image. Input channels are staged CI_T at a time: the block copies the
// input patch the tile needs (its halo included, zero outside the image)
// and the 3x3 x CI_T x CO_T filter slice into shared memory as f32, then
// each of the 256 threads accumulates 4 pixels x 4 output channels in
// registers. All plain CUDA cores.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stddef.h>

namespace rodt {

constexpr int DTYPE_F32 = 0;
constexpr int DTYPE_BF16 = 1;

constexpr int TILE = 16;     // output tile is TILE x TILE pixels
constexpr int CO_T = 16;     // output channels per block
constexpr int CI_T = 8;      // input channels staged per pass
constexpr int THREADS = 256; // 64 pixel groups x 4 channel groups
constexpr float BN_EPS = 1e-3f;  // flax BatchNorm epsilon

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}
// v rounded to T and back (the value a T tensor would hold)
template <typename T> __device__ __forceinline__ float round_to(float v) {
  return to_f(from_f<T>(v));
}
__device__ __forceinline__ float silu(float z) {
  return z / (1.f + expf(-z));
}
constexpr int ACT_SILU = 0;
constexpr int ACT_RELU = 1;
template <int ACT> __device__ __forceinline__ float activate(float z) {
  return ACT == ACT_RELU ? fmaxf(z, 0.f) : silu(z);
}

struct ConvOpts {
  const float* in_scale = nullptr;   // input transform (with in_bias)
  const float* in_bias = nullptr;
  const float* out_scale = nullptr;  // output epilogue (with out_bias)
  const float* out_bias = nullptr;
  float* stats = nullptr;            // [2][P][Cout] partials
};

// For a 256-thread block laid out as tid = pg * 4 + cg (cg: 4 channels
// cg*4..cg*4+3), sum s[4] and ss[4] over the 64 pixel groups in a fixed
// order and write them to part[0][p][c0 + .] and part[1][p][c0 + .]
// (channels >= C skipped). Every thread of the block must call it.
__device__ __forceinline__ void block_channel_partials(
    float s[4], float ss[4], float* part, size_t P, size_t p, int c0,
    int C) {
  __shared__ float red[2][THREADS / 32][16];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
#pragma unroll
    for (int off = 4; off < 32; off <<= 1) {  // same cg, other pixel groups
      s[k] += __shfl_xor_sync(0xffffffffu, s[k], off);
      ss[k] += __shfl_xor_sync(0xffffffffu, ss[k], off);
    }
  }
  if (lane < 4) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      red[0][warp][lane * 4 + k] = s[k];
      red[1][warp][lane * 4 + k] = ss[k];
    }
  }
  __syncthreads();
  if (threadIdx.x < 32) {
    const int which = threadIdx.x >> 4, c = threadIdx.x & 15;
    float t = 0.f;
    for (int w = 0; w < THREADS / 32; ++w) t += red[which][w][c];
    if (c0 + c < C) part[(which * P + p) * C + c0 + c] = t;
  }
}

// For a 256-thread block laid out as tid = pg * 4 + cg, a thread holding
// s[CPT], ss[CPT] of channels cg*CPT .. cg*CPT+CPT-1: sum over the 64 pixel
// groups in a fixed order and write part[0][p][.] and part[1][p][.] of
// part[2][P][4 CPT] (the 2x2 convs of hgstem.cu and hgstem_bwd.cu, whose
// blocks own all 16 or 32 channels). Every thread of the block must call
// it.
template <int CPT>
__device__ __forceinline__ void block_partials(float s[CPT], float ss[CPT],
                                               float* part, size_t P,
                                               size_t p) {
  constexpr int C = 4 * CPT;
  __shared__ float red[2][THREADS / 32][C];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < CPT; ++k) {
#pragma unroll
    for (int off = 4; off < 32; off <<= 1) {  // same cg, other pixel groups
      s[k] += __shfl_xor_sync(0xffffffffu, s[k], off);
      ss[k] += __shfl_xor_sync(0xffffffffu, ss[k], off);
    }
  }
  if (lane < 4) {
#pragma unroll
    for (int k = 0; k < CPT; ++k) {
      red[0][warp][lane * CPT + k] = s[k];
      red[1][warp][lane * CPT + k] = ss[k];
    }
  }
  __syncthreads();
  if (threadIdx.x < 2 * C) {
    const int which = threadIdx.x / C, c = threadIdx.x % C;
    float t = 0.f;
    for (int w = 0; w < THREADS / 32; ++w) t += red[which][w][c];
    part[(which * P + p) * C + c] = t;
  }
}

// y[b, oy, ox, co] = sum_{ky,kx,ci} a[b, oy*S-1+ky, ox*S-1+kx, ci]
//                                   * w[ky, kx, ci, co]
// with a = x, or the input transform of x; then the optional epilogues.
// STATS (o.stats set) is a template flag so that the convs without the
// statistics epilogue keep its registers free (119 vs 80 a thread).
template <typename T, int S, bool STATS, int ACT>
__global__ void __launch_bounds__(THREADS)
conv3x3_tile_kernel(const T* __restrict__ x, const T* __restrict__ w,
                    T* __restrict__ y, ConvOpts o, int H, int W, int Cin,
                    int Cout, int Ho, int Wo, int tiles_x, int n_tiles) {
  constexpr int IN_T = (TILE - 1) * S + 3;  // input patch side
  __shared__ float s_in[CI_T][IN_T][IN_T];
  __shared__ __align__(16) float s_w[9][CI_T][CO_T];

  const int tid = threadIdx.x;
  const int cg = tid & 3;          // output channels cg*4 .. cg*4+3
  const int pg = tid >> 2;         // pixel group 0..63
  const int tx = pg & (TILE - 1);  // tile column
  const int ty0 = pg >> 4;         // tile rows ty0, ty0+4, ty0+8, ty0+12
  const int oy0 = (blockIdx.x / tiles_x) * TILE;
  const int ox0 = (blockIdx.x % tiles_x) * TILE;
  const int co0 = blockIdx.y * CO_T;
  const int b = blockIdx.z;
  const int iy0 = oy0 * S - 1;
  const int ix0 = ox0 * S - 1;
  const T* xb = x + (size_t)b * H * W * Cin;

  float acc[4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int k = 0; k < 4; ++k) acc[j][k] = 0.f;

  for (int ci0 = 0; ci0 < Cin; ci0 += CI_T) {
    const int nci = min(CI_T, Cin - ci0);
    __syncthreads();  // the previous pass is done reading shared memory
    for (int idx = tid; idx < CI_T * IN_T * IN_T; idx += THREADS) {
      const int c = idx % CI_T;  // fastest: contiguous in NHWC
      const int pix = idx / CI_T;
      const int iy = pix / IN_T, ix = pix % IN_T;
      const int gy = iy0 + iy, gx = ix0 + ix;
      float v = 0.f;
      if (c < nci && gy >= 0 && gy < H && gx >= 0 && gx < W) {
        v = to_f(xb[((size_t)gy * W + gx) * Cin + ci0 + c]);
        if (o.in_scale != nullptr)
          v = round_to<T>(
              activate<ACT>(v * o.in_scale[ci0 + c] + o.in_bias[ci0 + c]));
      }
      s_in[c][iy][ix] = v;
    }
    for (int idx = tid; idx < 9 * CI_T * CO_T; idx += THREADS) {
      const int co = idx % CO_T;
      const int r = idx / CO_T;
      const int c = r % CI_T, tap = r / CI_T;
      float v = 0.f;
      if (c < nci && co0 + co < Cout)
        v = to_f(w[((size_t)tap * Cin + ci0 + c) * Cout + co0 + co]);
      s_w[tap][c][co] = v;
    }
    __syncthreads();
    for (int c = 0; c < nci; ++c) {
#pragma unroll
      for (int ky = 0; ky < 3; ++ky) {
#pragma unroll
        for (int kx = 0; kx < 3; ++kx) {
          const float4 wv =
              *reinterpret_cast<const float4*>(&s_w[ky * 3 + kx][c][cg * 4]);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float xv = s_in[c][(ty0 + 4 * j) * S + ky][tx * S + kx];
            acc[j][0] = fmaf(xv, wv.x, acc[j][0]);
            acc[j][1] = fmaf(xv, wv.y, acc[j][1]);
            acc[j][2] = fmaf(xv, wv.z, acc[j][2]);
            acc[j][3] = fmaf(xv, wv.w, acc[j][3]);
          }
        }
      }
    }
  }

  float s[4] = {0.f, 0.f, 0.f, 0.f}, ss[4] = {0.f, 0.f, 0.f, 0.f};
  const int ox = ox0 + tx;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int oy = oy0 + ty0 + 4 * j;
    if (oy >= Ho || ox >= Wo) continue;
    T* yp = y + (((size_t)b * Ho + oy) * Wo + ox) * Cout;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int co = co0 + cg * 4 + k;
      if (co >= Cout) continue;
      float v = acc[j][k];
      if (o.out_scale != nullptr)
        v = activate<ACT>(v * o.out_scale[co] + o.out_bias[co]);
      const T t = from_f<T>(v);
      yp[co] = t;
      if (STATS) {
        const float r = to_f(t);
        s[k] += r;
        ss[k] = fmaf(r, r, ss[k]);
      }
    }
  }
  if (STATS)
    block_channel_partials(s, ss, o.stats, (size_t)gridDim.z * n_tiles,
                           (size_t)b * n_tiles + blockIdx.x, co0, Cout);
}

inline int out_size(int n, int stride) { return (n - 1) / stride + 1; }

inline int tile_count(int Ho, int Wo) {
  return ((Ho + TILE - 1) / TILE) * ((Wo + TILE - 1) / TILE);
}

// Enqueues one conv on `stream`; returns cudaGetLastError() after it.
template <typename T, int S, int ACT>
inline int launch_conv3x3(const void* x, const void* w, void* y,
                          const ConvOpts& o, int B, int H, int W, int Cin,
                          int Cout, cudaStream_t stream) {
  const int Ho = out_size(H, S), Wo = out_size(W, S);
  const int tiles_x = (Wo + TILE - 1) / TILE;
  const int n_tiles = tile_count(Ho, Wo);
  dim3 grid(n_tiles, (Cout + CO_T - 1) / CO_T, B);
  if (o.stats != nullptr)
    conv3x3_tile_kernel<T, S, true, ACT><<<grid, THREADS, 0, stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(w),
        static_cast<T*>(y), o, H, W, Cin, Cout, Ho, Wo, tiles_x, n_tiles);
  else
    conv3x3_tile_kernel<T, S, false, ACT><<<grid, THREADS, 0, stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(w),
        static_cast<T*>(y), o, H, W, Cin, Cout, Ho, Wo, tiles_x, n_tiles);
  return static_cast<int>(cudaGetLastError());
}

template <int S, int ACT = ACT_SILU>
inline int launch_conv3x3_dtype(int dtype, const void* x, const void* w,
                                void* y, const ConvOpts& o, int B, int H,
                                int W, int Cin, int Cout,
                                cudaStream_t stream) {
  if (B <= 0 || H <= 0 || W <= 0 || Cin <= 0 || Cout <= 0 || B > 65535 ||
      (Cout + CO_T - 1) / CO_T > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == DTYPE_F32)
    return launch_conv3x3<float, S, ACT>(x, w, y, o, B, H, W, Cin, Cout,
                                         stream);
  if (dtype == DTYPE_BF16)
    return launch_conv3x3<__nv_bfloat16, S, ACT>(x, w, y, o, B, H, W, Cin,
                                                 Cout, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Reduces [2][P][C] partials per channel in a fixed order (f64 sums, so a
// repeated run gives identical bits). One block per channel.
//   sums != nullptr: sums[0][c], sums[1][c] = the two f32 totals;
//   mean != nullptr: mean = s / n, var = max(0, ss / n - mean^2) (flax's
//     fast variance), and when scale != nullptr also the BN fold
//     g = scale * rsqrt(var + eps), h = bias - mean * g.
// (static: every .cu that includes this header gets its own copy.)
static __global__ void __launch_bounds__(THREADS)
finalize_partials_kernel(const float* __restrict__ part, int P, int C,
                         float n, float* sums, float* mean, float* var,
                         const float* scale, const float* bias, float* g,
                         float* h) {
  __shared__ double red[2][THREADS];
  const int c = blockIdx.x;
  double s = 0.0, ss = 0.0;
  for (int p = threadIdx.x; p < P; p += THREADS) {
    s += part[(size_t)p * C + c];
    ss += part[((size_t)P + p) * C + c];
  }
  red[0][threadIdx.x] = s;
  red[1][threadIdx.x] = ss;
  __syncthreads();
  for (int k = THREADS / 2; k > 0; k >>= 1) {
    if (threadIdx.x < k) {
      red[0][threadIdx.x] += red[0][threadIdx.x + k];
      red[1][threadIdx.x] += red[1][threadIdx.x + k];
    }
    __syncthreads();
  }
  if (threadIdx.x != 0) return;
  const float fs = static_cast<float>(red[0][0]);
  const float fss = static_cast<float>(red[1][0]);
  if (sums != nullptr) {
    sums[c] = fs;
    sums[C + c] = fss;
  }
  if (mean != nullptr) {
    const float m = fs / n;
    const float v = fmaxf(0.f, fss / n - m * m);
    mean[c] = m;
    var[c] = v;
    if (scale != nullptr) {
      const float gg = scale[c] / sqrtf(v + BN_EPS);
      g[c] = gg;
      h[c] = bias[c] - m * gg;
    }
  }
}

inline int launch_finalize(const float* part, int P, int C, float n,
                           float* sums, float* mean, float* var,
                           const float* scale, const float* bias, float* g,
                           float* h, cudaStream_t stream) {
  finalize_partials_kernel<<<C, THREADS, 0, stream>>>(
      part, P, C, n, sums, mean, var, scale, bias, g, h);
  return static_cast<int>(cudaGetLastError());
}

// A host callback that averages the n floats at buf (device memory, the
// caller's stream) over the ranks of a data-parallel step; 0 on success.
// Every rank holds as many rows, so an average of per-rank batch sums
// divided by this rank's count is the global batch's mean.
typedef int (*SyncFn)(float* buf, int n);

// The 2 * C batch sums at `sums` averaged over the data group by `sync`
// (nothing when sync is null).
inline int sync_sums(void* sync, float* sums, int C) {
  if (sync == nullptr) return 0;
  return reinterpret_cast<SyncFn>(sync)(sums, 2 * C) == 0
             ? 0
             : static_cast<int>(cudaErrorUnknown);
}

// launch_finalize's statistics (and fold) of a train-mode BatchNorm; with
// `sync`, of the global batch: the partials reduce to sums in `scratch`
// (2 * C floats), sync averages them, and mean / var / the fold come from
// the averaged sums with this rank's n.
inline int launch_finalize_synced(const float* part, int P, int C, float n,
                                  void* sync, float* scratch, float* mean,
                                  float* var, const float* scale,
                                  const float* bias, float* g, float* h,
                                  cudaStream_t stream) {
  if (sync == nullptr)
    return launch_finalize(part, P, C, n, nullptr, mean, var, scale, bias, g,
                           h, stream);
  int err = launch_finalize(part, P, C, 1.f, scratch, nullptr, nullptr,
                            nullptr, nullptr, nullptr, nullptr, stream);
  if (err != 0) return err;
  err = sync_sums(sync, scratch, C);
  if (err != 0) return err;
  return launch_finalize(scratch, 1, C, n, nullptr, mean, var, scale, bias, g,
                         h, stream);
}

}  // namespace rodt
