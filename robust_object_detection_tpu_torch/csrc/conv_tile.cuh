// Shared tiled direct 3x3 convolution (pad 1, stride 1 or 2), NHWC in and
// out, HWIO filter, f32 accumulation, optional folded-BN + SiLU epilogue.
// Used by conv3x3.cu (K3-f) and yolo_front.cu (K2-f).
//
// One block computes a TILE x TILE output tile for CO_T output channels of
// one image. Input channels are staged CI_T at a time: the block copies the
// input patch the tile needs (its halo included, zero outside the image)
// and the 3x3 x CI_T x CO_T filter slice into shared memory as f32, then
// each of the 256 threads accumulates 4 pixels x 4 output channels in
// registers. All plain CUDA cores; tensor cores (mma.sync / wgmma) and TMA
// are later work.
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

// y[b, oy, ox, co] = sum_{ky,kx,ci} x[b, oy*S-1+ky, ox*S-1+kx, ci]
//                                   * w[ky, kx, ci, co]
// and, when scale != nullptr, y = silu(y * scale[co] + bias[co]).
template <typename T, int S>
__global__ void __launch_bounds__(THREADS)
conv3x3_tile_kernel(const T* __restrict__ x, const T* __restrict__ w,
                    T* __restrict__ y, const float* __restrict__ scale,
                    const float* __restrict__ bias, int H, int W, int Cin,
                    int Cout, int Ho, int Wo, int tiles_x) {
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
      if (c < nci && gy >= 0 && gy < H && gx >= 0 && gx < W)
        v = to_f(xb[((size_t)gy * W + gx) * Cin + ci0 + c]);
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
      if (scale != nullptr) {
        v = v * scale[co] + bias[co];
        v = v / (1.f + expf(-v));  // silu
      }
      yp[co] = from_f<T>(v);
    }
  }
}

inline int out_size(int n, int stride) { return (n - 1) / stride + 1; }

// Enqueues one conv on `stream`; returns cudaGetLastError() after it.
template <typename T, int S>
inline int launch_conv3x3(const void* x, const void* w, void* y,
                          const float* scale, const float* bias, int B, int H,
                          int W, int Cin, int Cout, cudaStream_t stream) {
  const int Ho = out_size(H, S), Wo = out_size(W, S);
  const int tiles_x = (Wo + TILE - 1) / TILE;
  const int tiles_y = (Ho + TILE - 1) / TILE;
  dim3 grid(tiles_x * tiles_y, (Cout + CO_T - 1) / CO_T, B);
  conv3x3_tile_kernel<T, S><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<T*>(y),
      scale, bias, H, W, Cin, Cout, Ho, Wo, tiles_x);
  return static_cast<int>(cudaGetLastError());
}

template <int S>
inline int launch_conv3x3_dtype(int dtype, const void* x, const void* w,
                                void* y, const float* scale,
                                const float* bias, int B, int H, int W,
                                int Cin, int Cout, cudaStream_t stream) {
  if (B <= 0 || H <= 0 || W <= 0 || Cin <= 0 || Cout <= 0 || B > 65535 ||
      (Cout + CO_T - 1) / CO_T > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == DTYPE_F32)
    return launch_conv3x3<float, S>(x, w, y, scale, bias, B, H, W, Cin, Cout,
                                    stream);
  if (dtype == DTYPE_BF16)
    return launch_conv3x3<__nv_bfloat16, S>(x, w, y, scale, bias, B, H, W,
                                            Cin, Cout, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace rodt
