// Helpers shared by the port's kernel sources: the dtype codes, the
// element conversions, the activation codes, and the train-mode BatchNorm
// statistics: finalize_partials_kernel, which reduces per-block [2][P][C]
// sum / sum-of-squares partials in a fixed order into the batch mean, the
// clamped fast variance and the BN fold, and the data-parallel callback
// (SyncFn, sync_sums, launch_finalize_synced) that averages those sums over
// the ranks of a data-parallel step. The convolutions themselves are the
// tensor-core kernels of conv3x3_tc.cuh / conv3x3_tf32.cuh, front_tc.cuh /
// front_tf32.cuh and stem_tc.cuh / stem_tf32.cuh.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stddef.h>

namespace rodt {

constexpr int DTYPE_F32 = 0;
constexpr int DTYPE_BF16 = 1;

constexpr int THREADS = 256; // threads of finalize_partials_kernel
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
constexpr int ACT_SILU = 0;
constexpr int ACT_RELU = 1;

inline int out_size(int n, int stride) { return (n - 1) / stride + 1; }

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
