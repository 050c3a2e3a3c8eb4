// K1: per-image training corruption in one read + write pass, NHWC f32
// in [0, 255].
//
// Replaces: robust_object_detection_tpu/ops/pallas_corrupt.py, _kernel
// (public entry fused_random_corruption; random_corruption_fast on the
// TPU). Each image gets the branch of its choice id and nothing else:
//   0 clean:  a copy;
//   1 noise:  y = floor(clip(x + sigma * g, 0, 255)), g a standard normal
//             from Box-Muller on two 16-bit uniforms of one 32-bit draw;
//   2 blur:   the 0-degree motion kernel, a horizontal k-tap mean with
//             reflect-101 borders, y = clip(rint(sum * (1/k)), 0, 255);
//   3 lowres: 2x2 box mean then half-pixel bilinear 2x upsample, fused as
//             one FIR per axis (horizontal, then vertical on its result),
//             reflect-101 borders, y = clip(floor(v + 0.5), 0, 255).
// The blur and lowres arithmetic uses explicitly rounded f32 operations in
// the TPU kernel's order (no FMA contraction), so the plain version in
// ops/fused_corrupt.py reproduces it bit for bit.
//
// The TPU kernel drew its noise from the core's own PRNG. This one hashes
// (image seed, element index) with a keyed murmur3 finalizer, a counter-
// based generator: no state, any element in any order, and the plain
// version replays the same bits with integer tensor ops.
//
// What bounds it on the H100: bytes, one f32 read and one write per
// element (16 x 1024 x 1024 x 3 x 8 bytes = 403 MB per step). The design:
//
//  * A 2-D grid of tiles per image, (column band, row band, image), a tile
//    TW pixels x TH rows, 32-bit indices. The image's choice is read once
//    per block, so the branch never diverges inside a block.
//  * Clean and noise move the tile with 16-byte loads and stores over the
//    interleaved W * C row (every row is 16-byte aligned when W * C is a
//    multiple of 4 and the pointers are; the wrapper's plan says so, else
//    element loads and stores).
//  * Blur and lowres stage the tile and its halo in shared memory with
//    16-byte cp.async: +-k/2 pixels for blur; +-2 rows and +-2 pixels for
//    lowres. A staged position outside the image holds the pixel that
//    reflect-101 maps it to, loaded element by element: the only element
//    loads, at image borders (and at a row's ragged 16-byte ends). The
//    compute then reads shared memory with no reflect arithmetic.
//  * Lowres runs its horizontal FIR once per staged row into shared memory
//    (TH + 4 rows), then the vertical FIR on that buffer; the parent's
//    kernel recomputed the horizontal FIR of four rows (16 loads) for
//    every output element.
//  * Each output's arithmetic is the parent's: the same __fadd_rn /
//    __fmul_rn order, the blur summed from 0 left to right with no
//    sliding sum, the same logf, sqrtf, cosf and hash. Only where the
//    operands come from changed, so the output keeps the parent's bits.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int TW = 64;    // tile width in pixels (kernels.CORRUPT_TW)
constexpr int TH = 16;    // tile height in rows (kernels.CORRUPT_TH)
constexpr size_t SMEM_LIMIT = 232448;

__host__ __device__ inline int ceil4(int n) { return (n + 3) & ~3; }

// floats of a staged row for a halo of hx pixels: the tile's row plus
// halos, rounded to whole 16-byte chunks from a 16-byte aligned start
__host__ __device__ inline int stage_width(int hx, int C) {
  return ceil4((TW + 2 * hx) * C) + 4;
}

// dynamic shared bytes of a launch: the larger of blur's staged rows and
// lowres' staged rows plus its horizontal-FIR buffer
__host__ __device__ inline size_t smem_bytes(int C, int R) {
  const size_t blur = (size_t)TH * stage_width(R, C) * 4;
  const size_t lowres =
      (size_t)(TH + 4) * (stage_width(2, C) + TW * C) * 4;
  return blur > lowres ? blur : lowres;
}

__device__ __forceinline__ uint32_t fmix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

__device__ __forceinline__ int reflect101(int i, int n) {
  if (i < 0) i = -i;
  if (i >= n) i = 2 * n - 2 - i;
  return i;
}

// reflect-101, then clamped into [0, n): the positions a tile stages past
// the halo it needs (a ragged last tile, 16-byte rounding) stay in bounds
__device__ __forceinline__ int reflect_clamp(int i, int n) {
  return min(max(reflect101(i, n), 0), n - 1);
}

__device__ __forceinline__ int floor_div(int a, int b) {
  return a >= 0 ? a / b : -((-a + b - 1) / b);
}

__device__ __forceinline__ float noise_value(float xv, uint32_t i,
                                             uint32_t key, float sigma) {
  const uint32_t bits = fmix32(fmix32(i ^ key) + key);
  const float u1 = ((float)(bits & 0xFFFFu) + 0.5f) / 65536.0f;
  const float u2 = ((float)((bits >> 16) & 0xFFFFu) + 0.5f) / 65536.0f;
  const float g = sqrtf(-2.0f * logf(u1)) * cosf(6.2831855f * u2);
  return floorf(fminf(fmaxf(__fadd_rn(xv, __fmul_rn(sigma, g)), 0.f),
                      255.f));
}

// one axis of the lowres FIR at coordinate j from the pair means s(.):
// even j: 0.75 s(j) + 0.25 s(j-2); odd j: 0.75 s(j-1) + 0.25 s(j+1)
__device__ __forceinline__ void fir_taps(int j, int* q1, int* q2) {
  if ((j & 1) == 0) {
    *q1 = j;
    *q2 = j - 2;
  } else {
    *q1 = j - 1;
    *q2 = j + 1;
  }
}

__device__ __forceinline__ float fir(float s1, float s2) {
  return __fadd_rn(__fmul_rn(0.75f, s1), __fmul_rn(0.25f, s2));
}

__device__ __forceinline__ float pair_mean(float a, float b) {
  return __fmul_rn(__fadd_rn(a, b), 0.5f);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}

// Stage image rows y0 - hy .. y0 - hy + nrows - 1 (reflected) and, of each,
// the floats a .. a + sw - 1 of its W * C interleaved row (a 16-byte
// aligned start, a multiple of 4; positions outside the row reflected by
// pixel). Whole 16-byte chunks inside the row go by cp.async when `vec`.
__device__ __forceinline__ void stage(float* S, const float* img, int y0,
                                      int hy, int nrows, int a, int sw, int H,
                                      int W, int C, int vec) {
  const int WC = W * C, chunks = sw / 4;
  for (int e = threadIdx.x; e < nrows * chunks; e += THREADS) {
    const int j = e / chunks, k = e - j * chunks;
    const float* row = img + (size_t)reflect_clamp(y0 - hy + j, H) * WC;
    const int g = a + 4 * k;
    float* dst = S + j * sw + 4 * k;
    if (vec && g >= 0 && g + 4 <= WC) {
      cp_async16(dst, row + g);
    } else {
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int px = floor_div(g + u, C), c = g + u - px * C;
        dst[u] = __ldg(row + reflect_clamp(px, W) * C + c);
      }
    }
  }
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::);
  __syncthreads();
}

// CC: the channel count when it is 3 (a compile-time constant), else 0
// and C is read from the argument
template <int CC>
__global__ void __launch_bounds__(THREADS)
corrupt_tile_kernel(const float* __restrict__ x, float* __restrict__ y,
                    const int* __restrict__ choice,
                    const int* __restrict__ seeds, int H, int W, int C_arg,
                    float sigma, int R, float inv_k, int vec) {
  extern __shared__ __align__(16) float S[];
  const int C = CC ? CC : C_arg;
  const int WC = W * C, TWC = TW * C;
  const int b = blockIdx.z;
  const int x0 = blockIdx.x * TW, y0 = blockIdx.y * TH;
  const int f0 = x0 * C;                    // the tile's first row float
  const int fn = min(TW, W - x0) * C;       // its floats a row
  const int rows = min(TH, H - y0);
  const float* img = x + (size_t)b * H * WC;
  float* out = y + (size_t)b * H * WC;
  const int ch = choice[b];

  if (ch == 2 || ch == 3) {
    const int hx = ch == 2 ? R : 2, hy = ch == 2 ? 0 : 2;
    const int a = (f0 - hx * C) & ~3;        // floor to a multiple of 4
    const int sw = stage_width(hx, C);
    stage(S, img, y0, hy, TH + 2 * hy, a, sw, H, W, C, vec);
    if (ch == 2) {  // blur: k taps along the staged row, from 0
      for (int e = threadIdx.x; e < TH * TWC; e += THREADS) {
        const int r = e / TWC, f = e - r * TWC;
        if (r >= rows || f >= fn) continue;
        const float* base = S + r * sw + (f0 + f - a);
        float acc = 0.f;
        for (int t = -R; t <= R; ++t) acc = __fadd_rn(acc, base[t * C]);
        out[(size_t)(y0 + r) * WC + f0 + f] =
            fminf(fmaxf(rintf(__fmul_rn(acc, inv_k)), 0.f), 255.f);
      }
    } else {  // lowres: the horizontal FIR of every staged row, once
      float* Hb = S + (TH + 4) * sw;
      for (int e = threadIdx.x; e < (TH + 4) * TW; e += THREADS) {
        const int j = e / TW, xi = e - j * TW, px = x0 + xi;
        if (px >= W) continue;
        int q1, q2;
        fir_taps(px, &q1, &q2);
        const float* srow = S + j * sw - a;
        for (int c = 0; c < C; ++c) {
          const float s1 = pair_mean(srow[q1 * C + c], srow[(q1 + 1) * C + c]);
          const float s2 = pair_mean(srow[q2 * C + c], srow[(q2 + 1) * C + c]);
          Hb[j * TWC + xi * C + c] = fir(s1, s2);
        }
      }
      __syncthreads();
      // then the vertical FIR; staged row j holds image row y0 - 2 + j
      for (int e = threadIdx.x; e < TH * TWC; e += THREADS) {
        const int r = e / TWC, f = e - r * TWC;
        if (r >= rows || f >= fn) continue;
        int r1, r2;
        fir_taps(y0 + r, &r1, &r2);
        const float* h1 = Hb + (r1 - y0 + 2) * TWC + f;
        const float* h2 = Hb + (r2 - y0 + 2) * TWC + f;
        const float v = fir(pair_mean(h1[0], h1[TWC]),
                            pair_mean(h2[0], h2[TWC]));
        out[(size_t)(y0 + r) * WC + f0 + f] =
            fminf(fmaxf(floorf(__fadd_rn(v, 0.5f)), 0.f), 255.f);
      }
    }
    return;
  }

  // clean (0 and any other id) and noise (1): the element index of the
  // noise draw is the flat (y * W + x) * C + c within the image
  const bool noise = ch == 1;
  const uint32_t key = noise ? fmix32((uint32_t)seeds[b] ^ 0x9E3779B9u) : 0u;
  if (vec) {
    const int n4 = TWC / 4;
    for (int e = threadIdx.x; e < TH * n4; e += THREADS) {
      const int r = e / n4, f = 4 * (e - r * n4);
      if (r >= rows || f >= fn) continue;
      const int i = (y0 + r) * WC + f0 + f;
      float4 v = __ldg(reinterpret_cast<const float4*>(img + i));
      if (noise) {
        v.x = noise_value(v.x, (uint32_t)i, key, sigma);
        v.y = noise_value(v.y, (uint32_t)i + 1u, key, sigma);
        v.z = noise_value(v.z, (uint32_t)i + 2u, key, sigma);
        v.w = noise_value(v.w, (uint32_t)i + 3u, key, sigma);
      }
      *reinterpret_cast<float4*>(out + i) = v;
    }
  } else {
    for (int e = threadIdx.x; e < TH * TWC; e += THREADS) {
      const int r = e / TWC, f = e - r * TWC;
      if (r >= rows || f >= fn) continue;
      const int i = (y0 + r) * WC + f0 + f;
      const float v = __ldg(img + i);
      out[i] = noise ? noise_value(v, (uint32_t)i, key, sigma) : v;
    }
  }
}

}  // namespace

// x, y (B, H, W, C) f32; choice, seeds (B,) int32. H and W even and >= 8,
// blur_k odd with blur_k / 2 < W, inv_k = float(1 / blur_k) (checked by
// the wrapper). smem and vec: the plan of kernels.corrupt_plan (vec: W * C
// a multiple of 4 and x, y 16-byte aligned).
extern "C" int corrupt_nhwc(const void* x, void* y, const void* choice,
                            const void* seeds, int B, int H, int W, int C,
                            float sigma, int blur_k, float inv_k, int smem,
                            int vec, void* stream) {
  if (B <= 0 || B > 65535 || H <= 0 || W <= 0 || C <= 0 || blur_k <= 0 ||
      blur_k / 2 >= W || (size_t)H * W * C >= (size_t)1 << 31)
    return static_cast<int>(cudaErrorInvalidValue);
  const int R = blur_k / 2;
  if ((size_t)smem != smem_bytes(C, R) || (size_t)smem > SMEM_LIMIT)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto kernel = C == 3 ? corrupt_tile_kernel<3> : corrupt_tile_kernel<0>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<grid, THREADS, smem, s>>>(
      static_cast<const float*>(x), static_cast<float*>(y),
      static_cast<const int*>(choice), static_cast<const int*>(seeds), H, W,
      C, sigma, R, inv_k, vec);
  return static_cast<int>(cudaGetLastError());
}
