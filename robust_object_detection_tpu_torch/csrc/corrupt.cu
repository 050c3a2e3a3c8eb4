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
// What bounds it on the H100: bytes. One f32 read and one write per
// element (16 x 1024 x 1024 x 3 x 8 bytes = 403 MB per step); the blur's 9
// and the lowres' 16 taps per output hit L1/L2, since neighbouring threads
// read neighbouring elements. The TPU kernel needed reflect-padded copies
// and row tiles with DMA halos; here each thread maps its taps' indices
// through reflect-101 itself, so there is no padded copy and no tiling.
// The per-image choice is read once per block (blocks never straddle
// images), so the branch never diverges inside a warp.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

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

__device__ __forceinline__ float pix(const float* img, int y, int x, int c,
                                     int H, int W, int C) {
  return img[((size_t)reflect101(y, H) * W + reflect101(x, W)) * C + c];
}

// mean of the 2x2-box pair starting at q along x (row y): (v[q] + v[q+1])/2
__device__ __forceinline__ float pair_x(const float* img, int y, int q,
                                        int c, int H, int W, int C) {
  return __fmul_rn(__fadd_rn(pix(img, y, q, c, H, W, C),
                             pix(img, y, q + 1, c, H, W, C)),
                   0.5f);
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

// horizontal FIR at (row y, column x)
__device__ __forceinline__ float lowres_h(const float* img, int y, int x,
                                          int c, int H, int W, int C) {
  int q1, q2;
  fir_taps(x, &q1, &q2);
  return fir(pair_x(img, y, q1, c, H, W, C), pair_x(img, y, q2, c, H, W, C));
}

__global__ void __launch_bounds__(THREADS)
corrupt_kernel(const float* __restrict__ x, float* __restrict__ y,
               const int* __restrict__ choice, const int* __restrict__ seeds,
               int H, int W, int C, float sigma, int blur_k, float inv_k) {
  const int b = blockIdx.y;
  const size_t per_img = (size_t)H * W * C;
  const size_t i = (size_t)blockIdx.x * THREADS + threadIdx.x;
  if (i >= per_img) return;
  const float* img = x + b * per_img;
  float* out = y + b * per_img;
  const int c = (int)(i % C);
  const int px = (int)((i / C) % W);
  const int py = (int)(i / ((size_t)C * W));
  const int ch = choice[b];

  float v;
  if (ch == 1) {  // noise
    const uint32_t key = fmix32((uint32_t)seeds[b] ^ 0x9E3779B9u);
    const uint32_t bits = fmix32(fmix32((uint32_t)i ^ key) + key);
    const float u1 = ((float)(bits & 0xFFFFu) + 0.5f) / 65536.0f;
    const float u2 = ((float)((bits >> 16) & 0xFFFFu) + 0.5f) / 65536.0f;
    const float g = sqrtf(-2.0f * logf(u1)) * cosf(6.2831855f * u2);
    v = floorf(fminf(fmaxf(__fadd_rn(img[i], __fmul_rn(sigma, g)), 0.f),
                     255.f));
  } else if (ch == 2) {  // blur
    float acc = 0.f;
    for (int t = -(blur_k / 2); t <= blur_k / 2; ++t)
      acc = __fadd_rn(acc, pix(img, py, px + t, c, H, W, C));
    v = fminf(fmaxf(rintf(__fmul_rn(acc, inv_k)), 0.f), 255.f);
  } else if (ch == 3) {  // lowres
    int r1, r2;
    fir_taps(py, &r1, &r2);
    const float s1 = __fmul_rn(__fadd_rn(lowres_h(img, r1, px, c, H, W, C),
                                         lowres_h(img, r1 + 1, px, c, H, W,
                                                  C)),
                               0.5f);
    const float s2 = __fmul_rn(__fadd_rn(lowres_h(img, r2, px, c, H, W, C),
                                         lowres_h(img, r2 + 1, px, c, H, W,
                                                  C)),
                               0.5f);
    v = fminf(fmaxf(floorf(__fadd_rn(fir(s1, s2), 0.5f)), 0.f), 255.f);
  } else {  // clean
    v = img[i];
  }
  out[i] = v;
}

}  // namespace

// x, y (B, H, W, C) f32; choice, seeds (B,) int32. H and W even and >= 8
// (checked by the wrapper), blur_k odd, inv_k = float(1 / blur_k).
extern "C" int corrupt_nhwc(const void* x, void* y, const void* choice,
                            const void* seeds, int B, int H, int W, int C,
                            float sigma, int blur_k, float inv_k,
                            void* stream) {
  if (B <= 0 || B > 65535 || H <= 0 || W <= 0 || C <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t per_img = (size_t)H * W * C;
  dim3 grid((unsigned)((per_img + THREADS - 1) / THREADS), B);
  corrupt_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(y),
      static_cast<const int*>(choice), static_cast<const int*>(seeds), H, W,
      C, sigma, blur_k, inv_k);
  return static_cast<int>(cudaGetLastError());
}
