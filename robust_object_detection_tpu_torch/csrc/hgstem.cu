// K4-f: the HGNetv2 stem (HGStem) from the image to stem3's output, NHWC,
// eval mode.
//
// Replaces: robust_object_detection_tpu/ops/pallas_stem.py, _stem1_kernel,
// _conv2x2_kernel (twice), _assemble_kernel and _stem3_kernel (public entry
// stem_fused_inference):
//   stem1   conv3x3 stride 2 pad 1, 3 -> 32, BN1 (eps 1e-3) + ReLU   -> a1
//   stem2a  conv2x2 (zero pad right/bottom, VALID), 32 -> 16, BN + ReLU
//   stem2b  conv2x2 (same padding), 16 -> 32, BN + ReLU             -> a2b
//   pool    2x2 stride-1 max of a1 with zero pad right/bottom (equal to the
//           ceil-mode pool, since a1 >= 0)
//   cat     [pool, a2b], 64 channels
//   stem3   conv3x3 stride 2 pad 1, 64 -> 32, returned BEFORE BN3 (the
//           caller applies BN3 + ReLU and the 1x1 stem4).
// Every BN is folded from the running statistics by the caller into
// (g, b) f32 vectors: bn(y) = g * y + b.
//
// The TPU version keeps every tensor as (B, H, C, W) channel planes, builds
// conv patches from lane rolls, splits even and odd columns for the
// stride-2 convs and walks 8-row blocks in order, because NHWC tensors of
// 3..64 channels are lane padded there and strided lane slices do not
// exist. None of that comes along: here every stage reads and writes NHWC
// with plain indices, and blocks run in any order.
//
// Stages (five launches on one stream):
//   1. stem1 through the tiled conv of conv_tile.cuh, BN1 + ReLU in its
//      epilogue on the f32 accumulator; a1 stored in the working dtype;
//   2. stem2a, conv2x2_relu_kernel<32, 16>;
//   3. stem2b, conv2x2_relu_kernel<16, 32>, written straight into channels
//      32..63 of the concat buffer (output channel stride 64);
//   4. pool2x2_kernel writes channels 0..31 of the concat buffer;
//   5. stem3 through the tiled conv, no epilogue.
// The concat buffer does reach memory (the pool is not fused into stem3's
// staging): a later change can save its 2 x B x H/2 x W/2 x 64 elements of
// traffic.
//
// Rounding: a1, a2a, a2b (hence the concat) and y3 are stored in the
// working dtype; every sum and every BN + ReLU runs in f32 on the
// accumulator. (The TPU kernels store the pre-BN y and apply BN + ReLU
// while reading: the same math with one rounding moved.)
//
// What bounds it on the H100: 40 GFLOP at (8, 1024, 1024, 3) against
// about 84 MB that must move (x and y3 in bf16), so operations; with plain
// CUDA cores the 2x2 convs and stem3 dominate. Tensor cores are later work.

#include "conv_tile.cuh"

namespace rodt {

// y[b, i, j, off + co] = relu(g[co] * sum_{dy,dx in {0,1}, ci}
//     x[b, i+dy, j+dx, ci] * w[dy, dx, ci, co] + b[co]),  x zero outside.
// One block: a TILE x TILE pixel tile of one image, all COUT channels.
// 256 threads = 64 pixel groups x 4 channel groups; a thread accumulates
// 4 pixels x COUT/4 channels. ldo is the channel stride of y.
template <typename T, int CIN, int COUT>
__global__ void __launch_bounds__(THREADS)
conv2x2_relu_kernel(const T* __restrict__ x, const T* __restrict__ w,
                    const float* __restrict__ g, const float* __restrict__ b,
                    T* __restrict__ y, int H, int W, int ldo, int off,
                    int tiles_x) {
  constexpr int IN_T = TILE + 1;
  constexpr int CPT = COUT / 4;  // channels per thread
  static_assert(CPT % 4 == 0, "COUT must be a multiple of 16");
  __shared__ float s_in[CIN][IN_T][IN_T];
  __shared__ __align__(16) float s_w[4][CIN][COUT];

  const int tid = threadIdx.x;
  const int cg = tid & 3;
  const int pg = tid >> 2;
  const int tx = pg & (TILE - 1);
  const int ty0 = pg >> 4;
  const int oy0 = (blockIdx.x / tiles_x) * TILE;
  const int ox0 = (blockIdx.x % tiles_x) * TILE;
  const int bi = blockIdx.y;
  const T* xb = x + (size_t)bi * H * W * CIN;

  for (int idx = tid; idx < CIN * IN_T * IN_T; idx += THREADS) {
    const int c = idx % CIN;  // fastest: contiguous in NHWC
    const int pix = idx / CIN;
    const int iy = pix / IN_T, ix = pix % IN_T;
    const int gy = oy0 + iy, gx = ox0 + ix;
    float v = 0.f;
    if (gy < H && gx < W) v = to_f(xb[((size_t)gy * W + gx) * CIN + c]);
    s_in[c][iy][ix] = v;
  }
  for (int idx = tid; idx < 4 * CIN * COUT; idx += THREADS)
    (&s_w[0][0][0])[idx] = to_f(w[idx]);
  __syncthreads();

  float acc[4][CPT];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int k = 0; k < CPT; ++k) acc[j][k] = 0.f;

  for (int c = 0; c < CIN; ++c) {
#pragma unroll
    for (int dy = 0; dy < 2; ++dy) {
#pragma unroll
      for (int dx = 0; dx < 2; ++dx) {
        float wv[CPT];
#pragma unroll
        for (int k4 = 0; k4 < CPT; k4 += 4) {
          const float4 t = *reinterpret_cast<const float4*>(
              &s_w[dy * 2 + dx][c][cg * CPT + k4]);
          wv[k4] = t.x;
          wv[k4 + 1] = t.y;
          wv[k4 + 2] = t.z;
          wv[k4 + 3] = t.w;
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float xv = s_in[c][ty0 + 4 * j + dy][tx + dx];
#pragma unroll
          for (int k = 0; k < CPT; ++k)
            acc[j][k] = fmaf(xv, wv[k], acc[j][k]);
        }
      }
    }
  }

  const int ox = ox0 + tx;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int oy = oy0 + ty0 + 4 * j;
    if (oy >= H || ox >= W) continue;
    T* yp = y + (((size_t)bi * H + oy) * W + ox) * ldo + off + cg * CPT;
#pragma unroll
    for (int k = 0; k < CPT; ++k) {
      const int co = cg * CPT + k;
      yp[k] = from_f<T>(fmaxf(acc[j][k] * g[co] + b[co], 0.f));
    }
  }
}

// y[b, i, j, c] (channel stride ldo) = max over dy, dx in {0, 1} of
// a[b, i+dy, j+dx, c], a zero outside; one thread per output element.
template <typename T>
__global__ void __launch_bounds__(THREADS)
pool2x2_kernel(const T* __restrict__ a, T* __restrict__ y, int H, int W,
               int C, int ldo, size_t total) {
  const size_t i = (size_t)blockIdx.x * THREADS + threadIdx.x;
  if (i >= total) return;
  const int c = (int)(i % C);
  const size_t pix = i / C;
  const int xq = (int)(pix % W);
  const int yq = (int)((pix / W) % H);
  const bool right = xq + 1 < W, below = yq + 1 < H;
  const size_t row = (size_t)W * C;
  float m = to_f(a[i]);
  m = fmaxf(m, right ? to_f(a[i + C]) : 0.f);
  m = fmaxf(m, below ? to_f(a[i + row]) : 0.f);
  m = fmaxf(m, (right && below) ? to_f(a[i + row + C]) : 0.f);
  y[pix * ldo + c] = from_f<T>(m);
}

template <typename T>
inline int launch_mid_stages(const void* a1, const void* k2a,
                             const float* g2a, const float* b2a,
                             const void* k2b, const float* g2b,
                             const float* b2b, void* a2a, void* cat, int B,
                             int H2, int W2, cudaStream_t st) {
  const int tiles_x = (W2 + TILE - 1) / TILE;
  dim3 grid(tile_count(H2, W2), B);
  conv2x2_relu_kernel<T, 32, 16><<<grid, THREADS, 0, st>>>(
      static_cast<const T*>(a1), static_cast<const T*>(k2a), g2a, b2a,
      static_cast<T*>(a2a), H2, W2, 16, 0, tiles_x);
  int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  conv2x2_relu_kernel<T, 16, 32><<<grid, THREADS, 0, st>>>(
      static_cast<const T*>(a2a), static_cast<const T*>(k2b), g2b, b2b,
      static_cast<T*>(cat), H2, W2, 64, 32, tiles_x);
  err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  const size_t total = (size_t)B * H2 * W2 * 32;
  const unsigned blocks = (unsigned)((total + THREADS - 1) / THREADS);
  pool2x2_kernel<T><<<blocks, THREADS, 0, st>>>(
      static_cast<const T*>(a1), static_cast<T*>(cat), H2, W2, 32, 64,
      total);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace rodt

// x (B, H, W, 3); k1 (3,3,3,32), k2a (2,2,32,16), k2b (2,2,16,32), k3
// (3,3,64,32) HWIO in the working dtype; g*, b* the folded BN vectors, f32;
// a1 (B, H/2, W/2, 32), a2a (B, H/2, W/2, 16) and cat (B, H/2, W/2, 64) are
// scratch in the working dtype; y3 (B, H/4, W/4, 32). H and W are
// multiples of 4.
extern "C" int hgstem_nhwc(const void* x, const void* k1, const void* g1,
                           const void* b1, const void* k2a, const void* g2a,
                           const void* b2a, const void* k2b, const void* g2b,
                           const void* b2b, const void* k3, void* a1,
                           void* a2a, void* cat, void* y3, int B, int H,
                           int W, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B <= 0 || B > 65535 || H <= 0 || W <= 0 || H % 4 || W % 4)
    return static_cast<int>(cudaErrorInvalidValue);
  const int H2 = H / 2, W2 = W / 2;
  rodt::ConvOpts p1;
  p1.out_scale = static_cast<const float*>(g1);
  p1.out_bias = static_cast<const float*>(b1);
  int err = rodt::launch_conv3x3_dtype<2, rodt::ACT_RELU>(
      dtype, x, k1, a1, p1, B, H, W, 3, 32, st);
  if (err != 0) return err;
  const float* fg2a = static_cast<const float*>(g2a);
  const float* fb2a = static_cast<const float*>(b2a);
  const float* fg2b = static_cast<const float*>(g2b);
  const float* fb2b = static_cast<const float*>(b2b);
  if (dtype == rodt::DTYPE_F32)
    err = rodt::launch_mid_stages<float>(a1, k2a, fg2a, fb2a, k2b, fg2b,
                                         fb2b, a2a, cat, B, H2, W2, st);
  else
    err = rodt::launch_mid_stages<__nv_bfloat16>(
        a1, k2a, fg2a, fb2a, k2b, fg2b, fb2b, a2a, cat, B, H2, W2, st);
  if (err != 0) return err;
  // no epilogue asked for, so the activation is never applied; the ReLU
  // instantiation is stem1's, reused
  return rodt::launch_conv3x3_dtype<2, rodt::ACT_RELU>(
      dtype, cat, k3, y3, rodt::ConvOpts(), B, H2, W2, 64, 32, st);
}
