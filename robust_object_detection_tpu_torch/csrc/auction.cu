// K6: B independent Q x M one-to-one assignments by the Bertsekas forward
// auction with a round cap, plus the greedy completion of capped images, in
// one launch.
//
// Replaces: robust_object_detection_tpu/ops/assignment.py, _auction_kernel
// (public entry auction_assignment). Bidders are the ground-truth columns,
// items the queries. A round: every valid GT that owns no query finds its
// best and second best net value (value - price) over the queries and bids
// v1 - w2 + eps on the best one, v1 = net1 + price[best]; a query takes its
// highest bid (ties to the lowest GT index) and that bid becomes its price.
// The rounds stop when no valid GT is unassigned or at max_rounds. An image
// that still has an unassigned valid GT then is `capped`: its matching is
// replaced by a from-scratch greedy solve (repeatedly the globally cheapest
// pair whose cost is below BIG / 2, ties to the lowest query then the lowest
// GT index, retiring its row and column).
//
// The TPU version runs all images in lockstep as (B, Mp, Qp) vector sweeps
// with the value tensor resident in VMEM, argmax / mask-reduce passes over
// the whole tensor per round, and a greedy step that rescans the whole
// matrix per pick. Here one block owns one image and stops on its own:
// prices, owners, bids and the per-GT state live in shared memory, the
// value rows (M, Q), row-major so a GT's scan is coalesced, are read from
// global memory (B x M x Q x 4 bytes, L2 resident). Per round each warp
// takes bidding GTs in turn, lanes scan the queries keeping a (best, index,
// second best) triple merged by shuffles; bids meet in a 64-bit shared
// atomicMax on (orderable bid bits, ~GT index), whose result does not depend
// on arrival order. The greedy completion keeps per GT column its best
// unused query, picks the best column with one block reduction, and
// rescans only the columns whose best query was just taken. Every compare
// is an f32 compare on the same values as the plain version's, so the
// result is the same bits.
//
// What bounds it on the H100: neither bytes nor operations of the card;
// it is a chain of dependent rounds inside one block per image (latency),
// on 8 of 132 SMs. The floor is one read of value and one write of owner.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int AU_THREADS = 1024;
constexpr int AU_WARPS = AU_THREADS / 32;
constexpr float NEG = -1e18f;   // "no bid" / masked sentinel
constexpr float BIG = 1e6f;     // prohibitive cost of a padded GT
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ unsigned orderable(float f) {
  const unsigned u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}
__device__ __forceinline__ float from_orderable(unsigned k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

// (v, i) beats (w, j): larger value, ties to the lower index
__device__ __forceinline__ bool beats(float v, int i, float w, int j) {
  return v > w || (v == w && i < j);
}

// Warp scan of row[q] - price[q] (price == nullptr: row[q]) over the
// queries not flagged in `skip` (skip == nullptr: all): best value, its
// lowest index, and the best of the rest (NEG if there is none). All lanes
// return the same triple.
__device__ __forceinline__ void warp_top2(const float* __restrict__ row,
                                          const float* price,
                                          const unsigned char* skip, int Q,
                                          float& best, int& arg,
                                          float& second) {
  const int lane = threadIdx.x & 31;
  float b1 = -INFINITY, b2 = NEG;
  int a1 = INT32_MAX;
  for (int q = lane; q < Q; q += 32) {
    if (skip != nullptr && skip[q]) continue;
    const float v = price != nullptr ? row[q] - price[q] : row[q];
    if (v > b1) {
      b2 = fmaxf(b2, b1);
      b1 = v;
      a1 = q;
    } else {
      b2 = fmaxf(b2, v);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float o1 = __shfl_xor_sync(FULL, b1, off);
    const int oa = __shfl_xor_sync(FULL, a1, off);
    const float o2 = __shfl_xor_sync(FULL, b2, off);
    if (beats(o1, oa, b1, a1)) {
      b2 = fmaxf(o2, b1);
      b1 = o1;
      a1 = oa;
    } else {
      b2 = fmaxf(b2, o1);
    }
  }
  best = b1;
  arg = a1;
  second = b2;
}

__global__ void __launch_bounds__(AU_THREADS)
auction_kernel(const float* __restrict__ value,
               const unsigned char* __restrict__ valid,
               int* __restrict__ owner_out, int* __restrict__ capped_out,
               int Q, int M, float eps, int max_rounds, int complete_greedy) {
  extern __shared__ __align__(8) unsigned char smem_raw[];
  unsigned long long* bid = reinterpret_cast<unsigned long long*>(smem_raw);
  float* price = reinterpret_cast<float*>(bid + Q);       // [Q]
  int* owner = reinterpret_cast<int*>(price + Q);          // [Q]
  float* colbest = reinterpret_cast<float*>(owner + Q);    // [M]
  int* colq = reinterpret_cast<int*>(colbest + M);         // [M]
  unsigned char* assigned = reinterpret_cast<unsigned char*>(colq + M);
  unsigned char* q_used = assigned + M;                    // [Q]
  unsigned char* m_used = q_used + Q;                      // [M]
  __shared__ float red_v[AU_WARPS];
  __shared__ int red_q[AU_WARPS], red_m[AU_WARPS];
  __shared__ int pick_q;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.x;
  const float* val = value + (size_t)b * M * Q;
  const unsigned char* vld = valid + (size_t)b * M;

  for (int q = tid; q < Q; q += AU_THREADS) {
    price[q] = 0.f;
    owner[q] = -1;
  }
  __syncthreads();

  int capped = 0;
  for (int r = 0;; ++r) {
    for (int m = tid; m < M; m += AU_THREADS) assigned[m] = 0;
    for (int q = tid; q < Q; q += AU_THREADS) bid[q] = 0ull;
    __syncthreads();
    for (int q = tid; q < Q; q += AU_THREADS)
      if (owner[q] >= 0) assigned[owner[q]] = 1;
    __syncthreads();
    int open = 0;
    for (int m = tid; m < M; m += AU_THREADS)
      open |= (vld[m] && !assigned[m]);
    capped = __syncthreads_or(open);
    if (!capped || r >= max_rounds) break;

    for (int m = warp; m < M; m += AU_WARPS) {
      if (!vld[m] || assigned[m]) continue;  // warp-uniform
      float net1, w2;
      int j1;
      warp_top2(val + (size_t)m * Q, price, nullptr, Q, net1, j1, w2);
      if (lane == 0) {
        const float v1 = net1 + price[j1];
        const float bp = v1 - w2 + eps;
        atomicMax(&bid[j1], ((unsigned long long)orderable(bp) << 32) |
                                (unsigned)(0x7fffffff - m));
      }
    }
    __syncthreads();
    for (int q = tid; q < Q; q += AU_THREADS) {
      const unsigned long long k = bid[q];
      if (k == 0ull) continue;
      const float best = from_orderable((unsigned)(k >> 32));
      if (best > NEG / 2) {
        price[q] = best;
        owner[q] = 0x7fffffff - (int)(unsigned)(k & 0xffffffffu);
      }
    }
    __syncthreads();
  }

  if (capped && complete_greedy) {
    // from-scratch greedy on the raw values; prices are discarded
    for (int q = tid; q < Q; q += AU_THREADS) {
      owner[q] = -1;
      q_used[q] = 0;
    }
    for (int m = tid; m < M; m += AU_THREADS) m_used[m] = 0;
    __syncthreads();
    for (int m = warp; m < M; m += AU_WARPS) {
      float v, s;
      int a;
      warp_top2(val + (size_t)m * Q, nullptr, nullptr, Q, v, a, s);
      if (lane == 0) {
        colbest[m] = v;
        colq[m] = a;
        // a column with no pair below BIG / 2 can never be picked
        if (!(v > -BIG / 2)) m_used[m] = 1;
      }
    }
    __syncthreads();
    const int n_iter = min(Q, M);
    for (int it = 0; it < n_iter; ++it) {
      // the best unused column: largest value, then lowest query, then
      // lowest GT index (the plain version's argmin over the flat (q, m))
      float bv = -INFINITY;
      int bq = INT32_MAX, bm = INT32_MAX;
      for (int m = tid; m < M; m += AU_THREADS) {
        if (m_used[m]) continue;
        const float v = colbest[m];
        const int q = colq[m];
        if (v > bv || (v == bv && (q < bq || (q == bq && m < bm)))) {
          bv = v;
          bq = q;
          bm = m;
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float ov = __shfl_xor_sync(FULL, bv, off);
        const int oq = __shfl_xor_sync(FULL, bq, off);
        const int om = __shfl_xor_sync(FULL, bm, off);
        if (ov > bv || (ov == bv && (oq < bq || (oq == bq && om < bm)))) {
          bv = ov;
          bq = oq;
          bm = om;
        }
      }
      if (lane == 0) {
        red_v[warp] = bv;
        red_q[warp] = bq;
        red_m[warp] = bm;
      }
      __syncthreads();
      if (warp == 0) {
        bv = red_v[lane];
        bq = red_q[lane];
        bm = red_m[lane];
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
          const float ov = __shfl_xor_sync(FULL, bv, off);
          const int oq = __shfl_xor_sync(FULL, bq, off);
          const int om = __shfl_xor_sync(FULL, bm, off);
          if (ov > bv || (ov == bv && (oq < bq || (oq == bq && om < bm)))) {
            bv = ov;
            bq = oq;
            bm = om;
          }
        }
        if (lane == 0) {
          const bool take = bm != INT32_MAX && bv > -BIG / 2;
          pick_q = take ? bq : -1;
          if (take) {
            owner[bq] = bm;
            q_used[bq] = 1;
            m_used[bm] = 1;
          }
        }
      }
      __syncthreads();
      const int pq = pick_q;
      if (pq < 0) break;  // block-uniform: nothing assignable is left
      for (int m = warp; m < M; m += AU_WARPS) {
        if (m_used[m] || colq[m] != pq) continue;  // warp-uniform
        float v, s;
        int a;
        warp_top2(val + (size_t)m * Q, nullptr, q_used, Q, v, a, s);
        if (lane == 0) {
          colbest[m] = v;
          colq[m] = a;
          if (!(v > -BIG / 2)) m_used[m] = 1;
        }
      }
      __syncthreads();
    }
  }

  for (int q = tid; q < Q; q += AU_THREADS)
    owner_out[(size_t)b * Q + q] = owner[q];
  if (tid == 0) capped_out[b] = capped ? 1 : 0;
}

}  // namespace

// value (B, M, Q) f32 = -cost transposed (padded GTs at <= -BIG); valid
// (B, M) bytes (0 / 1); owner (B, Q) int32 out (-1 = unmatched); capped
// (B,) int32 out.
extern "C" int auction_assign(const void* value, const void* valid,
                              void* owner, void* capped, int B, int Q, int M,
                              float eps, int max_rounds, int complete_greedy,
                              void* stream) {
  if (B <= 0 || Q <= 0 || M <= 0 || max_rounds < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = (size_t)Q * (8 + 4 + 4 + 1) + (size_t)M * (4 + 4 + 2);
  if (smem > 200 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = cudaFuncSetAttribute(
      auction_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  auction_kernel<<<B, AU_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(value),
      static_cast<const unsigned char*>(valid), static_cast<int*>(owner),
      static_cast<int*>(capped), Q, M, eps, max_rounds, complete_greedy);
  return static_cast<int>(cudaGetLastError());
}
