// K6: B independent Q x M one-to-one assignments by the Bertsekas forward
// auction with a round cap, plus the greedy completion of capped images, in
// one launch.
//
// Replaces: robust_object_detection_tpu/ops/assignment.py, _auction_kernel
// (public entry auction_assignment). Bidders are the ground-truth columns,
// items the queries. A round: every valid GT that owns no query finds its
// best and second best net value (value - price, value = -cost) over the
// queries and bids v1 - w2 + eps on the best one, v1 = net1 + price[best];
// a query takes its highest bid (ties to the lowest GT index) and that bid
// becomes its price. The rounds stop when no valid GT is unassigned or at
// max_rounds. An image that still has an unassigned valid GT then is
// `capped`: its matching is replaced by a from-scratch greedy solve
// (repeatedly the globally cheapest pair whose cost is below BIG / 2, ties
// to the lowest query then the lowest GT index, retiring its row and
// column).
//
// The TPU version runs all images in lockstep as (B, Mp, Qp) vector sweeps
// with the value tensor resident in VMEM. Here one block owns one image and
// stops on its own; what bounds it on the H100 is neither bytes nor
// operations but a chain of dependent rounds inside one block (latency),
// on B of 132 SMs. The design cuts the length and the cost of that chain:
//
//  * The value rows are staged in shared memory once. The block reads
//    cost (B, Q, M) where the caller holds it, coalesced along M, and
//    stores -cost transposed, a GT's row of Q values contiguous (padded to
//    qs, a multiple of 4, for 16-byte reads). The GT columns are listed
//    valid first, each group in index order; the first `cap` valid columns
//    (as many as fit beside the per-query state) are staged, the rest are
//    read from cost where they lie by the same scans. One launch a call:
//    no transposed copy, no negation pass, no cast of `capped`.
//  * Every scan (a bidder's row, a column or a query in the greedy) runs
//    on a group of 8 lanes, four a warp, so 128 run at once (1024
//    threads: faster than 512 when images cap, about as fast when they
//    converge; tools/profile_torch_auction.py --threads). A lane keeps
//    one (best, index, second best) a float4 component, four independent
//    compare chains over 16-byte shared loads; the group merges them by
//    shuffles. The merge does not depend on order: ties go to the lower
//    index.
//  * A round costs two barriers. Bidders meet in a 64-bit shared atomicMax
//    on (orderable bid, ~column), whose result does not depend on arrival
//    order (a compare-and-swap loop in the SASS, which seldom spins: few
//    bidders meet on one query). The resolve pass updates the `assigned`
//    flags in place (a
//    query that changes hands unassigns its old owner and assigns the new
//    one; a GT owns at most one query and only unassigned GTs bid, so no
//    two writes collide), clears the bids and counts the GTs that became
//    assigned, which gives the open count for the next round's test.
//  * The greedy completion runs in rounds of locally dominant pairs. Pairs
//    are ordered strictly: larger value first, then lower query, then
//    lower GT (the plain version's first argmin over the flat (q, m)
//    index). Each free column keeps its best free query, each free query
//    its best free column; every pair that is each other's best is taken
//    at once, and only the columns and rows whose best was taken scan
//    again. Under a strict order the pairs taken are exactly those of the
//    sequential greedy (Preis 1999; Manne and Bisseling 2007); pairs whose
//    cost is BIG / 2 or more are never taken, as the plain version's guard.
//    The greedy first stages the columns the auction did not (invalid
//    ones) as far as they fit, and a column with no pair below BIG / 2
//    leaves the free set after its first scan, so that rows skip it.
//
// Every compare is an f32 compare on the same values as the plain
// version's, so owner and capped are the same, element for element.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int AU_THREADS = 1024;
constexpr int AU_WARPS = AU_THREADS / 32;
constexpr int STAGE_LOADS = 16;   // staging loads in flight a thread
constexpr int GROUP = 8;          // lanes of one scan
constexpr int GROUPS = AU_THREADS / GROUP;
constexpr float NEG = -1e18f;   // "no bid" / second-best sentinel
constexpr float BIG = 1e6f;     // prohibitive cost of a padded GT
constexpr unsigned FULL = 0xffffffffu;
// dynamic shared memory a block may take (227 KB less 1 KB for the
// kernel's static scalars); kernels.auction_plan uses the same number
constexpr size_t SMEM_LIMIT = 232448 - 1024;

// byte offsets of the dynamic shared memory's sections; each section is
// rounded up to 16 bytes (kernels.auction_plan mirrors this)
struct Layout {
  size_t val, price, bid, owner, rowm, cols, colq, cflag, qfree, total;
};

__host__ __device__ inline size_t take(size_t& o, size_t bytes) {
  const size_t at = o;
  o += (bytes + 15) & ~size_t(15);
  return at;
}

__host__ __device__ inline Layout layout(int Q, int M, int qs, int cap) {
  Layout L;
  size_t o = 0;
  L.val = take(o, (size_t)cap * qs * 4);    // staged rows, -cost
  L.price = take(o, (size_t)qs * 4);
  L.bid = take(o, (size_t)Q * 8);
  L.owner = take(o, (size_t)Q * 4);         // column list index or -1
  L.rowm = take(o, (size_t)Q * 4);          // greedy: best free column
  L.cols = take(o, (size_t)M * 4);          // list index -> GT index
  L.colq = take(o, (size_t)M * 4);          // greedy: best free query
  L.cflag = take(o, (size_t)M);             // assigned (auction) / free
  L.qfree = take(o, (size_t)qs);            // greedy: free query
  L.total = o;
  return L;
}

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

// one candidate of a lane's scan, the lane's queries in increasing order
__device__ __forceinline__ void consider(float v, int q, float& b1, int& a1,
                                         float& b2) {
  if (v > b1) {
    b2 = fmaxf(b2, b1);
    b1 = v;
    a1 = q;
  } else {
    b2 = fmaxf(b2, v);
  }
}

// A scan runs on a group of GROUP lanes (4 groups a warp): each lane keeps
// its own candidates, then the group's are merged by shuffles. Every lane
// of a warp takes part in the merge (a group without work merges its
// empty state), so the shuffles see a full warp.

// (o1, oa, o2) merged into (b1, a1, b2): the best of both, ties to the
// lower index, and the best of the rest
__device__ __forceinline__ void merge_pair(float o1, int oa, float o2,
                                           float& b1, int& a1, float& b2) {
  if (beats(o1, oa, b1, a1)) {
    b2 = fmaxf(o2, b1);
    b1 = o1;
    a1 = oa;
  } else {
    b2 = fmaxf(b2, o1);
  }
}

// the group's (best, lowest index, second best) merged; its lanes return it
__device__ __forceinline__ void merge_top2(float& b1, int& a1, float& b2) {
#pragma unroll
  for (int off = GROUP / 2; off > 0; off >>= 1) {
    const float o1 = __shfl_xor_sync(FULL, b1, off);
    const int oa = __shfl_xor_sync(FULL, a1, off);
    const float o2 = __shfl_xor_sync(FULL, b2, off);
    merge_pair(o1, oa, o2, b1, a1, b2);
  }
}

// A lane's part of a scan of a staged row (qs values, 16-byte aligned,
// pads at -inf) of value - price (kPrice) over the free queries (kSkip:
// qfree != 0): best value, its lowest query, and the best of the rest.
template <bool kPrice, bool kSkip>
__device__ __forceinline__ void lane_staged(const float* row,
                                            const float* price,
                                            const unsigned char* qfree,
                                            int qs, float& b1, int& a1,
                                            float& b2) {
  // one (best, index, second) a float4 component: four independent
  // compare chains, merged at the end (the merge does not depend on order)
  float c1[4] = {-INFINITY, -INFINITY, -INFINITY, -INFINITY};
  float c2[4] = {NEG, NEG, NEG, NEG};
  int ca[4] = {INT32_MAX, INT32_MAX, INT32_MAX, INT32_MAX};
  const float4* r4 = reinterpret_cast<const float4*>(row);
  for (int c = threadIdx.x & (GROUP - 1); c < qs / 4; c += GROUP) {
    float4 v = r4[c];
    if (kPrice) {
      const float4 p = reinterpret_cast<const float4*>(price)[c];
      v.x = v.x - p.x;
      v.y = v.y - p.y;
      v.z = v.z - p.z;
      v.w = v.w - p.w;
    }
    uchar4 f = make_uchar4(1, 1, 1, 1);
    if (kSkip) f = reinterpret_cast<const uchar4*>(qfree)[c];
    if (f.x) consider(v.x, 4 * c, c1[0], ca[0], c2[0]);
    if (f.y) consider(v.y, 4 * c + 1, c1[1], ca[1], c2[1]);
    if (f.z) consider(v.z, 4 * c + 2, c1[2], ca[2], c2[2]);
    if (f.w) consider(v.w, 4 * c + 3, c1[3], ca[3], c2[3]);
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) merge_pair(c1[j], ca[j], c2[j], b1, a1, b2);
}

// The same for a column that was not staged: -cost[q][m] read where it
// lies (stride M).
template <bool kPrice, bool kSkip>
__device__ __forceinline__ void lane_global(const float* __restrict__ cimg,
                                            int M, int m, int Q,
                                            const float* price,
                                            const unsigned char* qfree,
                                            float& b1, int& a1, float& b2) {
  for (int q = threadIdx.x & (GROUP - 1); q < Q; q += GROUP) {
    if (kSkip && !qfree[q]) continue;
    float v = -__ldg(cimg + (size_t)q * M + m);
    if (kPrice) v = v - price[q];
    consider(v, q, b1, a1, b2);
  }
}

// The group's scan of list entry i (staged when i < R) when `active`;
// every lane of the warp calls it. Returns (best, its query, second best).
template <bool kPrice, bool kSkip>
__device__ __forceinline__ void scan_column(bool active, int i, int R,
                                            const float* val, int qs,
                                            const float* __restrict__ cimg,
                                            int M, const int* cols, int Q,
                                            const float* price,
                                            const unsigned char* qfree,
                                            float& best, int& arg,
                                            float& second) {
  float b1 = -INFINITY, b2 = NEG;
  int a1 = INT32_MAX;
  if (active) {
    if (i < R)
      lane_staged<kPrice, kSkip>(val + (size_t)i * qs, price, qfree, qs, b1,
                                 a1, b2);
    else
      lane_global<kPrice, kSkip>(cimg, M, cols[i], Q, price, qfree, b1, a1,
                                 b2);
  }
  merge_top2(b1, a1, b2);
  best = b1;
  arg = a1;
  second = b2;
}

// The group's scan of query q's free columns when `active` (every lane of
// the warp calls it): the list entry of its best one under (larger value,
// lower GT index), or -1 when none is above -BIG / 2.
__device__ __forceinline__ int scan_row(bool active, int q, int R, int M,
                                        const float* val, int qs,
                                        const float* __restrict__ cimg,
                                        const int* cols,
                                        const unsigned char* cflag) {
  const int gl = threadIdx.x & (GROUP - 1);
  float bv = -INFINITY;
  int bm = INT32_MAX, bi = -1;
  if (active) {
    for (int i = gl; i < R; i += GROUP) {
      if (!cflag[i]) continue;
      const float v = val[(size_t)i * qs + q];
      const int m = cols[i];
      if (beats(v, m, bv, bm)) {
        bv = v;
        bm = m;
        bi = i;
      }
    }
    for (int i = R + gl; i < M; i += GROUP) {
      if (!cflag[i]) continue;
      const int m = cols[i];
      const float v = -__ldg(cimg + (size_t)q * M + m);
      if (beats(v, m, bv, bm)) {
        bv = v;
        bm = m;
        bi = i;
      }
    }
  }
#pragma unroll
  for (int off = GROUP / 2; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(FULL, bv, off);
    const int om = __shfl_xor_sync(FULL, bm, off);
    const int oi = __shfl_xor_sync(FULL, bi, off);
    if (beats(ov, om, bv, bm)) {
      bv = ov;
      bm = om;
      bi = oi;
    }
  }
  return (bi >= 0 && bv > -BIG / 2) ? bi : -1;
}

// Stage list entries i0 .. i1-1: val[i][q] = -cost[q][cols[i]], the pads
// q in [Q, qs) at -inf. Reads are coalesced along the listed columns,
// STAGE_LOADS loads in flight a thread; a thread walks (q, i) by a fixed
// stride with no division.
__device__ __forceinline__ void stage_rows(float* val,
                                           const float* __restrict__ cimg,
                                           const int* cols, int Q, int M,
                                           int qs, int i0, int i1) {
  const int n = i1 - i0, tid = threadIdx.x;
  if (n <= 0) return;
  const int dq = AU_THREADS / n, di = AU_THREADS - dq * n;
  int q = tid / n, i = tid - (tid / n) * n;
  while (q < Q) {
    float x[STAGE_LOADS];
    int at[STAGE_LOADS];
#pragma unroll
    for (int u = 0; u < STAGE_LOADS; ++u) {
      at[u] = -1;
      x[u] = 0.f;
      if (q < Q) {
        x[u] = __ldg(cimg + (size_t)q * M + cols[i0 + i]);
        at[u] = (i0 + i) * qs + q;
      }
      q += dq;
      i += di;
      if (i >= n) {
        i -= n;
        ++q;
      }
    }
#pragma unroll
    for (int u = 0; u < STAGE_LOADS; ++u)
      if (at[u] >= 0) val[at[u]] = -x[u];
  }
  if (qs > Q)
    for (int e = tid; e < n * (qs - Q); e += AU_THREADS) {
      const int i = e / (qs - Q);
      val[(i0 + i) * qs + Q + (e - i * (qs - Q))] = -INFINITY;
    }
}

// Block-wide exclusive prefix of a 0/1 flag; `total` gets the block's sum.
// Contains two barriers.
__device__ __forceinline__ int block_prefix(int flag, int* warp_tot,
                                            int& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned bal = __ballot_sync(FULL, flag);
  if (lane == 0) warp_tot[warp] = __popc(bal);
  __syncthreads();
  int pre = 0, tot = 0;
  for (int w = 0; w < AU_WARPS; ++w) {
    const int t = warp_tot[w];
    pre += w < warp ? t : 0;
    tot += t;
  }
  __syncthreads();
  total = tot;
  return pre + __popc(bal & ((1u << lane) - 1u));
}

__global__ void __launch_bounds__(AU_THREADS, 1)
auction_kernel(const float* __restrict__ cost,
               const unsigned char* __restrict__ valid,
               int* __restrict__ owner_out,
               unsigned char* __restrict__ capped_out, int* __restrict__ stats,
               int Q, int M, int qs, int cap, float eps, int max_rounds,
               int complete_greedy) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Layout L = layout(Q, M, qs, cap);
  float* val = reinterpret_cast<float*>(smem_raw + L.val);
  float* price = reinterpret_cast<float*>(smem_raw + L.price);
  unsigned long long* bid =
      reinterpret_cast<unsigned long long*>(smem_raw + L.bid);
  int* owner = reinterpret_cast<int*>(smem_raw + L.owner);
  int* rowm = reinterpret_cast<int*>(smem_raw + L.rowm);
  int* cols = reinterpret_cast<int*>(smem_raw + L.cols);
  int* colq = reinterpret_cast<int*>(smem_raw + L.colq);
  unsigned char* cflag = smem_raw + L.cflag;
  unsigned char* qfree = smem_raw + L.qfree;
  __shared__ int warp_tot[AU_WARPS];
  __shared__ int n_open;

  const int tid = threadIdx.x, lane = tid & 31;
  const int gid = tid / GROUP, gl = tid & (GROUP - 1);   // scan group, lane
  const int b = blockIdx.x;
  const float* cimg = cost + (size_t)b * Q * M;
  const unsigned char* vld = valid + (size_t)b * M;

  // the column list: valid GTs in index order, then the others
  int nv = 0;
  for (int base = 0; base < M; base += AU_THREADS)
    nv += __syncthreads_count(base + tid < M && vld[base + tid]);
  int v_seen = 0, o_seen = 0;
  for (int base = 0; base < M; base += AU_THREADS) {
    const int m = base + tid;
    const int f = m < M && vld[m] ? 1 : 0;
    int chunk_v;
    const int pv = block_prefix(f, warp_tot, chunk_v);
    if (m < M) cols[f ? v_seen + pv : nv + o_seen + (tid - pv)] = m;
    v_seen += chunk_v;
    o_seen += min(AU_THREADS, M - base) - chunk_v;
  }
  const int R = min(nv, cap);   // staged rows: list entries 0 .. R-1

  for (int q = tid; q < qs; q += AU_THREADS) {
    price[q] = 0.f;
    qfree[q] = q < Q ? 1 : 0;
  }
  for (int q = tid; q < Q; q += AU_THREADS) {
    bid[q] = 0ull;
    owner[q] = -1;
  }
  for (int i = tid; i < M; i += AU_THREADS) cflag[i] = 0;
  __syncthreads();   // cols complete

  stage_rows(val, cimg, cols, Q, M, qs, 0, R);
  if (tid == 0) n_open = nv;
  __syncthreads();

  // the auction: two barriers a round
  int rounds = 0;
  for (;; ++rounds) {
    if (n_open == 0 || rounds >= max_rounds) break;   // block-uniform
    for (int base = 0; base < nv; base += GROUPS) {
      const int i = base + gid;
      const bool bidding = i < nv && !cflag[i];   // valid, unassigned
      if (!__any_sync(FULL, bidding)) continue;   // warp-uniform
      float net1, w2;
      int j1;
      scan_column<true, false>(bidding, i, R, val, qs, cimg, M, cols, Q,
                               price, nullptr, net1, j1, w2);
      if (bidding && gl == 0) {
        const float v1 = net1 + price[j1];
        const float bp = v1 - w2 + eps;
        atomicMax(&bid[j1], ((unsigned long long)orderable(bp) << 32) |
                                (unsigned)(0x7fffffff - i));
      }
    }
    __syncthreads();
    int fresh = 0;   // GTs assigned that displaced nobody
    for (int q = tid; q < Q; q += AU_THREADS) {
      const unsigned long long k = bid[q];
      if (k == 0ull) continue;
      bid[q] = 0ull;
      const float best = from_orderable((unsigned)(k >> 32));
      if (best > NEG / 2) {
        const int i = 0x7fffffff - (int)(unsigned)(k & 0xffffffffu);
        const int old = owner[q];
        price[q] = best;
        owner[q] = i;
        cflag[i] = 1;
        if (old >= 0)
          cflag[old] = 0;
        else
          ++fresh;
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      fresh += __shfl_xor_sync(FULL, fresh, off);
    if (lane == 0 && fresh) atomicSub(&n_open, fresh);
    __syncthreads();
  }
  const bool capped = n_open > 0;

  int greedy_rounds = 0;
  if (capped && complete_greedy) {
    // from-scratch greedy on the raw values; prices are discarded. The
    // columns the auction did not stage (invalid ones: the greedy takes
    // any pair below BIG / 2) are staged as far as they fit.
    for (int q = tid; q < Q; q += AU_THREADS) owner[q] = -1;
    for (int i = tid; i < M; i += AU_THREADS) cflag[i] = 1;   // free
    const int R2 = min(M, cap);
    stage_rows(val, cimg, cols, Q, M, qs, R, R2);
    __syncthreads();
    // every column's best free query, every query's best free column;
    // then, after each round, those whose best was taken
    bool first = true;
    for (;;) {
      for (int base = 0; base < M; base += GROUPS) {
        const int i = base + gid;
        bool need = i < M && cflag[i];
        if (need && !first) need = colq[i] >= 0 && !qfree[colq[i]];
        if (!__any_sync(FULL, need)) continue;    // warp-uniform
        float v, sec;
        int a;
        scan_column<false, true>(need, i, R2, val, qs, cimg, M, cols, Q,
                                 nullptr, qfree, v, a, sec);
        if (need && gl == 0) {
          colq[i] = (a != INT32_MAX && v > -BIG / 2) ? a : -1;
          // a column with no pair below BIG / 2 is never taken: it
          // leaves the free set, so that no row scans it again
          if (first && colq[i] < 0) cflag[i] = 0;
        }
      }
      if (first) __syncthreads();
      for (int base = 0; base < Q; base += GROUPS) {
        const int q = base + gid;
        bool need = q < Q && qfree[q];
        if (need && !first) need = rowm[q] >= 0 && !cflag[rowm[q]];
        if (!__any_sync(FULL, need)) continue;    // warp-uniform
        const int bi = scan_row(need, q, R2, M, val, qs, cimg, cols, cflag);
        if (need && gl == 0) rowm[q] = bi;
      }
      __syncthreads();
      // take every pair that is each other's best
      int took = 0;
      for (int q = tid; q < Q; q += AU_THREADS) {
        const int i = rowm[q];
        if (qfree[q] && i >= 0 && colq[i] == q) {
          owner[q] = i;
          qfree[q] = 0;
          cflag[i] = 0;
          took = 1;
        }
      }
      if (!__syncthreads_or(took)) break;   // block-uniform
      ++greedy_rounds;
      first = false;
    }
  }

  for (int q = tid; q < Q; q += AU_THREADS) {
    const int i = owner[q];
    owner_out[(size_t)b * Q + q] = i >= 0 ? cols[i] : -1;
  }
  if (tid == 0) {
    capped_out[b] = capped ? 1 : 0;
    if (stats != nullptr) {
      stats[2 * b] = rounds;
      stats[2 * b + 1] = greedy_rounds;
    }
  }
}

}  // namespace

// cost (B, Q, M) f32 as the caller holds it (padded GTs at >= BIG); valid
// (B, M) bytes (0 / 1); owner (B, Q) int32 out (-1 = unmatched); capped
// (B,) bytes out (0 / 1); stats (B, 2) int32 out or null: auction rounds
// run and greedy rounds that took a pair. qs, cap, smem: the plan of
// kernels.auction_plan (qs = Q rounded up to 4, cap = rows that can be
// staged, smem = the dynamic shared bytes of that layout).
extern "C" int auction_assign(const void* cost, const void* valid,
                              void* owner, void* capped, void* stats, int B,
                              int Q, int M, int qs, int cap, int smem,
                              float eps, int max_rounds, int complete_greedy,
                              void* stream) {
  if (B <= 0 || Q <= 0 || M <= 0 || max_rounds < 0 || qs % 4 != 0 ||
      qs < Q || qs >= Q + 4 || cap < 0 || cap > M)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t need = layout(Q, M, qs, cap).total;
  if ((size_t)smem != need || need > SMEM_LIMIT)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = cudaFuncSetAttribute(
      auction_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  auction_kernel<<<B, AU_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(cost),
      static_cast<const unsigned char*>(valid), static_cast<int*>(owner),
      static_cast<unsigned char*>(capped), static_cast<int*>(stats), Q, M, qs,
      cap, eps, max_rounds, complete_greedy);
  return static_cast<int>(cudaGetLastError());
}
