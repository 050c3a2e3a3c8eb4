// The owner scatter: a scatter-add into value cells without a sort and
// without atomics, the d(values) of the deformable-attention backwards
// (stamp_scatter.cu, K5-g1; deform_bwd.cu, K5 and K5-g2 backward):
//   out[row, cell, :] = sum over the taps t of the row with idx[row, t] ==
//                       cell, taken in the order of t from +0.0, of the
//                       tap's contribution (a Contrib, below)
//
// A block owns one row and a tile of consecutive cells (the plan,
// kernels.stamp_plan or kernels.deform_bwd_plan, sizes it from the shape
// alone). Its threads scan a range [ta, tb) of the row's idx (the caller's:
// the whole row for K5-g1, its tile's level for the backwards) 2048 taps a
// pass, 8 consecutive taps a lane (16-byte loads, the next pass's already
// in flight); the taps that land in the tile are listed in shared memory
// in t order (the lanes' places by a ballot of each bit of their counts,
// the warps' by their counts), up to 4096 of them before they are added.
// Each warp owns the cells of the tile whose hash is its index (not a
// contiguous range: the clamped taps of samples outside a map pile on its
// border row, which would fall to one warp). It reads the list 32 entries
// at a time, queues its own taps, and for every 16 queued loads their
// contributions (lane = channel, all 16 in flight) and adds them, oldest
// first, into a shared f32 tile [channel][cell] whose odd row stride puts
// the 32 lanes on 32 banks. The adds stay in t order and start
// from +0.0, so a cell's sum is the same sequence of fadds as a sort by
// (cell, t) and a segmented sum give: the same bits on every run. The
// caller's Store then writes the tile once, every cell of it.
//
// Contrib, the value a tap adds to one channel (one channel a lane):
//   channel(d0, nch)       before each chunk of 32 channels: lane < nch
//                          holds channel d0 + lane;
//   load(tk, cell, tk_lane, lane_live, v)
//                          v[k] = the lane's channel of tap tk[k] for each
//                          k with cell[k] >= 0 (any value elsewhere);
//                          tk_lane = tk[lane % STAMP_BATCH] where
//                          lane_live, so that a lane can work out one
//                          tap's share and hand it to the others.
// Store: store(tile, S, d0, nch, c0, ncell) writes channels d0 .. d0 +
// nch - 1 of the block's ncell cells from c0, channel ch of tile-local
// cell cl at tile[ch * S + cl]; called by every thread.
#pragma once

#include <stdint.h>

#include <cuda_runtime.h>

#include "conv_tile.cuh"

namespace rodt {

constexpr int STAMP_THREADS = 256;
constexpr int STAMP_WARPS = STAMP_THREADS / 32;
constexpr int STAMP_U = 8;  // consecutive taps a lane reads a pass
constexpr int STAMP_CHUNK = STAMP_THREADS * STAMP_U;  // taps a pass
constexpr int STAMP_LIST = 2 * STAMP_CHUNK;  // list entries a block holds
constexpr int STAMP_BATCH = 16;  // contributions a warp keeps in flight
constexpr int STAMP_RING = 64;   // a warp's queue of taps (> BATCH + 31)
constexpr int STAMP_MAX_TILE = 512;
constexpr int STAMP_CELL_BITS = 9;  // a list entry: t - tbase, cell
constexpr int STAMP_SPAN = 1 << (31 - STAMP_CELL_BITS);  // t - tbase bound

// shared memory of a block over `tile` cells: the [32][tile + 1] f32 tile
// (an odd row stride: the 32 channel lanes hit 32 banks), the list of
// taps, the warps' counts (double-buffered) and their queues
inline size_t stamp_smem(int tile) {
  return sizeof(float) * 32 * (size_t)(tile + 1) +
         sizeof(int) * (STAMP_LIST + 2 * STAMP_WARPS +
                        STAMP_WARPS * STAMP_RING);
}

// taps t .. t + STAMP_U - 1 of a row's idx (0 from tb on): two or four
// 16-byte loads where ivec (the scanned range a multiple of 8 taps from a
// 16-byte aligned start)
template <typename IdxT>
__device__ __forceinline__ void load_taps(const IdxT* __restrict__ ir,
                                          int t, int tb, bool ivec,
                                          IdxT (&v)[STAMP_U]) {
  if (ivec && t < tb) {
    constexpr int PER = 16 / sizeof(IdxT);
#pragma unroll
    for (int k = 0; k < STAMP_U / PER; ++k) {
      const int4 q = *reinterpret_cast<const int4*>(ir + t + k * PER);
      const IdxT* e = reinterpret_cast<const IdxT*>(&q);
#pragma unroll
      for (int j = 0; j < PER; ++j) v[k * PER + j] = e[j];
    }
  } else {
#pragma unroll
    for (int j = 0; j < STAMP_U; ++j) v[j] = t + j < tb ? ir[t + j] : 0;
  }
}

// The warp that owns tile-local cell c (c < 512): a hash of the bits of c
// / 4, so that taps piled on one map row or column (the clamped taps of
// samples outside a map land on its border cells) spread over the block's
// warps, while the neighbour cells of a sampling point's corners 0 and 1
// (or 2 and 3) mostly share a warp.
__device__ __forceinline__ int stamp_owner(int c) {
  c >>= 2;
  return (c ^ (c >> 3) ^ (c >> 6)) & (STAMP_WARPS - 1);
}

// Adds `count` queued taps from ring[head]: their contributions loaded
// together, then added into the lane's row of the tile oldest first. A
// ring entry is (t - tbase) << STAMP_CELL_BITS | cell.
template <class Contrib>
__device__ __forceinline__ void stamp_batch(const int* __restrict__ ring,
                                            int head, int count, int tbase,
                                            Contrib& contrib, bool chan,
                                            float* __restrict__ trow) {
  float v[STAMP_BATCH];
  int cell[STAMP_BATCH], tk[STAMP_BATCH];
#pragma unroll
  for (int k = 0; k < STAMP_BATCH; ++k) {
    const int e = ring[(head + k) & (STAMP_RING - 1)];
    cell[k] = k < count ? e & ((1 << STAMP_CELL_BITS) - 1) : -1;
    tk[k] = tbase + (e >> STAMP_CELL_BITS);
    v[k] = 0.f;
  }
  const int kl = (threadIdx.x & 31) & (STAMP_BATCH - 1);
  const int tk_lane =
      tbase + (ring[(head + kl) & (STAMP_RING - 1)] >> STAMP_CELL_BITS);
  contrib.load(tk, cell, tk_lane, kl < count, v);
#pragma unroll
  for (int k = 0; k < STAMP_BATCH; ++k)
    if (chan && cell[k] >= 0) trow[cell[k]] += v[k];
}

// The warp's share of the block's list: the taps whose tile-local cell it
// owns, in list order (t order). The warp reads the list 32 entries at a
// time and queues its own taps in `ring` (STAMP_RING entries of its own);
// whenever STAMP_BATCH of them are queued it adds them (stamp_batch).
template <class Contrib>
__device__ __forceinline__ void stamp_walk(const int* __restrict__ list,
                                           int n, int tbase,
                                           Contrib& contrib, bool chan,
                                           float* __restrict__ trow,
                                           int* __restrict__ ring) {
  const unsigned FULL = 0xffffffffu;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned below = (1u << lane) - 1u;
  int head = 0, queued = 0;
  for (int j0 = 0; j0 < n; j0 += 32) {  // uniform over the warp
    const int j = j0 + lane;
    const int e = j < n ? list[j] : 0;
    const bool mine =
        j < n && stamp_owner(e & ((1 << STAMP_CELL_BITS) - 1)) == warp;
    const unsigned m = __ballot_sync(FULL, mine);
    if (mine)
      ring[(head + queued + __popc(m & below)) & (STAMP_RING - 1)] = e;
    queued += __popc(m);
    __syncwarp();
    while (queued >= STAMP_BATCH) {  // uniform
      stamp_batch(ring, head, STAMP_BATCH, tbase, contrib, chan, trow);
      head += STAMP_BATCH;
      queued -= STAMP_BATCH;
    }
    __syncwarp();  // the ring's slots are read before they are refilled
  }
  if (queued) stamp_batch(ring, head, queued, tbase, contrib, chan, trow);
  __syncwarp();
}

// The block's tile: cells c0 .. c0 + ncell - 1 of the row whose idx is ir,
// from the taps in [ta, tb) (ta < tb), channel chunk by channel chunk of
// DH. smem: the block's stamp_smem(tile) bytes. Every thread of the block
// calls it.
template <typename IdxT, class Contrib, class Store>
__device__ __forceinline__ void owner_scatter(
    const IdxT* __restrict__ ir, int ta, int tb, int c0, int ncell,
    int tile, int DH, bool ivec, Contrib& contrib, const Store& store,
    float* smem) {
  const unsigned FULL = 0xffffffffu;
  const int S = tile + 1;  // row stride of the tile
  float* tl = smem;
  int* list = reinterpret_cast<int*>(tl + 32 * S);
  int* cnt = list + STAMP_LIST;  // [2][STAMP_WARPS]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // in a pass over taps t0 .. t0 + STAMP_CHUNK - 1, lane `lane` of warp w
  // reads the STAMP_U taps from t0 + toff: the block's list stays in t
  // order when each pass appends warp by warp, lane by lane
  const int toff = (warp * 32 + lane) * STAMP_U;
  const unsigned below = (1u << lane) - 1u;

  for (int d0 = 0; d0 < DH; d0 += 32) {
    const int nch = min(32, DH - d0);
    for (int i = tid; i < 8 * S; i += STAMP_THREADS)  // 32 S floats
      reinterpret_cast<float4*>(tl)[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    const bool chan = lane < nch;
    contrib.channel(d0, nch);
    float* trow = tl + lane * S;
    IdxT ahead[STAMP_U];  // the next pass's idx, loaded early
    load_taps(ir, ta + toff, tb, ivec, ahead);
    int n = 0, tbase = ta, par = 0;
    for (int t0 = ta; t0 < tb; t0 += STAMP_CHUNK) {  // uniform
      int cl[STAMP_U];
      int h = 0;
#pragma unroll
      for (int j = 0; j < STAMP_U; ++j) {
        const long long c = (long long)ahead[j] - c0;
        cl[j] = t0 + toff + j < tb && c >= 0 && c < ncell ? (int)c : -1;
        h += cl[j] >= 0;
      }
      load_taps(ir, t0 + STAMP_CHUNK + toff, tb, ivec, ahead);
      // this lane's first place among the warp's hits: the exclusive sum
      // of h over the lanes below, by bit planes (h <= 8)
      int pre = 0;
#pragma unroll
      for (int k = 0; k < 4; ++k)
        pre += __popc(__ballot_sync(FULL, (h >> k) & 1) & below) << k;
      if (lane == 31) cnt[par * STAMP_WARPS + warp] = pre + h;
      __syncthreads();  // the counts; for the first pass, the zeroed tile
      int p = n + pre, total = 0;
#pragma unroll
      for (int w = 0; w < STAMP_WARPS; ++w) {
        const int k = cnt[par * STAMP_WARPS + w];
        p += w < warp ? k : 0;
        total += k;
      }
      par ^= 1;
#pragma unroll
      for (int j = 0; j < STAMP_U; ++j)
        if (cl[j] >= 0)
          list[p++] = (t0 - tbase + toff + j) << STAMP_CELL_BITS | cl[j];
      n += total;
      // walk the list when the next pass might not fit or might not be
      // expressible against tbase, and after the last pass (uniform)
      const int next = t0 + STAMP_CHUNK;
      if (n > 0 && (next >= tb || n > STAMP_LIST - STAMP_CHUNK ||
                    next + STAMP_CHUNK - tbase > STAMP_SPAN)) {
        __syncthreads();  // the list
        stamp_walk(list, n, tbase, contrib, chan, trow,
                   cnt + 2 * STAMP_WARPS + warp * STAMP_RING);
        __syncthreads();  // the list is refilled
        n = 0;
      }
      if (n == 0) tbase = next;
    }
    store.store(tl, S, d0, nch, c0, ncell);
    __syncthreads();  // the next channel chunk zeroes the tile
  }
}

// A row laid out (DH, HW), out[d * HW + c]: the tile stored with lanes
// along cells, every warp store 128 contiguous bytes (in f32), the reads
// of the tile on 32 banks. K5-g1's dv and K5-g2's d(values_t).
template <typename TOut>
struct ChanMajorStore {
  TOut* __restrict__ dr;  // the row's first element
  int HW;
  __device__ __forceinline__ void store(const float* tl, int S, int d0,
                                        int nch, int c0, int ncell) const {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    for (int ch = warp; ch < nch; ch += STAMP_WARPS)
      for (int cl = lane; cl < ncell; cl += 32)
        dr[(size_t)(d0 + ch) * HW + c0 + cl] = from_f<TOut>(tl[ch * S + cl]);
  }
};

}  // namespace rodt
