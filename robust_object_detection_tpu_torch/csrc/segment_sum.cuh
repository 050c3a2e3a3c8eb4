// Segmented sum over taps sorted by destination cell: the scatter-add of
// the deformable-attention backwards (stamp_scatter.cu, K5-g1, and the
// d(values) of ms_deform_attn_sorted.cu, K5-g2 backward) without atomics.
//
// The caller sorts, per row (one (batch, head)), the keys
//   key = (cell << sb) | pos        pos = the tap's place in its own order
// so the taps of one cell are contiguous and keep the order of pos. One
// block owns SEG_CELLS consecutive cells of one row, one warp SEG_CPW of
// them. The warp finds its first and last tap by a 32-way search in the
// sorted keys, reads the keys 32 at a time (one coalesced load, then
// shuffles), and walks them with lane = channel, adding each tap's
// contribution to a register; at the end of a cell the sum goes to the
// block's shared tile, a cell without taps gets its zero. The block then
// stores the tile in the output's layout, lanes along whichever axis is
// contiguous there. Every output element is written exactly once, by one
// thread, from a sum taken in the order of pos: no memset, no atomics,
// and the same bits on every run. A cell's taps never straddle two warps,
// because warps own cells, not taps.
//
// `Contrib` supplies the taps' values:
//   prefetch(pos, live)  called by every lane for the key it loaded
//                        (live: the lane holds a tap);
//   value(j, d)          called by every lane: the contribution of the
//                        tap lane j holds to channel d (d may be >= DH in
//                        the last 32-channel chunk: 0).
#pragma once

#include "conv_tile.cuh"

namespace rodt {

constexpr int SEG_CELLS = 128;                     // cells per block
constexpr int SEG_CPW = SEG_CELLS / (THREADS / 32);  // cells per warp

// First index in the sorted keys[0..n) whose key is >= target, found by the
// whole warp: each round the 32 lanes probe 32 evenly spaced keys and a
// ballot keeps the one gap that holds the answer, so 20,000 keys take 3-4
// dependent loads where a binary search takes 15. Every lane of the warp
// must call it, and every lane gets the answer.
template <typename KeyT>
__device__ __forceinline__ int warp_lower_bound(
    const KeyT* __restrict__ keys, int n, long long target, int lane) {
  int lo = 0, hi = n;
  while (lo < hi) {  // uniform over the warp
    const int step = (hi - lo + 31) >> 5;
    const int p = lo + (lane + 1) * step - 1;
    const bool less = p < hi && (long long)keys[p] < target;
    const int cnt = __popc(__ballot_sync(0xffffffffu, less));
    const int base = lo;
    lo = min(base + cnt * step, hi);
    if (cnt < 32) hi = min(hi, base + (cnt + 1) * step - 1);
  }
  return lo;
}

// keys: this row's T sorted keys; out: this row's first element, cell c and
// channel d at out[c * cell_stride + d * chan_stride] (one of the strides
// is 1). tile_idx: which SEG_CELLS cells of the row this block owns. Every
// thread of the block must call it.
template <typename KeyT, typename TOut, typename Contrib>
__device__ __forceinline__ void segment_sum_tile(
    const KeyT* __restrict__ keys, int T, int sb, int HW, int DH,
    int tile_idx, Contrib& contrib, TOut* __restrict__ out,
    size_t cell_stride, size_t chan_stride) {
  __shared__ float tile[SEG_CELLS][33];
  const unsigned FULL = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  const int c0 = tile_idx * SEG_CELLS;
  const int lb = (threadIdx.x >> 5) * SEG_CPW;  // tile-local first cell
  const int ts = warp_lower_bound(keys, T, (long long)(c0 + lb) << sb, lane);
  const int te = warp_lower_bound(
      keys, T, (long long)(c0 + lb + SEG_CPW) << sb, lane);
  const long long pos_mask = (1LL << sb) - 1;
  const int ncell = min(SEG_CELLS, HW - c0);

  for (int d0 = 0; d0 < DH; d0 += 32) {
    int cur = lb;
    float acc = 0.f;
    for (int t0 = ts; t0 < te; t0 += 32) {
      const int n = min(32, te - t0);
      const bool live = lane < n;
      const long long k = live ? (long long)keys[t0 + lane] : 0;
      const int my_cell = (int)(k >> sb) - c0;  // in [lb, lb + SEG_CPW)
      contrib.prefetch((int)(k & pos_mask), live);
      for (int j = 0; j < n; ++j) {
        const int cell = __shfl_sync(FULL, my_cell, j);
        while (cur < cell) {  // uniform over the warp
          tile[cur][lane] = acc;
          acc = 0.f;
          ++cur;
        }
        acc += contrib.value(j, d0 + lane);
      }
    }
    while (cur < lb + SEG_CPW) {
      tile[cur][lane] = acc;
      acc = 0.f;
      ++cur;
    }
    __syncthreads();
    const int nch = min(32, DH - d0);
    if (chan_stride == 1) {  // channels contiguous: lanes along channels
      for (int i = threadIdx.x; i < SEG_CELLS * 32; i += THREADS) {
        const int cl = i >> 5, ch = i & 31;
        if (cl < ncell && ch < nch)
          out[(size_t)(c0 + cl) * cell_stride + d0 + ch] =
              from_f<TOut>(tile[cl][ch]);
      }
    } else {  // cells contiguous: lanes along cells
      for (int i = threadIdx.x; i < SEG_CELLS * 32; i += THREADS) {
        const int ch = i / SEG_CELLS, cl = i % SEG_CELLS;
        if (cl < ncell && ch < nch)
          out[(size_t)(d0 + ch) * chan_stride +
              (size_t)(c0 + cl) * cell_stride] = from_f<TOut>(tile[cl][ch]);
      }
    }
    __syncthreads();  // the next chunk overwrites the tile
  }
}

// blocks of a launch over `rows` rows of HW cells, or 0 if out of range
inline unsigned segment_sum_blocks(int rows, int HW) {
  const size_t tiles = ((size_t)HW + SEG_CELLS - 1) / SEG_CELLS;
  const size_t blocks = tiles * (size_t)rows;
  return blocks > 0x7fffffffu ? 0u : (unsigned)blocks;
}

}  // namespace rodt
