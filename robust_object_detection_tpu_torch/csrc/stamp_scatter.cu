// K5-g1: the d(values) of one level's bilinear sampling ("stamp scatter").
//
// Replaces: robust_object_detection_tpu/ops/deform.py, _stamp_scatter_pallas
// (called by bilinear_sample's backward rule through _stamp_scatter):
//   dv[b, h, :, c] = sum over the taps t with idx[b, h, t] == c of
//                    gw[b, h, :, t]
// idx (B, heads, T) cell ids, gw (B, heads, DH, T) f32 read through two
// element strides (channel, tap): the reference's layout (T, 1) or the
// transpose of a contiguous (B, heads, T, DH), (1, DH); dv (B, heads, DH,
// HW) f32, every element written.
//
// The TPU version has no scatter unit: it sorts the taps by cell, pads them
// to chunks of 512 and multiplies each chunk's gradients with one-hot
// tiles of 2048 cells built in fast memory. A GPU adds directly, and needs
// no sort when one warp owns each cell: one launch, no memset, no atomics.
//
// A block owns one row (b, h) and a tile of consecutive cells (the plan,
// kernels.stamp_plan, sizes it from the shape and the layout alone so that
// rows x tiles fill the card). Its threads scan the row's idx 2048 taps a
// pass, 8 consecutive taps a lane (16-byte loads, the next pass's already
// in flight); the taps that land in the tile are listed in shared memory
// in t order (the lanes' places by a ballot of each bit of their counts,
// the warps' by their counts), up to 4096 of them before they are added.
// Each warp owns the cells of the tile whose hash is its index (not a
// contiguous range: the clamped taps of samples outside a map pile on its
// border row, which would fall to one warp). It reads the list 32 entries
// at a time, queues its own taps, and for every 16 queued loads their gw
// columns (lane = channel, all 16 loads in flight) and adds them,
// oldest first, into a shared f32 tile [channel][cell] whose odd row stride
// puts the 32 lanes on 32 banks. The adds stay in t order and start from
// +0.0, so a cell's sum is the same sequence of fadds as a sort by (cell,
// t) and a segmented sum give: the same bits on every run. The tile is
// then stored with lanes along cells, 128 contiguous bytes a warp store.
//
// What bounds it on the H100: bytes, at 1 operation per element of gw. It
// must write dv (rows x DH x HW x 4 bytes: 134 MB at the RT-DETR-L level of
// HW 16,384, 64 rows, DH 32) and read gw (rows x DH x T x 4: 56 MB at T
// 6,848) and idx once. dv is written once, coalesced. In the (1, DH)
// layout a tap's column is one 128-byte row; in the reference's layout its
// channels are T elements apart, one sector each, shared by the neighbour
// taps of a sampling point through L1. Every block scans its row's whole
// idx (from L2 after the first), the price of needing no sort; the scan
// and the list keep the gathers of a block in flight together.

#include <stdint.h>

#include <cuda_runtime.h>

namespace rodt {

constexpr int STAMP_THREADS = 256;
constexpr int STAMP_WARPS = STAMP_THREADS / 32;
constexpr int STAMP_U = 8;  // consecutive taps a lane reads a pass
constexpr int STAMP_CHUNK = STAMP_THREADS * STAMP_U;  // taps a pass
constexpr int STAMP_LIST = 2 * STAMP_CHUNK;  // list entries a block holds
constexpr int STAMP_BATCH = 16;  // gw loads a warp keeps in flight
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

// taps t .. t + STAMP_U - 1 of a row's idx (0 past T): two or four
// 16-byte loads where ivec (T % STAMP_U == 0 and idx 16-byte aligned)
template <typename IdxT>
__device__ __forceinline__ void load_taps(const IdxT* __restrict__ ir,
                                          int t, int T, bool ivec,
                                          IdxT (&v)[STAMP_U]) {
  if (ivec && t < T) {
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
    for (int j = 0; j < STAMP_U; ++j) v[j] = t + j < T ? ir[t + j] : 0;
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

// The warp's share of the block's list: the taps whose tile-local cell it
// owns, in list order (t order), each channel lane's gw value added into
// its row of the tile. The warp reads the list 32
// entries at a time and queues its own taps in `ring` (STAMP_RING entries
// of its own); whenever STAMP_BATCH of them are queued it loads their gw
// values (all in flight together) and then adds them, oldest first. A
// list entry is (t - tbase) << STAMP_CELL_BITS | cell; gch: this lane's
// channel of the row's gw; ts: the tap stride.
template <bool PAIRS>
__device__ __forceinline__ void stamp_batch(const int* __restrict__ ring,
                                            int head, int count, int tbase,
                                            const float* __restrict__ gch,
                                            int ts, bool chan,
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
  bool taken = false;  // PAIRS: v[k] came with the load of tap k - 1
#pragma unroll
  for (int k = 0; k < STAMP_BATCH; ++k) {
    if (taken) {
      taken = false;
    } else if (chan && cell[k] >= 0) {
      if (PAIRS && k + 1 < STAMP_BATCH && cell[k + 1] >= 0 &&
          !(tk[k] & 1) && tk[k + 1] == tk[k] + 1) {
        const float2 p2 = *reinterpret_cast<const float2*>(gch + tk[k]);
        v[k] = p2.x;
        v[k + 1] = p2.y;
        taken = true;
      } else {
        v[k] = gch[(size_t)tk[k] * ts];
      }
    }
  }
#pragma unroll
  for (int k = 0; k < STAMP_BATCH; ++k)
    if (chan && cell[k] >= 0) trow[cell[k]] += v[k];
}

template <bool PAIRS>
__device__ __forceinline__ void stamp_walk(
    const int* __restrict__ list, int n, int tbase,
    const float* __restrict__ gch, int ts, bool chan,
    float* __restrict__ trow, int* __restrict__ ring) {
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
      stamp_batch<PAIRS>(ring, head, STAMP_BATCH, tbase, gch, ts, chan,
                         trow);
      head += STAMP_BATCH;
      queued -= STAMP_BATCH;
    }
    __syncwarp();  // the ring's slots are read before they are refilled
  }
  if (queued)
    stamp_batch<PAIRS>(ring, head, queued, tbase, gch, ts, chan, trow);
  __syncwarp();
}

template <typename IdxT, bool PAIRS>
__global__ void __launch_bounds__(STAMP_THREADS)
stamp_scatter_kernel(const IdxT* __restrict__ idx,
                     const float* __restrict__ gw, float* __restrict__ dv,
                     int tiles, int tile, int T, int HW, int DH, int cs,
                     int ts, int ivec) {
  extern __shared__ __align__(16) float smem[];
  const unsigned FULL = 0xffffffffu;
  const int S = tile + 1;  // row stride of the tile
  float* tl = smem;
  int* list = reinterpret_cast<int*>(tl + 32 * S);
  int* cnt = list + STAMP_LIST;  // [2][STAMP_WARPS]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t row = blockIdx.x / tiles;
  const int c0 = (int)(blockIdx.x % tiles) * tile;
  const int ncell = min(tile, HW - c0);
  const IdxT* ir = idx + row * T;
  const float* gr = gw + row * (size_t)DH * T;
  float* dr = dv + row * (size_t)DH * HW;
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
    const float* gch = gr + (size_t)(d0 + (chan ? lane : 0)) * cs;
    float* trow = tl + lane * S;
    IdxT ahead[STAMP_U];  // the next pass's idx, loaded early
    load_taps(ir, toff, T, ivec, ahead);
    int n = 0, tbase = 0, par = 0;
    for (int t0 = 0; t0 < T; t0 += STAMP_CHUNK) {  // uniform
      int cl[STAMP_U];
      int h = 0;
#pragma unroll
      for (int j = 0; j < STAMP_U; ++j) {
        const long long c = (long long)ahead[j] - c0;
        cl[j] = t0 + toff + j < T && c >= 0 && c < ncell ? (int)c : -1;
        h += cl[j] >= 0;
      }
      load_taps(ir, t0 + STAMP_CHUNK + toff, T, ivec, ahead);
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
      if (n > 0 && (next >= T || n > STAMP_LIST - STAMP_CHUNK ||
                    next + STAMP_CHUNK - tbase > STAMP_SPAN)) {
        __syncthreads();  // the list
        stamp_walk<PAIRS>(list, n, tbase, gch, ts, chan, trow,
                   cnt + 2 * STAMP_WARPS + warp * STAMP_RING);
        __syncthreads();  // the list is refilled
        n = 0;
      }
      if (n == 0) tbase = next;
    }
    // lanes along cells: every warp store is 128 contiguous bytes, and the
    // reads of the tile hit 32 banks
    for (int ch = warp; ch < nch; ch += STAMP_WARPS)
      for (int cl = lane; cl < ncell; cl += 32)
        dr[(size_t)(d0 + ch) * HW + c0 + cl] = tl[ch * S + cl];
    __syncthreads();  // the next channel chunk zeroes the tile
  }
}

template <typename IdxT, bool PAIRS>
inline int launch_stamp_scatter(const void* idx, const void* gw, void* dv,
                                int rows, int T, int HW, int DH, int cs,
                                int ts, int tile, int ivec, cudaStream_t st) {
  const size_t smem = stamp_smem(tile);
  const cudaError_t e = cudaFuncSetAttribute(
      stamp_scatter_kernel<IdxT, PAIRS>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int tiles = (HW + tile - 1) / tile;
  const size_t blocks = (size_t)rows * tiles;
  if (blocks > 0x7fffffffu) return static_cast<int>(cudaErrorInvalidValue);
  stamp_scatter_kernel<IdxT, PAIRS>
      <<<(unsigned)blocks, STAMP_THREADS, smem, st>>>(
          static_cast<const IdxT*>(idx), static_cast<const float*>(gw),
          static_cast<float*>(dv), tiles, tile, T, HW, DH, cs, ts, ivec);
  return static_cast<int>(cudaGetLastError());
}

template <typename IdxT>
inline int launch_stamp_scatter(const void* idx, const void* gw, void* dv,
                                int rows, int T, int HW, int DH, int cs,
                                int ts, int tile, int ivec, int pairs,
                                cudaStream_t st) {
  return pairs ? launch_stamp_scatter<IdxT, true>(idx, gw, dv, rows, T, HW,
                                                  DH, cs, ts, tile, ivec, st)
               : launch_stamp_scatter<IdxT, false>(idx, gw, dv, rows, T, HW,
                                                   DH, cs, ts, tile, ivec,
                                                   st);
}

}  // namespace rodt

// idx (rows, T) int32 (idx_bytes 4) or int64 (8), cells in [0, HW); gw
// (rows, DH, T) f32 with element strides cs (channel) and ts (tap), rows
// DH * T apart: (T, 1) or (1, DH); dv (rows, DH, HW) f32, every element
// written. The plan of kernels.stamp_plan: tile (cells a block, a multiple
// of 8 up to 512), ivec (T % 8 == 0 and idx 16-byte aligned: 16-byte loads
// of idx) and pairs (ts == 1, T even and gw 8-byte aligned: one 8-byte
// load for two neighbour taps).
extern "C" int stamp_scatter(const void* idx, const void* gw, void* dv,
                             int rows, int T, int HW, int DH, int cs, int ts,
                             int idx_bytes, int tile, int ivec, int pairs,
                             void* stream) {
  if (rows <= 0 || T <= 0 || HW <= 0 || DH <= 0 || tile < 8 ||
      tile > rodt::STAMP_MAX_TILE || tile % rodt::STAMP_WARPS ||
      !((cs == T && ts == 1) || (cs == 1 && ts == DH)) ||
      (ivec && (T % rodt::STAMP_U ||
                reinterpret_cast<uintptr_t>(idx) % 16)) ||
      (pairs && (ts != 1 || T % 2 || reinterpret_cast<uintptr_t>(gw) % 8)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (idx_bytes == 4)
    return rodt::launch_stamp_scatter<int32_t>(idx, gw, dv, rows, T, HW, DH,
                                               cs, ts, tile, ivec, pairs, st);
  if (idx_bytes == 8)
    return rodt::launch_stamp_scatter<int64_t>(idx, gw, dv, rows, T, HW, DH,
                                               cs, ts, tile, ivec, pairs, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
