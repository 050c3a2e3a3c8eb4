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
// The owner scatter of owner_scatter.cuh does it: a block owns one row (b,
// h) and a tile of consecutive cells (the plan, kernels.stamp_plan, sizes
// it from the shape alone so that rows x tiles fill the card), scans the
// row's whole idx, lists its tile's taps in t order, and each warp adds
// the gw columns of the cells it owns (by a hash) into a shared f32 tile,
// oldest first from +0.0: the same sequence of fadds as a sort by (cell,
// t) and a segmented sum give, the same bits on every run. The tile is
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

#include "owner_scatter.cuh"

namespace rodt {

// A tap's contribution: its gw column, one channel a lane, read through
// the (channel, tap) strides (cs, ts). PAIRS: where two neighbour taps of
// a batch are t and t + 1 with t even, one 8-byte load reads both (tap
// stride 1).
template <bool PAIRS>
struct GwColumn {
  const float* __restrict__ gr;  // the row's gw
  int cs, ts;
  const float* __restrict__ gch;  // this lane's channel
  bool chan;
  __device__ __forceinline__ void channel(int d0, int nch) {
    const int lane = threadIdx.x & 31;
    chan = lane < nch;
    gch = gr + (size_t)(d0 + (chan ? lane : 0)) * cs;
  }
  __device__ __forceinline__ void load(const int (&tk)[STAMP_BATCH],
                                       const int (&cell)[STAMP_BATCH], int,
                                       bool, float (&v)[STAMP_BATCH]) const {
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
  }
};

template <typename IdxT, bool PAIRS>
__global__ void __launch_bounds__(STAMP_THREADS)
stamp_scatter_kernel(const IdxT* __restrict__ idx,
                     const float* __restrict__ gw, float* __restrict__ dv,
                     int tiles, int tile, int T, int HW, int DH, int cs,
                     int ts, int ivec) {
  extern __shared__ __align__(16) float smem[];
  const size_t row = blockIdx.x / tiles;
  const int c0 = (int)(blockIdx.x % tiles) * tile;
  GwColumn<PAIRS> col{gw + row * (size_t)DH * T, cs, ts, nullptr, false};
  const ChanMajorStore<float> store{dv + row * (size_t)DH * HW, HW};
  owner_scatter(idx + row * T, 0, T, c0, min(tile, HW - c0), tile, DH,
                ivec != 0, col, store, smem);
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
