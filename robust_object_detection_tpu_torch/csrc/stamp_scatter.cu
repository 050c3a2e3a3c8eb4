// K5-g1: the d(values) of one level's bilinear sampling ("stamp scatter").
//
// Replaces: robust_object_detection_tpu/ops/deform.py, _stamp_scatter_pallas
// (called by bilinear_sample's backward rule through _stamp_scatter):
//   dv[b, h, :, c] = sum over the taps t with idx[b, h, t] == c of
//                    gw[b, h, :, t]
// idx (B, heads, T) cell ids, gw (B, heads, DH, T) f32, dv (B, heads, DH,
// HW) f32.
//
// The TPU version has no scatter unit: it sorts the taps by cell, pads them
// to chunks of 512 and multiplies each chunk's gradients with one-hot
// tiles of 2048 cells built in fast memory, between per-chunk tile bounds,
// accumulating into an output block that the sequential grid revisits; maps
// under 2048 cells go to a dense one-hot einsum instead. A GPU adds
// directly. The taps are sorted by (cell, tap position) with one library
// sort of packed keys (the TPU version sorts outside its kernel too), and
// the segmented sum of segment_sum.cuh does the rest: every cell is owned
// by one warp, summed in tap order and written once, its zero included, so
// there is no memset, no atomic and no padding, any HW and any T are taken,
// and two runs give the same bits.
//
// What bounds it on the H100: bytes, at 2 operations per element of gw. It
// reads gw (rows x DH x T x 4 bytes) and the keys once and writes dv (rows x
// DH x HW x 4 bytes) once; at the RT-DETR-L shapes (64 rows, DH 32, T 6,848,
// HW 16,384) dv is 134 MB, more than twice gw. dv is stored with the lanes
// along the cells (coalesced); a tap's channels are T elements apart in gw,
// so the gather of gw touches one sector per tap and channel, most of them
// shared by the four taps of a sampling point, which sit side by side in T.

#include <stdint.h>

#include "segment_sum.cuh"

namespace rodt {

struct GwContrib {
  const float* __restrict__ gw;  // this row's (DH, T)
  int T, DH;
  int pos;
  __device__ __forceinline__ void prefetch(int p, bool) { pos = p; }
  __device__ __forceinline__ float value(int j, int d) const {
    const int p = __shfl_sync(0xffffffffu, pos, j);
    return d < DH ? gw[(size_t)d * T + p] : 0.f;
  }
};

template <typename KeyT>
__global__ void __launch_bounds__(THREADS)
stamp_scatter_kernel(const KeyT* __restrict__ keys,
                     const float* __restrict__ gw, float* __restrict__ dv,
                     int tiles, int T, int sb, int HW, int DH) {
  const size_t row = blockIdx.x / tiles;
  GwContrib contrib{gw + row * DH * T, T, DH, 0};
  segment_sum_tile<KeyT, float>(keys + row * T, T, sb, HW, DH,
                                (int)(blockIdx.x % tiles), contrib,
                                dv + row * DH * HW, 1, (size_t)HW);
}

}  // namespace rodt

// keys (rows, T): (cell << sb) | tap position, each row sorted ascending,
// int32 (key_bytes 4) or int64 (8); gw (rows, DH, T) f32; dv (rows, DH, HW)
// f32, every element written.
extern "C" int stamp_scatter_sorted(const void* keys, const void* gw,
                                    void* dv, int rows, int T, int HW, int DH,
                                    int sb, int key_bytes, void* stream) {
  const unsigned blocks = rodt::segment_sum_blocks(rows, HW);
  if (rows <= 0 || T <= 0 || HW <= 0 || DH <= 0 || sb < 0 || sb > 31 ||
      blocks == 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int tiles = (HW + rodt::SEG_CELLS - 1) / rodt::SEG_CELLS;
  if (key_bytes == 4)
    rodt::stamp_scatter_kernel<int32_t><<<blocks, rodt::THREADS, 0, st>>>(
        static_cast<const int32_t*>(keys), static_cast<const float*>(gw),
        static_cast<float*>(dv), tiles, T, sb, HW, DH);
  else if (key_bytes == 8)
    rodt::stamp_scatter_kernel<int64_t><<<blocks, rodt::THREADS, 0, st>>>(
        static_cast<const int64_t*>(keys), static_cast<const float*>(gw),
        static_cast<float*>(dv), tiles, T, sb, HW, DH);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
