// K5-g2 forward: multi-scale deformable attention, the sorted-tap
// generation, for either layout of the value maps.
//
// Replaces: robust_object_detection_tpu/ops/deform.py, _fwd_pallas with its
// preparation _sorted_taps / _tpu_fwd / _tpu_fwd_t (public entries
// ms_deform_attn and ms_deform_attn_t). The function is that of
// ms_deform_attn.cu:
//   out[b, q, h, :] = sum over levels l, points p and the 4 bilinear taps t
//       attn[b, q, h, l, p] * wgt_t * v[b, h, cell_t, :]       (f32)
// with the geometry of deform.py:_merged_geometry (pixel = loc * size -
// 0.5; weight 0 for a tap outside its map). v is `values` (B, HW, NH, DH)
// or `values_t` (B, NH, DH, HW), f32 or bf16; out is f32. The backward of
// both entries is deform_bwd.cu, shared with K5.
//
// The TPU version sorts all taps of a (batch, head) by merged cell so that
// 512-tap chunks meet few 1024-cell value tiles, relays `values` out as
// v^T (channels on sublanes, for its one-hot matmuls) and gathers with
// one-hot matmuls; a caller holding v^T skips that copy. A GPU gather
// wants the opposite: one contiguous row a tap. So here:
//   * `values`: one launch of K5's gather (deform_fwd.cuh) with an f32 out,
//     the plan of kernels.deform_fwd_plan: the same sums as K5, stored
//     before K5's rounding.
//   * `values_t`: two launches on one stream. values_t_to_rows_kernel
//     transposes each batch's (NH * DH) x HW matrix into a workspace (B,
//     HW, NH, DH) in values' dtype, 64 x 64 tiles staged in shared memory
//     (row pitch an odd number of 4-byte words, so the gather of a
//     channel piece meets at most 2-way bank conflicts): 16-byte loads
//     along HW and 16-byte stores along the channels where the row pitch
//     and the pointers allow it, element accesses otherwise and in the
//     tiles at the edges (the plan of kernels.deform_relayout_plan). Then
//     the same gather on the workspace. The relayout is exact, so
//     `values_t` gives the `values` route's bits.
//
// Why a relayout and not an in-place read: in values_t a tap's DH
// channels lie HW elements apart, so a tap read in place costs DH sectors
// of 32 bytes where `values` gives one 64-byte row (bf16). The transpose
// reads the map once and writes it once, in whole lines, and the gather
// then runs at `values`' speed.
//
// What bounds it on the H100: bytes. `values`: the distinct value rows the
// taps touch, loc, attn and out. `values_t`: any reader in place must
// fetch every 32-byte sector that holds a touched element, nearly the
// whole map at uniform samples (about 88 MB bf16 at the RT-DETR-L train
// shapes, 0.026 ms). The relayout moves the map twice (read, write) before
// the gather reads its rows again, so it cannot come closer than about 40%
// of that bound. What could reach it: taps binned by (batch, head, level
// tile), each tile of values_t staged once in shared memory and gathered
// there, the per-query sums closed without atomics (the TPU's sorted
// design on the GPU).

#include <stdint.h>

#include "deform_fwd.cuh"

namespace rodt {

constexpr int RL_TILE_C = 64;   // channels (rows of values_t) a tile
constexpr int RL_TILE_P = 64;   // cells a tile
constexpr int RL_THREADS = 256;

// A 16-byte piece as raw words of W (the relayout copies bits: W is the
// element's unsigned type).
template <typename W>
union Piece16 {
  uint4 u;
  unsigned w32[4];
  W w[16 / sizeof(W)];
};

// One block per (cell tile, channel tile, batch): rows[b, p, c] =
// vt[b, c, p] for c < C = NH * DH, p < HW. W: unsigned short (bf16) or
// unsigned (f32). ld_vec: 16-byte loads along HW (HW a multiple of the
// piece, vt aligned); st_vec: 16-byte stores along C (C a multiple of the
// piece, rows aligned); a tile that crosses an edge uses element accesses.
template <typename W>
__global__ void __launch_bounds__(RL_THREADS)
values_t_to_rows_kernel(const W* __restrict__ vt, W* __restrict__ rows,
                        int C, int HW, int ld_vec, int st_vec) {
  constexpr int V = 16 / sizeof(W);
  // an odd number of 4-byte words a row
  constexpr int PITCH = RL_TILE_P + (sizeof(W) == 2 ? 2 : 1);
  __shared__ __align__(16) W tile[RL_TILE_C * PITCH];
  const int p0 = blockIdx.x * RL_TILE_P, c0 = blockIdx.y * RL_TILE_C;
  const W* src = vt + (size_t)blockIdx.z * C * HW;
  W* dst = rows + (size_t)blockIdx.z * HW * C;
  const bool full = c0 + RL_TILE_C <= C && p0 + RL_TILE_P <= HW;  // uniform

  if (ld_vec && full) {
    for (int v = threadIdx.x; v < RL_TILE_C * RL_TILE_P / V;
         v += RL_THREADS) {
      const int c = v / (RL_TILE_P / V), p = v % (RL_TILE_P / V) * V;
      Piece16<W> r;
      r.u = *reinterpret_cast<const uint4*>(src + (size_t)(c0 + c) * HW +
                                            p0 + p);
      unsigned* s = reinterpret_cast<unsigned*>(tile + c * PITCH + p);
#pragma unroll
      for (int m = 0; m < 4; ++m) s[m] = r.w32[m];
    }
  } else {
    for (int e = threadIdx.x; e < RL_TILE_C * RL_TILE_P; e += RL_THREADS) {
      const int c = e / RL_TILE_P, p = e % RL_TILE_P;
      if (c0 + c < C && p0 + p < HW)
        tile[c * PITCH + p] = src[(size_t)(c0 + c) * HW + p0 + p];
    }
  }
  __syncthreads();
  if (st_vec && full) {
    for (int v = threadIdx.x; v < RL_TILE_P * RL_TILE_C / V;
         v += RL_THREADS) {
      const int p = v / (RL_TILE_C / V), c = v % (RL_TILE_C / V) * V;
      Piece16<W> r;
#pragma unroll
      for (int j = 0; j < V; ++j) r.w[j] = tile[(c + j) * PITCH + p];
      *reinterpret_cast<uint4*>(dst + (size_t)(p0 + p) * C + c0 + c) = r.u;
    }
  } else {
    for (int e = threadIdx.x; e < RL_TILE_P * RL_TILE_C; e += RL_THREADS) {
      const int p = e / RL_TILE_C, c = e % RL_TILE_C;
      if (c0 + c < C && p0 + p < HW)
        dst[(size_t)(p0 + p) * C + c0 + c] = tile[c * PITCH + p];
    }
  }
}

template <typename W>
inline int launch_relayout(const void* vt, void* rows, int B, int C, int HW,
                           int ld_vec, int st_vec, cudaStream_t st) {
  const dim3 grid((unsigned)((HW + RL_TILE_P - 1) / RL_TILE_P),
                  (unsigned)((C + RL_TILE_C - 1) / RL_TILE_C), (unsigned)B);
  values_t_to_rows_kernel<W><<<grid, RL_THREADS, 0, st>>>(
      static_cast<const W*>(vt), static_cast<W*>(rows), C, HW, ld_vec,
      st_vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace rodt

// values (B, HW, NH, DH), or values_t (B, NH, DH, HW) when transposed != 0,
// f32 or bf16 (dtype); loc (B, Q, NH, L, P, 2) and attn (B, Q, NH, L, P)
// f32; out (B, Q, NH, DH) f32; ws: for values_t, a workspace (B, HW, NH,
// DH) in values' dtype that the relayout fills and the gather reads (null
// for values); levels: 3 * L host ints (H_l, W_l, start_l). vec,
// row_lanes, fixed: the gather's plan (kernels.deform_fwd_plan for the
// rows it reads); ld_vec, st_vec: the relayout's
// (kernels.deform_relayout_plan), 0 for values.
extern "C" int ms_deform_attn_sorted_fwd(const void* values, const void* loc,
                                         const void* attn, void* out,
                                         void* ws, const int* levels, int B,
                                         int HW, int Q, int NH, int DH, int L,
                                         int P, int dtype, int transposed,
                                         int vec, int row_lanes, int fixed,
                                         int ld_vec, int st_vec,
                                         void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!transposed)
    return ld_vec || st_vec
               ? static_cast<int>(cudaErrorInvalidValue)
               : rodt::launch_deform_fwd<true>(values, loc, attn, out,
                                               levels, B, HW, Q, NH, DH, L, P,
                                               dtype, vec, row_lanes, fixed,
                                               st);
  const int esize = dtype == rodt::DTYPE_BF16 ? 2 : 4;
  const int V = 16 / esize;
  const long long C = (long long)NH * DH;
  auto al16 = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  rodt::Levels lv;
  if (ws == nullptr ||
      !rodt::deform_fwd_ok(lv, ws, out, levels, B, HW, Q, NH, DH, L, P,
                           dtype, vec, row_lanes, fixed) ||
      B > 65535 || C > 0x7fffffffLL ||
      (C + rodt::RL_TILE_C - 1) / rodt::RL_TILE_C > 65535 ||
      (ld_vec && (HW % V != 0 || !al16(values))) ||
      (st_vec && (C % V != 0 || !al16(ws))))
    return static_cast<int>(cudaErrorInvalidValue);
  const int err =
      esize == 2 ? rodt::launch_relayout<unsigned short>(
                       values, ws, B, (int)C, HW, ld_vec, st_vec, st)
                 : rodt::launch_relayout<unsigned>(values, ws, B, (int)C, HW,
                                                   ld_vec, st_vec, st);
  if (err) return err;
  return rodt::launch_deform_fwd<true>(ws, loc, attn, out, levels, B, HW, Q,
                                       NH, DH, L, P, dtype, vec, row_lanes,
                                       fixed, st);
}
