// The backward of multi-scale deformable attention, one design for K5 and
// K5-g2: a taps kernel (the gather half) and the owner scatter (the
// scatter half), two launches, no sort, no atomics, no zero fill, no cast.
//
// Replaces: robust_object_detection_tpu/ops/deform.py, _slots_bwd_pallas
// with its glue _slots_bwd (K5 backward, the VJP of ms_deform_attn_slots)
// and _bwd_pallas with its glue _tpu_bwd_core (K5-g2 backward, the VJPs of
// ms_deform_attn and ms_deform_attn_t). Given dout (B, Q, NH, DH):
//   s_t = <v[b, h, cell_t, :], dout[b, q, h, :]>                 per tap
//   dattn[b, q, h, l, p] = sum_t s_t * wgt_t
//   dloc[b, q, h, l, p]  = attn * (W_l * sum_t s_t * dwx_t,
//                                  H_l * sum_t s_t * dwy_t)
//   dv[b, h, cell, :]    = sum over the taps t of that cell, in tap order,
//                          (wgt_t * attn) * dout[b, q_t, h, :]
// with the geometry of deform.py:_merged_geometry (pixel = loc * size -
// 0.5; the four taps around it weighted wgt_t = wx * wy, the weight and
// both derivatives 0 for a tap outside its map, whose cell is clipped into
// the map). v is `values` (B, HW, NH, DH) or `values_t` (B, NH, DH, HW),
// f32 or bf16, read through two strides; dout is in v's dtype or f32; dv
// has v's dtype and layout, one rounding of an f32 sum.
//
// The TPU versions re-gather with one-hot matmuls (K5 in (level, query)
// slots, K5-g2 after sorting the taps by cell), stamp dv one value tile at
// a time and hand the per-tap scalars to XLA glue. A GPU gathers and
// scatters directly:
//   * Taps kernel, one warp per (batch, query, head), the lanes of K5
//     forward (ms_deform_attn.cu): lane = (tap slot, channel group), a
//     bf16 value row of 32 channels read by 4 lanes in 16-byte pieces, so
//     one load instruction reads 8 taps. Each lane loads its group's dout
//     channels once and works out its own tap's geometry; a tap outside its
//     map gets weight 0 and a valid address (its clipped cell), so no load
//     sits behind a branch. The (3, 4) x 32-channel instantiation issues
//     all 48 taps' loads before its first FMA; a generic one takes any L
//     <= 4, L * P <= 32 and DH, four rounds of loads in flight. Each lane's
//     partial dot product over its channels goes to the warp's slice of
//     shared memory, and one lane a sampling point sums its four taps'
//     partials in a fixed order (channel group, then corner) and writes
//     dattn and dloc: no shuffles, and no order among warps, so any query
//     order gives the same bits. The kernel also writes, for the scatter,
//     each tap's cell (int32) and coefficient wgt * attn (f32) in
//     level-major order within its (batch, head) row: (level, query,
//     point, corner). A level's cells get only that level's taps, and
//     within a level this order is the tap order (query, point, corner) of
//     the sort keys K5-g2 used before.
//   * Scatter: the owner scatter of owner_scatter.cuh (K5-g1's), each
//     tap's contribution coef * dout[b, q(t), h, :] formed on the fly
//     (the product rounded, then added). Each level is tiled on its own,
//     so a block scans one level's taps, a third of the row at the
//     RT-DETR-L shapes. Every cell is written once, by the warp that owns
//     it, from a sum in tap order from +0.0: the sequence of fadds of a
//     sort by (cell, tap) and a segmented sum, so the same bits on every
//     run, and the same bits for K5 and K5-g2 on the same inputs. The
//     store writes the tile in dv's layout: `values` with lanes along
//     channels (16-byte stores), `values_t` with lanes along cells.
//
// values_t costs more: a tap's channels are HW elements apart, 32 sectors
// a tap for a row that `values` reads in 2 (bf16), a price paid to L2 by
// reading that layout in place rather than copying the map to `values`.
//
// What bounds it on the H100: bytes. The value rows the taps touch, dout,
// loc and attn read, dloc, dattn and dv written once; the cell and
// coefficient of every tap (8 bytes, 10.5 MB at the RT-DETR-L train
// shapes) cross memory twice between the two launches. What holds it
// above that bound is the scatter's latency: each block scans its level's
// cells (27 KB at those shapes) and its warps filter the tile's list for
// their own cells before they add, batch by batch.

#include <stdint.h>

#include <algorithm>

#include "deform_rows.cuh"
#include "owner_scatter.cuh"

namespace rodt {

// A lane's VEC channels of a value row: one 16-byte piece where the
// channels are contiguous (RowPiece), VEC element loads `ds` apart where
// STRIDED (values_t).
template <typename T, int VEC, bool STRIDED>
struct BwdPiece {
  RowPiece<T, VEC> r;
  __device__ __forceinline__ void load(const T* p, size_t) { r.load(p); }
  __device__ __forceinline__ float get(int j) const { return r.get(j); }
};

template <typename T, int VEC>
struct BwdPiece<T, VEC, true> {
  float v[VEC];
  __device__ __forceinline__ void load(const T* p, size_t ds) {
#pragma unroll
    for (int j = 0; j < VEC; ++j) v[j] = to_f(p[j * ds]);
  }
  __device__ __forceinline__ float get(int j) const { return v[j]; }
};

// Tap k of one (batch, query, head): its cell in the merged HW axis,
// clipped into its level's map, and its coefficient (wx * wy) * attn, 0 for
// a tap outside the map. lq, aq: the query's (L * P, 2) locations and (L *
// P) weights.
__device__ __forceinline__ void bwd_tap(int k, int P,
                                        const float* __restrict__ lq,
                                        const float* __restrict__ aq,
                                        const Levels& lv, int& cell,
                                        float& coef) {
  const int i = k >> 2, corner = k & 3, l = i / P;
  const int lw = pick_level(lv.w, l), lh = pick_level(lv.h, l);
  const float sx = lq[2 * i] * (float)lw - 0.5f;
  const float sy = lq[2 * i + 1] * (float)lh - 0.5f;
  const float flx = floorf(sx), fly = floorf(sy);
  const float fx = sx - flx, fy = sy - fly;
  // far outside either way: every tap has weight 0; keep the ints sane
  const int tx = (int)fminf(fmaxf(flx, -2.f), (float)lw) + (corner & 1);
  const int ty = (int)fminf(fmaxf(fly, -2.f), (float)lh) + (corner >> 1);
  const bool in = tx >= 0 && tx < lw && ty >= 0 && ty < lh;
  const float wx = (corner & 1) ? fx : 1.f - fx;
  const float wy = (corner >> 1) ? fy : 1.f - fy;
  cell = pick_level(lv.start, l) + min(max(ty, 0), lh - 1) * lw +
         min(max(tx, 0), lw - 1);
  coef = in ? wx * wy * aq[i] : 0.f;
}

// Point i's d(attn) and d(loc) from its four taps' dot products s_c, each
// the sum of the RL channel groups' partials staged at st[c * RL + g],
// taken in g order; the corners in order, nothing from a tap outside its
// map (the sums of ms_deform_attn_ref's autograd, as the TPU kernels' XLA
// glue forms them).
__device__ __forceinline__ void bwd_point(int i, int P, const float* st,
                                          int RL,
                                          const float* __restrict__ lq,
                                          const float* __restrict__ aq,
                                          const Levels& lv, float* dloc,
                                          float* dattn, size_t at) {
  const int l = i / P;
  const int lw = pick_level(lv.w, l), lh = pick_level(lv.h, l);
  const float sx = lq[2 * i] * (float)lw - 0.5f;
  const float sy = lq[2 * i + 1] * (float)lh - 0.5f;
  const float flx = floorf(sx), fly = floorf(sy);
  const float fx = sx - flx, fy = sy - fly;
  const int x0 = (int)fminf(fmaxf(flx, -2.f), (float)lw);
  const int y0 = (int)fminf(fmaxf(fly, -2.f), (float)lh);
  float da = 0.f, dx = 0.f, dy = 0.f;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    float s = 0.f;
    if (RL % 4 == 0) {
      for (int g = 0; g < RL; g += 4) {
        const float4 v = *reinterpret_cast<const float4*>(st + c * RL + g);
        s = (((s + v.x) + v.y) + v.z) + v.w;
      }
    } else {
      for (int g = 0; g < RL; ++g) s += st[c * RL + g];
    }
    const int tx = x0 + (c & 1), ty = y0 + (c >> 1);
    if (tx < 0 || tx >= lw || ty < 0 || ty >= lh) continue;
    const float wx = (c & 1) ? fx : 1.f - fx;
    const float wy = (c >> 1) ? fy : 1.f - fy;
    da = fmaf(s, wx * wy, da);
    dx = fmaf(s, (c & 1) ? wy : -wy, dx);
    dy = fmaf(s, (c >> 1) ? wx : -wx, dy);
  }
  const float a = aq[i];
  dattn[at] = da;
  reinterpret_cast<float2*>(dloc)[at] =
      make_float2(dx * a * (float)lw, dy * a * (float)lh);
}

// Rounds r0 .. r0 + NR - 1 of one warp: each lane works out its tap's
// geometry, channel group 0 of each slot writes the scatter's inputs
// (level-major: at = q * tpq + l * (tpl - tpq) + k in the row), and part[u]
// becomes the lane's partial <value row, dout> over its VEC channels of
// every pass. All NR rounds' loads are issued before the first FMA.
template <typename T, typename TD, int VEC, bool STRIDED, int NR>
__device__ __forceinline__ void bwd_gather(
    float (&part)[NR], int r0, int slots, int s, int g, int RL, int taps,
    int P, const float* __restrict__ lq, const float* __restrict__ aq,
    const Levels& lv, int* __restrict__ cell_out,
    float* __restrict__ coef_out, int level_step, const T* __restrict__ vb,
    size_t cs, size_t ds, const TD* __restrict__ dq, int DH, int passes) {
  int cell[NR];
#pragma unroll
  for (int u = 0; u < NR; ++u) {
    const int k = (r0 + u) * slots + s;
    float coef = 0.f;
    cell[u] = 0;  // past the last tap: a valid row, never used
    if (k < taps) {
      bwd_tap(k, P, lq, aq, lv, cell[u], coef);
      if (g == 0) {
        const int at = (k >> 2) / P * level_step + k;
        cell_out[at] = cell[u];
        coef_out[at] = coef;
      }
    }
    part[u] = 0.f;
  }
  for (int c = 0; c < passes; ++c) {  // uniform
    const int c0 = c * RL * VEC;
    const bool live = c0 + g * VEC < DH;
    float d[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j) d[j] = live ? to_f(dq[c0 + j]) : 0.f;
    BwdPiece<T, VEC, STRIDED> raw[NR];
#pragma unroll
    for (int u = 0; u < NR; ++u)
      if (live) raw[u].load(vb + c0 * ds + cell[u] * cs, ds);
#pragma unroll
    for (int u = 0; u < NR; ++u)
      if (live)
#pragma unroll
        for (int j = 0; j < VEC; ++j)
          part[u] = fmaf(raw[u].get(j), d[j], part[u]);
  }
}

constexpr int BWD_STAGE = 12 * 32;  // a warp's staged partials, 12 rounds

// One warp per (batch, query, head). FL, FP, FRL > 0: the model's (L, P) =
// (3, 4) with DH = FRL * VEC = 32, all rounds' loads in flight together;
// 0: any L, P, DH and RL, four rounds at a time, DH in passes of RL * VEC
// channels. STRIDED: v is values_t. Each lane stages its partials in the
// warp's slice of shared memory (round u, lane at u * 32 + lane: tap (u *
// slots + s), group g at tap * RL + g), and lane j closes the j-th point
// of the staged taps.
template <typename T, typename TD, int VEC, bool STRIDED, int FL, int FP,
          int FRL>
__global__ void __launch_bounds__(THREADS)
deform_bwd_taps_kernel(const T* __restrict__ values,
                       const float* __restrict__ loc,
                       const float* __restrict__ attn,
                       const TD* __restrict__ dout, float* __restrict__ dloc,
                       float* __restrict__ dattn, int* __restrict__ cell,
                       float* __restrict__ coef, Levels lv, size_t n_warps,
                       int HW, int Q, int NH, int DH, int L, int P,
                       int row_lanes) {
  __shared__ __align__(16) float stage[THREADS / 32][BWD_STAGE];
  const int lane = threadIdx.x & 31;
  const size_t wid =
      (size_t)blockIdx.x * (THREADS / 32) + (threadIdx.x >> 5);
  if (wid >= n_warps) return;  // the whole warp leaves together
  float* st = stage[threadIdx.x >> 5];
  const int h = (int)(wid % NH);
  const int q = (int)(wid / NH % Q);
  const size_t b = wid / NH / Q;
  const int np = FL ? FP : P, lp = FL ? FL * FP : L * P, taps = 4 * lp;
  const int RL = FRL ? FRL : row_lanes, slots = 32 / RL;
  const int s = lane / RL, g = lane % RL;
  const int tpq = 4 * np;
  const size_t tpl = (size_t)Q * tpq, row = b * NH + h;
  const float* lq = loc + wid * lp * 2;
  const float* aq = attn + wid * lp;
  int* co = cell + row * (FL ? FL : L) * tpl + (size_t)q * tpq;
  float* ce = coef + row * (FL ? FL : L) * tpl + (size_t)q * tpq;
  // cell c, channel d of this (batch, head) at vb[c * cs + d * ds]
  const size_t cs = STRIDED ? 1 : (size_t)NH * DH;
  const size_t ds = STRIDED ? (size_t)HW : 1;
  const T* vb = values +
                (STRIDED ? row * (size_t)DH * HW : (b * HW * NH + h) * DH) +
                (size_t)g * VEC * ds;
  const TD* dq = dout + wid * DH + g * VEC;

  if constexpr (FL > 0) {
    constexpr int ROUNDS = (4 * FL * FP + 32 / FRL - 1) / (32 / FRL);
    static_assert(ROUNDS * 32 <= BWD_STAGE, "stage too small");
    float part[ROUNDS];
    bwd_gather<T, TD, VEC, STRIDED, ROUNDS>(
        part, 0, slots, s, g, RL, taps, np, lq, aq, lv, co, ce,
        (int)tpl - tpq, vb, cs, ds, dq, DH, 1);
#pragma unroll
    for (int u = 0; u < ROUNDS; ++u) st[u * 32 + lane] = part[u];
    __syncwarp();
    if (lane < lp)
      bwd_point(lane, np, st + lane * 4 * RL, RL, lq, aq, lv, dloc, dattn,
                wid * lp + lane);
  } else {
    constexpr int BURST = 4;  // rounds whose loads are in flight together
    const int passes = (DH + RL * VEC - 1) / (RL * VEC);
    for (int r0 = 0; r0 * slots < taps; r0 += BURST) {  // uniform
      float part[BURST];
      bwd_gather<T, TD, VEC, STRIDED, BURST>(
          part, r0, slots, s, g, RL, taps, np, lq, aq, lv, co, ce,
          (int)tpl - tpq, vb, cs, ds, dq, DH, passes);
      __syncwarp();  // the last burst's points are closed
#pragma unroll
      for (int u = 0; u < BURST; ++u) st[u * 32 + lane] = part[u];
      __syncwarp();
      // a burst holds BURST * slots taps: whole points from r0 * slots / 4
      const int i = r0 * slots / 4 + lane;
      if (lane < slots && i < lp)
        bwd_point(i, np, st + lane * 4 * RL, RL, lq, aq, lv, dloc, dattn,
                  wid * lp + i);
    }
  }
}

// A tap's share of d(values): coef[t] * dout[b, q(t), h, :], the product
// rounded and then added. The taps t0 .. of one level, tpq a query; each
// lane of a batch's first STAMP_BATCH works out one tap's query and
// coefficient and hands them to the others.
template <typename TD>
struct DoutTerm {
  const float* __restrict__ coef;  // the row's coefficients
  const TD* __restrict__ dout;     // dout[b, 0, h, 0]
  size_t qs;                       // dout's query stride, NH * DH
  int t0, tpq;                     // the level's first tap, taps a query
  const TD* __restrict__ dch;      // this lane's channel
  bool chan;
  __device__ __forceinline__ void channel(int d0, int nch) {
    const int lane = threadIdx.x & 31;
    chan = lane < nch;
    dch = dout + d0 + (chan ? lane : 0);
  }
  __device__ __forceinline__ void load(const int (&tk)[STAMP_BATCH],
                                       const int (&cell)[STAMP_BATCH],
                                       int tk_lane, bool lane_live,
                                       float (&v)[STAMP_BATCH]) const {
    const unsigned FULL = 0xffffffffu;
    const int q_mine = lane_live ? (tk_lane - t0) / tpq : 0;
    const float c_mine = lane_live ? coef[tk_lane] : 0.f;
    float x[STAMP_BATCH];
#pragma unroll
    for (int k = 0; k < STAMP_BATCH; ++k) {
      const int qk = __shfl_sync(FULL, q_mine, k);
      x[k] = chan && cell[k] >= 0 ? to_f(dch[(size_t)qk * qs]) : 0.f;
    }
#pragma unroll
    for (int k = 0; k < STAMP_BATCH; ++k)
      v[k] = __fmul_rn(__shfl_sync(FULL, c_mine, k), x[k]);
  }
};

// A row of the `values` layout (B, HW, NH, DH): cell c's channels at
// dr[c * cs], contiguous; SVEC channels a thread (16-byte stores where
// SVEC > 1, lanes along channels).
template <typename TOut, int SVEC>
struct CellMajorStore {
  TOut* __restrict__ dr;
  size_t cs;
  __device__ __forceinline__ void store(const float* tl, int S, int d0,
                                        int nch, int c0, int ncell) const {
    const int groups = nch / SVEC;
    for (int i = threadIdx.x; i < ncell * groups; i += STAMP_THREADS) {
      const int cl = i / groups, gi = i % groups;
      float a[SVEC];
#pragma unroll
      for (int j = 0; j < SVEC; ++j) a[j] = tl[(gi * SVEC + j) * S + cl];
      store_piece<TOut, SVEC>(dr + (size_t)(c0 + cl) * cs + d0 + gi * SVEC,
                              a);
    }
  }
};

// The scatter's tiles: each level is tiled on its own, level l in tiles
// of tile[l] cells, and tile t of a (batch, head) row is the (t -
// first[l])-th of level l for first[l] <= t < first[l + 1] (first[L] =
// row_tiles, the tiles of a row).
struct BwdTiles {
  int tile[MAX_LEVELS];
  int first[MAX_LEVELS];
  int row_tiles;
};

// One block per (row, tile), row = (batch, head). A tile lies in one
// level, and its block scans that level's taps only. SVEC 0: dv is
// values_t's (rows, DH, HW); else `values`' layout, SVEC channels a store.
// At most 64 registers, four blocks an SM: left alone, the bf16 instance
// with bf16 dout took 92 and ran two (0.26 ms against 0.21 on an H100,
// tools/profile_torch_deform_cuts.py).
template <typename T, typename TD, int SVEC>
__global__ void __launch_bounds__(STAMP_THREADS, 4)
deform_bwd_scatter_kernel(const int* __restrict__ cell,
                          const float* __restrict__ coef,
                          const TD* __restrict__ dout, T* __restrict__ dv,
                          Levels lv, BwdTiles bt, int L, int tpl, int tpq,
                          int HW, int Q, int NH, int DH, int ivec) {
  extern __shared__ __align__(16) float smem[];
  const size_t row = blockIdx.x / bt.row_tiles, b = row / NH;
  const int h = (int)(row % NH), t = (int)(blockIdx.x % bt.row_tiles);
  int l = 0;
#pragma unroll
  for (int k = 1; k < MAX_LEVELS; ++k)
    if (k < L && bt.first[k] <= t) l = k;
  const int tile = pick_level(bt.tile, l);
  const int start = pick_level(lv.start, l);
  const int c0 = start + (t - pick_level(bt.first, l)) * tile;
  const int ncell =
      min(tile, start + pick_level(lv.h, l) * pick_level(lv.w, l) - c0);
  const size_t taps = (size_t)L * tpl;
  DoutTerm<TD> term{coef + row * taps, dout + (b * Q * NH + h) * DH,
                    (size_t)NH * DH, l * tpl, tpq, nullptr, false};
  const int* ir = cell + row * taps;
  if constexpr (SVEC > 0) {
    const CellMajorStore<T, SVEC> store{dv + (b * HW * NH + h) * DH,
                                        (size_t)NH * DH};
    owner_scatter(ir, l * tpl, (l + 1) * tpl, c0, ncell, tile, DH,
                  ivec != 0, term, store, smem);
  } else {
    const ChanMajorStore<T> store{dv + row * (size_t)DH * HW, HW};
    owner_scatter(ir, l * tpl, (l + 1) * tpl, c0, ncell, tile, DH,
                  ivec != 0, term, store, smem);
  }
}

struct BwdArgs {
  const void *values, *loc, *attn, *dout;
  void *dloc, *dattn, *cell, *coef, *dv;
  Levels lv;
  BwdTiles bt;
  int max_tile, B, HW, Q, NH, DH, L, P, row_lanes, ivec;
};

template <typename T, typename TD, int VEC, bool STRIDED, int FL, int FP,
          int FRL>
inline int launch_taps(const BwdArgs& a, cudaStream_t st) {
  const size_t n_warps = (size_t)a.B * a.Q * a.NH;
  const size_t blocks = (n_warps + THREADS / 32 - 1) / (THREADS / 32);
  if (blocks > 0x7fffffffu) return static_cast<int>(cudaErrorInvalidValue);
  deform_bwd_taps_kernel<T, TD, VEC, STRIDED, FL, FP, FRL>
      <<<(unsigned)blocks, THREADS, 0, st>>>(
          static_cast<const T*>(a.values), static_cast<const float*>(a.loc),
          static_cast<const float*>(a.attn), static_cast<const TD*>(a.dout),
          static_cast<float*>(a.dloc), static_cast<float*>(a.dattn),
          static_cast<int*>(a.cell), static_cast<float*>(a.coef), a.lv,
          n_warps, a.HW, a.Q, a.NH, a.DH, a.L, a.P, a.row_lanes);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename TD, int SVEC>
inline int launch_scatter(const BwdArgs& a, cudaStream_t st) {
  const size_t smem = stamp_smem(a.max_tile);
  const cudaError_t e = cudaFuncSetAttribute(
      deform_bwd_scatter_kernel<T, TD, SVEC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const size_t blocks = (size_t)a.B * a.NH * a.bt.row_tiles;
  if (blocks > 0x7fffffffu) return static_cast<int>(cudaErrorInvalidValue);
  const int tpq = 4 * a.P;
  deform_bwd_scatter_kernel<T, TD, SVEC>
      <<<(unsigned)blocks, STAMP_THREADS, smem, st>>>(
          static_cast<const int*>(a.cell), static_cast<const float*>(a.coef),
          static_cast<const TD*>(a.dout), static_cast<T*>(a.dv), a.lv, a.bt,
          a.L, a.Q * tpq, tpq, a.HW, a.Q, a.NH, a.DH, a.ivec);
  return static_cast<int>(cudaGetLastError());
}

// Both launches for one (values dtype T, dout dtype TD): the taps kernel
// by the plan's vec, fixed and layout, then the scatter by layout and
// svec.
template <typename T, typename TD>
inline int launch_bwd(const BwdArgs& a, int vec, int fixed, int transposed,
                      int svec, cudaStream_t st) {
  constexpr int V = 16 / sizeof(T);
  int err;
  if (vec == 1)
    err = transposed ? launch_taps<T, TD, 1, true, 0, 0, 0>(a, st)
                     : launch_taps<T, TD, 1, false, 0, 0, 0>(a, st);
  else if (fixed)
    err = transposed ? launch_taps<T, TD, V, true, 3, 4, 32 / V>(a, st)
                     : launch_taps<T, TD, V, false, 3, 4, 32 / V>(a, st);
  else
    err = transposed ? launch_taps<T, TD, V, true, 0, 0, 0>(a, st)
                     : launch_taps<T, TD, V, false, 0, 0, 0>(a, st);
  if (err) return err;
  if (transposed) return launch_scatter<T, TD, 0>(a, st);
  return svec > 1 ? launch_scatter<T, TD, V>(a, st)
                  : launch_scatter<T, TD, 1>(a, st);
}

}  // namespace rodt

// values (B, HW, NH, DH), or (B, NH, DH, HW) when transposed != 0, f32 or
// bf16 (dtype); loc (B, Q, NH, L, P, 2) and attn (B, Q, NH, L, P) f32;
// dout (B, Q, NH, DH) in values' dtype or f32 (dout_dtype); levels: 3 * L
// host ints (H_l, W_l, start_l); tiles: L host ints, the scatter's tile of
// each level. Writes dloc, dattn (f32, the shapes of loc and attn), cell
// (B * NH, L * Q * P * 4) int32 and coef (the same, f32), the scatter's
// inputs in level-major order, and dv in values' dtype and layout, every
// element. The plan of kernels.deform_bwd_plan: tiles, vec, row_lanes,
// fixed (the taps kernel's lanes), ivec (16-byte loads of cell) and svec
// (channels a store of dv in the `values` layout).
extern "C" int ms_deform_attn_bwd(const void* values, const void* loc,
                                  const void* attn, const void* dout,
                                  void* dloc, void* dattn, void* cell,
                                  void* coef, void* dv, const int* levels,
                                  const int* tiles, int B, int HW, int Q,
                                  int NH, int DH, int L, int P, int dtype,
                                  int dout_dtype, int transposed, int vec,
                                  int row_lanes, int fixed, int ivec,
                                  int svec, void* stream) {
  rodt::BwdArgs a{values, loc, attn, dout, dloc, dattn, cell, coef, dv};
  a.B = B;
  a.HW = HW;
  a.Q = Q;
  a.NH = NH;
  a.DH = DH;
  a.L = L;
  a.P = P;
  a.row_lanes = row_lanes;
  a.ivec = ivec;
  const int esize = dtype == rodt::DTYPE_BF16 ? 2 : 4;
  const int V = 16 / esize;
  const size_t tpl = (size_t)Q * P * 4;
  auto al16 = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  if (B <= 0 || HW <= 0 || Q <= 0 || NH <= 0 || DH <= 0 || P <= 0 ||
      !rodt::fill_levels(a.lv, levels, L) || L * P > 32 ||
      (dtype != rodt::DTYPE_F32 && dtype != rodt::DTYPE_BF16) ||
      (dout_dtype != dtype && dout_dtype != rodt::DTYPE_F32) ||
      L * tpl > (size_t)(0x7fffffff - 2 * rodt::STAMP_CHUNK) ||
      row_lanes < 1 || row_lanes > 32 || (row_lanes & (row_lanes - 1)) ||
      !(vec == 1 || vec == V) ||
      (vec > 1 && (transposed ? DH % V != 0
                              : (DH * esize) % 16 != 0 || !al16(values))) ||
      (fixed && !(vec > 1 && L == 3 && P == 4 && DH == 32 &&
                  row_lanes * vec == 32)) ||
      (ivec && (tpl % rodt::STAMP_U || !al16(cell))) ||
      (transposed ? svec != 0
                  : !(svec == 1 ||
                      (svec == V && (DH * esize) % 16 == 0 && al16(dv)))))
    return static_cast<int>(cudaErrorInvalidValue);
  // the tiles of each level, a row's tiles and the largest tile
  a.max_tile = 0;
  long long first = 0;
  for (int l = 0; l < rodt::MAX_LEVELS; ++l) {
    a.bt.tile[l] = l < L ? tiles[l] : 1;
    a.bt.first[l] = (int)first;
    if (l >= L) continue;
    if (tiles[l] < rodt::STAMP_WARPS || tiles[l] > rodt::STAMP_MAX_TILE ||
        tiles[l] % rodt::STAMP_WARPS)
      return static_cast<int>(cudaErrorInvalidValue);
    first += ((long long)a.lv.h[l] * a.lv.w[l] + tiles[l] - 1) / tiles[l];
    a.max_tile = std::max(a.max_tile, tiles[l]);
  }
  a.bt.row_tiles = (int)first;
  if (first * B * NH > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == rodt::DTYPE_F32)
    return rodt::launch_bwd<float, float>(a, vec, fixed, transposed, svec,
                                          st);
  if (dout_dtype == rodt::DTYPE_BF16)
    return rodt::launch_bwd<__nv_bfloat16, __nv_bfloat16>(
        a, vec, fixed, transposed, svec, st);
  return rodt::launch_bwd<__nv_bfloat16, float>(a, vec, fixed, transposed,
                                                svec, st);
}
