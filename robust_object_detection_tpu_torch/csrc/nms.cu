// Greedy NMS over B images of K sorted candidates, one launch a batch: the
// selection loop of ops/nms.py's _nms_core on CUDA tensors.
//
// Replaces: robust_object_detection_tpu/ops/nms.py, _nms_core's
// `lax.scan` (:50; no pallas_call). The port's CPU path keeps it as an
// eager loop of max_outputs steps, ~24 small (B, K) ops a step, which on
// the card is paced by the host's launch rate. Candidates come sorted by
// non-increasing score (torch.topk(sorted=True), or nms()'s stable sort),
// so the loop's argmax, the first of the live maxima, is the first live
// candidate in position order, and the loop is one walk: a candidate with
// score > 0 is kept iff no candidate kept before it overlaps it with IoU >
// iou_thresh; the walk stops after P picks or at the first score <= 0.
//
// Boxes and scores share one type T, float or double; classes are int32 or
// int64.
//
// Arithmetic is the eager ops' to the bit. The class offset is
// float(class) * 8192 in f32, added to every coordinate in T; the area
// comes from the offset coordinates; iw = max(min(bx2, x2) - max(bx1, x1),
// 0), ih likewise; iou = inter / max((ba + area) - inter, 1e-9); the test is
// iou > thr in T. Every product, sum and quotient is written with the _rn intrinsics (__fmul_rn, __fadd_rn,
// __fsub_rn, __fdiv_rn and their double forms), which nvcc never contracts
// into an FMA and which round as IEEE, whatever the flags. minimum, maximum
// and the clamps propagate NaN as torch's do (a NaN IoU suppresses
// nothing). With thr >= 0 a pair with no positive intersection is passed
// over without the division: its IoU is 0 or NaN, never above thr.
//
// One block an image, chunk == threads candidates a step (the plan of
// kernels.nms_plan). A step:
//   1. each thread loads one candidate (score, box + class offset, area)
//      and tests it against every box kept so far (shared memory), leaving
//      at its first suppression; the chunk's first score <= 0 ends the walk
//      there;
//   2. the survivors are compacted in order (ballot + a warp scan);
//   3. every survivor pair (i < j) is tested once into a bit mask, a row of
//      chunk / 32 words a survivor;
//   4. one warp walks the survivors in order, a kept-bit word a lane: j is
//      kept iff its row ANDs to zero with the kept bits (one __any_sync a
//      survivor), and stops at the P-th pick;
//   5. the kept survivors are appended to the kept list and written to the
//      outputs at their slots.
// What bounds it is the walk's serial dependency, not its bytes (~24 B a
// candidate). The kept list (min(K, P) boxes and areas) lives in shared
// memory; where it does not fit beside the chunk it lives in `spill`
// (global memory, per image). Slots after the last pick get position 0
// and score -1, as the loop's argmax over an all-dead row leaves them.
// stats (or null) gets each image's walk length: the candidates consumed
// before it stopped.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr size_t NMS_SMEM_LIMIT = 232448 - 1024;
constexpr unsigned FULL = 0xffffffffu;
constexpr float CLASS_OFFSET = 8192.0f;

// class dtypes (kernels.NMS_CLASS_KINDS)
constexpr int CLS_NONE = 0, CLS_I32 = 1, CLS_I64 = 2;

template <typename T>
struct alignas(4 * sizeof(T)) Box4 {
  T x1, y1, x2, y2;
};

__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float div_rn(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ double div_rn(double a, double b) { return __ddiv_rn(a, b); }

// the floor of the IoU's denominator, 1e-9 in T (torch casts
// clamp's scalar to the tensor's dtype)
template <typename T> __device__ __forceinline__ T den_floor();
template <> __device__ __forceinline__ float den_floor<float>() { return 1e-9f; }
template <> __device__ __forceinline__ double den_floor<double>() { return 1e-9; }

// torch.minimum / torch.maximum: NaN if either side is NaN
template <typename T>
__device__ __forceinline__ T tmin(T a, T b) {
  return (a != a) ? a : ((b != b) ? b : (b < a ? b : a));
}
template <typename T>
__device__ __forceinline__ T tmax(T a, T b) {
  return (a != a) ? a : ((b != b) ? b : (b > a ? b : a));
}
// clamp(min=lo): NaN stays NaN
template <typename T>
__device__ __forceinline__ T clamp_lo(T v, T lo) { return v < lo ? lo : v; }

// Does kept box k (area ka) suppress candidate c (area ca)? The eager
// loop's IoU, k in the role of the picked box.
template <typename T>
__device__ __forceinline__ bool suppresses(const Box4<T>& k, T ka,
                                           const Box4<T>& c, T ca, T thr,
                                           bool thr_nonneg) {
  const T iw = clamp_lo(sub_rn(tmin(k.x2, c.x2), tmax(k.x1, c.x1)), T(0));
  const T ih = clamp_lo(sub_rn(tmin(k.y2, c.y2), tmax(k.y1, c.y1)), T(0));
  const T inter = mul_rn(iw, ih);
  if (thr_nonneg && !(inter > T(0))) return false;
  const T den = clamp_lo(sub_rn(add_rn(ka, ca), inter), den_floor<T>());
  return div_rn(inter, den) > thr;
}

__device__ __forceinline__ float class_value(const void* classes, int kind,
                                             size_t i) {
  if (kind == CLS_I32) return (float)static_cast<const int*>(classes)[i];
  return (float)static_cast<const long long*>(classes)[i];
}

__host__ __device__ size_t round16(size_t n) { return (n + 15) / 16 * 16; }

// Shared-memory layout, in bytes, for elements of eb bytes; mirrors
// kernels.nms_plan. kp: the kept boxes held in shared memory (0 when they
// live in `spill`).
struct Layout {
  size_t kbox, cbox, karea, carea, cscore, cpos, mask, total;
};

__host__ __device__ Layout layout(int kp, int chunk, size_t eb) {
  Layout L;
  size_t off = 0;
  L.kbox = off;
  off += (size_t)kp * 4 * eb;
  L.cbox = off;
  off += (size_t)chunk * 4 * eb;
  L.karea = off;
  off += (size_t)kp * eb;
  L.carea = off = round16(off);
  off += (size_t)chunk * eb;
  L.cscore = off = round16(off);
  off += (size_t)chunk * eb;
  L.cpos = off = round16(off);
  off += (size_t)chunk * 4;
  L.mask = off = round16(off);
  off += (size_t)chunk * (chunk / 32) * 4;
  L.total = round16(off);
  return L;
}

// kept boxes an image holds in `spill`: rounded up to 4, so that every
// image's boxes start 16-byte (f32) or 32-byte (f64) aligned
__host__ __device__ int spill_rows(int kp) { return (kp + 3) / 4 * 4; }

template <typename T>
__global__ void __launch_bounds__(1024)
nms_walk_kernel(const T* __restrict__ boxes, const T* __restrict__ scores,
                const void* __restrict__ classes, int cls_kind, int K, int P,
                T thr, int kp_smem, T* __restrict__ spill,
                long long* __restrict__ idx_out, T* __restrict__ sval_out,
                int* __restrict__ stats) {
  extern __shared__ __align__(32) unsigned char smem[];
  __shared__ int s_stop, s_total, s_got, s_last;
  __shared__ int s_wpre[32], s_bpre[32];
  __shared__ unsigned s_bits[32];

  const int C = blockDim.x, W = C >> 5;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int b = blockIdx.x;
  const Layout L = layout(kp_smem, C, sizeof(T));
  Box4<T>* kbox;
  T* karea;
  if (kp_smem > 0) {
    kbox = reinterpret_cast<Box4<T>*>(smem + L.kbox);
    karea = reinterpret_cast<T*>(smem + L.karea);
  } else {
    const int rows = spill_rows(min(K, P));
    kbox = reinterpret_cast<Box4<T>*>(spill + (size_t)b * rows * 5);
    karea = reinterpret_cast<T*>(kbox + rows);
  }
  Box4<T>* cbox = reinterpret_cast<Box4<T>*>(smem + L.cbox);
  T* carea = reinterpret_cast<T*>(smem + L.carea);
  T* cscore = reinterpret_cast<T*>(smem + L.cscore);
  int* cpos = reinterpret_cast<int*>(smem + L.cpos);
  unsigned* mask = reinterpret_cast<unsigned*>(smem + L.mask);

  const T* bx = boxes + (size_t)b * K * 4;
  const T* sc = scores + (size_t)b * K;
  const size_t row = (size_t)b * K;
  long long* idx_b = idx_out + (size_t)b * P;
  T* sval_b = sval_out + (size_t)b * P;
  const bool nonneg = thr >= T(0);

  int n = 0, walked = K;
  for (int base = 0; base < K; base += C) {
    const int end = min(K, base + C);
    if (t == 0) s_stop = end;
    __syncthreads();
    // 1. load; the chunk's first score <= 0 ends the walk
    const int pos = base + t;
    T s = T(0);
    if (pos < end) {
      s = sc[pos];
      if (!(s > T(0))) atomicMin(&s_stop, pos);
    }
    __syncthreads();
    const int stop = s_stop;
    bool live = pos < stop;
    Box4<T> c;
    T ca = T(0);
    if (live) {
      c.x1 = bx[(size_t)pos * 4];
      c.y1 = bx[(size_t)pos * 4 + 1];
      c.x2 = bx[(size_t)pos * 4 + 2];
      c.y2 = bx[(size_t)pos * 4 + 3];
      if (cls_kind != CLS_NONE) {
        const T off = T(__fmul_rn(class_value(classes, cls_kind, row + pos),
                                  CLASS_OFFSET));
        c.x1 = add_rn(c.x1, off);
        c.y1 = add_rn(c.y1, off);
        c.x2 = add_rn(c.x2, off);
        c.y2 = add_rn(c.y2, off);
      }
      ca = mul_rn(sub_rn(c.x2, c.x1), sub_rn(c.y2, c.y1));
      for (int i = 0; i < n; ++i) {
        if (suppresses(kbox[i], karea[i], c, ca, thr, nonneg)) {
          live = false;
          break;
        }
      }
    }
    // 2. compact the survivors in order
    const unsigned bal = __ballot_sync(FULL, live);
    if (lane == 0) s_wpre[warp] = __popc(bal);
    __syncthreads();
    if (warp == 0) {
      const int v = lane < W ? s_wpre[lane] : 0;
      int incl = v;
      for (int o = 1; o < 32; o <<= 1) {
        const int u = __shfl_up_sync(FULL, incl, o);
        if (lane >= o) incl += u;
      }
      if (lane < W) s_wpre[lane] = incl - v;
      if (lane == 31) s_total = incl;
    }
    __syncthreads();
    const int n_surv = s_total;
    if (live) {
      const int r = s_wpre[warp] + __popc(bal & ((1u << lane) - 1u));
      cbox[r] = c;
      carea[r] = ca;
      cscore[r] = s;
      cpos[r] = pos;
    }
    __syncthreads();
    // 3. survivor pairs i < j: bit i % 32 of word i / 32 of row j
    for (int item = t; item < n_surv * W; item += C) {
      const int j = item / W, w = item - j * W;
      const int i0 = w << 5;
      if (i0 >= j) continue;
      const int i1 = min(i0 + 32, j);
      const Box4<T> cj = cbox[j];
      const T aj = carea[j];
      unsigned bits = 0u;
      for (int i = i0; i < i1; ++i)
        if (suppresses(cbox[i], carea[i], cj, aj, thr, nonneg))
          bits |= 1u << (i - i0);
      mask[j * W + w] = bits;
    }
    __syncthreads();
    // 4. the walk over the survivors, one warp
    if (warp == 0) {
      unsigned kw = 0u;
      int got = 0, last = -1;
      const int room = P - n;
      for (int j = 0; j < n_surv; ++j) {
        const unsigned m = (lane << 5) < j ? mask[j * W + lane] : 0u;
        if (!__any_sync(FULL, (m & kw) != 0u)) {
          if (lane == (j >> 5)) kw |= 1u << (j & 31);
          last = j;
          if (++got == room) break;
        }
      }
      s_bits[lane] = kw;
      const int v = __popc(kw);
      int incl = v;
      for (int o = 1; o < 32; o <<= 1) {
        const int u = __shfl_up_sync(FULL, incl, o);
        if (lane >= o) incl += u;
      }
      s_bpre[lane] = incl - v;
      if (lane == 0) {
        s_got = got;
        s_last = last;
      }
    }
    __syncthreads();
    // 5. append the kept survivors at their slots
    if (t < n_surv) {
      const unsigned wb = s_bits[t >> 5];
      if ((wb >> (t & 31)) & 1u) {
        const int k = n + s_bpre[t >> 5] + __popc(wb & ((1u << (t & 31)) - 1u));
        kbox[k] = cbox[t];
        karea[k] = carea[t];
        idx_b[k] = cpos[t];
        sval_b[k] = cscore[t];
      }
    }
    n += s_got;
    if (n == P) {
      walked = cpos[s_last] + 1;
      break;
    }
    if (stop < end) {
      walked = stop;
      break;
    }
  }
  for (int k = n + t; k < P; k += C) {
    idx_b[k] = 0;
    sval_b[k] = T(-1);
  }
  if (t == 0 && stats != nullptr) stats[b] = walked;
}

template <typename T>
int launch_walk(const void* boxes, const void* scores, const void* classes,
                int cls_kind, int B, int K, int P, double thr, int threads,
                int kp_smem, int smem, void* spill, void* idx, void* sval,
                void* stats, cudaStream_t stream) {
  const Layout L = layout(kp_smem, threads, sizeof(T));
  if ((size_t)smem != L.total || L.total > NMS_SMEM_LIMIT)
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = nms_walk_kernel<T>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<B, threads, smem, stream>>>(
      static_cast<const T*>(boxes), static_cast<const T*>(scores), classes,
      cls_kind, K, P, static_cast<T>(thr), kp_smem, static_cast<T*>(spill),
      static_cast<long long*>(idx), static_cast<T*>(sval),
      static_cast<int*>(stats));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// boxes (B, K, 4), scores (B, K), classes (B, K) or null, all contiguous;
// f64: 1 for float64 boxes and scores, 0 for float32; thr as given (cast to
// T here, as torch casts the comparison's scalar); threads (== the chunk),
// kp_smem and smem from kernels.nms_plan; spill (kp_smem 0 only): B x
// spill_rows x 5 elements of T; idx (B, P) int64, sval (B, P) of T; stats
// (B,) int32 or null.
extern "C" int nms_walk(const void* boxes, const void* scores,
                        const void* classes, int cls_kind, int f64, int B,
                        int K, int P, double thr, int threads, int kp_smem,
                        int smem, void* spill, void* idx, void* sval,
                        void* stats, void* stream) {
  if (B <= 0 || K <= 0 || P <= 0 || threads < 32 || threads > 1024 ||
      threads % 32 != 0 || cls_kind < CLS_NONE || cls_kind > CLS_I64 ||
      (cls_kind != CLS_NONE && classes == nullptr) ||
      (kp_smem != 0 && kp_smem != (K < P ? K : P)) ||
      (kp_smem == 0 && spill == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (f64)
    return launch_walk<double>(boxes, scores, classes, cls_kind, B, K, P, thr,
                               threads, kp_smem, smem, spill, idx, sval,
                               stats, s);
  return launch_walk<float>(boxes, scores, classes, cls_kind, B, K, P, thr,
                            threads, kp_smem, smem, spill, idx, sval, stats,
                            s);
}
