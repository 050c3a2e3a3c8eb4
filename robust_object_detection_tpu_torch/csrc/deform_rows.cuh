// Value rows of the deformable-attention kernels (deform_fwd.cuh, the
// gather of K5 and K5-g2 forward; deform_bwd.cu, the backward of K5 and
// K5-g2): a lane's piece of a value row, VEC channels read with one
// 16-byte load where VEC > 1, and its store.
#pragma once

#include <type_traits>

#include "conv_tile.cuh"
#include "deform_levels.cuh"

namespace rodt {

// The value rows are read in pieces of VEC channels (16 bytes when VEC >
// 1), RL lanes a row (RL a power of two): lane = (slot s = lane / RL,
// channel group g = lane % RL). Round r of a pass reads tap k = r * (32 /
// RL) + s, corner k % 4 of sampling point k / 4 = (level, point).
template <typename T, int VEC>
struct RowPiece;

template <>
struct RowPiece<__nv_bfloat16, 8> {
  uint4 u;
  __device__ __forceinline__ void load(const __nv_bfloat16* p) {
    u = *reinterpret_cast<const uint4*>(p);
  }
  __device__ __forceinline__ void zero() { u = make_uint4(0, 0, 0, 0); }
  __device__ __forceinline__ float get(int j) const {
    const unsigned w = j < 2 ? u.x : j < 4 ? u.y : j < 6 ? u.z : u.w;
    return __uint_as_float((j & 1) ? (w & 0xffff0000u) : (w << 16));
  }
};

template <>
struct RowPiece<float, 4> {
  float4 f;
  __device__ __forceinline__ void load(const float* p) {
    f = *reinterpret_cast<const float4*>(p);
  }
  __device__ __forceinline__ void zero() { f = make_float4(0, 0, 0, 0); }
  __device__ __forceinline__ float get(int j) const {
    return j == 0 ? f.x : j == 1 ? f.y : j == 2 ? f.z : f.w;
  }
};

template <typename T>
struct RowPiece<T, 1> {
  float v;
  __device__ __forceinline__ void load(const T* p) { v = to_f(*p); }
  __device__ __forceinline__ void zero() { v = 0.f; }
  __device__ __forceinline__ float get(int) const { return v; }
};

__device__ __forceinline__ unsigned pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&h);
}

// Stores a lane's VEC f32 sums as T: 16 bytes of bf16 or f32 (VEC 8 or
// 4), 32 bytes of f32 from a bf16 piece (two float4 stores), or one
// element.
template <typename T, int VEC>
__device__ __forceinline__ void store_piece(T* p, const float (&a)[VEC]) {
  if constexpr (VEC == 8 && std::is_same<T, float>::value) {
    float4* q = reinterpret_cast<float4*>(p);
    q[0] = make_float4(a[0], a[1], a[2], a[3]);
    q[1] = make_float4(a[4], a[5], a[6], a[7]);
  } else if constexpr (VEC == 8) {
    *reinterpret_cast<uint4*>(p) =
        make_uint4(pack_bf16x2(a[0], a[1]), pack_bf16x2(a[2], a[3]),
                   pack_bf16x2(a[4], a[5]), pack_bf16x2(a[6], a[7]));
  } else if constexpr (VEC == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(a[0], a[1], a[2], a[3]);
  } else {
    *p = from_f<T>(a[0]);
  }
}

__device__ __forceinline__ int pick_level(const int (&a)[MAX_LEVELS],
                                          int l) {
  return l == 0 ? a[0] : l == 1 ? a[1] : l == 2 ? a[2] : a[3];
}

}  // namespace rodt
