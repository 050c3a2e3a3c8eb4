// The two tiny per-channel kernels of a train-mode BatchNorm's backward
// that K2-b (yolo_front_bwd.cu) and K4-b (hgstem_bwd.cu) share, in both
// dtypes: the cotangent of a batch-statistics pair as the terms of e = d +
// ds + 2 y dss, and the folded-BN chain rule.
#pragma once

#include "conv_tile.cuh"

namespace rodt {

// The cotangent of a batch-statistics pair (mean, var) of n values as the
// per-element terms of e = d + ds + 2 y dss.
static __global__ void stat_cotangent_kernel(const float* dmean,
                                             const float* dvar,
                                             const float* mean, float n,
                                             int C, float* ds, float* dss) {
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    ds[c] = dmean[c] / n - 2.f * mean[c] * dvar[c] / n;
    dss[c] = dvar[c] / n;
  }
}

// Folded-BN backward (pallas_stem._bn_chain). sums = (dg, db), the
// gradients by the fold g = sc * rsqrt(var + eps), b = bi - mean * g.
static __global__ void bn_chain_kernel(const float* sums, const float* sc,
                                       const float* mean, const float* var,
                                       float n, const float* dmean_in,
                                       const float* dvar_in, int C,
                                       float* dsc, float* dbi, float* ds,
                                       float* dss) {
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    const float dgc = sums[c], dbc = sums[C + c];
    const float r = 1.f / sqrtf(var[c] + BN_EPS);
    dsc[c] = dgc * r - dbc * mean[c] * r;
    dbi[c] = dbc;
    const float dm = -dbc * sc[c] * r + dmean_in[c];
    const float dv = (dgc - dbc * mean[c]) * sc[c] * (-0.5f) * r * r * r
                     + dvar_in[c];
    ds[c] = dm / n - 2.f * mean[c] * dv / n;
    dss[c] = dv / n;
  }
}

}  // namespace rodt
