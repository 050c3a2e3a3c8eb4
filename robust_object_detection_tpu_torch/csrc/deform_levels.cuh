// The level table of the deformable-attention kernels (deform_fwd.cuh,
// deform_bwd.cu): (H_l, W_l) of each value map and the flat offset of its
// first cell in the merged HW axis, passed by value.
#pragma once

namespace rodt {

constexpr int MAX_LEVELS = 4;

struct Levels {
  int h[MAX_LEVELS];
  int w[MAX_LEVELS];
  int start[MAX_LEVELS];
};

// levels: 3 * L host ints, (H_l, W_l, start_l) per level.
inline bool fill_levels(Levels& lv, const int* levels, int L) {
  if (L <= 0 || L > MAX_LEVELS) return false;
  for (int l = 0; l < MAX_LEVELS; ++l) {
    lv.h[l] = l < L ? levels[3 * l] : 1;
    lv.w[l] = l < L ? levels[3 * l + 1] : 1;
    lv.start[l] = l < L ? levels[3 * l + 2] : 0;
  }
  return true;
}

}  // namespace rodt
