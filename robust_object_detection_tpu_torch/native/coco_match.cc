// COCOeval greedy matcher core (C++), the native tier of eval/coco_map.py.
//
// The reference leans on pycocotools' C extension for this loop
// (train_frcnn_baseline.py:15-16); our vectorised numpy scorer keeps one
// sequential Python loop over detections per (image, category, area range)
// — the CPU hotspot across the 36 DET + 16 VID eval runs. This implements
// that loop natively with pycocotools-exact semantics:
//
//   * gt ignore = iscrowd || area outside range; gts stable-sorted
//     non-ignored first,
//   * detections stable-sorted by descending score, capped at max_dets,
//   * IoU uses the detection area as denominator for crowd gts,
//   * greedy per-threshold matching, pycocotools inner-loop tie-breaks
//     (a non-ignored running best can't be displaced by an ignored gt;
//     equal IoU replaces, so the last max wins),
//   * dt ignore = matched-to-ignored-gt, or unmatched && out of range.
//
// Exposed as C symbols for ctypes (see native/__init__.py).

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <numeric>
#include <vector>

namespace {

inline double box_area(const float* b) {
  return static_cast<double>(b[2]) * static_cast<double>(b[3]);
}

// IoU between one detection and one gt, xywh; crowd uses dt area only.
inline double iou_xywh(const float* d, const float* g, bool crowd) {
  double dx1 = d[0], dy1 = d[1], dx2 = d[0] + d[2], dy2 = d[1] + d[3];
  double gx1 = g[0], gy1 = g[1], gx2 = g[0] + g[2], gy2 = g[1] + g[3];
  double iw = std::min(dx2, gx2) - std::max(dx1, gx1);
  double ih = std::min(dy2, gy2) - std::max(dy1, gy1);
  if (iw <= 0 || ih <= 0) return 0.0;
  double inter = iw * ih;
  double uni = crowd ? box_area(d) : box_area(d) + box_area(g) - inter;
  return uni > 1e-10 ? inter / uni : 0.0;
}

}  // namespace

extern "C" {

// Match one (image, category, area-range) cell.
//
// dt_boxes: (n_dt, 4) xywh float32; dt_scores: (n_dt,)
// gt_boxes: (n_gt, 4); gt_crowd: (n_gt,) uint8; gt_areas: (n_gt,)
// thrs: (n_thr,) float64 IoU thresholds
// Outputs (caller-allocated):
//   out_scores: (capped_d,) float32 — detection scores in matched order
//   out_matched, out_ignore: (n_thr * capped_d,) uint8
//   returns n_pos (non-ignored gt count); capped_d = min(n_dt, max_dets)
int coco_match_image_category(
    const float* dt_boxes, const float* dt_scores, int n_dt,
    const float* gt_boxes, const uint8_t* gt_crowd, const float* gt_areas,
    int n_gt, double area_lo, double area_hi, int max_dets,
    const double* thrs, int n_thr, float* out_scores, uint8_t* out_matched,
    uint8_t* out_ignore) {
  // gt ignore flags + stable sort: non-ignored first
  std::vector<uint8_t> gt_ig(n_gt);
  for (int g = 0; g < n_gt; ++g) {
    gt_ig[g] = gt_crowd[g] ||
               gt_areas[g] < area_lo || gt_areas[g] > area_hi;
  }
  std::vector<int> gorder(n_gt);
  std::iota(gorder.begin(), gorder.end(), 0);
  std::stable_sort(gorder.begin(), gorder.end(),
                   [&](int a, int b) { return gt_ig[a] < gt_ig[b]; });

  int n_pos = 0;
  for (int g = 0; g < n_gt; ++g) n_pos += gt_ig[g] ? 0 : 1;

  // dt stable sort by descending score, cap at max_dets
  std::vector<int> dorder(n_dt);
  std::iota(dorder.begin(), dorder.end(), 0);
  std::stable_sort(dorder.begin(), dorder.end(), [&](int a, int b) {
    return dt_scores[a] > dt_scores[b];
  });
  int nd = std::min(n_dt, max_dets);

  for (int d = 0; d < nd; ++d) out_scores[d] = dt_scores[dorder[d]];

  // IoU matrix (nd, n_gt) in sorted orders
  std::vector<double> ious(static_cast<size_t>(nd) * n_gt);
  for (int d = 0; d < nd; ++d) {
    const float* db = dt_boxes + 4 * dorder[d];
    for (int g = 0; g < n_gt; ++g) {
      const float* gb = gt_boxes + 4 * gorder[g];
      ious[static_cast<size_t>(d) * n_gt + g] =
          iou_xywh(db, gb, gt_crowd[gorder[g]] != 0);
    }
  }

  std::vector<int> gtm(static_cast<size_t>(n_thr) * n_gt, 0);
  std::memset(out_matched, 0, static_cast<size_t>(n_thr) * nd);
  std::memset(out_ignore, 0, static_cast<size_t>(n_thr) * nd);

  for (int t = 0; t < n_thr; ++t) {
    for (int d = 0; d < nd; ++d) {
      double best = thrs[t] < 1e-10 ? 1e-10 : thrs[t];
      int m = -1;
      for (int g = 0; g < n_gt; ++g) {
        bool crowd = gt_crowd[gorder[g]] != 0;
        if (gtm[static_cast<size_t>(t) * n_gt + g] && !crowd) continue;
        // gts sorted non-ignored first: once the running best is real,
        // an ignored gt can never displace it (pycocotools break)
        if (m > -1 && !gt_ig[gorder[m]] && gt_ig[gorder[g]]) break;
        double v = ious[static_cast<size_t>(d) * n_gt + g];
        if (v < best) continue;
        best = v;
        m = g;
      }
      if (m < 0) continue;
      out_matched[static_cast<size_t>(t) * nd + d] = 1;
      out_ignore[static_cast<size_t>(t) * nd + d] = gt_ig[gorder[m]];
      if (!gt_crowd[gorder[m]]) gtm[static_cast<size_t>(t) * n_gt + m] = 1;
    }
    // unmatched dts out of area range are ignored
    for (int d = 0; d < nd; ++d) {
      if (out_matched[static_cast<size_t>(t) * nd + d]) continue;
      double a = box_area(dt_boxes + 4 * dorder[d]);
      out_ignore[static_cast<size_t>(t) * nd + d] =
          (a < area_lo || a > area_hi) ? 1 : 0;
    }
  }
  return n_pos;
}

}  // extern "C"
