"""The COCOeval bbox protocol in numpy: IoU thresholds 0.50:0.05:0.95,
101 recall points, greedy matching in descending score order, crowd and
area-range ignores, maxDets 100, areas all / small / medium / large.

A frozen copy of ``robust_object_detection_tpu_torch/eval/coco_map.py``
(commit bdbb134) with its C++ matcher taken out: the numpy matcher only.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Sequence

import numpy as np

IOU_THRS = np.linspace(0.5, 0.95, 10)
REC_THRS = np.linspace(0.0, 1.0, 101)
AREA_RNG = {
    "all": (0.0, 1e10),
    "small": (0.0, 32.0 ** 2),
    "medium": (32.0 ** 2, 96.0 ** 2),
    "large": (96.0 ** 2, 1e10),
}


@dataclasses.dataclass
class Detections:
    """Per-image detections: xywh boxes, scores, integer category ids."""
    boxes: np.ndarray       # (N, 4) xywh
    scores: np.ndarray      # (N,)
    classes: np.ndarray     # (N,) int


@dataclasses.dataclass
class GroundTruth:
    """Per-image ground truth: xywh boxes, category ids, iscrowd flags."""
    boxes: np.ndarray       # (M, 4) xywh
    classes: np.ndarray     # (M,) int
    iscrowd: np.ndarray | None = None   # (M,) bool
    areas: np.ndarray | None = None     # (M,) — COCO uses the ann's area field

    def __post_init__(self):
        m = len(self.boxes)
        if self.iscrowd is None:
            self.iscrowd = np.zeros(m, bool)
        if self.areas is None:
            self.areas = (self.boxes[:, 2] * self.boxes[:, 3]
                          if m else np.zeros(0))


def _iou_xywh(dt: np.ndarray, gt: np.ndarray, crowd: np.ndarray) -> np.ndarray:
    """COCO IoU: (D, G); crowd GT uses detection area as the denominator
    (pycocotools maskUtils.iou semantics)."""
    if len(dt) == 0 or len(gt) == 0:
        return np.zeros((len(dt), len(gt)))
    dx1, dy1 = dt[:, 0], dt[:, 1]
    dx2, dy2 = dt[:, 0] + dt[:, 2], dt[:, 1] + dt[:, 3]
    gx1, gy1 = gt[:, 0], gt[:, 1]
    gx2, gy2 = gt[:, 0] + gt[:, 2], gt[:, 1] + gt[:, 3]
    iw = np.minimum(dx2[:, None], gx2[None]) - np.maximum(dx1[:, None], gx1[None])
    ih = np.minimum(dy2[:, None], gy2[None]) - np.maximum(dy1[:, None], gy1[None])
    inter = np.clip(iw, 0, None) * np.clip(ih, 0, None)
    da = (dt[:, 2] * dt[:, 3])[:, None]
    ga = (gt[:, 2] * gt[:, 3])[None]
    union = np.where(crowd[None], da, da + ga - inter)
    return inter / np.maximum(union, 1e-10)


def _match_image_category(dt_boxes, dt_scores, gt_boxes, gt_crowd, gt_areas,
                          area_rng, max_dets):
    """COCOeval.evaluateImg for one (image, category, area range).

    Returns (dt_scores_sorted, dt_matched (T, D) bool, dt_ignore (T, D) bool,
    n_positive) where T = len(IOU_THRS), D = min(len(dt), max_dets).
    """
    T = len(IOU_THRS)
    # GT ignore: crowd or out of area range (COCOeval _prepare + evaluateImg).
    gt_ig = gt_crowd | (gt_areas < area_rng[0]) | (gt_areas > area_rng[1])
    # Sort GT: non-ignored first (stable), like gtind = argsort(_ignore).
    gorder = np.argsort(gt_ig, kind="stable")
    gt_boxes = gt_boxes[gorder]
    gt_crowd_s = gt_crowd[gorder]
    gt_ig = gt_ig[gorder]

    # Sort detections by descending score (stable), cap at max_dets.
    dorder = np.argsort(-dt_scores, kind="stable")[:max_dets]
    dt_boxes = dt_boxes[dorder]
    dt_scores = dt_scores[dorder]

    D, G = len(dt_boxes), len(gt_boxes)
    n_pos = int((~gt_ig).sum())
    if D == 0:
        return dt_scores, np.zeros((T, 0), bool), np.zeros((T, 0), bool), n_pos

    ious = _iou_xywh(dt_boxes, gt_boxes, gt_crowd_s)  # (D, G)

    dtm = np.full((T, D), -1, np.int64)    # matched gt index or -1
    gtm = np.zeros((T, G), bool)           # gt already matched
    for d in range(D):
        if G:
            iou_d = ious[d]                                     # (G,)
            # candidate gts per threshold: unmatched (or crowd) and above thr
            thr = np.maximum(IOU_THRS, 1e-10)[:, None]          # (T, 1)
            allowed = (~gtm) | gt_crowd_s[None]                 # (T, G)
            cand = allowed & (iou_d[None] >= thr)               # (T, G)
            # COCO tie-break: prefer non-ignored gts — once the running best is
            # non-ignored, an ignored gt can't take over; among same ignore
            # status, highest IoU wins with earliest index on ties. Because
            # gts are sorted non-ignored-first, this equals: pick argmax IoU
            # among non-ignored candidates if any, else among ignored ones.
            # Ties: pycocotools' inner loop replaces the running best on
            # ious >= best, so the LAST gt with the max IoU wins.
            def argmax_last(x):
                return x.shape[1] - 1 - x[:, ::-1].argmax(axis=1)

            iou_masked = np.where(cand, iou_d[None], -1.0)
            non_ig = cand & ~gt_ig[None]
            iou_non_ig = np.where(non_ig, iou_d[None], -1.0)
            has_non_ig = non_ig.any(axis=1)
            best = np.where(has_non_ig,
                            argmax_last(iou_non_ig),
                            argmax_last(iou_masked))
            found = cand[np.arange(T), best]
            dtm[:, d] = np.where(found, best, -1)
            newly = found & ~gt_crowd_s[best]
            gtm[np.arange(T)[newly], best[newly]] = True

    matched = dtm >= 0
    # dt ignore: matched to an ignored gt, or unmatched & detection area
    # outside the range (COCOeval evaluateImg dtIg computation).
    dt_areas = dt_boxes[:, 2] * dt_boxes[:, 3]
    out_of_rng = (dt_areas < area_rng[0]) | (dt_areas > area_rng[1])
    match_ig = np.zeros((T, D), bool)
    m = matched
    match_ig[m] = gt_ig[dtm[m]]
    dt_ig = np.where(matched, match_ig, out_of_rng[None])
    return dt_scores, matched, dt_ig, n_pos


@dataclasses.dataclass
class EvalResult:
    """Accumulated COCO metrics.

    precision: (T, R, K, A) — iou thr x recall thr x category x area range;
    recall: (T, K, A). -1 marks absent categories, matching pycocotools.
    ap50, ap, per_class_ap50 are the headline scalars the reference reads
    (eval_all.py:131-156).
    """
    precision: np.ndarray
    recall: np.ndarray
    categories: List[int]
    area_labels: List[str]

    def _valid_mean(self, x: np.ndarray) -> float:
        v = x[x > -1]
        return float(v.mean()) if v.size else 0.0

    @property
    def ap(self) -> float:          # mAP@[.5:.95], area=all
        return self._valid_mean(self.precision[:, :, :, 0])

    @property
    def ap50(self) -> float:        # mAP@50, area=all
        return self._valid_mean(self.precision[0, :, :, 0])

    @property
    def ap75(self) -> float:
        return self._valid_mean(self.precision[5, :, :, 0])

    def ap_by_area(self, label: str) -> float:
        a = self.area_labels.index(label)
        return self._valid_mean(self.precision[:, :, :, a])

    @property
    def per_class_ap50(self) -> Dict[int, float]:
        """AP@50 per category — the reference's precision[0,:,k,0,2] slice
        (eval_all.py:146-156; their index 2 is maxDets=100, ours is fixed)."""
        out = {}
        for k, cat in enumerate(self.categories):
            out[cat] = self._valid_mean(self.precision[0, :, k, 0])
        return out


def evaluate(detections: Mapping[int, Detections],
             ground_truth: Mapping[int, GroundTruth],
             categories: Sequence[int],
             max_dets: int = 100,
             area_labels: Sequence[str] = ("all", "small", "medium", "large"),
             ) -> EvalResult:
    """Run the full COCOeval bbox protocol over a set of images.

    detections / ground_truth: image_id -> per-image arrays. Images present in
    ground_truth but missing from detections count as all-FN, like COCOeval.
    """
    img_ids = sorted(ground_truth.keys())
    T, R = len(IOU_THRS), len(REC_THRS)
    K, A = len(categories), len(area_labels)
    precision = -np.ones((T, R, K, A))
    recall = -np.ones((T, K, A))

    empty_dt = Detections(np.zeros((0, 4)), np.zeros(0), np.zeros(0, int))

    for k, cat in enumerate(categories):
        # Pre-slice per-category views once per image.
        per_img = []
        for img_id in img_ids:
            gt = ground_truth[img_id]
            dt = detections.get(img_id, empty_dt)
            gsel = gt.classes == cat
            dsel = dt.classes == cat
            per_img.append((dt.boxes[dsel], dt.scores[dsel],
                            gt.boxes[gsel], gt.iscrowd[gsel], gt.areas[gsel]))

        for a, label in enumerate(area_labels):
            rng = AREA_RNG[label]
            scores_all, matched_all, ignore_all = [], [], []
            n_pos = 0
            for db, ds, gb, gc, ga in per_img:
                s, m, ig, np_ = _match_image_category(db, ds, gb, gc, ga,
                                                      rng, max_dets)
                scores_all.append(s)
                matched_all.append(m)
                ignore_all.append(ig)
                n_pos += np_
            if n_pos == 0:
                continue
            scores = np.concatenate(scores_all)
            matched = np.concatenate(matched_all, axis=1)   # (T, Dtot)
            ignored = np.concatenate(ignore_all, axis=1)

            # Global stable sort by descending score (COCOeval: mergesort).
            order = np.argsort(-scores, kind="mergesort")
            matched = matched[:, order]
            ignored = ignored[:, order]

            tps = matched & ~ignored
            fps = ~matched & ~ignored
            tp_cum = np.cumsum(tps, axis=1).astype(np.float64)
            fp_cum = np.cumsum(fps, axis=1).astype(np.float64)

            for t in range(T):
                tp, fp = tp_cum[t], fp_cum[t]
                nd = len(tp)
                rc = tp / n_pos
                pr = tp / np.maximum(tp + fp, np.spacing(1))
                recall[t, k, a] = rc[-1] if nd else 0.0
                # Monotone interpolated precision (running max from the end).
                if nd:
                    pr = np.maximum.accumulate(pr[::-1])[::-1]
                    inds = np.searchsorted(rc, REC_THRS, side="left")
                    q = np.zeros(R)
                    valid = inds < nd
                    q[valid] = pr[inds[valid]]
                    precision[t, :, k, a] = q
                else:
                    precision[t, :, k, a] = 0.0

    return EvalResult(precision=precision, recall=recall,
                      categories=list(categories),
                      area_labels=list(area_labels))


def summarize(result: EvalResult) -> Dict[str, float]:
    """The headline dict persisted to eval_results.json (eval_all.py:322-347)."""
    return {
        "mAP50": result.ap50,
        "mAP50_95": result.ap,
        "mAP75": result.ap75,
        "mAP_small": result.ap_by_area("small"),
        "mAP_medium": result.ap_by_area("medium"),
        "mAP_large": result.ap_by_area("large"),
    }
