"""Batched class-aware NMS with static shapes (counterpart of
robust_object_detection_tpu/ops/nms.py).

Same greedy algorithm and fixed capacities as the reference: callers
pre-select the top ``num_candidates`` scores, then ``max_outputs`` steps
each pick the highest-scoring live box of every image, emit it, and kill
every live box it overlaps. Each step is a handful of (B, K) tensor ops
with no host synchronisation, so the loop only enqueues work on the card.
Picked rows are gathered with ``torch.gather`` (the reference's one-hot
matmul gather is a TPU workaround with the same values).
"""

from __future__ import annotations

import torch

# boxes of different classes never overlap once each class is translated
# to its own region (the torchvision batched_nms trick)
_CLASS_OFFSET = 8192.0


def _nms_core(boxes: torch.Tensor, scores: torch.Tensor,
              classes: torch.Tensor, max_outputs: int, iou_thresh: float,
              class_aware: bool):
    """Greedy NMS over (B, K) candidates -> (B, max_outputs) picks.

    Padding slots carry score <= 0 and are never picked as valid.
    Returns (boxes (B,P,4), scores (B,P), classes (B,P) int32 with -1 in
    invalid slots, valid (B,P) bool)."""
    nb = (boxes + classes[..., None].float() * _CLASS_OFFSET
          if class_aware else boxes)
    x1, y1, x2, y2 = nb.unbind(-1)                             # (B, K)
    area = (x2 - x1) * (y2 - y1)
    s_live = torch.where(scores > 0, scores, torch.full_like(scores, -1.0))
    picks, svals = [], []
    for _ in range(max_outputs):
        i = torch.argmax(s_live, dim=1, keepdim=True)          # (B, 1)
        si = torch.gather(s_live, 1, i)
        bx1, by1, bx2, by2, ba = (torch.gather(v, 1, i)
                                  for v in (x1, y1, x2, y2, area))
        iw = (torch.minimum(bx2, x2) - torch.maximum(bx1, x1)).clamp(min=0.0)
        ih = (torch.minimum(by2, y2) - torch.maximum(by1, y1)).clamp(min=0.0)
        inter = iw * ih
        iou = inter / (ba + area - inter).clamp(min=1e-9)
        s_live = torch.where(iou > iou_thresh, -1.0, s_live)
        s_live = s_live.scatter(1, i, -1.0)
        picks.append(i)
        svals.append(si)
    idx = torch.cat(picks, 1)                                  # (B, P)
    sval = torch.cat(svals, 1)
    valid = sval > 0
    ob = torch.gather(boxes, 1, idx[..., None].expand(-1, -1, 4))
    oc = torch.gather(classes.to(torch.int32), 1, idx)
    ob = torch.where(valid[..., None], ob, 0.0)
    os_ = torch.where(valid, sval, 0.0)
    oc = torch.where(valid, oc, -1)
    return ob, os_, oc, valid


def nms(boxes: torch.Tensor, scores: torch.Tensor, classes: torch.Tensor,
        max_outputs: int = 300, iou_thresh: float = 0.7,
        class_aware: bool = True):
    """Single-image NMS over fixed-capacity candidates: boxes (K, 4) xyxy,
    scores (K,) with padding slots at score <= 0, classes (K,). Returns
    (boxes, scores, classes, valid) with leading dim max_outputs, by
    descending score."""
    ob, os_, oc, ov = _nms_core(boxes[None], scores[None], classes[None],
                                max_outputs, iou_thresh, class_aware)
    return ob[0], os_[0], oc[0], ov[0]


def batched_nms(boxes: torch.Tensor, scores: torch.Tensor,
                classes: torch.Tensor, num_candidates: int = 1024,
                max_outputs: int = 300, iou_thresh: float = 0.7,
                score_thresh: float = 0.001, class_aware: bool = True):
    """Threshold -> top-k -> greedy NMS. boxes (B, N, 4); scores, classes
    (B, N). Returns (boxes, scores, classes, valid), (B, max_outputs, ...)."""
    s = torch.where(scores > score_thresh, scores, 0.0)
    k = min(num_candidates, s.shape[1])
    top_s, top_i = torch.topk(s, k, dim=1)
    top_b = torch.gather(boxes, 1, top_i[..., None].expand(-1, -1, 4))
    top_c = torch.gather(classes, 1, top_i)
    return _nms_core(top_b, top_s, top_c, max_outputs, iou_thresh,
                     class_aware)


def multilabel_nms(boxes: torch.Tensor, scores: torch.Tensor,
                   num_candidates: int = 30000, max_outputs: int = 300,
                   iou_thresh: float = 0.7, score_thresh: float = 0.001):
    """Multi-label NMS (the Ultralytics val protocol): every (box, class)
    pair above threshold competes. boxes (B, N, 4); scores (B, N, C). The
    top-k runs over the class-major flattened (C*N) score plane."""
    b, n, c = scores.shape
    st = scores.transpose(1, 2)
    s = torch.where(st > score_thresh, st, 0.0).reshape(b, c * n)
    k = min(num_candidates, n * c)
    top_s, top_i = torch.topk(s, k, dim=1)
    box_i = top_i % n
    top_c = (top_i // n).to(torch.int32)
    top_b = torch.gather(boxes, 1, box_i[..., None].expand(-1, -1, 4))
    return _nms_core(top_b, top_s, top_c, max_outputs, iou_thresh,
                     class_aware=True)
