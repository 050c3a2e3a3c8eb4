"""Batched class-aware NMS with static shapes (counterpart of
robust_object_detection_tpu/ops/nms.py).

Same greedy algorithm and fixed capacities as the reference: callers
pre-select the top ``num_candidates`` scores, then ``max_outputs`` picks
each take the highest-scoring live box of every image, emit it, and kill
every live box it overlaps. On CPU tensors the picks are the reference's
loop, one step per output, each a handful of (B, K) tensor ops
(:func:`_greedy_loop`, the plain version). On CUDA tensors they are one
launch of ``nms_walk`` (``csrc/nms.cu``), which walks each image's sorted
candidates once and equals the loop bit for bit (:func:`_greedy_walk`).
Picked rows are gathered with ``torch.gather`` (the reference's one-hot
matmul gather is a TPU workaround with the same values).
"""

from __future__ import annotations

from typing import Optional

import torch

from .. import kernels

# boxes of different classes never overlap once each class is translated
# to its own region (the torchvision batched_nms trick)
_CLASS_OFFSET = 8192.0


def _greedy_loop(boxes: torch.Tensor, scores: torch.Tensor,
                 classes: torch.Tensor, max_outputs: int, iou_thresh: float,
                 class_aware: bool):
    """The reference's loop: max_outputs argmax steps over (B, K) -> (idx
    (B, P) int64, sval (B, P), the picked score or -1)."""
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
    return torch.cat(picks, 1), torch.cat(svals, 1)


def _greedy_walk(boxes: torch.Tensor, scores: torch.Tensor,
                 classes: torch.Tensor, max_outputs: int, iou_thresh: float,
                 class_aware: bool, stats: Optional[torch.Tensor] = None):
    """One launch of ``nms_walk`` on CUDA tensors: the loop's (idx, sval).
    Boxes and scores share one type, float32 or float64 (what every caller
    passes); classes are int32 or int64. stats, an int32 (B,) tensor or
    None, gets each image's walk length."""
    b, k = scores.shape
    p = int(max_outputs)
    if boxes.shape != (b, k, 4) or (class_aware and classes.shape != (b, k)):
        raise ValueError(f"nms: boxes {tuple(boxes.shape)}, scores "
                         f"{tuple(scores.shape)} and classes "
                         f"{tuple(classes.shape)} do not match")
    if (boxes.dtype not in (torch.float32, torch.float64)
            or scores.dtype != boxes.dtype):
        raise ValueError(f"nms on CUDA takes float32 or float64 boxes and "
                         f"scores of one type, got {boxes.dtype} and "
                         f"{scores.dtype}")
    if class_aware and classes.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"nms on CUDA takes int32 or int64 classes, got "
                         f"{classes.dtype}")
    dev = boxes.device
    if stats is not None and (stats.shape != (b,) or stats.dtype != torch.int32
                              or stats.device != dev
                              or not stats.is_contiguous()):
        raise ValueError("nms: stats must be a contiguous int32 (B,) tensor "
                         "on the boxes' device")
    if b == 0:
        return (torch.zeros((0, p), dtype=torch.int64, device=dev),
                scores.new_zeros((0, p)))
    bx, sc = boxes.detach().contiguous(), scores.detach().contiguous()
    cls, kind = None, kernels.NMS_CLASS_KINDS["none"]
    if class_aware:
        cls = classes.detach().contiguous()
        kind = kernels.NMS_CLASS_KINDS[str(cls.dtype).split(".")[1]]
    plan = kernels.nms_plan(b, k, p, bx.element_size())
    idx = torch.empty((b, p), dtype=torch.int64, device=dev)
    sval = torch.empty((b, p), dtype=sc.dtype, device=dev)
    spill = (torch.empty((plan["spill"],), dtype=bx.dtype, device=dev)
             if plan["spill"] else None)
    err = kernels.launch(
        dev, "nms_walk", bx.data_ptr(), sc.data_ptr(),
        None if cls is None else cls.data_ptr(), kind,
        int(bx.dtype == torch.float64), b, k, p, float(iou_thresh),
        plan["threads"], plan["kp_smem"], plan["smem"],
        None if spill is None else spill.data_ptr(), idx.data_ptr(),
        sval.data_ptr(), None if stats is None else stats.data_ptr())
    kernels.check(err, "nms_walk")
    _nms_core.launches += 1
    return idx, sval


def walk_lengths(idx: torch.Tensor, sval: torch.Tensor,
                 scores: torch.Tensor) -> torch.Tensor:
    """The candidates a walk over sorted scores (B, K) consumes before it
    stops, from the picks: the P-th pick's position + 1 where P picks were
    made, else the first score <= 0 (K if none): int32 (B,)."""
    k = scores.shape[1]
    dead = ~(scores > 0)
    stop = torch.where(dead.any(1), dead.int().argmax(1),
                       torch.full_like(dead[:, 0], k, dtype=torch.int64))
    return torch.where(sval[:, -1] > 0, idx[:, -1] + 1, stop).int()


def _nms_core(boxes: torch.Tensor, scores: torch.Tensor,
              classes: torch.Tensor, max_outputs: int, iou_thresh: float,
              class_aware: bool, stats: Optional[torch.Tensor] = None):
    """Greedy NMS over (B, K) candidates -> (B, max_outputs) picks.

    The candidates come sorted by non-increasing score, as
    ``torch.topk(sorted=True)`` gives them to :func:`batched_nms` and
    :func:`multilabel_nms` (ties in any order). The loop's argmax takes
    the first of equal maxima, so on sorted candidates its picks are one
    walk in position order: a candidate with score > 0 is kept iff no
    candidate kept before it overlaps it with IoU > iou_thresh, and the
    walk stops after max_outputs picks or at the first score <= 0. CUDA
    tensors take that walk in one launch (:func:`_greedy_walk`, counted in
    ``_nms_core.launches``); other tensors run the loop, which also holds
    on unsorted candidates. Slots after the last pick carry position 0 and
    score -1. :func:`nms` sorts its single image first.

    Padding slots carry score <= 0 and are never picked as valid. stats,
    an int32 (B,) tensor or None (the predict steps), gets each image's
    walk length (:func:`walk_lengths`). Returns (boxes (B,P,4), scores
    (B,P), classes (B,P) int32 with -1 in invalid slots, valid (B,P)
    bool)."""
    if boxes.device.type == "cuda":
        idx, sval = _greedy_walk(boxes, scores, classes, max_outputs,
                                 iou_thresh, class_aware, stats)
    else:
        idx, sval = _greedy_loop(boxes, scores, classes, max_outputs,
                                 iou_thresh, class_aware)
        if stats is not None:
            stats.copy_(walk_lengths(idx, sval, scores))
    valid = sval > 0
    ob = torch.gather(boxes, 1, idx[..., None].expand(-1, -1, 4))
    oc = torch.gather(classes.to(torch.int32), 1, idx)
    ob = torch.where(valid[..., None], ob, 0.0)
    os_ = torch.where(valid, sval, 0.0)
    oc = torch.where(valid, oc, -1)
    return ob, os_, oc, valid


_nms_core.launches = 0


def nms(boxes: torch.Tensor, scores: torch.Tensor, classes: torch.Tensor,
        max_outputs: int = 300, iou_thresh: float = 0.7,
        class_aware: bool = True):
    """Single-image NMS over fixed-capacity candidates: boxes (K, 4) xyxy,
    scores (K,) with padding slots at score <= 0, classes (K,). Returns
    (boxes, scores, classes, valid) with leading dim max_outputs, by
    descending score. The candidates are first sorted by score
    (``torch.sort(descending=True, stable=True)``, scores <= 0 as -1), so
    the picks are the loop's on them as given."""
    s, order = torch.sort(torch.where(scores > 0, scores, -1.0),
                          descending=True, stable=True)
    ob, os_, oc, ov = _nms_core(boxes[order][None], s[None],
                                classes[order][None], max_outputs,
                                iou_thresh, class_aware)
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
