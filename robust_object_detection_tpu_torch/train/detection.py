"""Detection training core: task-aligned assignment and the YOLOv8 losses
(counterpart of robust_object_detection_tpu/train/detection.py).

Loss recipe (YOLOv8 defaults, the reference run's hyp box=7.5, cls=0.5,
dfl=1.5):
  * classification: BCE(pred logits, soft target scores), normalised by the
    total target score,
  * box: (1 - CIoU) weighted by the assigned target score,
  * DFL: cross-entropy of the two integer bins bracketing each target
    distance, same weighting.

The assigner is the reference's ``precise=True`` configuration: the
alignment metric in f32 and an exact ``torch.topk``. (The TPU production
step ranks with a bf16 metric and ``approx_max_k``; that difference is
deliberate and logged in ROADMAP.md.) Padded GTs (class -1) are masked,
never branched on. :func:`yolo_loss` assigns one image at a time: the same
math as the batched form, with each (M, N) tensor 1/B the size of the
batched (B, M, N) one (826 MB in f32 at (16, 600, 21504)).
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from ..core.profiling import span
from ..models import yolov8 as yolo_lib
from ..ops import boxes as box_ops
from ..parallel.mesh import global_sum


def _candidates_in_gt(anchors: torch.Tensor, gt_boxes: torch.Tensor,
                      eps: float = 1e-9) -> torch.Tensor:
    """(N, 2) anchor centres x (B, M, 4) gt -> (B, M, N) bool: centre
    strictly inside the gt box."""
    x, y = anchors[:, 0], anchors[:, 1]
    x1, y1, x2, y2 = (gt_boxes[..., i:i + 1] for i in range(4))
    return ((x - x1 > eps) & (y - y1 > eps) & (x2 - x > eps)
            & (y2 - y > eps))


def task_aligned_assign(scores: torch.Tensor, pred_boxes: torch.Tensor,
                        anchors: torch.Tensor, gt_boxes: torch.Tensor,
                        gt_classes: torch.Tensor, topk: int = 10,
                        alpha: float = 0.5, beta: float = 6.0
                        ) -> Dict[str, torch.Tensor]:
    """Task-aligned label assignment (TAL), Ultralytics-8.3 semantics.

    scores: (B, N, nc) sigmoid probabilities; pred_boxes: (B, N, 4) xyxy
    px; anchors: (N, 2) pixel centres; gt_boxes: (B, M, 4) xyxy px;
    gt_classes: (B, M) int with -1 padding. The overlap is CIoU clamped at
    0; a conflicted anchor goes to the gt of highest overlap over the full
    row. Returns fg_mask (B, N) bool, target_boxes (B, N, 4),
    target_scores (B, N, nc), target_gt (B, N) int32.
    """
    b, n, nc = scores.shape
    m = gt_boxes.shape[1]
    gt_valid = gt_classes >= 0                                   # (B, M)
    gt_cls = torch.clamp(gt_classes, min=0).long()

    iou = box_ops.pairwise_ciou(gt_boxes.float(), pred_boxes.float())
    iou = torch.clamp(iou, min=0) * gt_valid[..., None]          # (B, M, N)
    cls_score = torch.gather(scores.transpose(1, 2).float(), 1,
                             gt_cls[..., None].expand(b, m, n))  # (B, M, N)
    s_pow = (torch.sqrt(torch.clamp(cls_score, min=0)) if alpha == 0.5
             else cls_score ** alpha)
    metric = s_pow * iou ** beta

    mask = _candidates_in_gt(anchors, gt_boxes) & gt_valid[..., None]
    metric = torch.where(mask, metric, 0.0)

    k = min(topk, n)
    kth = torch.topk(metric, k, dim=-1).values[..., -1:]
    pos = mask & (metric >= kth) & (metric > 0)                  # (B, M, N)

    # conflicted anchors: the gt of highest overlap over the full row
    conflicted = pos.sum(1, keepdim=True) > 1                    # (B, 1, N)
    best_gt = F.one_hot(iou.argmax(1), m).transpose(1, 2).bool()
    pos = torch.where(conflicted, best_gt, pos)

    pos_metric = torch.where(pos, metric, 0.0)
    max_metric = pos_metric.amax(2, keepdim=True)                # (B, M, 1)
    max_iou = torch.where(pos, iou, 0.0).amax(2, keepdim=True)
    ratio = max_iou / (max_metric + 1e-9)

    def pick(v: torch.Tensor) -> torch.Tensor:      # v: (B, M) or (B, M, N)
        v = v if v.dim() == 3 else v[..., None]
        return torch.where(pos, v, 0.0).sum(1)
    tb = torch.stack([pick(gt_boxes[..., c].float()) for c in range(4)], -1)
    tc = pick(gt_cls.float()).long()                             # (B, N)
    anchor_score = pick(pos_metric * ratio)
    fg_mask = pick(torch.ones(b, m, device=pos.device)) > 0      # (B, N)
    target_gt = pick(torch.arange(m, dtype=torch.float32,
                                  device=pos.device).expand(b, m)).int()
    target_scores = (F.one_hot(tc, nc).float()
                     * (anchor_score * fg_mask)[..., None])
    return {"fg_mask": fg_mask,
            "target_boxes": torch.where(fg_mask[..., None], tb, 0.0),
            "target_scores": target_scores,
            "target_gt": target_gt}


def dfl_loss(box_logits: torch.Tensor, target_ltrb: torch.Tensor,
             weight: torch.Tensor) -> torch.Tensor:
    """Distribution focal loss. box_logits (B, N, 4, REG_MAX); target_ltrb
    (B, N, 4) in stride units, clipped to [0, REG_MAX - 1.01]; weight
    (B, N)."""
    reg_max = box_logits.shape[-1]
    t = torch.clamp(target_ltrb, 0.0, reg_max - 1 - 0.01)
    tl = torch.floor(t)
    wl = tl + 1.0 - t
    wr = t - tl
    logp = F.log_softmax(box_logits, dim=-1)
    bins = torch.arange(reg_max, dtype=torch.float32, device=logp.device)
    w = (wl[..., None] * (bins == tl[..., None])
         + wr[..., None] * (bins == tl[..., None] + 1.0))
    per_anchor = -(logp * w).sum(-1).mean(-1)                    # (B, N)
    return (per_anchor * weight).sum()


def optax_bce(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Elementwise binary cross-entropy with logits (numerically stable)."""
    return (torch.clamp(logits, min=0) - logits * targets
            + torch.log1p(torch.exp(-logits.abs())))


def yolo_loss(outs, gt_boxes: torch.Tensor, gt_classes: torch.Tensor,
              img_size: int, box_w: float = 7.5, cls_w: float = 0.5,
              dfl_w: float = 1.5, topk: int = 10
              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Full YOLOv8 loss from the raw head outputs (the port's NCHW
    per-level (box_logits, cls_logits)); gt_boxes (B, M, 4) xyxy pixels,
    gt_classes (B, M) with -1 padding. Returns (total, {"box", "cls",
    "dfl", "num_fg"}). The assignment runs in the span ``train.assign``."""
    box_logits, cls_logits = yolo_lib.flatten_outputs(outs)
    dev = box_logits.device
    anchors_np, strides_np = yolo_lib.anchor_points(img_size)
    anchors = torch.as_tensor(anchors_np, device=dev)
    strides = torch.as_tensor(strides_np, device=dev)[:, None]
    anchors_px = anchors * strides

    d = yolo_lib.dfl_expectation(box_logits)
    pred_boxes = torch.cat([(anchors - d[..., :2]) * strides,
                            (anchors + d[..., 2:]) * strides], -1)
    scores = torch.sigmoid(cls_logits)

    # one image at a time: the same math, 1/B of the (B, M, N) memory
    with span("train.assign"), torch.no_grad():
        parts = [task_aligned_assign(scores[i:i + 1], pred_boxes[i:i + 1],
                                     anchors_px, gt_boxes[i:i + 1],
                                     gt_classes[i:i + 1], topk=topk)
                 for i in range(scores.shape[0])]
        assign = {k: torch.cat([p[k] for p in parts]) for k in parts[0]}
    ts = assign["target_scores"]
    fg = assign["fg_mask"]
    # the global batch's sum under a data-parallel step, as the
    # reference's over its sharded batch
    tsum = torch.clamp(global_sum(ts.sum()), min=1.0)

    cls_loss = optax_bce(cls_logits, ts).sum() / tsum

    w = ts.sum(-1) * fg                                          # (B, N)
    tb = assign["target_boxes"]
    box_loss = ((1.0 - box_ops.ciou(pred_boxes, tb)) * w).sum() / tsum

    t_ltrb = torch.cat([anchors - tb[..., :2] / strides,
                        tb[..., 2:] / strides - anchors], -1)
    dfl = dfl_loss(box_logits, t_ltrb, w) / tsum

    total = box_w * box_loss + cls_w * cls_loss + dfl_w * dfl
    return total, {"box": box_loss, "cls": cls_loss, "dfl": dfl,
                   "num_fg": fg.sum()}
