"""Box utilities (counterpart of robust_object_detection_tpu/ops/boxes.py):
format conversion and clipping; IoU, GIoU and CIoU, elementwise on aligned
(..., 4) xyxy boxes and pairwise (..., M, 4) x (..., N, 4) -> (..., M, N);
the COCO-convention IoU on xywh boxes.

The pairwise versions stay component-wise, as the reference's do: every
intermediate is (..., M, N), never a (..., M, N, 2) or (..., M, N, 4)
broadcast, which keeps the TAL assigner's (B, M, N) passes at their least
memory. The CIoU aspect weight alpha carries no gradient (``detach``, the
reference's ``stop_gradient``).
"""

from __future__ import annotations

import math

import torch


def xywh_to_xyxy(b: torch.Tensor) -> torch.Tensor:
    x, y, w, h = b.unbind(-1)
    return torch.stack([x, y, x + w, y + h], -1)


def xyxy_to_xywh(b: torch.Tensor) -> torch.Tensor:
    x1, y1, x2, y2 = b.unbind(-1)
    return torch.stack([x1, y1, x2 - x1, y2 - y1], -1)


def cxcywh_to_xyxy(b: torch.Tensor) -> torch.Tensor:
    cx, cy, w, h = b.unbind(-1)
    return torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1)


def xyxy_to_cxcywh(b: torch.Tensor) -> torch.Tensor:
    x1, y1, x2, y2 = b.unbind(-1)
    return torch.stack([(x1 + x2) / 2, (y1 + y2) / 2, x2 - x1, y2 - y1], -1)


def clip_to_image(b: torch.Tensor, h: float, w: float) -> torch.Tensor:
    """Clamp xyxy boxes into [0, w] x [0, h]."""
    x1, y1, x2, y2 = b.unbind(-1)
    return torch.stack([x1.clamp(0, w), y1.clamp(0, h), x2.clamp(0, w),
                        y2.clamp(0, h)], -1)


def area(b: torch.Tensor) -> torch.Tensor:
    return (torch.clamp(b[..., 2] - b[..., 0], min=0)
            * torch.clamp(b[..., 3] - b[..., 1], min=0))


def _pairwise_parts(a: torch.Tensor, b: torch.Tensor):
    ax1, ay1, ax2, ay2 = (a[..., :, None, i] for i in range(4))
    bx1, by1, bx2, by2 = (b[..., None, :, i] for i in range(4))
    return (ax1, ay1, ax2, ay2), (bx1, by1, bx2, by2)


def _pairwise_inter(pa, pb) -> torch.Tensor:
    (ax1, ay1, ax2, ay2), (bx1, by1, bx2, by2) = pa, pb
    iw = torch.clamp(torch.minimum(ax2, bx2) - torch.maximum(ax1, bx1), min=0)
    ih = torch.clamp(torch.minimum(ay2, by2) - torch.maximum(ay1, by1), min=0)
    return iw * ih


def pairwise_iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """IoU matrix between (..., M, 4) and (..., N, 4) xyxy -> (..., M, N)."""
    pa, pb = _pairwise_parts(a, b)
    inter = _pairwise_inter(pa, pb)
    union = area(a)[..., :, None] + area(b)[..., None, :] - inter
    return inter / torch.clamp(union, min=1e-9)


def pairwise_iou_xywh_coco(a: torch.Tensor, b: torch.Tensor,
                           b_iscrowd: torch.Tensor | None = None
                           ) -> torch.Tensor:
    """COCO-convention IoU on xywh boxes (pycocotools maskUtils.iou): for
    crowd GT the denominator is the detection area only."""
    pa, pb = _pairwise_parts(xywh_to_xyxy(a), xywh_to_xyxy(b))
    inter = _pairwise_inter(pa, pb)
    area_a = (a[..., 2] * a[..., 3])[..., :, None]
    area_b = (b[..., 2] * b[..., 3])[..., None, :]
    union = area_a + area_b - inter
    if b_iscrowd is not None:
        union = torch.where(b_iscrowd[..., None, :], area_a + 0 * area_b,
                            union)
    return inter / torch.clamp(union, min=1e-9)


def pairwise_giou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """GIoU matrix between (..., M, 4) and (..., N, 4) xyxy -> (..., M, N)."""
    pa, pb = _pairwise_parts(a, b)
    (ax1, ay1, ax2, ay2), (bx1, by1, bx2, by2) = pa, pb
    inter = _pairwise_inter(pa, pb)
    union = area(a)[..., :, None] + area(b)[..., None, :] - inter
    iou = inter / torch.clamp(union, min=1e-9)
    ew = torch.maximum(bx2, ax2) - torch.minimum(bx1, ax1)
    eh = torch.maximum(by2, ay2) - torch.minimum(by1, ay1)
    earea = torch.clamp(ew, min=0) * torch.clamp(eh, min=0)
    return iou - (earea - union) / torch.clamp(earea, min=1e-9)


def pairwise_ciou(a: torch.Tensor, b: torch.Tensor,
                  eps: float = 1e-7) -> torch.Tensor:
    """CIoU matrix between (..., M, 4) and (..., N, 4) xyxy -> (..., M, N),
    Ultralytics ``bbox_iou(CIoU=True)`` semantics (the TAL overlap)."""
    pa, pb = _pairwise_parts(a, b)
    (ax1, ay1, ax2, ay2), (bx1, by1, bx2, by2) = pa, pb
    inter = _pairwise_inter(pa, pb)
    union = area(a)[..., :, None] + area(b)[..., None, :] - inter + eps
    iou = inter / union
    cw = torch.maximum(bx2, ax2) - torch.minimum(bx1, ax1)
    ch = torch.maximum(by2, ay2) - torch.minimum(by1, ay1)
    c2 = cw * cw + ch * ch + eps
    rho2 = (((bx1 + bx2) - (ax1 + ax2)) ** 2
            + ((by1 + by2) - (ay1 + ay2)) ** 2) / 4.0
    ang_a = torch.atan((a[..., 2] - a[..., 0])
                       / (a[..., 3] - a[..., 1] + eps))
    ang_b = torch.atan((b[..., 2] - b[..., 0])
                       / (b[..., 3] - b[..., 1] + eps))
    v = (4 / math.pi ** 2) * (ang_b[..., None, :] - ang_a[..., :, None]) ** 2
    alpha = (v / (v - iou + (1 + eps))).detach()
    return iou - (rho2 / c2 + v * alpha)


def _elementwise_inter(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    wh = torch.clamp(torch.minimum(a[..., 2:], b[..., 2:])
                     - torch.maximum(a[..., :2], b[..., :2]), min=0)
    return wh[..., 0] * wh[..., 1]


def iou_elementwise(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elementwise IoU between aligned (..., 4) xyxy boxes."""
    inter = _elementwise_inter(a, b)
    union = area(a) + area(b) - inter
    return inter / torch.clamp(union, min=1e-9)


def giou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elementwise generalised IoU between aligned (..., 4) xyxy boxes."""
    inter = _elementwise_inter(a, b)
    union = area(a) + area(b) - inter
    iou = inter / torch.clamp(union, min=1e-9)
    ewh = torch.clamp(torch.maximum(a[..., 2:], b[..., 2:])
                      - torch.minimum(a[..., :2], b[..., :2]), min=0)
    earea = ewh[..., 0] * ewh[..., 1]
    return iou - (earea - union) / torch.clamp(earea, min=1e-9)


def ciou(a: torch.Tensor, b: torch.Tensor, eps: float = 1e-7) -> torch.Tensor:
    """Elementwise complete IoU (YOLOv8's box loss)."""
    inter = _elementwise_inter(a, b)
    union = area(a) + area(b) - inter
    iou = inter / (union + eps)
    elt = torch.minimum(a[..., :2], b[..., :2])
    erb = torch.maximum(a[..., 2:], b[..., 2:])
    cw = erb[..., 0] - elt[..., 0]
    ch = erb[..., 1] - elt[..., 1]
    c2 = cw * cw + ch * ch + eps
    acx = (a[..., 0] + a[..., 2]) / 2
    acy = (a[..., 1] + a[..., 3]) / 2
    bcx = (b[..., 0] + b[..., 2]) / 2
    bcy = (b[..., 1] + b[..., 3]) / 2
    rho2 = (acx - bcx) ** 2 + (acy - bcy) ** 2
    aw = a[..., 2] - a[..., 0]
    ah = a[..., 3] - a[..., 1]
    bw = b[..., 2] - b[..., 0]
    bh = b[..., 3] - b[..., 1]
    v = (4 / math.pi ** 2) * (torch.atan(bw / (bh + eps))
                              - torch.atan(aw / (ah + eps))) ** 2
    alpha = (v / torch.clamp(v - iou + (1 + eps), min=eps)).detach()
    return iou - rho2 / c2 - alpha * v
