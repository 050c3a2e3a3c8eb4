"""Faster R-CNN inference step (counterpart of the serving half of
robust_object_detection_tpu/train/frcnn.py).

The predict step keeps the contract of ``train.detector.make_predict_step``
(model, (B, H, W, 3) images in [0, 255] -> fixed-capacity canvas-xyxy
detections), so ``eval.fused_sweep`` and ``eval.detector_eval`` take it as
they take YOLOv8's and RT-DETR's. Canvases are square (the sweep's
letterbox) or rectangular (the aspect-bucket eval at torchvision-native
resolution, eval/detector_eval.evaluate_bucketed). The train step, its
losses, anchor matching and the sampler are not ported yet.
"""

from __future__ import annotations

from typing import Callable

import torch

from ..models import frcnn as F
from ..ops import boxes as box_ops
from ..ops import nms as nms_ops

HEAD_DELTA_WEIGHTS = (10.0, 10.0, 5.0, 5.0)


def detect(cfg: F.FrcnnConfig, proposals: torch.Tensor,
           prop_valid: torch.Tensor, scores: torch.Tensor,
           box_deltas: torch.Tensor, img_hw):
    """The RoI heads' outputs -> detections: softmax, per-class decode
    with HEAD_DELTA_WEIGHTS, clip to the canvas, drop the background and
    sub-0.01 px boxes (torchvision's remove_small_boxes(min_size=1e-2)),
    then one class-aware NMS over min(2048, P * (K-1)) candidates."""
    ih, iw = img_hw
    probs = torch.softmax(scores, -1)                       # (B, P, K)
    k = cfg.num_classes
    boxes_k = F.decode_deltas(box_deltas, proposals[..., None, :],
                              HEAD_DELTA_WEIGHTS)           # (B, P, K, 4)
    boxes_k = box_ops.clip_to_image(boxes_k, ih, iw)
    b, p = probs.shape[:2]
    wh_ok = ((boxes_k[..., 2] - boxes_k[..., 0] > 1e-2)
             & (boxes_k[..., 3] - boxes_k[..., 1] > 1e-2))
    fg_probs = probs[..., 1:] * prop_valid[..., None] * wh_ok[..., 1:]
    cand_scores = fg_probs.reshape(b, -1)
    cand_boxes = boxes_k[..., 1:, :].reshape(b, -1, 4)
    cand_classes = torch.arange(
        k - 1, dtype=torch.int32, device=scores.device).expand(
            b, p, k - 1).reshape(b, -1)
    return nms_ops.batched_nms(
        cand_boxes, cand_scores, cand_classes,
        num_candidates=min(2048, cand_scores.shape[1]),
        max_outputs=cfg.box_detections, iou_thresh=cfg.box_nms_thresh,
        score_thresh=cfg.box_score_thresh)


def make_predict_step(model: F.FasterRCNN, img_size) -> Callable:
    """uint8 or float batch in [0, 255] -> per-image fixed-capacity
    detections (boxes (B, box_detections, 4) canvas xyxy, scores, classes
    int32 0-based foreground, valid).

    `model` gives the configuration; the step runs the module it is given
    (``step(model, images)``). img_size: int (square canvas) or (H, W)."""
    cfg = model.cfg
    hw = F._hw(img_size)

    @torch.inference_mode()
    def step(net: F.FasterRCNN, images: torch.Tensor):
        pyramid, obj, rpn_deltas = net.extract(images.float() / 255.0)
        proposals, prop_valid = F.generate_proposals(obj, rpn_deltas, hw,
                                                     cfg)
        scores, box_deltas = net.roi_forward(pyramid, proposals)
        return detect(cfg, proposals, prop_valid, scores, box_deltas, hw)

    return step
