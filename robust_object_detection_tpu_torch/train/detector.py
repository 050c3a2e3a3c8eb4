"""Detector inference step (counterpart of
robust_object_detection_tpu/train/detector.py ``make_predict_step``).

Training is not ported yet. In the port a model carries its own weights
and running statistics, so the step takes the module where the reference
takes its ``DetTrainState``; there is no EMA copy.
"""

from __future__ import annotations

from typing import Callable

import torch

from ..models import yolov8 as yolo_lib
from ..ops import nms as nms_ops


def make_predict_step(img_size: int, conf: float = 0.001, iou: float = 0.7,
                      max_det: int = 300, num_candidates: int = 30000,
                      multi_label: bool = True) -> Callable:
    """Inference: (model, images (B, S, S, 3) in [0, 255]) -> NMS'd
    detections (boxes (B, max_det, 4) canvas xyxy, scores, classes int32,
    valid), fixed capacity.

    multi_label=True is the Ultralytics VAL protocol the reference
    evaluates under (every class above `conf` yields a candidate per box);
    multi_label=False is the PREDICT path (per-box argmax class).
    """

    @torch.inference_mode()
    def step(model: torch.nn.Module, images: torch.Tensor):
        x = images.float() / 255.0
        boxes, scores = yolo_lib.decode(model(x), img_size)
        if multi_label:
            return nms_ops.multilabel_nms(
                boxes, scores,
                num_candidates=min(num_candidates,
                                   scores.shape[1] * scores.shape[2]),
                max_outputs=max_det, iou_thresh=iou, score_thresh=conf)
        best_score, best_cls = scores.max(-1)
        return nms_ops.batched_nms(
            boxes, best_score, best_cls,
            num_candidates=min(num_candidates, boxes.shape[1]),
            max_outputs=max_det, iou_thresh=iou, score_thresh=conf)

    return step
