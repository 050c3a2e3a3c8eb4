"""RT-DETR inference step (counterpart of
robust_object_detection_tpu/train/rtdetr.py ``make_predict_step``). The
train step, the losses, the matcher and the denoising queries are not
ported yet.
"""

from __future__ import annotations

from typing import Callable

import torch

from ..models import rtdetr as rtdetr_lib


def make_predict_step(img_size: int, max_det: int = 300) -> Callable:
    """Inference: (model, images (B, S, S, 3) in [0, 255]) -> NMS-free
    detections (boxes (B, max_det, 4) canvas xyxy, scores, classes int32,
    valid), fixed capacity: the contract of
    ``train.detector.make_predict_step``, so ``eval.fused_sweep`` takes
    either."""

    @torch.inference_mode()
    def step(model: torch.nn.Module, images: torch.Tensor):
        x = images.float() / 255.0
        return rtdetr_lib.postprocess(model(x), img_size, max_det)

    return step
