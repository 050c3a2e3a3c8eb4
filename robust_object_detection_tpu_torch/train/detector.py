"""YOLO detector train and inference steps (counterpart of
robust_object_detection_tpu/train/detector.py ``make_optimizer``,
``DetTrainState`` / ``init_state``, ``make_train_step`` and
``make_predict_step``).

In the port a model carries its own weights and running statistics, so a
:class:`TrainState` holds the module, the EMA of its parameters, the
optimizer, its learning-rate schedule and the step count, and the train
step updates it in place. Optimisation follows the reference run configs
(SGD lr0=0.01, lrf=0.01, nesterov momentum 0.937, weight decay 5e-4 on
conv weights only, linear warmup then linear decay; EMA decay 0.9999 with
the Ultralytics ramp). The host-side ``train()`` loop (mosaic, data
pipeline, checkpoints, validation) is not ported yet.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Tuple

import torch

from ..core.config import CorruptionConfig
from ..models import yolov8 as yolo_lib
from ..ops import nms as nms_ops
from ..ops.fused_corrupt import fused_random_corruption
from . import augment as aug
from . import detection as det_loss


def make_optimizer(lr0: float = 0.01, lrf: float = 0.01,
                   momentum: float = 0.937, weight_decay: float = 5e-4,
                   warmup_steps: int = 100, total_steps: int = 10000
                   ) -> Tuple[Callable, Callable[[int], float]]:
    """(tx, sched). sched(count): linear warmup 0 -> lr0 over warmup_steps,
    then linear decay lr0 -> lr0 * lrf over the remaining steps, evaluated
    at the count BEFORE the update (step 0 runs at lr 0), as optax
    evaluates ``join_schedules``. tx(model) -> (SGD, LambdaLR): nesterov
    SGD (optax's ``trace`` recursion), weight decay only on conv weights
    (parameters with ndim > 1; BatchNorm and biases take none), and the
    schedule as a LambdaLR stepped after each update."""
    decay_steps = max(1, total_steps - warmup_steps)

    def sched(count: int) -> float:
        if count < warmup_steps:
            return lr0 * count / warmup_steps
        frac = min(count - warmup_steps, decay_steps) / decay_steps
        return lr0 + (lr0 * lrf - lr0) * frac

    def tx(model: torch.nn.Module):
        params = [p for p in model.parameters() if p.requires_grad]
        groups = [{"params": [p for p in params if p.dim() > 1],
                   "weight_decay": weight_decay},
                  {"params": [p for p in params if p.dim() <= 1],
                   "weight_decay": 0.0}]
        opt = torch.optim.SGD(groups, lr=lr0, momentum=momentum,
                              nesterov=True)
        return opt, torch.optim.lr_scheduler.LambdaLR(
            opt, lambda count: sched(count) / lr0)

    return tx, sched


@dataclasses.dataclass
class TrainState:
    """The module (parameters and BatchNorm running statistics), the EMA of
    its parameters by name, the optimizer and its schedule, the step."""
    model: torch.nn.Module
    ema: Dict[str, torch.Tensor]
    optimizer: torch.optim.Optimizer
    scheduler: torch.optim.lr_scheduler.LRScheduler
    step: int = 0


def init_state(model: torch.nn.Module, tx: Callable) -> TrainState:
    """A fresh state for `model` (in train mode, e.g. ``yolov8.create(...,
    train=True)``): EMA = a copy of the parameters, optimizer from `tx`."""
    opt, sched = tx(model)
    ema = {n: p.detach().clone() for n, p in model.named_parameters()
           if p.requires_grad}
    return TrainState(model, ema, opt, sched)


def make_train_step(img_size: int, corruption: CorruptionConfig,
                    augment: bool, ema_decay: float = 0.9999,
                    base_augment: bool = False) -> Callable:
    """Train step: (state, images_u8 (B, S, S, 3), gt_boxes (B, M, 4) xyxy
    canvas px, gt_classes (B, M) with -1 padding, generator on the images'
    device) -> metrics {loss, box, cls, dfl, num_fg, grad_norm} as device
    tensors; `state` is updated in place.

    Order, as the reference: uint8 -> bf16 -> HSV -> flip (base_augment)
    -> f32 -> K1 corruption with p = 0.5 (augment, the reference's
    Augmented mode) -> /255 -> train forward -> loss -> backward -> SGD ->
    EMA of the parameters with d = decay * (1 - exp(-(step + 1) / 2000)).
    """

    def step(state: TrainState, images_u8: torch.Tensor,
             gt_boxes: torch.Tensor, gt_classes: torch.Tensor,
             generator: torch.Generator) -> Dict[str, torch.Tensor]:
        model = state.model
        model.train()
        # the augmentation chain runs in bf16, as the reference's does
        x = images_u8.to(torch.bfloat16)
        if base_augment:
            x = aug.random_hsv(x, generator)
            x, gt_boxes = aug.random_flip_lr(x, gt_boxes, gt_classes,
                                             generator)
        x = x.float()
        if augment:
            x, _ = fused_random_corruption(x.contiguous(), generator,
                                           corruption)
        x = x / 255.0

        state.optimizer.zero_grad(set_to_none=True)
        loss, metrics = det_loss.yolo_loss(model(x), gt_boxes, gt_classes,
                                           img_size)
        loss.backward()
        grad_norm = torch.nn.utils.get_total_norm(
            [p.grad for p in model.parameters() if p.grad is not None])
        state.optimizer.step()
        state.scheduler.step()

        d = ema_decay * (1.0 - math.exp(-(state.step + 1) / 2000.0))
        with torch.no_grad():
            for name, p in model.named_parameters():
                if name in state.ema:
                    state.ema[name].mul_(d).add_(p, alpha=1.0 - d)
        state.step += 1
        return dict({k: v.detach() for k, v in metrics.items()},
                    loss=loss.detach(), grad_norm=grad_norm)

    return step


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
