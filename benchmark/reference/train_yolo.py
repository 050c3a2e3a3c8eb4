"""The YOLOv8 Augmented train step, plain, for the first steps of a run:
the input chain of ``augment.py``, the train-mode forward of
``yolov8.py``, the loss of ``yolo_loss.py``, nesterov SGD with weight
decay on the conv weights and the linear warm-up / decay schedule, and the
EMA of the parameters with the Ultralytics ramp.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence

import torch

from .augment import augment
from .yolo_loss import yolo_loss
from .yolov8 import YoloV8


def schedule(opt: dict):
    """lr(count): linear warm-up 0 -> lr0, then linear decay to lr0 * lrf,
    at the count before the update."""
    lr0, lrf = opt["lr0"], opt["lrf"]
    warm, total = opt["warmup_steps"], opt["total_steps"]
    decay = max(1, total - warm)

    def lr(count: int) -> float:
        if count < warm:
            return lr0 * count / warm
        return lr0 + (lr0 * lrf - lr0) * min(count - warm, decay) / decay
    return lr


def run_steps(config: dict, weights: Dict[str, torch.Tensor],
              batches: Sequence[tuple], step_seed: int, img_size: int,
              precision: str = "exact") -> dict:
    """len(batches) steps from `weights`. Returns {"loss": [per step],
    "grad": {leaf: first step's gradient}, "stats": {BatchNorm buffer:
    the first step's batch mean or variance}, "params": {leaf: after the
    last step}, "ema": {leaf: after the last step}}."""
    dev = batches[0][0].device
    scale = config["scale"]
    model = YoloV8(config["nc"], scale["depth"], scale["width"],
                   scale["max_channels"], precision).to(dev).train()
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.copy_(weights[name])
    params = dict(model.named_parameters())
    opt_cfg = config["optimizer"]
    sgd = torch.optim.SGD(
        [{"params": [p for p in params.values() if p.dim() > 1],
          "weight_decay": opt_cfg["weight_decay"]},
         {"params": [p for p in params.values() if p.dim() <= 1],
          "weight_decay": 0.0}],
        lr=opt_cfg["lr0"], momentum=opt_cfg["momentum"], nesterov=True,
        foreach=False)
    lr = schedule(opt_cfg)
    ema = {n: p.detach().clone() for n, p in params.items()}
    gen = torch.Generator(dev).manual_seed(step_seed)
    losses: List[float] = []
    grad = stats = None
    for k, (images, boxes, classes) in enumerate(batches):
        model.ctx.calibrate = k == 0        # keep step 1's statistics
        for group in sgd.param_groups:
            group["lr"] = lr(k)
        x, gb = augment(images, boxes, classes, gen, config["corruption"],
                        getattr(torch, config["precision"]["augmentation"]))
        sgd.zero_grad(set_to_none=True)
        loss, _ = yolo_loss(model(x), gb, classes, img_size)
        loss.backward()
        if grad is None:
            grad = {n: p.grad.detach().clone() for n, p in params.items()}
            stats = {n: b.detach().clone() for n, b in model.named_buffers()
                     if ".running_" in n}
        sgd.step()
        d = opt_cfg["ema_decay"] * (1.0 - math.exp(-(k + 1) / 2000.0))
        with torch.no_grad():
            for n, p in params.items():
                ema[n].mul_(d).add_(p, alpha=1.0 - d)
        losses.append(float(loss.detach()))
    model.ctx.calibrate = False
    return {"loss": losses, "grad": grad, "stats": stats,
            "params": {n: p.detach() for n, p in params.items()},
            "ema": ema}
