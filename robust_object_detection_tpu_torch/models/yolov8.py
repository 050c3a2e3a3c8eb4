"""YOLOv8 detector family (counterpart of
robust_object_detection_tpu/models/yolov8.py), eval and train.

The module tree is the Ultralytics DetectionModel's: ``self.model`` is a
ModuleList indexed like the yolov8 yaml (0-9 backbone, 10-21 neck, 22 the
Detect head), so ``state_dict`` keys (``model.{i}.…``) match a real
``yolov8*.pt`` and models/convert.py maps the JAX variables onto them.

The input is NHWC in [0, 1], as in the reference. P1/P2 (layers 0 and 1)
always run through the fused front of ops.yolo_front (K2-f on the card):
``front_inference`` in eval mode, ``front_fused`` (K2-f train forward,
K2-b backward) in train mode, which returns the batch statistics the
running statistics are updated from; BN2 + SiLU follow in torch, as the
reference does after its fused front. The 3x3 convs of the first C2f
(layer 2) run through ops.conv3x3 (K3-f, and K3-b in the backward).
``dtype`` is the conv compute type: bf16 convs with f32 BatchNorm
statistics and an f32 head output and decode, as ``create(6, "m",
dtype=jnp.bfloat16)`` in the reference. :func:`create` stores the conv
weights in ``dtype`` for eval (the reference keeps f32 and casts them in
every call; casting once gives the same bf16 values) and in float32 for
training (master weights, cast in every forward as the reference does).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.yolo_front import fold_bn, front_fused, front_inference
from .layers import (C2f, SPPF, ConvBnAct, from_nhwc, resolve_device,
                     scale_channels, scale_depth, update_running, upsample2x)

# (depth_multiple, width_multiple, max_channels) per size variant.
VARIANTS: Dict[str, Tuple[float, float, int]] = {
    "n": (0.34, 0.25, 1024),
    "s": (0.34, 0.50, 1024),
    "m": (0.67, 0.75, 768),
    "l": (1.00, 1.00, 512),
    "x": (1.00, 1.25, 512),
}

STRIDES = (8, 16, 32)
REG_MAX = 16
CLS_BIAS_INIT = -4.6


@dataclasses.dataclass(frozen=True)
class YoloConfig:
    num_classes: int = 6
    variant: str = "m"

    @property
    def scales(self) -> Tuple[float, float, int]:
        return VARIANTS[self.variant]

    def width(self, base: int) -> int:
        _, w, mc = self.scales
        return scale_channels(base, w, mc)

    def depth(self, base: int) -> int:
        d, _, _ = self.scales
        return scale_depth(base, d)


class Upsample(nn.Module):
    def forward(self, x):
        return upsample2x(x)


class Concat(nn.Module):
    def forward(self, xs):
        return torch.cat(xs, 1)


class DFL(nn.Module):
    """Ultralytics' fixed arange(16) integral conv. Kept so the key layout
    matches real checkpoints; decode computes the same expectation with
    :func:`dfl_expectation`."""

    def __init__(self, c1: int = REG_MAX):
        super().__init__()
        self.conv = nn.Conv2d(c1, 1, 1, bias=False)
        with torch.no_grad():
            self.conv.weight.copy_(
                torch.arange(c1, dtype=torch.float32).view(1, c1, 1, 1))
        self.conv.weight.requires_grad_(False)


class Head(nn.Module):
    """Decoupled anchor-free head (the Ultralytics Detect layer, index 22):
    per level a box branch (cv2) to 4*REG_MAX DFL logits and a class branch
    (cv3) to nc logits. The final 1x1 convs run in f32."""

    def __init__(self, nc: int, ch: Sequence[int], **kw):
        super().__init__()
        c2 = max(16, ch[0] // 4, REG_MAX * 4)
        c3 = max(ch[0], min(nc, 100))
        self.cv2 = nn.ModuleList(
            nn.Sequential(ConvBnAct(x, c2, 3, **kw),
                          ConvBnAct(c2, c2, 3, **kw),
                          nn.Conv2d(c2, 4 * REG_MAX, 1)) for x in ch)
        self.cv3 = nn.ModuleList(
            nn.Sequential(ConvBnAct(x, c3, 3, **kw),
                          ConvBnAct(c3, c3, 3, **kw),
                          nn.Conv2d(c3, nc, 1)) for x in ch)
        self.dfl = DFL()

    @staticmethod
    def _branch(seq: nn.Sequential, f: torch.Tensor) -> torch.Tensor:
        return seq[2](seq[1](seq[0](f)).float())

    def forward(self, feats):
        return [(self._branch(self.cv2[i], f), self._branch(self.cv3[i], f))
                for i, f in enumerate(feats)]


def _hwio(w: torch.Tensor) -> torch.Tensor:
    return w.permute(2, 3, 1, 0).contiguous()


class YoloV8(nn.Module):
    """``dtype``: conv compute type; ``param_dtype``: conv weight storage
    (default ``dtype``); ``bn_dtype``: train-mode BatchNorm output and
    activation type (models/layers.py)."""

    def __init__(self, cfg: YoloConfig, dtype: torch.dtype = torch.float32,
                 param_dtype: Optional[torch.dtype] = None,
                 bn_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        self.bn_dtype = bn_dtype
        c, n = cfg.width, cfg.depth
        kw = dict(dtype=dtype, param_dtype=param_dtype, bn_dtype=bn_dtype)
        self.model = nn.ModuleList([
            ConvBnAct(3, c(64), 3, 2, **kw),                          # 0 P1
            ConvBnAct(c(64), c(128), 3, 2, **kw),                     # 1 P2
            C2f(c(128), c(128), n(3), True, hand_kernel=True, **kw),  # 2
            ConvBnAct(c(128), c(256), 3, 2, **kw),                    # 3 P3
            C2f(c(256), c(256), n(6), True, **kw),                    # 4
            ConvBnAct(c(256), c(512), 3, 2, **kw),                    # 5 P4
            C2f(c(512), c(512), n(6), True, **kw),                    # 6
            ConvBnAct(c(512), c(1024), 3, 2, **kw),                   # 7 P5
            C2f(c(1024), c(1024), n(3), True, **kw),                  # 8
            SPPF(c(1024), c(1024), **kw),                             # 9
            Upsample(),                                               # 10
            Concat(),                                                 # 11
            C2f(c(1024) + c(512), c(512), n(3), **kw),                # 12
            Upsample(),                                               # 13
            Concat(),                                                 # 14
            C2f(c(512) + c(256), c(256), n(3), **kw),                 # 15
            ConvBnAct(c(256), c(256), 3, 2, **kw),                    # 16
            Concat(),                                                 # 17
            C2f(c(512) + c(256), c(512), n(3), **kw),                 # 18
            ConvBnAct(c(512), c(512), 3, 2, **kw),                    # 19
            Concat(),                                                 # 20
            C2f(c(1024) + c(512), c(1024), n(3), **kw),               # 21
            Head(cfg.num_classes, (c(256), c(512), c(1024)), **kw),  # 22
        ])

    def front(self, x: torch.Tensor) -> torch.Tensor:
        """Layers 0-1: fused P1/P2 (K2-f; train mode: batch statistics and
        the running-statistics update), then BN2 + SiLU in torch.
        x (B, H, W, 3) in [0, 1] -> activated P2, NCHW view of NHWC."""
        p1, p2 = self.model[0], self.model[1]
        dtype = self.dtype
        xd = x.to(dtype).contiguous()
        if self.training:
            y2, m1, v1, m2, v2 = front_fused(
                xd, _hwio(p1.conv.weight), p1.bn.weight, p1.bn.bias,
                _hwio(p2.conv.weight))
            update_running(p1.bn, m1, v1)
            update_running(p2.bn, m2, v2)
            bn_dtype = self.bn_dtype
        else:
            y2 = front_inference(
                xd, _hwio(p1.conv.weight.to(dtype)), p1.bn.weight,
                p1.bn.bias, _hwio(p2.conv.weight.to(dtype)),
                (p1.bn.running_mean, p2.bn.running_mean),
                (p1.bn.running_var, p2.bn.running_var))
            m2, v2 = p2.bn.running_mean, p2.bn.running_var
            bn_dtype = torch.float32
        g2, b2 = fold_bn(p2.bn.weight, p2.bn.bias, m2, v2)
        z = (y2.float() * g2 + b2).to(bn_dtype)
        return from_nhwc(F.silu(z).to(dtype))

    def backbone(self, x: torch.Tensor):
        """CSPDarknet: (P3, P4, P5) at strides 8/16/32."""
        m = self.model
        h = m[2](self.front(x))
        p3 = m[4](m[3](h))
        p4 = m[6](m[5](p3))
        p5 = m[9](m[8](m[7](p4)))
        return p3, p4, p5

    def neck(self, feats):
        """PAN: top-down fusion, then bottom-up aggregation."""
        m = self.model
        p3, p4, p5 = feats
        t4 = m[12](m[11]([m[10](p5), p4]))
        t3 = m[15](m[14]([m[13](t4), p3]))
        b4 = m[18](m[17]([m[16](t3), t4]))
        b5 = m[21](m[20]([m[19](b4), p5]))
        return t3, b4, b5

    def forward(self, x: torch.Tensor):
        """x (B, H, W, 3) float in [0, 1]. Returns per-level (box_logits
        (B, 64, h, w), cls_logits (B, nc, h, w)) f32 at strides 8/16/32."""
        return self.model[22](self.neck(self.backbone(x)))


def init_weights(model: YoloV8, generator: torch.Generator) -> YoloV8:
    """The reference's flax init: lecun-normal conv kernels (truncated at
    2 std), zero biases, class-logit biases -4.6, BN affine 1/0 and running
    stats 0/1. Draws come from `generator` (on the CPU)."""
    head = model.model[22]
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, nn.Conv2d) and mod.weight.requires_grad:
                fan_in = mod.weight[0].numel()
                std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
                w = torch.empty(mod.weight.shape)
                nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std,
                                      generator=generator)
                mod.weight.copy_(w)
                if mod.bias is not None:
                    mod.bias.zero_()
            elif isinstance(mod, nn.BatchNorm2d):
                mod.reset_parameters()
        for seq in head.cv3:
            seq[2].bias.fill_(CLS_BIAS_INIT)
    return model


def create(num_classes: int = 6, variant: str = "m",
           dtype: torch.dtype = torch.float32,
           device: Optional[torch.device] = None,
           generator: Optional[torch.Generator] = None,
           train: bool = False,
           bn_dtype: torch.dtype = torch.float32) -> YoloV8:
    """A YOLOv8 on `device` (None: the CUDA card; raises when there is
    none), randomly initialised from `generator` (seed 0 when None).
    train=False: eval mode, conv weights stored in `dtype`; train=True:
    train mode, float32 master weights, train-mode BatchNorm output in
    `bn_dtype`."""
    device = resolve_device(device)
    gen = generator or torch.Generator().manual_seed(0)
    model = YoloV8(YoloConfig(num_classes, variant), dtype,
                   param_dtype=torch.float32 if train else dtype,
                   bn_dtype=bn_dtype)
    return init_weights(model, gen).to(device).train(train)


# ── Anchors and decode ───────────────────────────────────────────────────

def anchor_points(img_size: int, strides: Sequence[int] = STRIDES
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """Anchor centres (stride units, +0.5) (N, 2) [x, y] and strides (N,)."""
    pts, sts = [], []
    for s in strides:
        n = img_size // s
        ys, xs = np.mgrid[0:n, 0:n].astype(np.float32) + 0.5
        pts.append(np.stack([xs.ravel(), ys.ravel()], 1))
        sts.append(np.full(n * n, s, np.float32))
    return np.concatenate(pts), np.concatenate(sts)


def flatten_outputs(outs) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-level maps -> (box_logits (B, N, 4, REG_MAX), cls_logits
    (B, N, nc)), anchors in row-major (y, x) order per level."""
    box_l: List[torch.Tensor] = []
    cls_l: List[torch.Tensor] = []
    for box, cls in outs:
        b = box.shape[0]
        box_l.append(box.permute(0, 2, 3, 1).reshape(b, -1, 4, REG_MAX))
        cls_l.append(cls.permute(0, 2, 3, 1).reshape(b, -1, cls.shape[1]))
    return torch.cat(box_l, 1), torch.cat(cls_l, 1)


def dfl_expectation(box_logits: torch.Tensor) -> torch.Tensor:
    """(..., 4, REG_MAX) logits -> (..., 4) expected distances (l,t,r,b)."""
    p = torch.softmax(box_logits, dim=-1)
    bins = torch.arange(REG_MAX, dtype=torch.float32, device=p.device)
    return (p * bins).sum(-1)


def decode(outs, img_size: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Raw head outputs -> (boxes (B, N, 4) xyxy pixels, scores (B, N, nc))."""
    box_logits, cls_logits = flatten_outputs(outs)
    anchors, strides = anchor_points(img_size)
    dev = box_logits.device
    anchors = torch.as_tensor(anchors, device=dev)
    strides = torch.as_tensor(strides, device=dev)[:, None]
    d = dfl_expectation(box_logits.float())
    x1y1 = (anchors - d[..., :2]) * strides
    x2y2 = (anchors + d[..., 2:]) * strides
    return torch.cat([x1y1, x2y2], -1), torch.sigmoid(cls_logits.float())
