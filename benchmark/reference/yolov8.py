"""YOLOv8, plain: Ultralytics ``yolov8.yaml`` at a (depth, width,
max_channels) scale, every conv ``F.conv2d``, BatchNorm with flax's
arithmetic (train mode: the batch's f32 mean and fast variance
E[y^2] - E[y]^2 clamped at 0; eval mode: the running statistics; eps
1e-3), SiLU, the decoupled DFL head and its decode.

Module and parameter names are Ultralytics' (``model.{i}.conv.weight``,
``model.22.cv2.{level}.2.bias``), the key layout the program keeps too,
so one set of seeded weights loads into both. Departures from the
published model: nc 6 (VisDrone); the running statistics are not updated
(no compared number reads them); a calibration pass in train mode
(``calibrate``) sets them to one batch's statistics instead, which is how
the benchmark gives an eval model running statistics from the seed.
"""

from __future__ import annotations

import math
from typing import List, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .precision import operand

STRIDES = (8, 16, 32)
REG_MAX = 16
EPS = 1e-3


def make_divisible(v: float, divisor: int = 8) -> int:
    return max(divisor, int(v + divisor / 2) // divisor * divisor)


class ConvBnAct(nn.Module):
    def __init__(self, c1, c2, k=1, s=1, act=True, ctx=None):
        super().__init__()
        self.conv = nn.Conv2d(c1, c2, k, s, k // 2, bias=False)
        self.bn = nn.BatchNorm2d(c2, eps=EPS)
        self.act = act
        self.ctx = ctx

    def forward(self, x):
        p = self.ctx.precision
        y = operand(F.conv2d(operand(x, p), operand(self.conv.weight, p),
                             None, self.conv.stride, self.conv.padding), p)
        if self.training:
            mean = y.mean((0, 2, 3))
            var = torch.clamp((y * y).mean((0, 2, 3)) - mean * mean, min=0.0)
            if self.ctx.calibrate:
                self.bn.running_mean.copy_(mean.detach())
                self.bn.running_var.copy_(var.detach())
        else:
            mean, var = self.bn.running_mean, self.bn.running_var
        mul = torch.rsqrt(var + EPS) * self.bn.weight
        y = (y - mean[:, None, None]) * mul[:, None, None] \
            + self.bn.bias[:, None, None]
        return F.silu(y) if self.act else y


class Bottleneck(nn.Module):
    def __init__(self, c1, c2, shortcut, ctx):
        super().__init__()
        self.cv1 = ConvBnAct(c1, c2, 3, ctx=ctx)
        self.cv2 = ConvBnAct(c2, c2, 3, ctx=ctx)
        self.add = shortcut and c1 == c2

    def forward(self, x):
        y = self.cv2(self.cv1(x))
        return x + y if self.add else y


class C2f(nn.Module):
    def __init__(self, c1, c2, n, shortcut, ctx):
        super().__init__()
        self.c = c2 // 2
        self.cv1 = ConvBnAct(c1, 2 * self.c, 1, ctx=ctx)
        self.cv2 = ConvBnAct((2 + n) * self.c, c2, 1, ctx=ctx)
        self.m = nn.ModuleList(Bottleneck(self.c, self.c, shortcut, ctx)
                               for _ in range(n))

    def forward(self, x):
        y = list(self.cv1(x).chunk(2, 1))
        for m in self.m:
            y.append(m(y[-1]))
        return self.cv2(torch.cat(y, 1))


class SPPF(nn.Module):
    def __init__(self, c1, c2, ctx, k=5):
        super().__init__()
        self.cv1 = ConvBnAct(c1, c1 // 2, 1, ctx=ctx)
        self.cv2 = ConvBnAct(c1 // 2 * 4, c2, 1, ctx=ctx)
        self.k = k

    def forward(self, x):
        y = [self.cv1(x)]
        for _ in range(3):
            y.append(F.max_pool2d(y[-1], self.k, 1, self.k // 2))
        return self.cv2(torch.cat(y, 1))


class Head(nn.Module):
    def __init__(self, nc, ch, ctx):
        super().__init__()
        c2 = max(16, ch[0] // 4, REG_MAX * 4)
        c3 = max(ch[0], min(nc, 100))
        self.cv2 = nn.ModuleList(nn.Sequential(
            ConvBnAct(x, c2, 3, ctx=ctx), ConvBnAct(c2, c2, 3, ctx=ctx),
            nn.Conv2d(c2, 4 * REG_MAX, 1)) for x in ch)
        self.cv3 = nn.ModuleList(nn.Sequential(
            ConvBnAct(x, c3, 3, ctx=ctx), ConvBnAct(c3, c3, 3, ctx=ctx),
            nn.Conv2d(c3, nc, 1)) for x in ch)
        self.ctx = ctx

    def branch(self, seq, f):
        p = self.ctx.precision
        h = seq[1](seq[0](f))
        return operand(F.conv2d(operand(h, p), operand(seq[2].weight, p),
                                seq[2].bias), p)

    def forward(self, feats):
        return [(self.branch(self.cv2[i], f), self.branch(self.cv3[i], f))
                for i, f in enumerate(feats)]


class _Ctx:
    precision = "exact"
    calibrate = False      # train mode: keep each batch's statistics


class YoloV8(nn.Module):
    """x (B, H, W, 3) in [0, 1] -> per level (box logits (B, 64, h, w),
    class logits (B, nc, h, w)), f32."""

    def __init__(self, nc: int, depth: float, width: float, max_ch: int,
                 precision: str = "exact"):
        super().__init__()
        ctx = self.ctx = _Ctx()
        ctx.precision = precision

        def c(base):
            return make_divisible(min(base, max_ch) * width, 8)

        def n(base):
            return max(1, round(base * depth))

        def conv(a, b, k, s):
            return ConvBnAct(a, b, k, s, ctx=ctx)

        self.model = nn.ModuleList([
            conv(3, c(64), 3, 2), conv(c(64), c(128), 3, 2),
            C2f(c(128), c(128), n(3), True, ctx), conv(c(128), c(256), 3, 2),
            C2f(c(256), c(256), n(6), True, ctx), conv(c(256), c(512), 3, 2),
            C2f(c(512), c(512), n(6), True, ctx),
            conv(c(512), c(1024), 3, 2),
            C2f(c(1024), c(1024), n(3), True, ctx),
            SPPF(c(1024), c(1024), ctx), nn.Identity(), nn.Identity(),
            C2f(c(1024) + c(512), c(512), n(3), False, ctx), nn.Identity(),
            nn.Identity(), C2f(c(512) + c(256), c(256), n(3), False, ctx),
            conv(c(256), c(256), 3, 2), nn.Identity(),
            C2f(c(512) + c(256), c(512), n(3), False, ctx),
            conv(c(512), c(512), 3, 2), nn.Identity(),
            C2f(c(1024) + c(512), c(1024), n(3), False, ctx),
            Head(nc, (c(256), c(512), c(1024)), ctx)])
        # Ultralytics' fixed DFL integral conv: a buffer here, no weight
        self.model[22].dfl = nn.Module()

    def forward(self, x):
        m = self.model
        up = lambda t: F.interpolate(t, scale_factor=2, mode="nearest")  # noqa
        h = m[2](m[1](m[0](x.permute(0, 3, 1, 2))))
        p3 = m[4](m[3](h))
        p4 = m[6](m[5](p3))
        p5 = m[9](m[8](m[7](p4)))
        t4 = m[12](torch.cat([up(p5), p4], 1))
        t3 = m[15](torch.cat([up(t4), p3], 1))
        b4 = m[18](torch.cat([m[16](t3), t4], 1))
        b5 = m[21](torch.cat([m[19](b4), p5], 1))
        return m[22]([t3, b4, b5])


def weight_spec(model: YoloV8, nc_bias: float = -4.6):
    """(name, shape, rule) of every weight, the program's init scheme:
    lecun-normal conv kernels, zero biases except the class logits'
    -4.6, BatchNorm affine 1 / 0."""
    from ..harness.weights import lecun_std

    spec = []
    for name, p in model.named_parameters():
        shape = tuple(p.shape)
        if name.endswith("bn.weight"):
            rule = ("const", 1.0)
        elif name.endswith("bn.bias"):
            rule = ("const", 0.0)
        elif name.endswith(".bias"):
            rule = ("const", nc_bias if ".cv3." in name else 0.0)
        else:
            rule = ("normal", lecun_std(math.prod(shape[1:])))
        spec.append((name, shape, rule))
    return spec


@torch.no_grad()
def calibrate(model: YoloV8, images: torch.Tensor) -> None:
    """Running statistics of every BatchNorm = its batch statistics on
    `images` (B, H, W, 3) in [0, 1], each layer normalised by its own."""
    model.ctx.calibrate = True
    model.train()(images)
    model.ctx.calibrate = False
    model.eval()


def anchor_points(img_size: int) -> Tuple[np.ndarray, np.ndarray]:
    pts, sts = [], []
    for s in STRIDES:
        k = img_size // s
        ys, xs = np.mgrid[0:k, 0:k].astype(np.float32) + 0.5
        pts.append(np.stack([xs.ravel(), ys.ravel()], 1))
        sts.append(np.full(k * k, s, np.float32))
    return np.concatenate(pts), np.concatenate(sts)


def flatten_outputs(outs):
    box_l: List[torch.Tensor] = []
    cls_l: List[torch.Tensor] = []
    for box, cls in outs:
        b = box.shape[0]
        box_l.append(box.permute(0, 2, 3, 1).reshape(b, -1, 4, REG_MAX))
        cls_l.append(cls.permute(0, 2, 3, 1).reshape(b, -1, cls.shape[1]))
    return torch.cat(box_l, 1), torch.cat(cls_l, 1)


def dfl_expectation(box_logits):
    p = torch.softmax(box_logits, dim=-1)
    bins = torch.arange(REG_MAX, dtype=torch.float32, device=p.device)
    return (p * bins).sum(-1)


def decode(outs, img_size: int):
    """(boxes (B, N, 4) xyxy px, scores (B, N, nc))."""
    box_logits, cls_logits = flatten_outputs(outs)
    dev = box_logits.device
    a, s = anchor_points(img_size)
    a = torch.as_tensor(a, device=dev)
    s = torch.as_tensor(s, device=dev)[:, None]
    d = dfl_expectation(box_logits.float())
    return (torch.cat([(a - d[..., :2]) * s, (a + d[..., 2:]) * s], -1),
            torch.sigmoid(cls_logits.float()))


def count_flops(model: nn.Module, batch: int, img_size: int,
                backward: bool) -> float:
    """FLOPs of one forward (and backward) at (batch, img_size), counted by
    ``FlopCounterMode`` on the meta device."""
    from torch.utils.flop_counter import FlopCounterMode

    with torch.device("meta"):
        x = torch.zeros(batch, img_size, img_size, 3)
    counter = FlopCounterMode(display=False)
    with counter:
        outs = model(x)
        if backward:
            sum(b.sum() + c.sum() for b, c in outs).backward()
    return float(counter.get_total_flops())
