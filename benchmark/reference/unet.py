"""The reference's RestorationUNet, plain, in eval mode: 4 encoder stages
of 2 x (3x3 conv without bias -> BatchNorm (eps 1e-5, running statistics)
-> LeakyReLU 0.2) and a 2x2 max-pool, a bottleneck block, 4 decoder stages
of a 2x2 stride-2 transposed conv with bias, the skip concatenated and a
block, a 1x1 conv to a 3-channel residual; out = clamp(x + residual, 0, 1).
``apply_u8``: uint8 in, /255, forward, floor(clip(y * 255 + 0.5)) out.

Parameter names follow the program's ``models/unet.py`` (``enc.{i}.conv0``,
``mid``, ``up.{i}``, ``dec.{i}``, ``out``), so one set of seeded weights
loads into both. In train mode (a calibration pass, :func:`calibrate`)
each BatchNorm normalises by the batch's statistics (flax's: the mean and
the fast variance) and keeps them as its running statistics.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .precision import operand

EPS = 1e-5


class ConvBlock(nn.Module):
    def __init__(self, c1: int, c2: int):
        super().__init__()
        self.conv0 = nn.Conv2d(c1, c2, 3, padding=1, bias=False)
        self.bn0 = nn.BatchNorm2d(c2, eps=EPS)
        self.conv1 = nn.Conv2d(c2, c2, 3, padding=1, bias=False)
        self.bn1 = nn.BatchNorm2d(c2, eps=EPS)

    def forward(self, x, p):
        for conv, bn in ((self.conv0, self.bn0), (self.conv1, self.bn1)):
            y = operand(F.conv2d(operand(x, p), operand(conv.weight, p), None,
                                 1, 1), p)
            if self.training:       # a calibration pass: keep the batch's
                mean = y.mean((0, 2, 3))
                bn.running_mean.copy_(mean)
                bn.running_var.copy_(torch.clamp(
                    (y * y).mean((0, 2, 3)) - mean * mean, min=0.0))
            mul = torch.rsqrt(bn.running_var + EPS) * bn.weight
            y = (y - bn.running_mean[:, None, None]) * mul[:, None, None] \
                + bn.bias[:, None, None]
            x = F.leaky_relu(y, 0.2)
        return x


class RestorationUNet(nn.Module):
    def __init__(self, channels: Sequence[int], precision: str = "exact"):
        super().__init__()
        c = tuple(channels)
        self.precision = precision
        self.enc = nn.ModuleList(ConvBlock(ci, co)
                                 for ci, co in zip((3,) + c[:-1], c))
        self.mid = ConvBlock(c[-1], c[-1])
        out_ch = list(c[-2::-1]) + [c[0]]
        ups, decs, cur = [], [], c[-1]
        for skip, co in zip(reversed(c), out_ch):
            ups.append(nn.ConvTranspose2d(cur, cur, 2, 2))
            decs.append(ConvBlock(cur + skip, co))
            cur = co
        self.up = nn.ModuleList(ups)
        self.dec = nn.ModuleList(decs)
        self.out = nn.Conv2d(c[0], 3, 1)

    def forward(self, x):
        """x (N, H, W, 3) in [0, 1], H and W multiples of 16."""
        p = self.precision
        h = x.permute(0, 3, 1, 2)
        skips = []
        for block in self.enc:
            h = block(h, p)
            skips.append(h)
            h = F.max_pool2d(h, 2, 2)
        h = self.mid(h, p)
        for up, block, skip in zip(self.up, self.dec, reversed(skips)):
            h = operand(F.conv_transpose2d(operand(h, p),
                                           operand(up.weight, p), up.bias,
                                           stride=2), p)
            h = block(torch.cat([h, skip], 1), p)
        r = operand(F.conv2d(operand(h, p), operand(self.out.weight, p),
                             self.out.bias), p)
        return torch.clamp(x + r.permute(0, 2, 3, 1), 0.0, 1.0)


@torch.no_grad()
def calibrate(model: RestorationUNet, images: torch.Tensor) -> None:
    """Running statistics of every BatchNorm = its batch statistics on
    `images` (N, H, W, 3) in [0, 1], each layer normalised by its own."""
    model.train()(images)
    model.eval()


def apply_u8(model: RestorationUNet, x_u8: torch.Tensor) -> torch.Tensor:
    y = model(x_u8.float() / 255.0)
    return torch.floor(torch.clamp(y * 255.0 + 0.5, 0.0, 255.0))


def weight_spec(model: RestorationUNet):
    """lecun-normal kernels (fan-in in x kh x kw, for the transposed convs
    too), zero biases, BatchNorm affine 1 / 0: the program's init."""
    from ..harness.weights import lecun_std

    spec = []
    for name, p in model.named_parameters():
        shape = tuple(p.shape)
        if ".bn" in name:
            rule = ("const", 1.0 if name.endswith("weight") else 0.0)
        elif name.endswith("bias"):
            rule = ("const", 0.0)
        elif name.startswith("up."):
            rule = ("normal", lecun_std(shape[0] * shape[2] * shape[3]))
        else:
            rule = ("normal", lecun_std(math.prod(shape[1:])))
        spec.append((name, shape, rule))
    return spec


def count_flops(model: nn.Module, h: int, w: int) -> float:
    """FLOPs of one forward of one (h, w) image, on the meta device."""
    from torch.utils.flop_counter import FlopCounterMode

    with torch.device("meta"):
        x = torch.zeros(1, h, w, 3)
    counter = FlopCounterMode(display=False)
    with counter, torch.no_grad():
        model(x)
    return float(counter.get_total_flops())
