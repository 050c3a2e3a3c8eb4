"""Shared detector building blocks (counterpart of
robust_object_detection_tpu/models/layers.py).

Modules take and return NCHW-indexed tensors; on the card they stay in
channels_last memory, so the NHWC kernels get their inputs with a
permute and no copy. Conventions, as in the reference:

  * conv weights are stored in the module's ``dtype`` (bf16 for the eval
    path), so a forward casts no weight, and convs compute in it,
  * BatchNorm (eps 1e-3; flax momentum 0.97 == torch momentum 0.03) and the
    activation run in float32, so every ConvBnAct returns float32,
  * symmetric ``k // 2`` padding, as torch's Conv2d(padding=k//2).

Module and attribute names follow Ultralytics (``conv``/``bn``, ``cv1``/
``cv2``/``m``), so ``state_dict`` keys match a real YOLOv8 checkpoint.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.conv3x3 import conv3x3


def to_nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1).contiguous()


def from_nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


class ConvBnAct(nn.Module):
    """Conv2d(bias=False) + BatchNorm + SiLU (Ultralytics ``Conv``).

    hand_kernel=True routes a 3x3 stride-1 conv through ops.conv3x3 (the
    K3-f kernel on the card); every other conv is ``F.conv2d``, as the
    reference leaves them to XLA."""

    def __init__(self, c1: int, c2: int, k: int = 1, s: int = 1,
                 act: bool = True, dtype: torch.dtype = torch.float32,
                 hand_kernel: bool = False):
        super().__init__()
        if hand_kernel and (k, s) != (3, 1):
            raise ValueError("hand_kernel covers 3x3 stride-1 convs only")
        self.conv = nn.Conv2d(c1, c2, k, s, k // 2, bias=False, dtype=dtype)
        self.bn = nn.BatchNorm2d(c2, eps=1e-3, momentum=0.03)
        self.act = act
        self.hand_kernel = hand_kernel

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        wd = self.conv.weight
        xd = x.to(wd.dtype)
        if self.hand_kernel:
            y = from_nhwc(conv3x3(to_nhwc(xd),
                                  wd.permute(2, 3, 1, 0).contiguous()))
        else:
            y = F.conv2d(xd, wd, None, self.conv.stride, self.conv.padding)
        y = self.bn(y.float())
        return F.silu(y) if self.act else y


class Bottleneck(nn.Module):
    """YOLO residual bottleneck: two 3x3 convs + optional shortcut."""

    def __init__(self, c1: int, c2: int, shortcut: bool = True,
                 dtype: torch.dtype = torch.float32,
                 hand_kernel: bool = False):
        super().__init__()
        self.cv1 = ConvBnAct(c1, c2, 3, dtype=dtype, hand_kernel=hand_kernel)
        self.cv2 = ConvBnAct(c2, c2, 3, dtype=dtype, hand_kernel=hand_kernel)
        self.add = shortcut and c1 == c2

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.cv2(self.cv1(x))
        return x + y if self.add else y


class C2f(nn.Module):
    """Cross-stage partial block with n bottlenecks: cv1 projects to 2
    chunks, each bottleneck consumes the last chunk and appends its output,
    cv2 fuses the (2+n) chunks."""

    def __init__(self, c1: int, c2: int, n: int = 1, shortcut: bool = False,
                 dtype: torch.dtype = torch.float32,
                 hand_kernel: bool = False):
        super().__init__()
        self.c = c2 // 2
        self.cv1 = ConvBnAct(c1, 2 * self.c, 1, dtype=dtype)
        self.cv2 = ConvBnAct((2 + n) * self.c, c2, 1, dtype=dtype)
        self.m = nn.ModuleList(
            Bottleneck(self.c, self.c, shortcut, dtype, hand_kernel)
            for _ in range(n))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = list(self.cv1(x).chunk(2, 1))
        for m in self.m:
            y.append(m(y[-1]))
        return self.cv2(torch.cat(y, 1))


class SPPF(nn.Module):
    """Spatial pyramid pooling (fast): 3 chained 5x5 stride-1 max-pools."""

    def __init__(self, c1: int, c2: int, k: int = 5,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        c_ = c1 // 2
        self.cv1 = ConvBnAct(c1, c_, 1, dtype=dtype)
        self.cv2 = ConvBnAct(c_ * 4, c2, 1, dtype=dtype)
        self.k = k

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = [self.cv1(x)]
        for _ in range(3):
            y.append(F.max_pool2d(y[-1], self.k, 1, self.k // 2))
        return self.cv2(torch.cat(y, 1))


def upsample2x(x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour 2x upsample (torch nn.Upsample(scale=2))."""
    return F.interpolate(x, scale_factor=2, mode="nearest")


def make_divisible(v: float, divisor: int = 8) -> int:
    """Ultralytics channel rounding."""
    return max(divisor, int(v + divisor / 2) // divisor * divisor)


def scale_channels(base: int, width: float, max_channels: int) -> int:
    return make_divisible(min(base, max_channels) * width, 8)


def scale_depth(base: int, depth: float) -> int:
    return max(1, round(base * depth))
