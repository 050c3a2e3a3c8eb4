"""Shared detector building blocks (counterpart of
robust_object_detection_tpu/models/layers.py).

Modules take and return NCHW-indexed tensors; on the card they stay in
channels_last memory, so the NHWC kernels get their inputs with a
permute and no copy. Conventions, as in the reference:

  * ``dtype`` is the conv compute type; conv weights are stored in
    ``param_dtype`` (default ``dtype``: the eval path keeps bf16 weights
    and casts none per forward; a trainer keeps float32 master weights,
    cast to ``dtype`` in every forward as flax's ``nn.Conv(dtype=...)``
    does, so SGD updates do not vanish in bf16 rounding),
  * eval BatchNorm (eps 1e-3) and the activation run in float32 from the
    running statistics, so every eval ConvBnAct returns float32,
  * train BatchNorm has flax semantics (:func:`bn_train`): f32 batch
    statistics with the biased fast variance, running statistics updated
    as 0.97 * running + 0.03 * batch (YOLO's; Faster R-CNN keeps flax's
    default 0.99; torch's BatchNorm2d would update the running variance
    with the unbiased one), normalisation in f32, output
    and SiLU in ``bn_dtype`` (bf16 under the reference's
    ``bn_dtype_scope(jnp.bfloat16)``),
  * symmetric ``k // 2`` padding, as torch's Conv2d(padding=k//2).

Module and attribute names follow Ultralytics (``conv``/``bn``, ``cv1``/
``cv2``/``m``), so ``state_dict`` keys match a real YOLOv8 / RT-DETR
checkpoint.
"""

from __future__ import annotations

from typing import Optional, Union

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.conv3x3 import conv3x3
from ..ops.yolo_front import batch_stats

MOMENTUM = 0.97   # flax BatchNorm momentum (torch momentum 0.03)


def resolve_device(device: Union[None, str, torch.device]) -> torch.device:
    """The device an entry point builds its model on: the one the caller
    names, else the CUDA card. Without a card it raises; the port does not
    carry on on the CPU unless asked to (``device="cpu"``)."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA card (torch.cuda.is_available() is False): the port "
            "runs on the card unless the caller asks for another device; "
            "pass device='cpu' to run the plain versions on the CPU")
    return torch.device("cuda")


ACTIVATIONS = {"silu": F.silu, "relu": F.relu}


def to_nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1).contiguous()


def from_nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def update_running(bn: nn.BatchNorm2d, mean: torch.Tensor,
                   var: torch.Tensor, momentum: float = MOMENTUM) -> None:
    """flax's running-statistics update from one batch's statistics."""
    with torch.no_grad():
        bn.running_mean.mul_(momentum).add_(mean.detach() * (1 - momentum))
        bn.running_var.mul_(momentum).add_(var.detach() * (1 - momentum))


def bn_normalize(y: torch.Tensor, bn: nn.BatchNorm2d, mean: torch.Tensor,
                 var: torch.Tensor) -> torch.Tensor:
    """((y - mean) * (rsqrt(var + eps) * scale) + bias) over the channels
    of NCHW y, in f32 (flax's BatchNorm arithmetic)."""
    mul = torch.rsqrt(var + bn.eps) * bn.weight
    return ((y.float() - mean[:, None, None]) * mul[:, None, None]
            + bn.bias[:, None, None])


def bn_train(y: torch.Tensor, bn: nn.BatchNorm2d, out_dtype: torch.dtype,
             momentum: float = MOMENTUM) -> torch.Tensor:
    """Train-mode BatchNorm over (N, H, W) of NCHW y, flax semantics: f32
    statistics (fast variance, clamped), running update at `momentum`
    (YOLO's 0.97 by default; flax's own default, 0.99, for the models that
    keep it), ((y - mean) * (rsqrt(var + eps) * scale) + bias) in f32, cast
    to out_dtype."""
    mean, var = batch_stats(y, (0, 2, 3))
    update_running(bn, mean, var, momentum)
    return bn_normalize(y, bn, mean, var).to(out_dtype)


class ConvBnAct(nn.Module):
    """Conv2d(bias=False) + BatchNorm + activation (Ultralytics ``Conv``):
    SiLU by default, ``act_fn="relu"`` for the HGNetv2 blocks, ``act=False``
    for none. ``groups`` makes it grouped or depthwise (plain ``F.conv2d``).

    hand_kernel=True routes a 3x3 stride-1 conv through ops.conv3x3 (the
    K3-f kernel on the card, with K3-f / K3-b in its backward); every other
    conv is ``F.conv2d``, as the reference leaves them to XLA. Train or
    eval BatchNorm follows the module's ``training`` flag."""

    def __init__(self, c1: int, c2: int, k: int = 1, s: int = 1,
                 act: bool = True, dtype: torch.dtype = torch.float32,
                 hand_kernel: bool = False,
                 param_dtype: Optional[torch.dtype] = None,
                 bn_dtype: torch.dtype = torch.float32, groups: int = 1,
                 act_fn: str = "silu"):
        super().__init__()
        if hand_kernel and (k, s, groups) != (3, 1, 1):
            raise ValueError("hand_kernel covers dense 3x3 stride-1 convs "
                             "only")
        self.conv = nn.Conv2d(c1, c2, k, s, k // 2, groups=groups,
                              bias=False, dtype=param_dtype or dtype)
        self.bn = nn.BatchNorm2d(c2, eps=1e-3, momentum=0.03)
        self.act = ACTIVATIONS[act_fn] if act else None
        self.hand_kernel = hand_kernel
        self.dtype = dtype
        self.bn_dtype = bn_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xd = x.to(self.dtype)
        w = self.conv.weight
        if self.hand_kernel:     # conv3x3 casts an f32 master itself
            y = from_nhwc(conv3x3(to_nhwc(xd),
                                  w.permute(2, 3, 1, 0).contiguous()))
        else:
            y = F.conv2d(xd, w.to(self.dtype), None, self.conv.stride,
                         self.conv.padding, 1, self.conv.groups)
        if self.training:
            y = bn_train(y, self.bn, self.bn_dtype)
        else:
            y = self.bn(y.float())
        return self.act(y) if self.act else y


class Bottleneck(nn.Module):
    """YOLO residual bottleneck: two 3x3 convs + optional shortcut.
    ``**kw`` (dtype, param_dtype, bn_dtype) go to every ConvBnAct."""

    def __init__(self, c1: int, c2: int, shortcut: bool = True,
                 hand_kernel: bool = False, **kw):
        super().__init__()
        self.cv1 = ConvBnAct(c1, c2, 3, hand_kernel=hand_kernel, **kw)
        self.cv2 = ConvBnAct(c2, c2, 3, hand_kernel=hand_kernel, **kw)
        self.add = shortcut and c1 == c2

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.cv2(self.cv1(x))
        return x + y if self.add else y


class C2f(nn.Module):
    """Cross-stage partial block with n bottlenecks: cv1 projects to 2
    chunks, each bottleneck consumes the last chunk and appends its output,
    cv2 fuses the (2+n) chunks."""

    def __init__(self, c1: int, c2: int, n: int = 1, shortcut: bool = False,
                 hand_kernel: bool = False, **kw):
        super().__init__()
        self.c = c2 // 2
        self.cv1 = ConvBnAct(c1, 2 * self.c, 1, **kw)
        self.cv2 = ConvBnAct((2 + n) * self.c, c2, 1, **kw)
        self.m = nn.ModuleList(
            Bottleneck(self.c, self.c, shortcut, hand_kernel, **kw)
            for _ in range(n))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = list(self.cv1(x).chunk(2, 1))
        for m in self.m:
            y.append(m(y[-1]))
        return self.cv2(torch.cat(y, 1))


class SPPF(nn.Module):
    """Spatial pyramid pooling (fast): 3 chained 5x5 stride-1 max-pools."""

    def __init__(self, c1: int, c2: int, k: int = 5, **kw):
        super().__init__()
        c_ = c1 // 2
        self.cv1 = ConvBnAct(c1, c_, 1, **kw)
        self.cv2 = ConvBnAct(c_ * 4, c2, 1, **kw)
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
