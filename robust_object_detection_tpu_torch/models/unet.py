"""Residual restoration U-Net (counterpart of
robust_object_detection_tpu/models/unet.py).

The reference's 3.70M-parameter RestorationUNet at widths (32, 64, 128,
256):

  * 4 encoder stages, each a :class:`ConvBlock` (2 x (3x3 conv without
    bias -> BatchNorm -> LeakyReLU 0.2)) followed by a 2x2 max-pool; a
    bottleneck ConvBlock at the last width,
  * 4 decoder stages: a 2x2 stride-2 transposed conv (channel-preserving,
    with bias), concat of the skip, a ConvBlock down to the stage width
    (the last stage keeps the first width),
  * a 1x1 conv (with bias) to a 3-channel residual; the output is
    clamp(x + residual, 0, 1).

Inputs and outputs are NHWC float in [0, 1] with H, W divisible by 16;
:func:`restore_image` and :func:`apply_u8`'s callers pad by reflection.
Inside, activations are NCHW views in channels_last memory (the layout of
cuDNN's NHWC convolutions). The 3x3 convs compute K3's function, but the
reference reaches them through ``nn.Conv``, not its Pallas kernel, so here
they are ``F.conv2d`` (cuDNN on the card), with no hand kernel and no
launch count.

BatchNorm keeps flax's defaults, which differ from the detectors': momentum
0.99 and eps 1e-5. Train mode normalises with the batch's f32 statistics
(the biased fast variance E[y^2] - E[y]^2, clamped at 0) and updates the
running statistics with the same variance. ``dtype`` is the conv compute
type (f32 master weights cast per forward, as flax's ``nn.Conv(dtype)``);
BatchNorm and the activations stay f32. ``remat`` recomputes each
ConvBlock in the backward (``torch.utils.checkpoint``); the running
statistics are updated once, from the first forward.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops import image as image_ops
from ..ops.yolo_front import batch_stats
from .layers import bn_normalize, resolve_device, update_running

MOMENTUM = 0.99   # flax nn.BatchNorm default (torch momentum 0.01)
EPS = 1e-5


class ConvBlock(nn.Module):
    """2 x (3x3 conv, no bias -> BatchNorm -> LeakyReLU 0.2), NCHW."""

    def __init__(self, c1: int, c2: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv0 = nn.Conv2d(c1, c2, 3, padding=1, bias=False)
        self.bn0 = nn.BatchNorm2d(c2, eps=EPS, momentum=1 - MOMENTUM)
        self.conv1 = nn.Conv2d(c2, c2, 3, padding=1, bias=False)
        self.bn1 = nn.BatchNorm2d(c2, eps=EPS, momentum=1 - MOMENTUM)
        self.dtype = dtype

    def pure_forward(self, x: torch.Tensor):
        """(output, batch statistics of each BN in train mode); changes no
        state, so a recompute in the backward leaves the running
        statistics alone."""
        stats = []
        for conv, bn in ((self.conv0, self.bn0), (self.conv1, self.bn1)):
            y = F.conv2d(x.to(self.dtype), conv.weight.to(self.dtype), None,
                         1, 1)
            if self.training:
                mean, var = batch_stats(y, (0, 2, 3))
                stats.append((mean.detach(), var.detach()))
                y = bn_normalize(y, bn, mean, var)
            else:
                y = bn(y.float())
            x = F.leaky_relu(y, 0.2)
        return x, stats

    def update_running(self, stats) -> None:
        for bn, (mean, var) in zip((self.bn0, self.bn1), stats):
            update_running(bn, mean, var, MOMENTUM)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y, stats = self.pure_forward(x)
        self.update_running(stats)
        return y


class RestorationUNet(nn.Module):
    def __init__(self, channels: Sequence[int] = (32, 64, 128, 256),
                 dtype: torch.dtype = torch.float32, remat: bool = False):
        super().__init__()
        c = tuple(channels)
        self.channels, self.dtype, self.remat = c, dtype, remat
        self.enc = nn.ModuleList(ConvBlock(ci, co, dtype)
                                 for ci, co in zip((3,) + c[:-1], c))
        self.mid = ConvBlock(c[-1], c[-1], dtype)
        out_ch = list(c[-2::-1]) + [c[0]]
        ups, decs, cur = [], [], c[-1]
        for skip, co in zip(reversed(c), out_ch):
            ups.append(nn.ConvTranspose2d(cur, cur, 2, 2))
            decs.append(ConvBlock(cur + skip, co, dtype))
            cur = co
        self.up = nn.ModuleList(ups)
        self.dec = nn.ModuleList(decs)
        self.out = nn.Conv2d(c[0], 3, 1)

    def _block(self, block: ConvBlock, x: torch.Tensor) -> torch.Tensor:
        if self.remat and self.training and torch.is_grad_enabled():
            y, stats = checkpoint(block.pure_forward, x, use_reentrant=False)
            block.update_running(stats)
            return y
        return block(x)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (N, H, W, 3) float in [0, 1], H % 16 == W % 16 == 0 ->
        restored (N, H, W, 3) f32 in [0, 1]."""
        inp = x.float()
        h = inp.permute(0, 3, 1, 2)
        skips = []
        for block in self.enc:
            h = self._block(block, h)
            skips.append(h)
            h = F.max_pool2d(h, 2, 2)
        h = self._block(self.mid, h)
        dt = self.dtype
        for up, block, skip in zip(self.up, self.dec, reversed(skips)):
            h = F.conv_transpose2d(h.to(dt), up.weight.to(dt),
                                   up.bias.to(dt), stride=2)
            h = torch.cat([h, skip.to(dt)], 1)
            h = self._block(block, h)
        r = F.conv2d(h.to(dt), self.out.weight.to(dt), self.out.bias.to(dt))
        return torch.clamp(inp + r.float().permute(0, 2, 3, 1), 0.0, 1.0)


def macs_per_pixel(model: RestorationUNet) -> float:
    """Multiply-adds of one forward per input pixel, from the layers'
    shapes: a conv at level l (1 / 4**l of the pixels) costs its weight's
    size per output pixel, a 2x2 stride-2 transposed conv its weight's size
    / 4 per output pixel (one tap each). 122,560 at (32, 64, 128, 256)."""
    def block(b: ConvBlock, level: int) -> float:
        return (b.conv0.weight.numel() + b.conv1.weight.numel()) / 4 ** level
    n = len(model.channels)
    total = sum(block(b, i) for i, b in enumerate(model.enc))
    total += block(model.mid, n)
    for j, (up, b) in enumerate(zip(model.up, model.dec)):
        level = n - 1 - j
        total += up.weight.numel() / 4 / 4 ** level + block(b, level)
    return total + model.out.weight.numel()


def init_weights(model: RestorationUNet,
                 generator: torch.Generator) -> RestorationUNet:
    """flax's init: lecun-normal kernels (truncated at 2 std, fan-in =
    in x kh x kw, for the transposed convs too), zero biases, BN affine
    1 / 0 and running statistics 0 / 1. Draws come from `generator` (on
    the CPU)."""
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, (nn.Conv2d, nn.ConvTranspose2d)):
                w = mod.weight
                fan_in = (w.shape[0] if isinstance(mod, nn.ConvTranspose2d)
                          else w.shape[1]) * w.shape[2] * w.shape[3]
                std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
                t = torch.empty(w.shape)
                nn.init.trunc_normal_(t, 0.0, std, -2 * std, 2 * std,
                                      generator=generator)
                w.copy_(t)
                if mod.bias is not None:
                    mod.bias.zero_()
            elif isinstance(mod, nn.BatchNorm2d):
                mod.reset_parameters()
    return model


def create(channels: Sequence[int] = (32, 64, 128, 256),
           dtype: torch.dtype = torch.float32, remat: bool = False,
           device: Optional[torch.device] = None,
           generator: Optional[torch.Generator] = None,
           train: bool = False) -> RestorationUNet:
    """A U-Net on `device` (None: the CUDA card; raises when there is
    none), randomly initialised from `generator` (seed 0 when None), in
    eval mode unless train=True; weights in channels_last memory."""
    device = resolve_device(device)
    gen = generator or torch.Generator().manual_seed(0)
    model = init_weights(RestorationUNet(channels, dtype, remat), gen)
    return model.to(device, memory_format=torch.channels_last).train(train)


def param_count(model: nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())


def pad_to_16(img: torch.Tensor) -> Tuple[torch.Tensor, Tuple[int, int]]:
    """Reflect-pad H, W (NHWC or HWC) to multiples of 16; returns
    (padded, (orig_h, orig_w))."""
    h, w = img.shape[-3], img.shape[-2]
    return image_ops.pad_to_multiple(img, 16), (h, w)


@torch.inference_mode()
def restore_image(model: RestorationUNet, img: torch.Tensor) -> torch.Tensor:
    """Full-resolution restoration of one HWC [0, 1] image: pad to 16,
    forward, crop."""
    x, (h, w) = pad_to_16(img[None])
    return model(x)[0, :h, :w]


@torch.inference_mode()
def apply_u8(model: RestorationUNet, x_u8: torch.Tensor) -> torch.Tensor:
    """uint8 in, uint8 out (the reference's ``jit_apply_u8``): x (N, H, W,
    3) uint8 with H, W multiples of 16; /255, forward and the
    re-quantisation floor(clip(y * 255 + 0.5, 0, 255)) all run on x's
    device."""
    y = model(x_u8.float() / 255.0)
    return torch.floor(torch.clamp(y * 255.0 + 0.5, 0.0, 255.0)).to(
        torch.uint8)
