"""Feature Pyramid Network and RoIAlign (counterpart of
robust_object_detection_tpu/models/fpn.py).

The FPN is torchvision's v2 layout (``fasterrcnn_resnet50_fpn_v2``): 1x1
laterals, nearest x2 top-down, 3x3 outputs, P6 a stride-2 max-pool of P5.
With ``norm=True`` every lateral / output conv is bias-free and followed
by BatchNorm (``inner_blocks.{i}.0/1``, ``layer_blocks.{i}.0/1``, the v2
checkpoint's keys; in flax's train mode with ``train=True``); ``norm=False``
is the classic bias-only FPN
(``inner_blocks.{i}.0`` and ``layer_blocks.{i}.0`` with a bias: the
port's own keys for that layout). The convs run in the compute ``dtype``
(resnet.conv) and the BatchNorms output f32, as the reference's: with
``norm=True`` the pyramid is f32 whatever the dtype, with ``norm=False``
it is in the dtype.

RoIAlign mirrors the reference's function, not torchvision's: levels by
:func:`assign_levels` (with its +1e-8), ``aligned=False`` coordinates (a
plain divide by the stride), a fixed 2 x 2 samples a bin, each sample
clamped into [0, W-1] x [0, H-1] of its level (torchvision zeroes samples
outside), and the bin the mean of its samples. The levels are flattened
into one (B * sum HW, C) table and each corner of every sample is one
row gather from it, as the reference's ``take_along_axis``; a bf16 table's
rows are widened to f32 before the f32 weights multiply them (jnp's
promotion in the reference's sum); autograd
carries the gradient of the table back through the four gathers (an
index-add of each corner's rows).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .resnet import batch_norm, conv


class FPN(nn.Module):
    """(C2..C5) -> (P2..P6), all `features` channels."""

    def __init__(self, in_channels: Sequence[int] = (256, 512, 1024, 2048),
                 features: int = 256, norm: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.norm = norm
        self.dtype = dtype

        def block(c_in, kernel):
            conv = nn.Conv2d(c_in, features, kernel, 1, kernel // 2,
                             bias=not norm)
            return (nn.Sequential(conv, nn.BatchNorm2d(features)) if norm
                    else nn.Sequential(conv))
        self.inner_blocks = nn.ModuleList(block(c, 1) for c in in_channels)
        self.layer_blocks = nn.ModuleList(block(features, 3)
                                          for _ in in_channels)

    def _block(self, block: nn.Sequential, x: torch.Tensor,
               train: bool) -> torch.Tensor:
        x = conv(x, block[0], self.dtype)
        return batch_norm(x, block[1], train) if self.norm else x

    def forward(self, feats: Sequence[torch.Tensor], train: bool = False
                ) -> List[torch.Tensor]:
        """train: the BatchNorms in flax's train mode (resnet.batch_norm)."""
        laterals = [self._block(b, f, train)
                    for b, f in zip(self.inner_blocks, feats)]
        outs = [laterals[-1]]
        for lat in laterals[-2::-1]:
            outs.insert(0, lat + F.interpolate(outs[0], scale_factor=2,
                                               mode="nearest"))
        outs = [self._block(b, o, train)
                for b, o in zip(self.layer_blocks, outs)]
        # P6: stride-2 max-pool of P5 (torchvision LastLevelMaxPool)
        outs.append(F.max_pool2d(outs[-1], 1, 2))
        return outs


def assign_levels(boxes: torch.Tensor, k_min: int = 2, k_max: int = 5,
                  canonical_size: float = 224.0,
                  canonical_level: int = 4) -> torch.Tensor:
    """FPN level per RoI (Lin et al. eq. 1, torchvision LevelMapper):
    k = floor(k0 + log2(sqrt(area) / 224 + 1e-8)), clamped to [k_min,
    k_max]. boxes (..., 4) xyxy; returns int64 levels relative to k_min."""
    w = torch.clamp(boxes[..., 2] - boxes[..., 0], min=0.0)
    h = torch.clamp(boxes[..., 3] - boxes[..., 1], min=0.0)
    k = torch.floor(canonical_level
                    + torch.log2(torch.sqrt(w * h) / canonical_size + 1e-8))
    return (torch.clamp(k, k_min, k_max) - k_min).long()


def roi_align(features: Sequence[torch.Tensor], boxes: torch.Tensor,
              output_size: int = 7,
              strides: Tuple[int, ...] = (4, 8, 16, 32),
              sampling_ratio: int = 2) -> torch.Tensor:
    """Multi-level RoIAlign.

    features: per-level (B, C, H_l, W_l) maps (P2..P5; P6 is RPN-only);
    boxes: (B, R, 4) xyxy in image pixels. Returns (B, R, output_size,
    output_size, C)."""
    b, r = boxes.shape[:2]
    c = features[0].shape[1]
    dev = boxes.device
    hws = [(f.shape[2], f.shape[3]) for f in features]
    offsets = np.concatenate([[0], np.cumsum([h * w for h, w in hws])])
    n_rows = int(offsets[-1])
    flat = torch.cat([f.permute(0, 2, 3, 1).reshape(b, -1, c)
                      for f in features], 1).reshape(b * n_rows, c)

    levels = assign_levels(boxes)                          # (B, R)
    stride = torch.tensor(strides, dtype=torch.float32, device=dev)[levels]
    lvl_h = torch.tensor([h for h, _ in hws], device=dev)[levels]
    lvl_w = torch.tensor([w for _, w in hws], device=dev)[levels]
    # each RoI's level offset into the flattened (B * sum HW) table
    lvl_off = (torch.tensor(offsets[:-1], device=dev)[levels]
               + torch.arange(b, device=dev)[:, None] * n_rows)

    # RoI in level coordinates (aligned=False: a plain divide)
    x1 = boxes[..., 0] / stride
    y1 = boxes[..., 1] / stride
    x2 = boxes[..., 2] / stride
    y2 = boxes[..., 3] / stride
    bin_w = torch.clamp(x2 - x1, min=1.0) / output_size
    bin_h = torch.clamp(y2 - y1, min=1.0) / output_size

    s = sampling_ratio
    n_taps = output_size * s
    tap = (torch.arange(n_taps, dtype=torch.float32, device=dev) + 0.5) / s
    sx = x1[..., None] + tap * bin_w[..., None]             # (B, R, T)
    sy = y1[..., None] + tap * bin_h[..., None]

    def axis(v, size):
        # clamp to the level's bounds (outside -> edge, the reference's)
        last = size[..., None] - 1
        v = torch.minimum(torch.clamp(v, min=0.0), last.float())
        v0 = torch.floor(v)
        i0 = v0.long()
        return i0, torch.minimum(i0 + 1, last), v - v0

    x0i, x1i, fx = axis(sx, lvl_w)
    y0i, y1i, fy = axis(sy, lvl_h)
    row_w = lvl_w[..., None, None]

    def gather(yi, xi):
        idx = (lvl_off[..., None, None] + yi[..., :, None] * row_w
               + xi[..., None, :])                          # (B, R, T, T)
        return flat[idx.reshape(-1)].reshape(b, r, n_taps, n_taps,
                                              c).to(fx.dtype)

    wy0 = (1 - fy)[..., :, None, None]
    wy1 = fy[..., :, None, None]
    wx0 = (1 - fx)[..., None, :, None]
    wx1 = fx[..., None, :, None]
    # the reference's sum, term by term in its order; two corners live
    # at a time
    val = gather(y0i, x0i).mul_(wy0).mul_(wx0)
    val += gather(y0i, x1i).mul_(wy0).mul_(wx1)
    val += gather(y1i, x0i).mul_(wy1).mul_(wx0)
    val += gather(y1i, x1i).mul_(wy1).mul_(wx1)
    # the mean of the taps in each output bin
    val = val.reshape(b, r, output_size, s, output_size, s, c)
    return val.mean(dim=(3, 5))
