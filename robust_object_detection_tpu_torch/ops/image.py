"""Batched image resampling ops with OpenCV-parity semantics (counterpart
of robust_object_detection_tpu/ops/image.py).

NHWC (or HWC) tensors, computed in float32 throughout:

  * ``pad_reflect101`` — BORDER_REFLECT_101 (``gfedcb|abcdefgh|gfedcba``),
  * ``pad_to_multiple`` — pad H, W at the end up to a multiple (the
    U-Net's reflect padding to 16),
  * ``area_downsample_2x`` — cv2 INTER_AREA at factor 0.5: a 2x2 box mean,
  * ``resize_area`` — cv2 INTER_AREA downscaling at any size: each output
    pixel a fractional-overlap weighted mean of its source interval,
    separable, as shifted multiply-adds in f32 (no matmul, so no TF32),
  * ``resize_bilinear`` — half-pixel-centre bilinear (INTER_LINEAR), the
    same static gather indices and weights as the reference,
  * ``letterbox`` — aspect-preserving resize onto a top-left anchored
    square canvas,
  * the three cv2 quantisers. ``torch.round`` rounds half to even, like
    ``jnp.rint``.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def _reflect_index(n: int, pad: int) -> np.ndarray:
    return np.pad(np.arange(n), pad, mode="reflect")


def pad_reflect101(img: torch.Tensor, pad_h: int, pad_w: int) -> torch.Tensor:
    """Reflect-without-edge padding on the spatial dims of NHWC (or HWC)."""
    h, w = img.shape[-3], img.shape[-2]
    ih = torch.as_tensor(_reflect_index(h, pad_h), device=img.device)
    iw = torch.as_tensor(_reflect_index(w, pad_w), device=img.device)
    return img.index_select(-3, ih).index_select(-2, iw)


def pad_to_multiple(img: torch.Tensor, multiple: int,
                    mode: str = "reflect") -> torch.Tensor:
    """Pad H, W of NHWC (or HWC) at the end up to the next multiple.
    `mode` is a numpy pad mode of the index ("reflect" = BORDER_REFLECT_101,
    "symmetric", "edge", "wrap"); any pad length is taken, as jnp.pad
    takes it."""
    h, w = img.shape[-3], img.shape[-2]
    ph, pw = (-h) % multiple, (-w) % multiple
    if ph == 0 and pw == 0:
        return img
    ih = torch.as_tensor(np.pad(np.arange(h), (0, ph), mode=mode),
                         device=img.device)
    iw = torch.as_tensor(np.pad(np.arange(w), (0, pw), mode=mode),
                         device=img.device)
    return img.index_select(-3, ih).index_select(-2, iw)


def area_downsample_2x(img: torch.Tensor) -> torch.Tensor:
    """Exact 2x2 box average. img (..., H, W, C), even H, W -> f32."""
    h, w = img.shape[-3], img.shape[-2]
    if h % 2 or w % 2:
        raise ValueError(f"area_downsample_2x needs even H,W, got {h}x{w}")
    x = img.float().reshape(*img.shape[:-3], h // 2, 2, w // 2, 2,
                            img.shape[-1])
    return x.mean(dim=(-4, -2))


def _area_taps(out_size: int, in_size: int):
    """cv2 INTER_AREA weights as taps: (index (out, T), weight (out, T))
    of the row-stochastic resampling matrix of the reference
    (``ops/image._area_weights``: each output averages the source interval
    [i * scale, (i + 1) * scale) by overlap), zero-weight padding taps
    pointing at index 0."""
    scale = in_size / out_size
    w = np.zeros((out_size, in_size), np.float32)
    for i in range(out_size):
        lo, hi = i * scale, (i + 1) * scale
        j0, j1 = int(np.floor(lo)), int(np.ceil(hi))
        for j in range(j0, min(j1, in_size)):
            w[i, j] = min(hi, j + 1) - max(lo, j)
    w = w / w.sum(axis=1, keepdims=True)
    taps = max(int((row > 0).sum()) for row in w)
    idx = np.zeros((out_size, taps), np.int64)
    wt = np.zeros((out_size, taps), np.float32)
    for i, row in enumerate(w):
        nz = np.flatnonzero(row)
        idx[i, :len(nz)] = nz
        wt[i, :len(nz)] = row[nz]
    return idx, wt


def _area_axis(x: torch.Tensor, out_size: int, dim: int) -> torch.Tensor:
    idx, wt = _area_taps(out_size, x.shape[dim])
    shape = [1] * x.dim()
    shape[dim] = out_size
    y = None
    for t in range(idx.shape[1]):
        term = (x.index_select(dim, torch.as_tensor(idx[:, t],
                                                    device=x.device))
                * torch.as_tensor(wt[:, t], device=x.device).view(shape))
        y = term if y is None else y + term
    return y


def resize_area(img: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """cv2.resize(..., INTER_AREA) for downscaling, any sizes, NHWC or
    HWC -> f32 (callers quantise; cv2's uint8 path rounds half up)."""
    x = img.float()
    return _area_axis(_area_axis(x, out_h, x.dim() - 3), out_w, x.dim() - 2)


def _linear_weights(out_size: int, in_size: int):
    """Half-pixel-centre source taps (i0, i1) and weight of i1, in f32
    exactly as the reference computes them (cv2's clamped coordinate)."""
    scale = np.float32(in_size / out_size)
    dst = np.arange(out_size, dtype=np.float32)
    src = (dst + np.float32(0.5)) * scale - np.float32(0.5)
    i0 = np.floor(src)
    frac = src - i0
    i0 = np.clip(i0.astype(np.int64), 0, in_size - 1)
    i1 = np.clip(i0 + 1, 0, in_size - 1)
    frac = np.where(src < 0, np.float32(0.0), frac)
    frac = np.where(src > in_size - 1, np.float32(1.0), frac)
    return i0, i1, frac.astype(np.float32)


def resize_bilinear(img: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Half-pixel-centre bilinear resize on NHWC/HWC, separable gathers."""
    x = img.float()
    dev = x.device
    in_h, in_w = x.shape[-3], x.shape[-2]
    r0, r1, rf = (torch.as_tensor(a, device=dev)
                  for a in _linear_weights(out_h, in_h))
    rf = rf[:, None, None]
    x = x.index_select(-3, r0) * (1.0 - rf) + x.index_select(-3, r1) * rf
    c0, c1, cf = (torch.as_tensor(a, device=dev)
                  for a in _linear_weights(out_w, in_w))
    cf = cf[:, None]
    return x.index_select(-2, c0) * (1.0 - cf) + x.index_select(-2, c1) * cf


def letterbox(img: torch.Tensor, size: int, pad_value: float = 114.0
              ) -> Tuple[torch.Tensor, float, Tuple[int, int]]:
    """Resize keeping aspect ratio onto a size x size canvas, top-left
    anchored. Returns (canvas (..., size, size, C) f32, scale, (nh, nw))."""
    h, w = img.shape[-3], img.shape[-2]
    scale = min(size / h, size / w)
    nh, nw = round(h * scale), round(w * scale)
    resized = resize_bilinear(img, nh, nw)
    canvas = torch.full((*img.shape[:-3], size, size, img.shape[-1]),
                        pad_value, dtype=torch.float32, device=img.device)
    canvas[..., :nh, :nw, :] = resized
    return canvas, scale, (nh, nw)


def quantize_round(img: torch.Tensor) -> torch.Tensor:
    """cv2 saturate_cast<uchar> after float compute: round half to even,
    clip to [0, 255]."""
    return torch.clamp(torch.round(img), 0, 255)


def quantize_round_half_up(img: torch.Tensor) -> torch.Tensor:
    """cv2's fixed-point resize path: add half an LSB, truncate."""
    return torch.clamp(torch.floor(img + 0.5), 0, 255)


def quantize_trunc(img: torch.Tensor) -> torch.Tensor:
    """np.clip(x, 0, 255).astype(np.uint8): clip, then truncate."""
    return torch.floor(torch.clamp(img, 0, 255))
