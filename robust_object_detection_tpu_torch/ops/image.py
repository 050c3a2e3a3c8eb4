"""Batched image resampling ops with OpenCV-parity semantics (counterpart
of robust_object_detection_tpu/ops/image.py).

NHWC (or HWC) tensors, computed in float32 throughout:

  * ``pad_reflect101`` — BORDER_REFLECT_101 (``gfedcb|abcdefgh|gfedcba``),
  * ``area_downsample_2x`` — cv2 INTER_AREA at factor 0.5: a 2x2 box mean,
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


def area_downsample_2x(img: torch.Tensor) -> torch.Tensor:
    """Exact 2x2 box average. img (..., H, W, C), even H, W -> f32."""
    h, w = img.shape[-3], img.shape[-2]
    if h % 2 or w % 2:
        raise ValueError(f"area_downsample_2x needs even H,W, got {h}x{w}")
    x = img.float().reshape(*img.shape[:-3], h // 2, 2, w // 2, 2,
                            img.shape[-1])
    return x.mean(dim=(-4, -2))


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
