"""The fused sweep's image path and detection tail, plain: the four
variants (clean; noise sigma 15 added to a standard-normal draw, clipped
and truncated; the k9 motion blur at 0 degrees as shifted multiply-adds,
rounded half to even; lowres 0.5x as a 2x2 mean and a half-pixel bilinear
upsample, rounded half up twice), the letterbox onto the square canvas,
the reflect padding to 16 before restoration, and the multi-label greedy
NMS with fixed capacities.

Frozen copies (commit bdbb134) of ``ops/image.py``, ``ops/corrupt.py``'s
variant ops and ``ops/nms.py`` of the program's package.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

_CLASS_OFFSET = 8192.0


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


def motion_blur_kernel(k: int, angle_deg: float) -> np.ndarray:
    """k x k motion-blur kernel: centre row of ones rotated by angle
    (inverse-map bilinear, as cv2.warpAffine), normalised by sum + 1e-8."""
    base = np.zeros((k, k), dtype=np.float32)
    base[k // 2, :] = 1.0
    if angle_deg % 360 != 0:
        cx = cy = k / 2 - 0.5
        a = np.deg2rad(angle_deg)
        cos, sin = np.cos(a), np.sin(a)
        ys, xs = np.mgrid[0:k, 0:k].astype(np.float32)
        sx = cos * (xs - cx) - sin * (ys - cy) + cx
        sy = sin * (xs - cx) + cos * (ys - cy) + cy
        x0, y0 = np.floor(sx).astype(int), np.floor(sy).astype(int)
        fx, fy = sx - x0, sy - y0
        out = np.zeros_like(base)
        for dy in (0, 1):
            for dx in (0, 1):
                wgt = (fx if dx else 1 - fx) * (fy if dy else 1 - fy)
                xi, yi = x0 + dx, y0 + dy
                valid = (xi >= 0) & (xi < k) & (yi >= 0) & (yi < k)
                out += np.where(valid, base[np.clip(yi, 0, k - 1),
                                            np.clip(xi, 0, k - 1)] * wgt, 0.0)
        base = out
    return base / (base.sum() + 1e-8)


def add_noise(img: torch.Tensor, noise: torch.Tensor, sigma: float = 15.0,
              quantize: bool = True) -> torch.Tensor:
    """img + sigma * noise for a given standard-normal draw, in f32."""
    x = img.float() + sigma * noise
    return quantize_trunc(x) if quantize else x


def apply_motion_blur(img: torch.Tensor, k: int = 9, angle_deg: float = 0.0,
                      quantize: bool = True) -> torch.Tensor:
    """Depthwise k x k motion-blur correlation, reflect-101 border, in true
    f32 (shifted multiply-adds over the non-zero taps)."""
    x = img.float()
    squeeze = x.dim() == 3
    if squeeze:
        x = x[None]
    h, w = x.shape[1], x.shape[2]
    kern = motion_blur_kernel(k, angle_deg)
    pad = k // 2
    xp = pad_reflect101(x, pad, pad)
    y = None
    for dy in range(k):
        for dx in range(k):
            if kern[dy, dx] == 0.0:
                continue
            term = xp[:, dy:dy + h, dx:dx + w, :] * float(kern[dy, dx])
            y = term if y is None else y + term
    if quantize:
        y = quantize_round(y)
    return y[0] if squeeze else y


def apply_lowres(img: torch.Tensor, factor: float = 0.5,
                 quantize: bool = True) -> torch.Tensor:
    """INTER_AREA 0.5x down, INTER_LINEAR back up (even H, W)."""
    h, w = img.shape[-3], img.shape[-2]
    if factor != 0.5:
        raise NotImplementedError("on-device lowres supports factor=0.5")
    small = area_downsample_2x(img)
    if quantize:
        small = quantize_round_half_up(small)
    up = resize_bilinear(small, h, w)
    return quantize_round_half_up(up) if quantize else up


def _nms_core(boxes: torch.Tensor, scores: torch.Tensor,
              classes: torch.Tensor, max_outputs: int, iou_thresh: float,
              class_aware: bool):
    """Greedy NMS over (B, K) candidates -> (B, max_outputs) picks.

    Padding slots carry score <= 0 and are never picked as valid.
    Returns (boxes (B,P,4), scores (B,P), classes (B,P) int32 with -1 in
    invalid slots, valid (B,P) bool)."""
    nb = (boxes + classes[..., None].float() * _CLASS_OFFSET
          if class_aware else boxes)
    x1, y1, x2, y2 = nb.unbind(-1)                             # (B, K)
    area = (x2 - x1) * (y2 - y1)
    s_live = torch.where(scores > 0, scores, torch.full_like(scores, -1.0))
    picks, svals = [], []
    for _ in range(max_outputs):
        i = torch.argmax(s_live, dim=1, keepdim=True)          # (B, 1)
        si = torch.gather(s_live, 1, i)
        bx1, by1, bx2, by2, ba = (torch.gather(v, 1, i)
                                  for v in (x1, y1, x2, y2, area))
        iw = (torch.minimum(bx2, x2) - torch.maximum(bx1, x1)).clamp(min=0.0)
        ih = (torch.minimum(by2, y2) - torch.maximum(by1, y1)).clamp(min=0.0)
        inter = iw * ih
        iou = inter / (ba + area - inter).clamp(min=1e-9)
        s_live = torch.where(iou > iou_thresh, -1.0, s_live)
        s_live = s_live.scatter(1, i, -1.0)
        picks.append(i)
        svals.append(si)
    idx = torch.cat(picks, 1)                                  # (B, P)
    sval = torch.cat(svals, 1)
    valid = sval > 0
    ob = torch.gather(boxes, 1, idx[..., None].expand(-1, -1, 4))
    oc = torch.gather(classes.to(torch.int32), 1, idx)
    ob = torch.where(valid[..., None], ob, 0.0)
    os_ = torch.where(valid, sval, 0.0)
    oc = torch.where(valid, oc, -1)
    return ob, os_, oc, valid


def multilabel_nms(boxes: torch.Tensor, scores: torch.Tensor,
                   num_candidates: int = 30000, max_outputs: int = 300,
                   iou_thresh: float = 0.7, score_thresh: float = 0.001):
    """Multi-label NMS (the Ultralytics val protocol): every (box, class)
    pair above threshold competes. boxes (B, N, 4); scores (B, N, C). The
    top-k runs over the class-major flattened (C*N) score plane."""
    b, n, c = scores.shape
    st = scores.transpose(1, 2)
    s = torch.where(st > score_thresh, st, 0.0).reshape(b, c * n)
    k = min(num_candidates, n * c)
    top_s, top_i = torch.topk(s, k, dim=1)
    box_i = top_i % n
    top_c = (top_i // n).to(torch.int32)
    top_b = torch.gather(boxes, 1, box_i[..., None].expand(-1, -1, 4))
    return _nms_core(top_b, top_s, top_c, max_outputs, iou_thresh,
                     class_aware=True)
