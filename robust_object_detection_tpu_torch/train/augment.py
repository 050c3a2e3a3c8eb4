"""On-device detector training augmentations: HSV jitter and horizontal
flip (counterpart of robust_object_detection_tpu/train/augment.py
``rgb_to_hsv``, ``hsv_to_rgb``, ``random_hsv``, ``random_flip_lr``).

Each random op is a deterministic core fed its per-image draws
(:func:`hsv_jitter` takes the gains, :func:`flip_lr` the flip mask) and a
wrapper that draws them from a ``torch.Generator`` on the batch's device.
The cores compute in the image's dtype: the train step runs this chain in
bf16, as the reference does. Host-side mosaic belongs to the data
pipeline and is not here.
"""

from __future__ import annotations

from typing import Tuple

import torch


def rgb_to_hsv(rgb: torch.Tensor) -> torch.Tensor:
    """(..., 3) float [0, 1] RGB -> HSV (h in [0, 1))."""
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    mx = rgb.amax(-1)
    mn = rgb.amin(-1)
    d = mx - mn
    safe = torch.where(d == 0, torch.ones_like(d), d)
    h = torch.where(mx == r, (g - b) / safe % 6.0,
                    torch.where(mx == g, (b - r) / safe + 2.0,
                                (r - g) / safe + 4.0))
    h = torch.where(d == 0, torch.zeros_like(h), h) / 6.0
    s = torch.where(mx == 0, torch.zeros_like(d),
                    d / torch.where(mx == 0, torch.ones_like(mx), mx))
    return torch.stack([h, s, mx], -1)


def hsv_to_rgb(hsv: torch.Tensor) -> torch.Tensor:
    h, s, v = hsv[..., 0] * 6.0, hsv[..., 1], hsv[..., 2]
    i = torch.floor(h)
    f = h - i
    p = v * (1 - s)
    q = v * (1 - s * f)
    t = v * (1 - s * (1 - f))
    i = i.to(torch.int32) % 6

    def select(*vals):
        out = vals[5]
        for k in range(4, -1, -1):
            out = torch.where(i == k, vals[k], out)
        return out
    return torch.stack([select(v, q, p, p, t, v), select(t, v, v, q, p, p),
                        select(p, p, t, v, v, q)], -1)


def hsv_jitter(img: torch.Tensor, dh: torch.Tensor, ds: torch.Tensor,
               dv: torch.Tensor) -> torch.Tensor:
    """img (B, H, W, 3) float [0, 255]; dh additive hue (wraps), ds and dv
    multiplicative saturation and value gains, each (B,) in img's dtype."""
    dh, ds, dv = (g.to(img.dtype).view(-1, 1, 1) for g in (dh, ds, dv))
    hsv = rgb_to_hsv(img / 255.0)
    h = (hsv[..., 0] + dh) % 1.0
    s = torch.clamp(hsv[..., 1] * ds, 0.0, 1.0)
    v = torch.clamp(hsv[..., 2] * dv, 0.0, 1.0)
    return hsv_to_rgb(torch.stack([h, s, v], -1)) * 255.0


def random_hsv(img: torch.Tensor, generator: torch.Generator,
               hgain: float = 0.015, sgain: float = 0.7,
               vgain: float = 0.4) -> torch.Tensor:
    """Per-image HSV jitter, Ultralytics augment_hsv gains: uniform in
    [-hgain, hgain] (hue, additive) and [1 - g, 1 + g] (saturation, value)."""
    b = img.shape[0]
    u = torch.rand(3, b, generator=generator, device=img.device)
    return hsv_jitter(img, (2 * u[0] - 1) * hgain, 1 + (2 * u[1] - 1) * sgain,
                      1 + (2 * u[2] - 1) * vgain)


def flip_lr(img: torch.Tensor, boxes: torch.Tensor, classes: torch.Tensor,
            flip: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Horizontal flip of the images where flip (B,) is true, with their
    xyxy canvas boxes (B, M, 4); padded boxes (class -1) stay as they are."""
    w = img.shape[2]
    f = flip.to(torch.bool).view(-1, 1, 1, 1)
    img = torch.where(f, img.flip(2), img)
    fb = torch.stack([w - boxes[..., 2], boxes[..., 1], w - boxes[..., 0],
                      boxes[..., 3]], -1)
    keep = f[:, :, 0, :] & (classes >= 0)[..., None]
    return img, torch.where(keep, fb, boxes)


def random_flip_lr(img: torch.Tensor, boxes: torch.Tensor,
                   classes: torch.Tensor, generator: torch.Generator
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """p = 0.5 horizontal flip of each image and its boxes."""
    flip = torch.rand(img.shape[0], generator=generator,
                      device=img.device) < 0.5
    return flip_lr(img, boxes, classes, flip)
