"""Batched image corruption ops (counterpart of
robust_object_detection_tpu/ops/corrupt.py), float32 [0, 255] NHWC in and out.

  * noise: sigma 15 gaussian added in f32, clipped, truncated. Drawn from a
    ``torch.Generator``, so the numbers differ from the reference's
    Threefry stream (distributional parity only, as in the reference);
  * motion blur k=9: the reference's kernel construction, applied as a
    depthwise correlation with BORDER_REFLECT_101, rounded half to even;
  * lowres 0.5x: 2x2 box mean, round half up, bilinear back up, round half
    up.

The blur must be true f32 for uint8 parity with cv2 (the reference runs it
at Precision.HIGHEST). A cuDNN f32 conv runs in TF32 by default on the
card, so the blur here is written as shifted multiply-adds over the
kernel's non-zero taps (9 for the 0-degree kernel): plain f32 arithmetic on
any device, with no dependence on backend precision flags.

The training-time corruption (the reference's ``random_corruption_fast``,
the K1 Pallas kernel) is ops/fused_corrupt.py; :func:`random_corruption` is
the reference's op-by-op draw, on a ``torch.Generator``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..core.config import CorruptionConfig
from . import image as image_ops

# Corruption ids (used for per-image selection and reporting).
CLEAN, NOISE, BLUR, LOWRES = 0, 1, 2, 3
VARIANTS = ("Clean", "Noise", "Blur", "LowRes")


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
    return image_ops.quantize_trunc(x) if quantize else x


def apply_noise(img: torch.Tensor, generator: torch.Generator,
                sigma: float = 15.0, quantize: bool = True) -> torch.Tensor:
    """Additive gaussian noise; `generator` lives on img's device."""
    noise = torch.randn(img.shape, generator=generator, device=img.device,
                        dtype=torch.float32)
    return add_noise(img, noise, sigma, quantize)


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
    xp = image_ops.pad_reflect101(x, pad, pad)
    y = None
    for dy in range(k):
        for dx in range(k):
            if kern[dy, dx] == 0.0:
                continue
            term = xp[:, dy:dy + h, dx:dx + w, :] * float(kern[dy, dx])
            y = term if y is None else y + term
    if quantize:
        y = image_ops.quantize_round(y)
    return y[0] if squeeze else y


def apply_lowres(img: torch.Tensor, factor: float = 0.5,
                 quantize: bool = True) -> torch.Tensor:
    """INTER_AREA 0.5x down, INTER_LINEAR back up (even H, W)."""
    h, w = img.shape[-3], img.shape[-2]
    if factor != 0.5:
        raise NotImplementedError("on-device lowres supports factor=0.5")
    small = image_ops.area_downsample_2x(img)
    if quantize:
        small = image_ops.quantize_round_half_up(small)
    up = image_ops.resize_bilinear(small, h, w)
    return image_ops.quantize_round_half_up(up) if quantize else up


def corrupt_variant(img: torch.Tensor, variant, generator: torch.Generator,
                    cfg: CorruptionConfig = CorruptionConfig(),
                    quantize: bool = True,
                    noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Apply a fixed per-image corruption id (an int or a (B,) tensor).
    The noise branch draws a standard normal of img's shape from
    `generator`, or takes the given `noise` draw."""
    x = img.float()
    if noise is None:
        noised = apply_noise(x, generator, cfg.noise_sigma, quantize=quantize)
    else:
        noised = add_noise(x, noise, cfg.noise_sigma, quantize=quantize)
    blurred = apply_motion_blur(x, cfg.blur_kernel, cfg.blur_angle_deg,
                                quantize=quantize)
    low = apply_lowres(x, cfg.downscale_factor, quantize=quantize)
    stacked = torch.stack([x, noised, blurred, low])        # (4, B, H, W, C)
    variant = torch.as_tensor(variant, device=x.device).long()
    variant = variant.expand(x.shape[0])
    return stacked[variant, torch.arange(x.shape[0], device=x.device)]


def draw_random_corruption(shape, generator: torch.Generator,
                           cfg: CorruptionConfig = CorruptionConfig()):
    """The draws of :func:`random_corruption` for an NHWC `shape`, from
    `generator` on its device, in this order: the apply uniforms (B,), the
    branch (B,) uniform over noise / blur / lowres, the standard-normal
    noise (B, H, W, C). Returns (choice (B,) int64, noise)."""
    n = shape[0]
    dev = generator.device
    apply = torch.rand(n, generator=generator, device=dev) < cfg.prob
    choice3 = torch.randint(NOISE, LOWRES + 1, (n,), generator=generator,
                            device=dev)
    noise = torch.randn(tuple(shape), generator=generator, device=dev,
                        dtype=torch.float32)
    return torch.where(apply, choice3, torch.full_like(choice3, CLEAN)), noise


def random_corruption(img: torch.Tensor, generator: torch.Generator,
                      cfg: CorruptionConfig = CorruptionConfig(),
                      quantize: bool = True, fast: bool = False
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Corrupt each image of an NHWC batch with probability `cfg.prob`,
    choosing uniformly among noise / blur / lowres, op by op (the
    reference's ``random_corruption``; K1, ops/fused_corrupt.py, is the
    one-pass kernel). The draws come from `generator` on img's device
    (:func:`draw_random_corruption`). `fast` is accepted for the
    reference's signature: the blur here is true f32 on every device, so
    there is no faster precision to relax to.

    Returns (batch f32, choice (B,) in {CLEAN, NOISE, BLUR, LOWRES})."""
    del fast
    choice, noise = draw_random_corruption(img.shape, generator, cfg)
    return (corrupt_variant(img, choice, None, cfg, quantize, noise=noise),
            choice)
