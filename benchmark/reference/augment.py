"""The Augmented train step's input chain, plain: HSV jitter and a
horizontal flip (Ultralytics gains), then per image clean with probability
1 - p or one of noise sigma 15 / blur k9 at 0 degrees / lowres 0.5x, the
draws taken from a ``torch.Generator`` in the order the program's step
takes them.

Frozen copies (commit bdbb134) of ``train/augment.py``'s HSV and flip
cores and of ``ops/fused_corrupt.py``'s plain corruption (its counter-based
noise bits, the k-tap blur, the lowres FIR) and its draw.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

CLEAN, NOISE, BLUR, LOWRES = 0, 1, 2, 3
_M32 = 0xFFFFFFFF


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


def _mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    """(a * c) mod 2^32 for int64 a in [0, 2^32), without int64 overflow."""
    lo = a * (c & 0xFFFF)
    hi = ((a * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _fmix32(h: torch.Tensor) -> torch.Tensor:
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def noise_bits(seed: int, n: int, device=None) -> torch.Tensor:
    """The kernel's 32-bit draws for elements 0..n-1 of one image (int64)."""
    key = _fmix32(torch.tensor(seed ^ 0x9E3779B9, dtype=torch.int64,
                               device=device))
    idx = torch.arange(n, dtype=torch.int64, device=device)
    return _fmix32((_fmix32(idx ^ key) + key) & _M32)


def standard_normal(seed: int, shape, device=None) -> torch.Tensor:
    """The kernel's standard normal g (f32, `shape`) for one image: Box-Muller
    on the two 16-bit halves of :func:`noise_bits`, element i of the
    row-major flattening drawing bits i."""
    shape = tuple(shape)
    bits = noise_bits(seed, math.prod(shape), device).view(shape)
    u1 = ((bits & 0xFFFF).float() + 0.5) / 65536.0
    u2 = (((bits >> 16) & 0xFFFF).float() + 0.5) / 65536.0
    return torch.sqrt(-2.0 * torch.log(u1)) * torch.cos(u2 * (2.0 * math.pi))


def _noise(x: torch.Tensor, seed: int, sigma: float) -> torch.Tensor:
    g = standard_normal(seed, x.shape, x.device)
    return torch.floor(torch.clamp(x + sigma * g, 0.0, 255.0))


def _reflect(n: int, pad: int, device) -> torch.Tensor:
    return torch.as_tensor(np.pad(np.arange(n), pad, mode="reflect"),
                           device=device)


def _blur(x: torch.Tensor, k: int) -> torch.Tensor:
    """x (H, W, C): horizontal k-tap mean, summed left to right from 0."""
    w = x.shape[1]
    xp = x.index_select(1, _reflect(w, k // 2, x.device))
    acc = torch.zeros_like(x)
    for t in range(k):
        acc = acc + xp[:, t:t + w]
    return torch.clamp(torch.round(acc * (1.0 / k)), 0.0, 255.0)


def _fir(v: torch.Tensor, dim: int) -> torch.Tensor:
    """One lowres axis on v padded by 2 (reflect-101) along dim: pair means
    s(q) = (v[q] + v[q+1]) * 0.5, then even j: 0.75 s(j) + 0.25 s(j-2), odd
    j: 0.75 s(j-1) + 0.25 s(j+1). Returns the unpadded length."""
    n = v.shape[dim] - 4
    s = (v.narrow(dim, 0, n + 3) + v.narrow(dim, 1, n + 3)) * 0.5
    even = 0.75 * s.narrow(dim, 2, n) + 0.25 * s.narrow(dim, 0, n)
    odd = 0.75 * s.narrow(dim, 1, n) + 0.25 * s.narrow(dim, 3, n)
    shape = [1] * v.dim()
    shape[dim] = n
    is_even = (torch.arange(n, device=v.device) % 2 == 0).view(shape)
    return torch.where(is_even, even, odd)


def _lowres(x: torch.Tensor) -> torch.Tensor:
    """x (H, W, C): horizontal FIR on every padded row, then vertical."""
    h, w = x.shape[0], x.shape[1]
    xp = x.index_select(0, _reflect(h, 2, x.device)).index_select(
        1, _reflect(w, 2, x.device))
    y = _fir(_fir(xp, 1), 0)
    return torch.clamp(torch.floor(y + 0.5), 0.0, 255.0)


def corrupt(img: torch.Tensor, choice: torch.Tensor, seeds: torch.Tensor,
            sigma: float, blur_k: int) -> torch.Tensor:
    """img (B, H, W, C) f32 [0, 255], each image through its branch."""
    out = []
    for x, ch, seed in zip(img, choice.tolist(), seeds.tolist()):
        if ch == NOISE:
            out.append(_noise(x, int(seed), sigma))
        elif ch == BLUR:
            out.append(_blur(x, blur_k))
        elif ch == LOWRES:
            out.append(_lowres(x))
        else:
            out.append(x.clone())
    return torch.stack(out)


def augment(images_u8: torch.Tensor, boxes: torch.Tensor,
            classes: torch.Tensor, gen: torch.Generator, corruption: dict,
            dtype: torch.dtype, hsv_gains=(0.015, 0.7, 0.4)):
    """(images (B, S, S, 3) f32 in [0, 1], boxes) of one Augmented step;
    HSV and flip in `dtype`, the recipe's (the reference's bf16 chain),
    the corruption in f32. Draws, in order: the HSV gains (3, B), the
    flips (B,), the corruption's apply uniforms (B,), branches (B,) and
    noise seeds (B,)."""
    b = images_u8.shape[0]
    dev = images_u8.device
    x = images_u8.to(dtype)
    u = torch.rand(3, b, generator=gen, device=dev)
    hg, sg, vg = hsv_gains
    x = hsv_jitter(x, (2 * u[0] - 1) * hg, 1 + (2 * u[1] - 1) * sg,
                   1 + (2 * u[2] - 1) * vg)
    flip = torch.rand(b, generator=gen, device=dev) < 0.5
    x, boxes = flip_lr(x, boxes, classes, flip)
    x = x.float()
    apply = torch.rand(b, generator=gen, device=dev) < corruption["prob"]
    choice3 = torch.randint(NOISE, LOWRES + 1, (b,), generator=gen,
                            device=dev)
    choice = torch.where(apply, choice3, torch.full_like(choice3, CLEAN))
    seeds = torch.randint(0, 2 ** 30, (b,), generator=gen, device=dev)
    x = corrupt(x, choice, seeds, corruption["noise_sigma"],
                corruption["blur_kernel"])
    return x / 255.0, boxes
