"""Training-time per-image corruption in one pass (counterpart of
ops/pallas_corrupt.py ``fused_random_corruption``, the TPU's
``random_corruption_fast``).

Each image of an NHWC f32 [0, 255] batch is left clean with probability
1 - p and otherwise gets one of noise / blur / lowres, uniformly:

  * noise: x + sigma * g, clipped and truncated; g is Box-Muller on the two
    16-bit halves of one 32-bit counter-based draw, a keyed murmur3 hash of
    (image seed, element index);
  * blur: the 0-degree motion kernel as a horizontal k-tap mean (reflect-101
    borders), times float32(1/k), rounded half to even;
  * lowres: the 2x2 box mean and half-pixel bilinear 2x upsample composed
    as one FIR per axis (horizontal, then vertical), reflect-101 borders,
    one round-half-up at the end, with no intermediate uint8 rounding (the
    TPU kernel's fast path, pallas_corrupt.py:129-157 — not
    ``apply_lowres``).

:func:`fused_random_corruption` draws the choice and the seeds from a
``torch.Generator`` unless given; on a CUDA tensor it launches ``csrc/
corrupt.cu`` (K1: a 2-D grid of tiles per image, the plan of
``kernels.corrupt_plan``), on a CPU tensor it runs
:func:`fused_corruption_reference`, the plain version, which replays the
kernel's noise bits with integer tensor ops and its blur and lowres
arithmetic in the same f32 operation order. The TPU's on-core PRNG bits
cannot be reproduced, so noise matches the reference in distribution
only.
"""

from __future__ import annotations

import functools
import math
from typing import Optional, Tuple

import numpy as np
import torch

from .. import kernels
from ..core.config import CorruptionConfig
from .corrupt import BLUR, CLEAN, LOWRES, NOISE

_M32 = 0xFFFFFFFF


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


def fused_corruption_reference(img: torch.Tensor, choice: torch.Tensor,
                               seeds: torch.Tensor,
                               cfg: CorruptionConfig = CorruptionConfig()
                               ) -> torch.Tensor:
    """Plain version of K1: img (B, H, W, C) f32 [0, 255], choice and seeds
    (B,) int -> (B, H, W, C) f32, each image through its chosen branch."""
    out = []
    for x, ch, seed in zip(img, choice.tolist(), seeds.tolist()):
        if ch == NOISE:
            out.append(_noise(x, int(seed), cfg.noise_sigma))
        elif ch == BLUR:
            out.append(_blur(x, cfg.blur_kernel))
        elif ch == LOWRES:
            out.append(_lowres(x))
        else:
            out.append(x.clone())
    return torch.stack(out)


def draw_choice(n: int, generator: torch.Generator,
                cfg: CorruptionConfig = CorruptionConfig()
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-image (choice, seed), int32 on the generator's device: clean
    with probability 1 - cfg.prob, else uniform over noise/blur/lowres;
    seeds uniform in [0, 2^30)."""
    dev = generator.device
    apply = torch.rand(n, generator=generator, device=dev) < cfg.prob
    choice3 = torch.randint(NOISE, LOWRES + 1, (n,), generator=generator,
                            device=dev)
    choice = torch.where(apply, choice3, torch.full_like(choice3, CLEAN))
    seeds = torch.randint(0, 2 ** 30, (n,), generator=generator, device=dev)
    return choice.to(torch.int32), seeds.to(torch.int32)


def _check(img, choice, seeds, cfg) -> None:
    if img.dim() != 4 or img.dtype != torch.float32:
        raise ValueError(f"fused_random_corruption takes (B,H,W,C) float32, "
                         f"got {tuple(img.shape)} {img.dtype}")
    b, h, w, _ = img.shape
    if h % 2 or w % 2 or h < 8 or w < 8:
        raise ValueError(f"fused corruption needs even H, W >= 8, got "
                         f"{h}x{w}")
    if (cfg.blur_angle_deg % 360 != 0 or cfg.blur_kernel % 2 == 0
            or cfg.downscale_factor != 0.5):
        raise NotImplementedError("the fused corruption supports blur angle "
                                  "0 with an odd kernel and lowres 0.5x")
    if choice.shape != (b,) or seeds.shape != (b,):
        raise ValueError(f"choice and seeds must be ({b},)")
    if not img.is_contiguous():
        raise ValueError("fused_random_corruption takes a contiguous NHWC "
                         "batch")
    if img.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused_random_corruption runs on cpu or cuda, got "
                         f"{img.device}")


@functools.lru_cache(maxsize=64)
def _plan(b, h, w, c, blur_k, x_offset, y_offset):
    """(smem, vec) of :func:`kernels.corrupt_plan` for pointers whose
    16-byte offsets are given."""
    plan = kernels.corrupt_plan(b, h, w, c, blur_k, (x_offset, y_offset))
    return plan["smem"], plan["vec"]


def fused_random_corruption(img: torch.Tensor, generator: torch.Generator,
                            cfg: CorruptionConfig = CorruptionConfig(),
                            choice: Optional[torch.Tensor] = None,
                            seeds: Optional[torch.Tensor] = None
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Corrupt each image of img (B, H, W, C) f32 [0, 255], H and W even.
    choice / seeds ((B,) ints) are drawn from `generator` (on img's device)
    unless given. Returns (corrupted f32 batch, choice int32)."""
    b = img.shape[0]
    if choice is None or seeds is None:
        drawn_choice, drawn_seeds = draw_choice(b, generator, cfg)
        choice = drawn_choice if choice is None else choice
        seeds = drawn_seeds if seeds is None else seeds
    choice = torch.as_tensor(choice, device=img.device).to(torch.int32)
    seeds = torch.as_tensor(seeds, device=img.device).to(torch.int32)
    _check(img, choice, seeds, cfg)
    if img.device.type == "cpu":
        return fused_corruption_reference(img, choice, seeds, cfg), choice
    return _corrupt_cuda(img, choice, seeds, cfg), choice


def _corrupt_cuda(img, choice, seeds, cfg) -> torch.Tensor:
    """One launch of K1 on a checked call."""
    b, h, w, c = img.shape
    out = torch.empty_like(img)
    choice, seeds = choice.contiguous(), seeds.contiguous()
    smem, vec = _plan(b, h, w, c, cfg.blur_kernel, img.data_ptr() % 16,
                      out.data_ptr() % 16)
    err = kernels.launch(img.device, "corrupt_nhwc", img.data_ptr(),
                         out.data_ptr(), choice.data_ptr(), seeds.data_ptr(),
                         b, h, w, c, float(cfg.noise_sigma), cfg.blur_kernel,
                         float(np.float32(1.0 / cfg.blur_kernel)), smem, vec)
    kernels.check(err, "corrupt_nhwc")
    fused_random_corruption.launches += 1
    return out


fused_random_corruption.launches = 0
