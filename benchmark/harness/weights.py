"""Weights made from the seed, on the device, in one draw.

A family adapter gives the list of (name, shape, rule) of its model's
leaves; every "normal" leaf is a slice of one standard-normal draw on the
device, clamped at 2 and scaled (a truncated lecun normal, as the
program's own init), every "const" leaf a fill. Both the program and the
reference load the same tensors.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

from .traffic import sub_seed

LECUN_TRUNC = 0.87962566103423978   # std of a unit normal truncated at 2


def lecun_std(fan_in: int) -> float:
    return math.sqrt(1.0 / fan_in) / LECUN_TRUNC


def calibration_images(seed: int, device, n: int, h: int, w: int):
    """(n, h, w, 3) uniform images in [0, 1] from the seed, on `device`:
    what an eval model's running statistics are taken on."""
    import torch

    gen = torch.Generator(device).manual_seed(sub_seed(seed, "calibrate"))
    return torch.randint(0, 256, (n, h, w, 3), generator=gen,
                         device=device).float() / 255.0


def seeded_weights(spec: List[Tuple[str, tuple, tuple]], seed: int, device,
                   tag: str = "weights") -> Dict[str, "torch.Tensor"]:
    """{name: f32 tensor on `device`}; rules ("normal", std) or
    ("const", value)."""
    import torch

    n = sum(math.prod(shape) for _, shape, rule in spec
            if rule[0] == "normal")
    gen = torch.Generator(device).manual_seed(sub_seed(seed, tag))
    flat = torch.randn(n, generator=gen, device=device).clamp_(-2.0, 2.0)
    out, at = {}, 0
    for name, shape, rule in spec:
        if rule[0] == "normal":
            k = math.prod(shape)
            out[name] = flat[at:at + k].view(shape) * rule[1]
            at += k
        else:
            out[name] = torch.full(shape, float(rule[1]), device=device)
    return out


def load_into(model, weights: Dict[str, "torch.Tensor"]) -> None:
    """Copy `weights` into `model`'s parameters and buffers of the same
    names (cast to each one's dtype); every trainable parameter must be
    given."""
    import torch

    params = dict(model.named_parameters())
    missing = [n for n, p in params.items()
               if p.requires_grad and n not in weights]
    params.update(model.named_buffers())
    extra = [n for n in weights if n not in params]
    if missing or extra:
        raise KeyError(f"weights do not fit the model: missing {missing[:5]}"
                       f", extra {extra[:5]}")
    with torch.no_grad():
        for name, w in weights.items():
            params[name].copy_(w)
