"""The precision a reference computes its products in.

A reference runs in float32 with TF32 off (``exact``). Its control, the
step below the precision a configuration states, rounds every tensor a
convolution reads or writes: to float8 e4m3 with one scale a tensor (amax
to 448) below bfloat16, to bfloat16 below TF32. The rounding applies to
the gradients too (the backward's products read rounded output gradients
and write rounded input gradients), as a training step in that precision
would.
"""

from __future__ import annotations

import contextlib

import torch

# the control of each precision a configuration states
BELOW = {"bfloat16": "float8_e4m3", "tf32": "bfloat16"}


def _fp8(t: torch.Tensor) -> torch.Tensor:
    amax = t.detach().abs().amax().float().clamp(min=1e-12)
    scale = 448.0 / amax
    q = (t.detach().float() * scale).to(torch.float8_e4m3fn).float() / scale
    return q.to(t.dtype)


def _bf16(t: torch.Tensor) -> torch.Tensor:
    return t.detach().to(torch.bfloat16).to(t.dtype)


ROUNDERS = {"float8_e4m3": _fp8, "bfloat16": _bf16}


class _Round(torch.autograd.Function):
    """Rounds the value forward and its gradient backward."""

    @staticmethod
    def forward(ctx, t, precision):
        ctx.precision = precision
        return ROUNDERS[precision](t)

    @staticmethod
    def backward(ctx, g):
        return ROUNDERS[ctx.precision](g), None


def operand(t: torch.Tensor, precision: str) -> torch.Tensor:
    """`t` as a product's operand or result in `precision` ("exact": as
    is)."""
    if precision == "exact":
        return t
    return _Round.apply(t, precision)


@contextlib.contextmanager
def exact_float32():
    """TF32 off for cuDNN and cuBLAS while a reference runs."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved
