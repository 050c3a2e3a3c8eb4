"""3x3 stride-1 SAME convolution, NHWC (counterpart of ops/pallas_conv.py).

:func:`conv3x3` is the port of ``conv3x3_planes`` (forward only). On a CUDA
tensor it launches the hand-written kernel of ``csrc/conv3x3.cu``; on a CPU
tensor it runs :func:`conv3x3_reference`, the plain PyTorch version, which
is also what the kernel is checked against on the card. Any other device,
dtype, layout or shape raises: there is no fallback.

The TPU kernel's planes layout (B, H, C, W) existed for TPU lane padding
only; both functions here take and return NHWC.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .. import kernels


def conv3x3_reference(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain version: x (B, H, W, Cin), w (3, 3, Cin, Cout) -> (B, H, W, Cout)."""
    y = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1), padding=1)
    return y.permute(0, 2, 3, 1).contiguous()


def _check(x: torch.Tensor, w: torch.Tensor) -> None:
    if x.dim() != 4 or w.dim() != 4 or tuple(w.shape[:2]) != (3, 3):
        raise ValueError(f"conv3x3 takes x (B,H,W,Cin) and w (3,3,Cin,Cout), "
                         f"got {tuple(x.shape)} and {tuple(w.shape)}")
    if w.shape[2] != x.shape[3]:
        raise ValueError(f"conv3x3: x has {x.shape[3]} channels, "
                         f"w expects {w.shape[2]}")
    if x.dtype not in (torch.float32, torch.bfloat16) or w.dtype != x.dtype:
        raise ValueError(f"conv3x3 takes float32 or bfloat16 x and w of the "
                         f"same dtype, got {x.dtype} and {w.dtype}")
    if x.device != w.device:
        raise ValueError(f"conv3x3: x on {x.device}, w on {w.device}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("conv3x3 takes contiguous NHWC x and HWIO w")


def conv3x3(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """3x3 stride-1 SAME conv, no bias: x (B, H, W, Cin) NHWC, w (3, 3, Cin,
    Cout) HWIO -> (B, H, W, Cout) in x's dtype, accumulated in f32."""
    _check(x, w)
    if x.device.type == "cpu":
        return conv3x3_reference(x, w)
    if x.device.type != "cuda":
        raise ValueError(f"conv3x3 runs on cpu or cuda, got {x.device}")
    b, h, wd, cin = x.shape
    cout = w.shape[3]
    y = torch.empty((b, h, wd, cout), dtype=x.dtype, device=x.device)
    lib = kernels.load()
    with torch.cuda.device(x.device):       # launch on x's card and stream
        err = lib.conv3x3_nhwc(x.data_ptr(), w.data_ptr(), y.data_ptr(), b,
                               h, wd, cin, cout, kernels.dtype_code(x.dtype),
                               kernels.stream_ptr(x.device))
    kernels.check(err, "conv3x3_nhwc")
    conv3x3.launches += 1
    return y


conv3x3.launches = 0
