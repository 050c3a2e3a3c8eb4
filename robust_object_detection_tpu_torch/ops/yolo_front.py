"""YOLOv8 P1/P2 front in eval mode, NHWC (counterpart of
ops/pallas_yolo_front.py ``front_fused_inference``).

:func:`front_inference` runs Conv3x3/2 (3 -> C1) + BN1 (running stats) +
SiLU, then Conv3x3/2 (C1 -> C2), and returns the P2 output BEFORE BN2; the
caller applies BN2 + SiLU, as models/yolov8.py does. On a CUDA tensor it
launches the two kernels of ``csrc/yolo_front.cu``; on a CPU tensor it runs
:func:`front_inference_reference`, the plain PyTorch version. Any other
device, dtype, layout or shape raises.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

from .. import kernels

EPS = 1e-3   # flax BatchNorm epsilon (pallas_stem.EPS)


def fold_bn(scale, bias, mean, var) -> Tuple[torch.Tensor, torch.Tensor]:
    """Eval BN as y*g + b, in f32 (pallas_stem._fold_bn)."""
    g = scale.float() * torch.rsqrt(var.float() + EPS)
    return g, bias.float() - mean.float() * g


def front_inference_reference(x, k1, sc1, bi1, k2, means: Sequence,
                              variances: Sequence) -> torch.Tensor:
    """Plain version: x (B, H, W, 3) -> y2 (B, H/4, W/4, C2), pre-BN2."""
    g1, b1 = fold_bn(sc1, bi1, means[0], variances[0])
    y1 = F.conv2d(x.permute(0, 3, 1, 2), k1.permute(3, 2, 0, 1), stride=2,
                  padding=1)
    a1 = F.silu(y1.float() * g1[:, None, None] + b1[:, None, None])
    y2 = F.conv2d(a1.to(x.dtype), k2.permute(3, 2, 0, 1), stride=2,
                  padding=1)
    return y2.permute(0, 2, 3, 1).contiguous()


def _check(x, k1, sc1, bi1, k2, means, variances) -> None:
    if x.dim() != 4 or x.shape[3] != 3:
        raise ValueError(f"front_inference takes x (B,H,W,3), got "
                         f"{tuple(x.shape)}")
    if x.shape[1] % 2 or x.shape[2] % 2:
        raise ValueError(f"front_inference needs even H and W, got "
                         f"{x.shape[1]}x{x.shape[2]}")
    c1 = k1.shape[-1]
    if (k1.dim() != 4 or tuple(k1.shape[:3]) != (3, 3, 3) or k2.dim() != 4
            or tuple(k2.shape[:3]) != (3, 3, c1)):
        raise ValueError(f"front_inference takes k1 (3,3,3,C1) and k2 "
                         f"(3,3,C1,C2), got {tuple(k1.shape)} and "
                         f"{tuple(k2.shape)}")
    vecs = (sc1, bi1, means[0], variances[0])
    if any(v.shape != (c1,) for v in vecs):
        raise ValueError(f"front_inference: BN1 vectors must be ({c1},)")
    if (x.dtype not in (torch.float32, torch.bfloat16)
            or k1.dtype != x.dtype or k2.dtype != x.dtype):
        raise ValueError(f"front_inference takes float32 or bfloat16 x, k1, "
                         f"k2 of one dtype, got {x.dtype}, {k1.dtype}, "
                         f"{k2.dtype}")
    if any(t.device != x.device for t in (k1, k2, *vecs)):
        raise ValueError("front_inference: all tensors must be on x's device")
    if not (x.is_contiguous() and k1.is_contiguous() and k2.is_contiguous()):
        raise ValueError("front_inference takes contiguous NHWC x and HWIO "
                         "filters")


def front_inference(x, k1, sc1, bi1, k2, means: Sequence,
                    variances: Sequence) -> torch.Tensor:
    """x (B, H, W, 3) in x's working dtype (f32 or bf16), k1 (3, 3, 3, C1),
    k2 (3, 3, C1, C2) HWIO in the same dtype; sc1, bi1 the BN1 affine;
    means/variances the running stats (BN1, BN2) — only BN1's are used
    here. Returns y2 (B, ceil(H/4), ceil(W/4), C2) before BN2, in x's
    dtype."""
    _check(x, k1, sc1, bi1, k2, means, variances)
    if x.device.type == "cpu":
        return front_inference_reference(x, k1, sc1, bi1, k2, means,
                                         variances)
    if x.device.type != "cuda":
        raise ValueError(f"front_inference runs on cpu or cuda, got "
                         f"{x.device}")
    b, h, w, _ = x.shape
    c1, c2 = k1.shape[3], k2.shape[3]
    g1, b1 = (t.contiguous() for t in fold_bn(sc1, bi1, means[0],
                                                variances[0]))
    h2, w2 = h // 2, w // 2
    h4, w4 = (h2 + 1) // 2, (w2 + 1) // 2    # stride 2, pad 1, kernel 3
    a1 = torch.empty((b, h2, w2, c1), dtype=x.dtype, device=x.device)
    y2 = torch.empty((b, h4, w4, c2), dtype=x.dtype, device=x.device)
    lib = kernels.load()
    with torch.cuda.device(x.device):       # launch on x's card and stream
        err = lib.yolo_front_nhwc(x.data_ptr(), k1.data_ptr(),
                                  g1.data_ptr(), b1.data_ptr(),
                                  k2.data_ptr(), a1.data_ptr(),
                                  y2.data_ptr(), b, h, w, c1, c2,
                                  kernels.dtype_code(x.dtype),
                                  kernels.stream_ptr(x.device))
    kernels.check(err, "yolo_front_nhwc")
    front_inference.launches += 1
    return y2


front_inference.launches = 0
