"""HGNetv2 stem, image to stem3's output, NHWC, eval mode (counterpart of
ops/pallas_stem.py ``stem_fused_inference``).

    stem1  conv3x3/2 3 -> cm, BN + ReLU                       -> a1
    stem2a conv2x2 (zero pad right/bottom) cm -> cm/2, BN + ReLU
    stem2b conv2x2 (same padding) cm/2 -> cm, BN + ReLU       -> a2b
    pool   2x2 stride-1 max of a1, zero pad right/bottom (the ceil-mode
           pool, since a1 >= 0)
    stem3  conv3x3/2 on [pool, a2b], 2 cm -> cm, returned BEFORE BN3

The caller applies BN3 + ReLU and the 1x1 stem4, as models/rtdetr.HGStem
does after the TPU kernel. Every BN here is the affine fold of the running
statistics (eps 1e-3), computed in f32.

:func:`stem_fused_inference` launches ``hgstem_nhwc`` of ``csrc/hgstem.cu``
(K4-f) on a CUDA tensor and runs :func:`stem_reference`, the plain PyTorch
version, on a CPU tensor. Any other device, dtype, layout or shape raises:
there is no second route.

Rounding: both versions store a1, a2a, a2b (hence the concat) and y3 in
the working dtype and apply BN + ReLU in f32. The kernel applies BN + ReLU
to its f32 accumulator; the plain version to the conv's output in the
working dtype, one more rounding in bf16 and none in f32. The train mode
(batch statistics, the backward) is not ported yet.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F

from .. import kernels
from .yolo_front import fold_bn


def _conv(x, k, stride, padding):
    return F.conv2d(x, k.permute(3, 2, 0, 1), stride=stride, padding=padding)


def _bn_relu(y, g, b, dtype):
    return F.relu(y.float() * g[:, None, None] + b[:, None, None]).to(dtype)


def stem_reference(x, k1, sc1, bi1, k2a, sc2a, bi2a, k2b, sc2b, bi2b, k3,
                   means: Sequence, variances: Sequence) -> torch.Tensor:
    """Plain version: x (B, H, W, 3) -> y3 (B, H/4, W/4, cm), pre-BN3."""
    dtype = x.dtype
    folds = [fold_bn(sc, bi, means[i], variances[i]) for i, (sc, bi) in
             enumerate(((sc1, bi1), (sc2a, bi2a), (sc2b, bi2b)))]
    a1 = _bn_relu(_conv(x.permute(0, 3, 1, 2), k1, 2, 1), *folds[0], dtype)
    a2a = _bn_relu(_conv(F.pad(a1, (0, 1, 0, 1)), k2a, 1, 0), *folds[1],
                   dtype)
    a2b = _bn_relu(_conv(F.pad(a2a, (0, 1, 0, 1)), k2b, 1, 0), *folds[2],
                   dtype)
    ap = F.pad(a1, (0, 1, 0, 1))
    pool = torch.maximum(torch.maximum(ap[:, :, :-1, :-1], ap[:, :, 1:, :-1]),
                         torch.maximum(ap[:, :, :-1, 1:], ap[:, :, 1:, 1:]))
    y3 = _conv(torch.cat([pool, a2b], 1), k3, 2, 1)
    return y3.permute(0, 2, 3, 1).contiguous()


def _check(x, k1, k2a, k2b, k3, vecs, means, variances) -> None:
    if x.dim() != 4 or x.shape[3] != 3:
        raise ValueError(f"stem takes x (B,H,W,3), got {tuple(x.shape)}")
    if x.shape[1] % 4 or x.shape[2] % 4 or 0 in x.shape:
        raise ValueError(f"stem needs H and W multiples of 4, got "
                         f"{x.shape[1]}x{x.shape[2]}")
    cm = k1.shape[-1]
    want = ((3, 3, 3, cm), (2, 2, cm, cm // 2), (2, 2, cm // 2, cm),
            (3, 3, 2 * cm, cm))
    got = tuple(tuple(k.shape) for k in (k1, k2a, k2b, k3))
    if cm % 2 or got != want:
        raise ValueError(f"stem takes HWIO filters {want}, got {got}")
    if len(means) < 3 or len(variances) < 3:
        raise ValueError("stem takes the running statistics of BN1, BN2a "
                         "and BN2b (BN3's are the caller's)")
    sizes = (cm, cm, cm // 2, cm // 2, cm, cm)
    stats = (means[0], variances[0], means[1], variances[1], means[2],
             variances[2])
    if (any(v.shape != (c,) for v, c in zip(vecs, sizes))
            or any(v.shape != (c,) for v, c in zip(stats, sizes))):
        raise ValueError("stem: BN vectors do not match the filters")
    kers = (k1, k2a, k2b, k3)
    if (x.dtype not in (torch.float32, torch.bfloat16)
            or any(k.dtype != x.dtype for k in kers)):
        raise ValueError(f"stem takes float32 or bfloat16 x and filters of "
                         f"one dtype, got {x.dtype} and "
                         f"{[k.dtype for k in kers]}")
    if any(t.device != x.device for t in (*kers, *vecs, *stats)):
        raise ValueError("stem: all tensors must be on x's device")
    if not (x.is_contiguous() and all(k.is_contiguous() for k in kers)):
        raise ValueError("stem takes contiguous NHWC x and HWIO filters")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"stem runs on cpu or cuda, got {x.device}")


def stem_fused_inference(x, k1, sc1, bi1, k2a, sc2a, bi2a, k2b, sc2b, bi2b,
                         k3, means: Sequence,
                         variances: Sequence) -> torch.Tensor:
    """x (B, H, W, 3) in [0, 1] in the working dtype (f32 or bf16), H and W
    multiples of 4; k1 (3, 3, 3, cm), k2a (2, 2, cm, cm/2), k2b (2, 2, cm/2,
    cm), k3 (3, 3, 2 cm, cm) HWIO in the same dtype; sc*/bi* the BN affines;
    means / variances the running statistics of (BN1, BN2a, BN2b[, BN3]).
    Returns y3 (B, H/4, W/4, cm) before BN3, in x's dtype. The kernel is
    built for cm = 32 (HGNetv2-L)."""
    vecs = (sc1, bi1, sc2a, bi2a, sc2b, bi2b)
    _check(x, k1, k2a, k2b, k3, vecs, means, variances)
    if x.device.type == "cpu":
        return stem_reference(x, k1, sc1, bi1, k2a, sc2a, bi2a, k2b, sc2b,
                              bi2b, k3, means, variances)
    cm = k1.shape[-1]
    if cm != 32:
        raise ValueError(f"the stem kernel is built for cm = 32, got {cm}")
    b, h, w, _ = x.shape
    folds = [t.contiguous() for i, (sc, bi) in
             enumerate(((sc1, bi1), (sc2a, bi2a), (sc2b, bi2b)))
             for t in fold_bn(sc, bi, means[i], variances[i])]
    g1, b1, g2a, b2a, g2b, b2b = folds

    def scratch(c):
        return torch.empty((b, h // 2, w // 2, c), dtype=x.dtype,
                           device=x.device)

    a1, a2a, cat = scratch(cm), scratch(cm // 2), scratch(2 * cm)
    y3 = torch.empty((b, h // 4, w // 4, cm), dtype=x.dtype, device=x.device)
    lib = kernels.load()
    with torch.cuda.device(x.device):       # launch on x's card and stream
        err = lib.hgstem_nhwc(
            x.data_ptr(), k1.data_ptr(), g1.data_ptr(), b1.data_ptr(),
            k2a.data_ptr(), g2a.data_ptr(), b2a.data_ptr(), k2b.data_ptr(),
            g2b.data_ptr(), b2b.data_ptr(), k3.data_ptr(), a1.data_ptr(),
            a2a.data_ptr(), cat.data_ptr(), y3.data_ptr(), b, h, w,
            kernels.dtype_code(x.dtype), kernels.stream_ptr(x.device))
    kernels.check(err, "hgstem_nhwc")
    stem_fused_inference.launches += 1
    return y3


stem_fused_inference.launches = 0
