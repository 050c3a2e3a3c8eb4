"""YOLOv8 P1/P2 front, NHWC (counterpart of ops/pallas_yolo_front.py).

Both modes run Conv3x3/2 (3 -> C1) + BN1 + SiLU, then Conv3x3/2 (C1 ->
C2), and return the P2 output BEFORE BN2; the caller applies BN2 + SiLU,
as models/yolov8.py does.

  * :func:`front_inference` (``front_fused_inference``): BN1 from the
    running statistics. On a CUDA tensor it launches K2-f, eval
    (``csrc/yolo_front.cu``).
  * :func:`front_fused` (``front_fused``, train): BN1 from the batch
    statistics; returns ``(y2, mean1, var1, mean2, var2)``, the batch
    statistics of the stored (rounded) y1 and y2, so the caller applies
    BN2 and updates the running statistics. On a CUDA tensor it is a
    ``torch.autograd.Function``: forward K2-f, train, backward
    :func:`front_fused_backward` (``csrc/yolo_front_bwd.cu``, K2-b).

Each kernel has two routes, by dtype: bf16 runs the tensor-core implicit
GEMMs of ``csrc/front_tc.cuh`` (``yolo_front_tc_nhwc``,
``yolo_front_train_tc_nhwc``, ``yolo_front_bwd_tc_nhwc``) with a launch
plan computed in Python (``kernels.front_plan``,
``kernels.front_bwd_plan``: persistent blocks, which fix the number of
statistics partials the wrapper allocates, pixel chunks, 16-byte or
element staging), which the CPU tests hold; f32 runs the CUDA-core tiles
of ``csrc/conv_tile.cuh`` and ``csrc/conv_wgrad.cuh``.

On a CPU tensor each runs its plain PyTorch version
(:func:`front_inference_reference`, :func:`front_fused_reference`, whose
autograd is the plain backward). Any other device, dtype, layout or shape
raises.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

from .. import kernels

EPS = 1e-3   # flax BatchNorm epsilon (pallas_stem.EPS)


def batch_stats(y: torch.Tensor, dims) -> Tuple[torch.Tensor, torch.Tensor]:
    """flax train-mode BatchNorm statistics: f32 mean and fast variance
    E[y^2] - E[y]^2 clamped at 0 (flax ``_compute_stats``)."""
    yf = y.float()
    mean = yf.mean(dims)
    return mean, torch.clamp((yf * yf).mean(dims) - mean * mean, min=0.0)


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
    args = (x.data_ptr(), k1.data_ptr(), g1.data_ptr(), b1.data_ptr(),
            k2.data_ptr(), a1.data_ptr(), y2.data_ptr(), b, h, w, c1, c2)
    lib = kernels.load()
    with torch.cuda.device(x.device):       # launch on x's card and stream
        stream = kernels.stream_ptr(x.device)
        if x.dtype == torch.bfloat16:
            plan = kernels.front_plan(b, h, w, c1, c2, (args[0], args[1],
                                                        args[4]),
                                      kernels.sm_count(x.device))
            name = "yolo_front_tc_nhwc"
            err = lib.yolo_front_tc_nhwc(
                *args, plan["p1"]["blocks"], plan["p2"]["blocks"],
                plan["p1"]["vec"], plan["p2"]["vec"], stream)
        else:
            name = "yolo_front_nhwc"
            err = lib.yolo_front_nhwc(*args, kernels.DTYPE_F32, stream)
    kernels.check(err, name)
    front_inference.launches += 1
    return y2


front_inference.launches = 0


# ── train mode ───────────────────────────────────────────────────────────

def front_fused_reference(x, k1, sc1, bi1, k2):
    """Plain version of the train-mode front: x (B, H, W, 3) in the working
    dtype -> (y2 (B, H/4, W/4, C2) pre-BN2 in that dtype, mean1, var1,
    mean2, var2 f32). y1 and y2 are rounded to the working dtype and their
    statistics are those of the rounded values; a1 = silu(g1 y1 + b1) is
    rounded too, as in the TPU kernels. Differentiable by autograd."""
    dtype = x.dtype
    y1 = F.conv2d(x.permute(0, 3, 1, 2), k1.to(dtype).permute(3, 2, 0, 1),
                  stride=2, padding=1).to(dtype)
    mean1, var1 = batch_stats(y1, (0, 2, 3))
    g1, b1 = fold_bn(sc1, bi1, mean1, var1)
    a1 = F.silu(y1.float() * g1[:, None, None] + b1[:, None, None])
    y2 = F.conv2d(a1.to(dtype), k2.to(dtype).permute(3, 2, 0, 1), stride=2,
                  padding=1).to(dtype)
    mean2, var2 = batch_stats(y2, (0, 2, 3))
    return y2.permute(0, 2, 3, 1).contiguous(), mean1, var1, mean2, var2


def _check_train(x, k1, sc1, bi1, k2) -> None:
    if x.dim() != 4 or x.shape[3] != 3:
        raise ValueError(f"front_fused takes x (B,H,W,3), got "
                         f"{tuple(x.shape)}")
    if x.shape[1] % 2 or x.shape[2] % 2:
        raise ValueError(f"front_fused needs even H and W, got "
                         f"{x.shape[1]}x{x.shape[2]}")
    c1 = k1.shape[-1]
    if (k1.dim() != 4 or tuple(k1.shape[:3]) != (3, 3, 3) or k2.dim() != 4
            or tuple(k2.shape[:3]) != (3, 3, c1)):
        raise ValueError(f"front_fused takes k1 (3,3,3,C1) and k2 "
                         f"(3,3,C1,C2), got {tuple(k1.shape)} and "
                         f"{tuple(k2.shape)}")
    if sc1.shape != (c1,) or bi1.shape != (c1,):
        raise ValueError(f"front_fused: BN1 vectors must be ({c1},)")
    if (x.dtype not in (torch.float32, torch.bfloat16)
            or k1.dtype not in (x.dtype, torch.float32)
            or k2.dtype not in (x.dtype, torch.float32)
            or not (sc1.is_floating_point() and bi1.is_floating_point())):
        raise ValueError(f"front_fused takes float32 or bfloat16 x and "
                         f"filters of x's dtype or float32, got {x.dtype}, "
                         f"{k1.dtype}, {k2.dtype}")
    if any(t.device != x.device for t in (k1, k2, sc1, bi1)):
        raise ValueError("front_fused: all tensors must be on x's device")
    if not (x.is_contiguous() and k1.is_contiguous() and k2.is_contiguous()):
        raise ValueError("front_fused takes contiguous NHWC x and HWIO "
                         "filters")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"front_fused runs on cpu or cuda, got {x.device}")


def _f32(t: torch.Tensor) -> torch.Tensor:
    return t.float().contiguous()


class _FrontFused(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, k1, sc1, bi1, k2):
        b, h, w, _ = x.shape
        c1, c2 = k1.shape[3], k2.shape[3]
        h2, w2 = h // 2, w // 2
        h4, w4 = (h2 + 1) // 2, (w2 + 1) // 2
        dev, dtype = x.device, x.dtype
        k1d = k1.to(dtype).contiguous()
        k2d = k2.to(dtype).contiguous()
        sc1f, bi1f = _f32(sc1), _f32(bi1)
        y1 = torch.empty((b, h2, w2, c1), dtype=dtype, device=dev)
        y2 = torch.empty((b, h4, w4, c2), dtype=dtype, device=dev)
        bf16 = dtype == torch.bfloat16
        if bf16:        # one partial row per persistent block
            plan = kernels.front_plan(
                b, h, w, c1, c2, (x.data_ptr(), k1d.data_ptr(),
                                  k2d.data_ptr()), kernels.sm_count(dev))
            p1, p2 = plan["p1"]["blocks"], plan["p2"]["blocks"]
        else:           # one partial row per image and 16 x 16 tile
            p1 = b * kernels.tile_count(h2, w2)
            p2 = b * kernels.tile_count(h4, w4)
        st1 = torch.empty(2 * p1 * c1, dtype=torch.float32, device=dev)
        st2 = torch.empty(2 * p2 * c2, dtype=torch.float32, device=dev)
        mean1, var1, g1, b1 = (torch.empty(c1, device=dev) for _ in range(4))
        mean2, var2 = (torch.empty(c2, device=dev) for _ in range(2))
        args = (x.data_ptr(), k1d.data_ptr(), sc1f.data_ptr(),
                bi1f.data_ptr(), k2d.data_ptr(), y1.data_ptr(),
                y2.data_ptr(), st1.data_ptr(), st2.data_ptr(),
                mean1.data_ptr(), var1.data_ptr(), g1.data_ptr(),
                b1.data_ptr(), mean2.data_ptr(), var2.data_ptr(), b, h, w,
                c1, c2)
        lib = kernels.load()
        with torch.cuda.device(dev):
            stream = kernels.stream_ptr(dev)
            if bf16:
                name = "yolo_front_train_tc_nhwc"
                err = lib.yolo_front_train_tc_nhwc(
                    *args, p1, p2, plan["p1"]["vec"], plan["p2"]["vec"],
                    stream)
            else:
                name = "yolo_front_train_nhwc"
                err = lib.yolo_front_train_nhwc(*args, kernels.DTYPE_F32,
                                                stream)
        kernels.check(err, name)
        front_fused.launches += 1
        ctx.save_for_backward(x, k2d, y1, y2, sc1f, mean1, var1, g1, b1,
                              mean2)
        ctx.dtypes = (k1.dtype, sc1.dtype, bi1.dtype, k2.dtype)
        return y2, mean1, var1, mean2, var2

    @staticmethod
    def backward(ctx, dy2, dmean1, dvar1, dmean2, dvar2):
        dk1, dsc1, dbi1, dk2 = front_fused_backward(
            *ctx.saved_tensors, dy2, dmean1, dvar1, dmean2, dvar2)
        t_k1, t_sc1, t_bi1, t_k2 = ctx.dtypes
        return (None, dk1.to(t_k1), dsc1.to(t_sc1), dbi1.to(t_bi1),
                dk2.to(t_k2))


def front_fused(x, k1, sc1, bi1, k2):
    """Train-mode front: x (B, H, W, 3) in the working dtype (f32 or bf16),
    k1 (3, 3, 3, C1) and k2 (3, 3, C1, C2) HWIO in that dtype or f32 (a
    trainer's master weights, cast for the convs), sc1, bi1 the BN1 affine.
    Returns (y2 (B, H/4, W/4, C2) before BN2 in the working dtype, mean1,
    var1, mean2, var2 f32 batch statistics). Differentiable in k1, sc1,
    bi1, k2 and through all five outputs; no gradient reaches x (the
    image)."""
    _check_train(x, k1, sc1, bi1, k2)
    if x.device.type == "cpu":
        return front_fused_reference(x, k1, sc1, bi1, k2)
    return _FrontFused.apply(x, k1, sc1, bi1, k2)


front_fused.launches = 0


def front_fused_backward(x, k2, y1, y2, sc1, mean1, var1, g1, b1, mean2,
                         dy2, dmean1, dvar1, dmean2, dvar2):
    """K2-b on the card: the saved forward tensors of :func:`front_fused`
    (x, k2 in the working dtype; y1, y2; f32 sc1, mean1, var1, the fold
    g1, b1, and mean2) and the cotangents of its five outputs -> (dk1
    (3,3,3,C1), dsc1, dbi1, dk2 (3,3,C1,C2)), all f32. CUDA tensors only:
    on the CPU the backward of :func:`front_fused` is the autograd of
    :func:`front_fused_reference`."""
    if x.device.type != "cuda":
        raise ValueError(f"front_fused_backward launches K2-b on a CUDA "
                         f"card, got {x.device}")
    grads = _launch_backward(x, k2, y1, y2, sc1, mean1, var1, g1, b1, mean2,
                             dy2, dmean1, dvar1, dmean2, dvar2)
    front_fused_backward.launches += 1
    return grads


def _launch_backward(x, k2, y1, y2, sc1, mean1, var1, g1, b1, mean2, dy2,
                     dmean1, dvar1, dmean2, dvar2):
    """Scratch, outputs and the launch of K2-b (bf16: its plan's partial
    counts size gpart and wpart); the body of :func:`front_fused_backward`."""
    b, h, w, _ = x.shape
    _, h2, w2, c1 = y1.shape
    c2 = y2.shape[3]
    dev, dtype = x.device, x.dtype
    dy2 = dy2.to(dtype).contiguous()
    dmean1, dvar1, dmean2, dvar2 = (_f32(t) for t in (dmean1, dvar1, dmean2,
                                                      dvar2))
    bf16 = dtype == torch.bfloat16
    if bf16:
        plan = kernels.front_bwd_plan(
            b, h, w, c1, c2, (x.data_ptr(), k2.data_ptr(), y1.data_ptr(),
                              y2.data_ptr(), dy2.data_ptr()),
            kernels.sm_count(dev))
        p, chunks1, chunks2 = (plan["da_blocks"], plan["dk1_chunks"],
                               plan["dk2_chunks"])
    else:
        p = b * kernels.tile_count(h2, w2)
        chunks1 = kernels.wgrad_chunks(3, c1)
        chunks2 = kernels.wgrad_chunks(c1, c2)
    dy1 = torch.empty_like(y1)
    gpart = torch.empty(2 * p * c1, dtype=torch.float32, device=dev)
    wpart = torch.empty(max(chunks1 * 27 * c1, chunks2 * 9 * c1 * c2),
                        dtype=torch.float32, device=dev)
    vecs = torch.empty(2 * c2 + 4 * c1, dtype=torch.float32, device=dev)
    dk1 = torch.empty((3, 3, 3, c1), dtype=torch.float32, device=dev)
    dk2 = torch.empty((3, 3, c1, c2), dtype=torch.float32, device=dev)
    dsc1, dbi1 = torch.empty(c1, device=dev), torch.empty(c1, device=dev)
    head = [t.data_ptr() for t in (x, k2, y1, y2, dy2, sc1, mean1, var1,
                                   g1, b1, mean2, dmean1, dvar1, dmean2,
                                   dvar2, dy1)]
    tail = [t.data_ptr() for t in (gpart, wpart, vecs, dk1, dk2, dsc1,
                                   dbi1)] + [b, h, w, c1, c2]
    lib = kernels.load()
    with torch.cuda.device(dev):
        stream = kernels.stream_ptr(dev)
        if bf16:
            e2 = torch.empty_like(y2)   # dy2 with the BN2 stats fold
            name = "yolo_front_bwd_tc_nhwc"
            err = lib.yolo_front_bwd_tc_nhwc(
                *head, e2.data_ptr(), *tail, p, chunks2, chunks1,
                plan["vec"], plan["vec_x"], stream)
        else:
            name = "yolo_front_bwd_nhwc"
            err = lib.yolo_front_bwd_nhwc(*head, *tail, chunks1, chunks2,
                                          kernels.DTYPE_F32, stream)
    kernels.check(err, name)
    return dk1, dsc1, dbi1, dk2


front_fused_backward.launches = 0
