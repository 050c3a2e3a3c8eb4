"""HGNetv2 stem, image to stem3's output, NHWC, eval and train mode
(counterpart of ops/pallas_stem.py ``stem_fused_inference`` and
``stem_fused``).

    stem1  conv3x3/2 3 -> cm, BN + ReLU                       -> a1
    stem2a conv2x2 (zero pad right/bottom) cm -> cm/2, BN + ReLU
    stem2b conv2x2 (same padding) cm/2 -> cm, BN + ReLU       -> a2b
    pool   2x2 stride-1 max of a1, zero pad right/bottom (the ceil-mode
           pool, since a1 >= 0)
    stem3  conv3x3/2 on [pool, a2b], 2 cm -> cm, returned BEFORE BN3

The caller applies BN3 + ReLU and the 1x1 stem4, as models/rtdetr.HGStem
does after the TPU kernel. Every BN here is the affine fold of the running
statistics (eps 1e-3), computed in f32.

:func:`stem_fused_inference` launches K4-f (``csrc/hgstem.cu``) on a CUDA
tensor and runs :func:`stem_reference`, the plain PyTorch version, on a CPU
tensor. Any other device, dtype, layout or shape raises.

Each kernel has two routes, by dtype, both tensor-core implicit GEMMs
with a launch plan computed in Python (``kernels.stem_plan``,
``kernels.stem_bwd_plan`` and their ``kernels.STEM_ROUTES``: persistent
blocks, which fix the number of statistics and dgamma / dbeta partials the
wrapper allocates, pixel chunks, 16-byte or element staging), which the
CPU tests hold: bf16 runs ``csrc/front_tc.cuh`` and ``csrc/stem_tc.cuh``
(``hgstem_tc_nhwc``, ``hgstem_train_tc_nhwc``, ``hgstem_bwd_tc_nhwc``), f32
the split-TF32 kernels of ``csrc/front_tf32.cuh`` and
``csrc/stem_tf32.cuh`` (``hgstem_tf32_nhwc``, ``hgstem_train_tf32_nhwc``,
``hgstem_bwd_tf32_nhwc``). A build or launch failure raises; no route gives
way to another or to the plain version.

Rounding: both versions store a1, a2a, a2b (hence the concat) and y3 in
the working dtype and apply BN + ReLU in f32. The kernel applies BN + ReLU
to its f32 accumulator; the plain version to the conv's output in the
working dtype, one more rounding in bf16 and none in f32.

Train mode, :func:`stem_fused`: every BN uses its batch statistics (flax's
f32 mean and clamped fast variance of the stored, rounded conv output) and
the function returns ``(y3, means, variances)`` of the four convs, y3 still
before BN3, so the caller normalises y3 and updates the running statistics.
On a CUDA tensor it is a ``torch.autograd.Function``: forward
K4-f in train mode, backward :func:`stem_fused_backward`
(``csrc/hgstem_bwd.cu``, K4-b). On a CPU tensor it runs
:func:`stem_train_reference`, whose backward is autograd.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F

from .. import kernels
from ..parallel.mesh import kernel_sync, mean_over_data
from .yolo_front import EPS, _f32, batch_stats, fold_bn  # noqa: F401 (EPS)


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


def _check(x, k1, k2a, k2b, k3, vecs, masters: bool = False) -> None:
    """What both modes ask of x, the filters and the six BN affine vectors.
    masters: the filters may also be float32 whatever x's dtype (a
    trainer's master weights)."""
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
    sizes = (cm, cm, cm // 2, cm // 2, cm, cm)
    if any(v.shape != (c,) or not v.is_floating_point()
           for v, c in zip(vecs, sizes)):
        raise ValueError("stem: BN vectors do not match the filters")
    kers = (k1, k2a, k2b, k3)
    ok = (x.dtype, torch.float32) if masters else (x.dtype,)
    if (x.dtype not in (torch.float32, torch.bfloat16)
            or any(k.dtype not in ok for k in kers)):
        want = "that dtype or float32" if masters else "one dtype"
        raise ValueError(f"stem takes float32 or bfloat16 x and filters of "
                         f"{want}, got {x.dtype} and "
                         f"{[k.dtype for k in kers]}")
    if any(t.device != x.device for t in (*kers, *vecs)):
        raise ValueError("stem: all tensors must be on x's device")
    if not (x.is_contiguous() and all(k.is_contiguous() for k in kers)):
        raise ValueError("stem takes contiguous NHWC x and HWIO filters")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"stem runs on cpu or cuda, got {x.device}")


def _check_stats(x, cm, means, variances) -> None:
    if len(means) < 3 or len(variances) < 3:
        raise ValueError("stem takes the running statistics of BN1, BN2a "
                         "and BN2b (BN3's are the caller's)")
    sizes = (cm, cm, cm // 2, cm // 2, cm, cm)
    stats = (means[0], variances[0], means[1], variances[1], means[2],
             variances[2])
    if any(v.shape != (c,) or v.device != x.device
           for v, c in zip(stats, sizes)):
        raise ValueError("stem: BN vectors do not match the filters")


def _plan_args(plan):
    """The blocks, then the vec flags, of stem1, stem2a, stem2b and stem3
    in a :func:`kernels.stem_plan`."""
    convs = ("p1", "c2a", "c2b", "p3")
    return ([plan[c]["blocks"] for c in convs]
            + [plan[c]["vec"] for c in convs])


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
    _check(x, k1, k2a, k2b, k3, vecs)
    _check_stats(x, k1.shape[-1], means, variances)
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
    args = [t.data_ptr() for t in (x, k1, g1, b1, k2a, g2a, b2a, k2b, g2b,
                                   b2b, k3, a1, a2a, cat, y3)] + [b, h, w]
    dtype = str(x.dtype).split(".")[-1]
    plan = kernels.stem_plan(dtype, b, h, w, (args[0], args[1], args[4],
                                              args[7], args[10]),
                             kernels.sm_count(x.device))
    name = kernels.STEM_ROUTES[dtype]["eval"]
    lib = kernels.load()
    with torch.cuda.device(x.device):       # launch on x's card and stream
        err = getattr(lib, name)(*args, *_plan_args(plan),
                                 kernels.stream_ptr(x.device))
    kernels.check(err, name)
    stem_fused_inference.launches += 1
    return y3


stem_fused_inference.launches = 0


# ── train mode ───────────────────────────────────────────────────────────

def _pool2x2(a: torch.Tensor) -> torch.Tensor:
    """2x2 stride-1 max of a (B, C, H, W) with zero pad right/bottom, as
    max(max(left, right) of the upper row, max(left, right) of the lower
    row): ``torch.maximum`` splits a tie's gradient 0.5 / 0.5, the rule of
    the TPU kernel's backward."""
    ap = F.pad(a, (0, 1, 0, 1))
    return torch.maximum(
        torch.maximum(ap[:, :, :-1, :-1], ap[:, :, :-1, 1:]),
        torch.maximum(ap[:, :, 1:, :-1], ap[:, :, 1:, 1:]))


def stem_train_reference(x, k1, sc1, bi1, k2a, sc2a, bi2a, k2b, sc2b, bi2b,
                         k3):
    """Plain version of the train-mode stem: x (B, H, W, 3) in the working
    dtype -> (y3 (B, H/4, W/4, cm) pre-BN3 in that dtype, means, variances:
    4-tuples of f32 vectors for BN1, BN2a, BN2b, BN3). Every conv output is
    rounded to the working dtype and its statistics are those of the rounded
    values; every a = relu(g y + b) is rounded too, as in the kernels.
    Differentiable by autograd."""
    dtype = x.dtype

    def conv(a, k, stride, padding):
        return _conv(a, k.to(dtype), stride, padding).to(dtype)

    def bn_relu(y, sc, bi):
        mean, var = batch_stats(y, (0, 2, 3))
        g, b = fold_bn(sc, bi, mean, var)
        return _bn_relu(y, g, b, dtype), mean, var

    y1 = conv(x.permute(0, 3, 1, 2), k1, 2, 1)
    a1, mean1, var1 = bn_relu(y1, sc1, bi1)
    y2a = conv(F.pad(a1, (0, 1, 0, 1)), k2a, 1, 0)
    a2a, mean2a, var2a = bn_relu(y2a, sc2a, bi2a)
    y2b = conv(F.pad(a2a, (0, 1, 0, 1)), k2b, 1, 0)
    a2b, mean2b, var2b = bn_relu(y2b, sc2b, bi2b)
    y3 = conv(torch.cat([_pool2x2(a1), a2b], 1), k3, 2, 1)
    mean3, var3 = batch_stats(y3, (0, 2, 3))
    return (y3.permute(0, 2, 3, 1).contiguous(),
            (mean1, mean2a, mean2b, mean3), (var1, var2a, var2b, var3))


SLOT = 32     # floats per slot of the kernels' statistics buffers


class _StemFused(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, k1, sc1, bi1, k2a, sc2a, bi2a, k2b, sc2b, bi2b, k3):
        b, h, w, _ = x.shape
        dev, dtype = x.device, x.dtype
        cm = k1.shape[-1]
        kd = [k.to(dtype).contiguous() for k in (k1, k2a, k2b, k3)]
        vf = [_f32(v) for v in (sc1, bi1, sc2a, bi2a, sc2b, bi2b)]
        h2, w2 = h // 2, w // 2

        def half(c):
            return torch.empty((b, h2, w2, c), dtype=dtype, device=dev)

        y1, y2a, y2b, cat = half(cm), half(cm // 2), half(cm), half(2 * cm)
        y3 = torch.empty((b, h // 4, w // 4, cm), dtype=dtype, device=dev)
        route = str(dtype).split(".")[-1]
        # one partial row per persistent block of each conv
        plan = kernels.stem_plan(route, b, h, w, tuple(
            t.data_ptr() for t in (x, *kd)), kernels.sm_count(dev))
        stats = torch.empty(plan["stats"], dtype=torch.float32, device=dev)
        fvecs = torch.zeros((14, SLOT), dtype=torch.float32, device=dev)
        args = [t.data_ptr() for t in (
            x, kd[0], vf[0], vf[1], kd[1], vf[2], vf[3], kd[2], vf[4],
            vf[5], kd[3], y1, y2a, y2b, cat, y3, stats, fvecs)] + [b, h, w]
        # a data-parallel step averages each BN's batch sums over the
        # data group inside the launch (parallel/mesh.kernel_sync)
        sync_buf = torch.empty(2 * SLOT, dtype=torch.float32, device=dev)
        sync, keep = kernel_sync(sync_buf)
        name = kernels.STEM_ROUTES[route]["train"]
        lib = kernels.load()
        with torch.cuda.device(dev):
            err = getattr(lib, name)(*args, *_plan_args(plan), sync,
                                     sync_buf.data_ptr(),
                                     kernels.stream_ptr(dev))
        del keep
        kernels.check(err, name)
        stem_fused.launches += 1
        ctx.save_for_backward(x, y1, y2a, y2b, cat, y3, kd[1], kd[2], kd[3],
                              vf[0], vf[2], vf[4], fvecs)
        ctx.dtypes = tuple(t.dtype for t in (k1, sc1, bi1, k2a, sc2a, bi2a,
                                             k2b, sc2b, bi2b, k3))
        sizes = (cm, cm // 2, cm, cm)
        means = tuple(fvecs[4 * i if i < 3 else 12, :c].clone()
                      for i, c in enumerate(sizes))
        variances = tuple(fvecs[4 * i + 1 if i < 3 else 13, :c].clone()
                          for i, c in enumerate(sizes))
        return (y3, *means, *variances)

    @staticmethod
    def backward(ctx, dy3, *dstats):
        grads = stem_fused_backward(*ctx.saved_tensors, dy3, dstats[:4],
                                    dstats[4:])
        return (None, *(g.to(t) for g, t in zip(grads, ctx.dtypes)))


def stem_fused(x, k1, sc1, bi1, k2a, sc2a, bi2a, k2b, sc2b, bi2b, k3):
    """Train-mode stem: x (B, H, W, 3) in [0, 1] in the working dtype (f32
    or bf16), H and W multiples of 4; the HWIO filters in that dtype or f32
    (a trainer's master weights, cast for the convs); sc*, bi* the BN
    affines. Returns (y3 (B, H/4, W/4, cm) before BN3 in the working dtype,
    means, variances), 4-tuples of f32 batch statistics of BN1, BN2a, BN2b
    and BN3. Differentiable in the filters and affines and through all nine
    outputs; no gradient reaches x (the image). The kernels are built for
    cm = 32 (HGNetv2-L)."""
    vecs = (sc1, bi1, sc2a, bi2a, sc2b, bi2b)
    _check(x, k1, k2a, k2b, k3, vecs, masters=True)
    if x.device.type == "cpu":
        return stem_train_reference(x, k1, sc1, bi1, k2a, sc2a, bi2a, k2b,
                                    sc2b, bi2b, k3)
    if k1.shape[-1] != 32:
        raise ValueError(f"the stem kernel is built for cm = 32, got "
                         f"{k1.shape[-1]}")
    out = _StemFused.apply(x, k1, sc1, bi1, k2a, sc2a, bi2a, k2b, sc2b, bi2b,
                           k3)
    return out[0], tuple(out[1:5]), tuple(out[5:9])


stem_fused.launches = 0


def stem_fused_backward(x, y1, y2a, y2b, cat, y3, k2a, k2b, k3, sc1, sc2a,
                        sc2b, fvecs, dy3, dmeans, dvars):
    """K4-b on the card: the saved forward tensors of :func:`stem_fused`
    (x, the pre-BN y1, y2a, y2b, y3 and the concat in the working dtype; the
    filters k2a, k2b, k3 in that dtype; f32 sc1, sc2a, sc2b; ``fvecs`` the
    forward's statistics buffer) and the cotangents of y3 and of the four
    means and variances (``None`` = zero) -> the f32 gradients (dk1, dsc1,
    dbi1, dk2a, dsc2a, dbi2a, dk2b, dsc2b, dbi2b, dk3). CUDA tensors only:
    on the CPU the backward of :func:`stem_fused` is the autograd of
    :func:`stem_train_reference`."""
    if x.device.type != "cuda":
        raise ValueError(f"stem_fused_backward launches K4-b on a CUDA card, "
                         f"got {x.device}")
    grads = _launch_backward(x, y1, y2a, y2b, cat, y3, k2a, k2b, k3, sc1,
                             sc2a, sc2b, fvecs, dy3, dmeans, dvars)
    stem_fused_backward.launches += 1
    return grads


def _launch_backward(x, y1, y2a, y2b, cat, y3, k2a, k2b, k3, sc1, sc2a,
                     sc2b, fvecs, dy3, dmeans, dvars):
    """Scratch, outputs and the launch of K4-b (its plan's partial counts
    size gpart and wpart); the body of :func:`stem_fused_backward`."""
    b, h, w, _ = x.shape
    h2, w2 = h // 2, w // 2
    cm = y1.shape[3]
    dev, dtype = x.device, x.dtype
    dy3 = dy3.to(dtype).contiguous()
    dstat = torch.zeros((8, SLOT), dtype=torch.float32, device=dev)
    for i, (dm, dv) in enumerate(zip(dmeans, dvars)):
        if dm is not None:
            dstat[i, :dm.numel()] = dm.float()
        if dv is not None:
            dstat[4 + i, :dv.numel()] = dv.float()
    # the statistics are the global batch's: their cotangents, averaged
    mean_over_data(dstat)
    def half(c):
        return torch.empty((b, h2, w2, c), dtype=dtype, device=dev)

    def f32(*shape):
        return torch.empty(shape, dtype=torch.float32, device=dev)

    dcat, da1p, dy2b, dy2a, dy1 = (half(2 * cm), half(cm), half(cm),
                                   half(cm // 2), half(cm))
    route = str(dtype).split(".")[-1]
    plan = kernels.stem_bwd_plan(route, b, h, w, tuple(
        t.data_ptr() for t in (x, k2a, k2b, k3, dy3)), kernels.sm_count(dev))
    gpart, wpart, work = f32(plan["gpart"]), f32(plan["wpart"]), f32(4 * SLOT)
    dk1, dk3 = f32(3, 3, 3, cm), f32(3, 3, 2 * cm, cm)
    dk2a, dk2b = f32(2, 2, cm, cm // 2), f32(2, 2, cm // 2, cm)
    dvec = f32(6, SLOT)
    e3 = torch.empty_like(y3)   # dy3 with the BN3 statistics fold
    args = [t.data_ptr() for t in (
        x, y1, y2a, y2b, cat, y3, k2a, k2b, k3, sc1, sc2a, sc2b, fvecs, dy3,
        dstat, dcat, da1p, dy2b, dy2a, dy1, e3, gpart, wpart, work, dk1,
        dk2a, dk2b, dk3, dvec)] + [b, h, w]
    sync, keep = kernel_sync(work)
    name = kernels.STEM_ROUTES[route]["bwd"]
    lib = kernels.load()
    with torch.cuda.device(dev):
        err = getattr(lib, name)(*args, *(plan[k] for k in STEM_BWD_PLAN),
                                 sync, kernels.stream_ptr(dev))
    del keep
    kernels.check(err, name)
    ch = cm // 2
    return (dk1, dvec[0, :cm], dvec[1, :cm], dk2a, dvec[2, :ch],
            dvec[3, :ch], dk2b, dvec[4, :cm], dvec[5, :cm], dk3)


stem_fused_backward.launches = 0

# the order of the plan's counts in hgstem_bwd_tc_nhwc's arguments
STEM_BWD_PLAN = ("da_blocks", "dk3_chunks", "asm_blocks", "wg2b_chunks",
                 "dx2b_blocks", "wg2a_chunks", "dx2a_blocks", "dk1_chunks",
                 "vec", "vec_x")
