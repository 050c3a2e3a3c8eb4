#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Drives the port's five paths once each at full width, with seeded random
weights: the serving path, the 4-pass robustness sweep (nc=6, bf16, eval
mode, 1024 canvas, 64 synthetic 768x1024 images in batches of 8), once
with YOLOv8m and once with RT-DETR-L, and the training path, ``bench.py``'s
two workloads (YOLOv8m trained at 1024 px, batch 16, and RT-DETR-L at
batch 8 with contrastive denoising; 80 ground-truth boxes per image in 600
slots, the Augmented mode with HSV + flip, bf16 convs with bf16 BatchNorm
outputs and f32 statistics); and the decoder's sampling workload through
each generation of the deformable-attention op family. Phases:

  1. environment: torch / CUDA / nvcc versions, the card's name and power
     limit; exits non-zero without a CUDA card;
  2. build: compiles the kernels of csrc/ with nvcc from this checkout;
     ptxas's registers and spills of every kernel, and the count of
     tensor-core instructions (HMMA / HGMMA), async copies (LDGSTS) and
     f32 FMAs in the SASS of K3's, K2's and K4's bf16 kernels (every
     instantiation); HMMA must be above 0 in each;
  3. kernels: the eval kernels (K3-f, K2-f) against their plain PyTorch
     versions at the sweep's shapes (f32 with TF32 off: max abs err <=
     1e-4 x max|ref|; bf16: <= 1e-2 x max|ref|), with CUDA-event timings
     (median of 10 calls after 3 warm-ups) of both and the profiler's
     device ms of each bf16 K2-f sub-kernel (P1, P2); K3-f, K3-f as dX and
     K3-b at odd shapes and on a misaligned x (conv3x3_edges); and the
     kernels' refusal of CUDA tensors they do not take;
  4. model check: YOLOv8m f32 logits on the card (kernels, TF32 off)
     against the same weights on the CPU (plain versions) at 128 px;
  5. the sweep: launch counters zeroed just before it and read just after
     (front 1 and conv3x3 4 per forward, x 4 passes x batches), finite
     per-variant mAPs, detections per image, images/sec;
  6. training kernels: K3-b (conv3x3 wgrad) and K3-f as dX, K2-f in train
     mode, K2-b and K1 against their plain versions at the training
     shapes, in f32 with TF32 off and in bf16, timed the same way (with the
     device ms of each bf16 K2 sub-kernel: P1, P2, finalize; stat
     cotangent, e2 prep, dA1, dk2, dk1, the chunk sums, bn chain), K2-b and
     the train statistics bit-identical on a second run, and the kernels'
     refusal of bad CUDA inputs (tolerances in phase_train_kernels);
  7. train-step model check: one YOLOv8m f32 train step at 128 px, batch
     2, no corruption, on the card (kernels, TF32 off) and on the CPU
     (plain versions) from the same weights and batch: loss within 1e-4
     relative, every parameter's gradient within 1e-3 x max|ref| of its
     leaf;
  8. training: 1 warm-up step, then 5 timed steps with the launch
     counters zeroed just before and read just after (per step: K1 1,
     front train forward 1, front backward 1, conv3x3 8 = 4 forward + 4
     dX, conv3x3 wgrad 4); finite loss and grad norm every step, moved
     BatchNorm running statistics and EMA; step ms (median), images/s and
     peak device memory;
  9. RT-DETR-L kernels: K4-f (the HGNetv2 stem) and K5 forward
     (multi-scale deformable attention) against their plain versions at
     the sweep's shapes and at one odd shape each, f32 with TF32 off and
     bf16 (tolerances in phase_rtdetr_kernels), timed as above, with the
     profiler's device ms of each bf16 K4-f launch (stem1, stem2a, stem2b,
     pool, stem3) and cuDNN's time for each conv stage of the stem beside
     it, and the refusal of bad CUDA inputs;
 10. RT-DETR-L model check: f32 at 128 px on the card (kernels, TF32 off)
     against the same weights on the CPU (plain versions): the same
     selected anchors, last-layer logits and boxes within 2e-3 x max|ref|,
     the same decoded scores;
 11. the RT-DETR-L sweep: as phase 5 with the NMS-free predict step;
     per forward K4-f 1, K5 6 and K3-f 6 launches; images/sec and peak
     memory;
 12. RT-DETR-L training kernels: K4-f in train mode, K4-b (the stem's
     backward), K5 backward and K6 (the auction matcher) against their
     plain versions at the train step's shapes and at one odd shape each,
     f32 with TF32 off and bf16 where the kernel takes it (tolerances in
     phase_rtdetr_train_kernels; K6 by equality), timed as above, with the
     profiler's device ms of each bf16 K4-f train and K4-b launch, and
     cuDNN's time for each stage of the stem's backward beside K4-b; and the
     kernels this step shares with earlier paths at its own shapes (K5
     forward at 428 queries, K3-b, K3-f as dX and K1 at batch 8);
 13. RT-DETR-L train-step model check: forward, loss and backward of one
     f32 batch at 128 px on the card (kernels, TF32 off) and on the CPU
     (plain versions), same weights, batch and denoising queries; every
     assignment the card's matcher made is solved again by the plain
     version on the CPU from the same cost tensor and must be equal;
 14. RT-DETR-L training: 1 warm-up step, then 5 timed steps with the
     launch counters zeroed just before and read just after (per step: K1
     1, K4-f train 1, K4-b 1, K3-f 12 = 6 forward + 6 dX, K3-b 6, K5
     forward 6, K5 backward 6, K6 7); finite loss and grad norm, moved
     running statistics and EMA; step ms, images/s, peak memory;
 15. the earlier generations' kernels: K5-g2 forward and backward (the
     sorted-tap deformable attention, both layouts of the value maps) and
     K5-g1 (``stamp_scatter``, and ``bilinear_sample``'s three gradients
     through it) against their plain versions at the RT-DETR-L decoder's
     shapes (300 and 428 queries; each of the three levels for K5-g1) and
     at one odd shape, f32 and bf16 values (tolerances in
     phase_sorted_kernels); every backward twice for identical bits; timed
     as above with the tap sort inside the timed call, ``torch.sort`` alone
     beside it; the one library call for K5-g1 (``scatter_add_`` into
     zeros) and, for the record, ``grid_sample`` forward + backward beside
     ``bilinear_sample``; the refusal of bad CUDA inputs;
 16. the generations' path: six forward + backward calls (one per decoder
     layer, 428 queries, values (8, 21504, 8, 32), bf16 then f32) of
     ``ms_deform_attn``, of ``ms_deform_attn_t`` and of the per-level
     composition over ``bilinear_sample``, launch counters zeroed just
     before and read just after (K5-g2 forward 12, K5-g2 backward 12,
     K5-g1 18 per dtype), each output and gradient held against
     ``ms_deform_attn_slots`` (K5) on the same inputs; ms per call.

Every kernel's line in the summary also carries ``bound_ms``, the least
time the card could take for the same work: the larger of the bytes the
function must move (inputs once, outputs once; for the gather of K5 the
distinct rows this run's taps touch) over 3.35 TB/s and its operations
over the card's peak for the type (989 TFLOP/s bf16 on the tensor cores,
67 TFLOP/s f32), and ``library_ms``, the time of the one PyTorch call
that computes the same function where there is one (a cuDNN convolution
or its filter gradient; ``scatter_add_`` for K5-g1), timed here and used
nowhere in the port.

Any failed check raises, so the script exits non-zero and prints no
result. The line before the last is the kernel summary
``{"kernels": [...]}``; the last line is ``{"ok": true, "device": ...}``.
"""

from __future__ import annotations

import json
import math
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

IMG_SIZE = 1024
BATCH = 8
N_IMAGES = 64
NATIVE_HW = (768, 1024)
SEED = 0
TRAIN_BATCH = 16       # bench.py's train workload
MAX_BOXES = 600
GT_PER_IMAGE = 80
TRAIN_STEPS = 5
RTDETR_TRAIN_BATCH = 8  # bench.py's RT-DETR workload

# the card's published peaks (H100 SXM data sheet, dense)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"FAIL: {msg}")


def run_cmd(cmd) -> str:
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=60)
    return (res.stdout or res.stderr).strip()


def time_ms(fn, iters: int = 10, warmup: int = 3) -> float:
    """Median CUDA-event time of one call, after warm-up."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms_by_kernel(fn, calls: int = 10):
    """[(device ms a call, launches a call, kernel name)] of `fn` under
    torch.profiler, after one warm-up call; largest first. A kernel's ms a
    call is its mean device ms a launch times its launches a call, so that
    records the profiler drops (seen when several sessions run in one
    process) lower neither."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    rows = []
    for e in prof.key_averages():
        if (e.device_time_total > 0
                and e.device_type == torch.autograd.DeviceType.CUDA):
            n = max(1, round(e.count / calls))
            rows.append((e.device_time_total / 1e3 / e.count * n, n, e.key))
    return sorted(rows, reverse=True)


def device_ms_by_launch(fn, calls: int = 10):
    """[(device ms, kernel name)] of `fn`'s launches in launch order, each
    the mean over `calls` profiled calls after one warm-up, so that two
    launches of one kernel (stem1 and stem3 of the CUDA-core stem) stay
    apart. None when the profiler's record does not split into `calls`
    equal sequences (it may drop records in a process that ran several
    sessions)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    ev = sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA
                 and not getattr(e, "is_user_annotation", False)),
                key=lambda e: e.time_range.start)
    n = len(ev) // calls
    seqs = [ev[i * n:(i + 1) * n] for i in range(calls)]
    if not ev or len(ev) % calls or any(
            [e.name for e in s] != [e.name for e in seqs[0]] for s in seqs):
        return None
    return [(sum(s[i].time_range.elapsed_us() for s in seqs) / calls / 1e3,
             seqs[0][i].name) for i in range(n)]


def short_kernel_name(name: str) -> str:
    """A kernel's name without its namespaces and argument list."""
    for ns in ("(anonymous namespace)::", "rodt::stc::", "rodt::ftc::",
               "rodt::tc::", "rodt::", "at::native::", "void "):
        name = name.replace(ns, "")
    return name.split("(")[0].strip()


def stem_parts(fn, tag, what):
    """Prints the device ms of each launch of `fn` (a K4 call) in launch
    order, by the profiler; returns [(ms, short name)] (None when the
    record did not split into calls, then the sums by kernel name are
    printed instead)."""
    seq = device_ms_by_launch(fn)
    if seq is None:
        rows = device_ms_by_kernel(fn)
        print(f"[{tag}] {what} device ms by kernel (launch order lost): "
              + "; ".join(f"{short_kernel_name(k)} x{n} {ms}"
                          for ms, n, k in rows))
        return None
    seq = [(ms, short_kernel_name(k)) for ms, k in seq]
    print(f"[{tag}] {what} device ms by launch: " + "; ".join(
        f"{i} {k} {ms}" for i, (ms, k) in enumerate(seq))
        + f"; sum {sum(ms for ms, _ in seq)}")
    return seq


# K2's bf16 sub-kernels (csrc/front_tc.cuh and the shared reductions), by
# a substring of their names
FRONT_PARTS = (("P1", "front_p1_kernel"), ("P2", "front_p2_kernel"),
               ("finalize", "finalize_partials_kernel"),
               ("stat cotangent", "stat_cotangent_kernel"),
               ("e2 prep", "e2_prep_kernel"), ("dA1", "front_da1_tc_kernel"),
               ("dk2", "front_dk2_tc_kernel"), ("dk1", "front_dk1_tc_kernel"),
               ("sums", "sum_chunks_tc_kernel"),
               ("bn chain", "bn_chain_kernel"))


def front_parts(fn, tag, what):
    """Prints the device ms a call of each K2 sub-kernel that `fn`
    launches (profiler); returns {part: ms}."""
    parts = {}
    for ms, n, key in device_ms_by_kernel(fn):
        for part, sub in FRONT_PARTS:
            if sub in key:
                parts[part] = parts.get(part, 0.0) + ms
    print(f"[{tag}] {what} device ms by sub-kernel: " + ", ".join(
        f"{k} {v}" for k, v in parts.items()) + f"; sum {sum(parts.values())}")
    return parts


def work(dtype: str, nbytes: float, flops: float, library_ms=None) -> dict:
    """The bound's inputs for one kernel run: the bytes it must move, its
    operations, the type whose peak applies; and the library call's ms."""
    return dict(bytes=nbytes, flops=flops, peak=PEAK_FLOPS[dtype],
                library_ms=library_ms)


def bound(w: dict):
    """(bound_ms, bound_by) of a :func:`work` record."""
    t_bytes = w["bytes"] / HBM_BYTES_PER_S * 1e3
    t_ops = w["flops"] / w["peak"] * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def esize(dtype) -> int:
    import torch
    return torch.empty((), dtype=dtype).element_size()


def max_err(out, ref):
    """(max abs error, max |ref|) of out against the f32 reference."""
    return ((out.float() - ref).abs().max().item(),
            ref.abs().max().item())


def require_refused(tag, bad, counters) -> None:
    """Every call of `bad` raises ValueError and launches no kernel."""
    before = [f.launches for f in counters]
    refused = 0
    for fn in bad:
        try:
            fn()
        except ValueError:
            refused += 1
    require(refused == len(bad), f"only {refused}/{len(bad)} bad CUDA "
            f"inputs were refused")
    require([f.launches for f in counters] == before,
            "a refused call launched a kernel")
    print(f"[{tag}] bad CUDA inputs refused: {refused}/{len(bad)}")


# K3's odd shapes (B, H, W, Cin, Cout): channel counts of 3, 5 and 8, 24 and
# 40 (multiples of 8, not of 16), 56 output channels (two output-channel
# slices), W = 17 and H = 1 (ragged tiles), B = 1
CONV3X3_EDGES = ((2, 37, 45, 5, 20), (3, 16, 16, 8, 16), (1, 9, 30, 3, 17),
                 (2, 37, 45, 24, 56), (1, 1, 17, 40, 20),
                 (2, 19, 17, 56, 24))


def misaligned(t):
    """A contiguous copy of t one element past a 16-byte boundary (so K3's
    bf16 kernels must stage element by element)."""
    import torch
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    require(out.is_contiguous() and out.data_ptr() % 16 != 0,
            "misaligned copy is aligned")
    return out


def conv3x3_edges(C, g, dev, tag):
    """K3-f forward, K3-f as dX and K3-b on CONV3X3_EDGES and on a
    misaligned x, f32 (TF32 off) and bf16 against the plain versions in f32
    on the same values: K3-f 1e-4 / 1e-2 x max|ref|, K3-b 1e-3 x max|ref|
    in both dtypes (bf16 products are exact in f32; only the summation
    order differs), K3-b bit-identical on a second run."""
    import torch
    from robust_object_detection_tpu_torch import kernels
    cases = [(s, False) for s in CONV3X3_EDGES] + [((2, 37, 45, 48, 48),
                                                    True)]
    n = 0
    for (b, h, w, cin, cout), shifted in cases:
        x = torch.randn(b, h, w, cin, device=dev, generator=g)
        dy = torch.randn(b, h, w, cout, device=dev, generator=g)
        k = torch.randn(3, 3, cin, cout, device=dev, generator=g) * 0.1
        for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 1e-2)):
            xd, dyd, kd = x.to(dtype), dy.to(dtype), k.to(dtype)
            if shifted:
                xd, dyd = misaligned(xd), misaligned(dyd)
                if dtype == torch.bfloat16:
                    sm = kernels.sm_count(dev)
                    plans = (kernels.conv3x3_tc_plan(
                        b, h, w, cin, cout, (xd.data_ptr(), kd.data_ptr()),
                        sm), kernels.wgrad_tc_plan(
                        b, h, w, cin, cout, (xd.data_ptr(), dyd.data_ptr()),
                        sm))
                    require(all(p["vec"] == 0 for p in plans),
                            "a misaligned x took 16-byte staging")
            log = []
            with torch.backends.cudnn.flags(allow_tf32=False):
                check(f"conv3x3 {dtype} {(b, h, w, cin, cout)}",
                      C.conv3x3(xd, kd),
                      C.conv3x3_reference(xd.float(), kd.float()), tol, log)
            check_conv3x3_backward(C, xd, dyd, kd, 1e-3, log)
            n += 1
    print(f"[{tag}] conv3x3 forward, dX and wgrad on {len(cases)} odd "
          f"shapes (one with a misaligned x and dy), f32 and bf16: {n} "
          f"cases passed")


def phase_kernels(dev):
    """Each kernel vs its plain version at the main path's shapes."""
    import torch
    import torch.nn.functional as F
    from robust_object_detection_tpu_torch.ops import conv3x3 as C
    from robust_object_detection_tpu_torch.ops import yolo_front as TF

    g = torch.Generator(dev).manual_seed(SEED)
    results = {}

    # K3-f: C2f_0 bottleneck conv, (8, 256, 256, 48) x (3, 3, 48, 48)
    x = torch.randn(BATCH, 256, 256, 48, device=dev, generator=g)
    k = torch.randn(3, 3, 48, 48, device=dev, generator=g) * 0.1
    conv = {}
    for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 1e-2)):
        xd, kd = x.to(dtype), k.to(dtype)
        out = C.conv3x3(xd, kd)
        with torch.backends.cudnn.flags(allow_tf32=False):
            ref = C.conv3x3_reference(xd.float(), kd.float())
        err, scale = max_err(out, ref)
        ms = time_ms(lambda: C.conv3x3(xd, kd))
        plain_ms = time_ms(lambda: C.conv3x3_reference(xd, kd))
        xv, kv = xd.permute(0, 3, 1, 2), kd.permute(3, 2, 0, 1)
        lib_ms = time_ms(lambda: F.conv2d(xv, kv, padding=1))
        name = str(dtype).split(".")[-1]
        print(f"[kernels] conv3x3 {name} (8,256,256,48)->48: max_abs_err "
              f"{err} (max|ref| {scale}, tol {tol * scale}) kernel {ms} ms "
              f"plain {plain_ms} ms (cuDNN, default flags, with its layout "
              f"copies) library {lib_ms} ms (F.conv2d alone)")
        require(math.isfinite(err) and err <= tol * scale,
                f"conv3x3 {name} error {err} > {tol} x {scale}")
        conv[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                          **work(name, (x.numel() * 2 + k.numel())
                                 * esize(dtype),
                                 2 * k.numel() * x.numel() // 48, lib_ms))
    results["conv3x3"] = conv
    conv3x3_edges(C, g, dev, "kernels")

    # K2-f: front, (8, 1024, 1024, 3) -> 48 -> 96
    xf = torch.rand(BATCH, IMG_SIZE, IMG_SIZE, 3, device=dev, generator=g)
    k1 = torch.randn(3, 3, 3, 48, device=dev, generator=g) * 0.2
    k2 = torch.randn(3, 3, 48, 96, device=dev, generator=g) * 0.1
    sc1 = torch.rand(48, device=dev, generator=g) + 0.5
    bi1 = torch.randn(48, device=dev, generator=g) * 0.1
    means = (torch.randn(48, device=dev, generator=g) * 0.1,
             torch.zeros(96, device=dev))
    variances = (torch.rand(48, device=dev, generator=g) + 0.5,
                 torch.ones(96, device=dev))
    front = {}
    for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 1e-2)):
        xd, k1d, k2d = xf.to(dtype), k1.to(dtype), k2.to(dtype)
        args = (xd, k1d, sc1, bi1, k2d, means, variances)
        out = TF.front_inference(*args)
        with torch.backends.cudnn.flags(allow_tf32=False):
            ref = TF.front_inference_reference(
                xd.float(), k1d.float(), sc1, bi1, k2d.float(), means,
                variances)
        err, scale = max_err(out, ref)
        ms = time_ms(lambda: TF.front_inference(*args))
        plain_ms = time_ms(lambda: TF.front_inference_reference(*args))
        name = str(dtype).split(".")[-1]
        print(f"[kernels] yolo_front {name} (8,1024,1024,3)->48->96: "
              f"max_abs_err {err} (max|ref| {scale}, tol {tol * scale}) "
              f"kernel {ms} ms plain {plain_ms} ms (cuDNN, default flags)")
        require(math.isfinite(err) and err <= tol * scale,
                f"yolo_front {name} error {err} > {tol} x {scale}")
        front[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                           **front_work(name, BATCH, esize(dtype)))
        if dtype == torch.bfloat16:
            front[name]["parts"] = front_parts(
                lambda: TF.front_inference(*args), "kernels",
                "yolo_front bfloat16 (8,1024,1024,3)")
    results["yolo_front"] = front

    # the kernels refuse CUDA tensors they do not take, and launch nothing
    require_refused("kernels", (
        lambda: C.conv3x3(x[:, :, ::2], k),
        lambda: C.conv3x3(x.half(), k.half()),
        lambda: TF.front_inference(xf[:, :1023], k1, sc1, bi1, k2, means,
                                   variances)),
        (C.conv3x3, TF.front_inference))
    torch.cuda.synchronize()
    return results


def front_work(dtype: str, batch: int, elt: int, backward: bool = False):
    """The YOLO front at (batch, 1024, 1024, 3) -> 48 -> 96. Forward: reads
    x, writes y2 (y1 / a1 stays inside). Backward: reads x, y1, y2 and dy2;
    dX of P2, then the two filter gradients. No one PyTorch call computes
    either."""
    px1 = batch * (IMG_SIZE // 2) ** 2
    px2 = batch * (IMG_SIZE // 4) ** 2
    f1, f2 = 2 * 27 * 48 * px1, 2 * 9 * 48 * 96 * px2
    x_b, y1_b, y2_b = batch * IMG_SIZE ** 2 * 3 * elt, px1 * 48 * elt, \
        px2 * 96 * elt
    if backward:
        return work(dtype, x_b + y1_b + 2 * y2_b, 2 * f2 + f1)
    return work(dtype, x_b + y2_b + (27 * 48 + 9 * 48 * 96) * elt, f1 + f2)


def phase_model_check(dev):
    """YOLOv8m f32 on the card (hand kernels, TF32 off) vs the same
    weights on the CPU (plain versions), 2 x 128 x 128 input."""
    import torch
    from robust_object_detection_tpu_torch.models import yolov8 as Y

    gpu = Y.create(6, "m", torch.float32, dev,
                   torch.Generator().manual_seed(SEED))
    cpu = Y.create(6, "m", torch.float32, torch.device("cpu"),
                   torch.Generator().manual_seed(SEED))
    x = torch.rand(2, 128, 128, 3, generator=torch.Generator().manual_seed(1))
    with torch.no_grad(), torch.backends.cudnn.flags(allow_tf32=False):
        outs = gpu(x.to(dev))
        refs = cpu(x)
    worst = 0.0
    for (ob, oc), (rb, rc) in zip(outs, refs):
        for o, r in ((ob, rb), (oc, rc)):
            require(o.shape == r.shape, "model output shapes differ")
            err, scale = max_err(o.cpu(), r)
            worst = max(worst, err / scale)
    print(f"[model] YOLOv8m f32 card vs CPU logits: max rel err {worst} "
          f"(tol 1e-3)")
    require(math.isfinite(worst) and worst <= 1e-3,
            f"card logits differ from the CPU reference by {worst}")


def synthetic_samples(n: int):
    """n in-memory 768x1024 uint8 images with 1-5 GT boxes each."""
    import numpy as np
    from robust_object_detection_tpu_torch.data.pipeline import Sample

    rng = np.random.RandomState(SEED)
    h, w = NATIVE_HW
    images, samples = {}, []
    for i in range(n):
        images[i + 1] = rng.randint(0, 256, (h, w, 3), dtype=np.uint8)
        m = int(rng.randint(1, 6))
        xy = rng.rand(m, 2) * [w - 64, h - 64]
        wh = rng.rand(m, 2) * 56 + 8
        samples.append(Sample(
            image_path=Path(f"synthetic/img{i:04d}.png"), image_id=i + 1,
            width=w, height=h,
            boxes_xyxy=np.concatenate([xy, xy + wh], 1).astype(np.float32),
            classes=rng.randint(0, 6, m).astype(np.int32)))
    return images, samples


def run_sweep(dev, tag, title, model, predict, counters, per_forward):
    """One 4-pass sweep through the port's entry points with `predict`:
    warm-up batch, launch counters zeroed just before the sweep and read
    just after, finite mAPs, images/s and peak memory. Returns the launch
    counts and the detections of one more fused step (not counted)."""
    import numpy as np
    import torch
    from robust_object_detection_tpu_torch.eval import fused_sweep as FS

    images, samples = synthetic_samples(N_IMAGES)

    def loader(sample):
        return images[sample.image_id]

    # warm-up batch (cuDNN algorithm choice, allocator), off the count
    FS.run_fused_sweep(predict, model, None, None, samples[:BATCH], IMG_SIZE,
                       BATCH, load_image=loader)
    torch.cuda.synchronize()

    for f in counters.values():
        f.launches = 0
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    out = FS.run_fused_sweep(predict, model, None, None, samples, IMG_SIZE,
                             BATCH, seed=SEED, load_image=loader)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = {k: f.launches for k, f in counters.items()}
    peak = torch.cuda.max_memory_allocated(dev)

    forwards = 4 * math.ceil(N_IMAGES / BATCH)
    expect = {k: n * forwards for k, n in per_forward.items()}
    print(f"[{tag}] launches {launches} expected {expect}")
    require(launches == expect, f"launch counts {launches} != {expect}")
    require(out["images_evaluated"] == 4 * N_IMAGES, "images_evaluated")
    for variant, summary in out["corrupted"].items():
        m50, m5095 = summary["mAP50"], summary["mAP50_95"]
        print(f"[{tag}] {variant}: mAP50 {m50} mAP50-95 {m5095}")
        require(all(math.isfinite(v) and 0.0 <= v <= 1.0
                    for v in (m50, m5095)), f"{variant} mAP not finite")
    rate = out["images_evaluated"] / elapsed
    print(f"[{tag}] {title} bf16 1024px, {N_IMAGES} images 768x1024 x 4 "
          f"passes, batch {BATCH}: {elapsed} s, {rate} images/s (host "
          f"scoring included); peak memory {peak} bytes "
          f"({peak / 2 ** 30} GiB)")

    step = FS.make_fused_step(predict, None, NATIVE_HW, IMG_SIZE)
    batch = torch.from_numpy(np.stack([images[s.image_id]
                                       for s in samples[:BATCH]])).to(dev)
    dets = step(model, None, batch, torch.Generator(dev).manual_seed(SEED))
    require(bool(torch.isfinite(dets[0]).all()
                 and torch.isfinite(dets[1]).all()), "non-finite detections")
    return launches, dets


def phase_sweep(dev):
    """The YOLOv8m sweep; returns the launch counts of its run."""
    import torch
    from robust_object_detection_tpu_torch.models import yolov8 as Y
    from robust_object_detection_tpu_torch.ops import conv3x3 as C
    from robust_object_detection_tpu_torch.ops import yolo_front as TF
    from robust_object_detection_tpu_torch.train import detector as D

    model = Y.create(6, "m", torch.bfloat16, dev,
                     torch.Generator().manual_seed(SEED))
    launches, (_, _, _, valid) = run_sweep(
        dev, "sweep", "YOLOv8m", model, D.make_predict_step(IMG_SIZE),
        {"conv3x3": C.conv3x3, "yolo_front": TF.front_inference},
        {"conv3x3": 4, "yolo_front": 1})
    per_img = valid.sum(-1).float().mean(-1).tolist()
    print(f"[sweep] detections per image by pass (Clean, Noise, Blur, "
          f"LowRes): {per_img}")
    return launches


def check(name, out, ref, tol, log):
    """max abs err of out vs the f32 reference within tol x max|ref|."""
    err, scale = max_err(out, ref)
    log.append(f"{name} {err} (max|ref| {scale}, tol {tol * scale})")
    require(math.isfinite(err) and err <= tol * scale,
            f"{name}: error {err} > {tol} x {scale}")
    return err


def check_conv3x3_backward(C, xd, dyd, kd, tol, log):
    """K3-b and K3-f as dX on one (x, dy, k) against the plain versions in
    f32 on the same values, and K3-b twice for the same bits; returns K3-b's
    max abs error."""
    import torch
    name = str(xd.dtype).split(".")[-1]
    shape = tuple(xd.shape)
    with torch.backends.cudnn.flags(allow_tf32=False):
        err = check(f"conv3x3_wgrad {name} {shape}", C.conv3x3_wgrad(xd, dyd),
                    C.conv3x3_wgrad_reference(xd.float(), dyd.float()),
                    tol, log)
        kflip = kd.flip(0, 1).transpose(2, 3).contiguous()
        check(f"conv3x3 dX {name} {shape}", C.conv3x3(dyd, kflip),
              C.conv3x3_reference(dyd.float(), kflip.float()),
              1e-4 if xd.dtype == torch.float32 else 1e-2, log)
    again = C.conv3x3_wgrad(xd, dyd)
    require(torch.equal(again, C.conv3x3_wgrad(xd, dyd)),
            "conv3x3_wgrad is not deterministic")
    return err


def check_corrupt(FC, g, dev, batch):
    """K1 on (batch, 1024, 1024, 3) f32, all four branches, image 1
    mid-grey: clean and blur bit-exact, lowres and noise within 1 LSB of
    the plain version, the noise's mean -0.5 +- 0.5 and std 15 +- 0.5.
    Returns (img, choice, seeds, per-branch max abs diff, noise mean,
    noise std)."""
    import torch
    img = torch.floor(torch.rand(batch, IMG_SIZE, IMG_SIZE, 3, device=dev,
                                 generator=g) * 256)
    img[1] = 128.0
    choice = torch.arange(batch, device=dev, dtype=torch.int32) % 4
    seeds = torch.randint(0, 2 ** 30, (batch,), device=dev, generator=g,
                          dtype=torch.int32)
    out, _ = FC.fused_random_corruption(img, None, choice=choice,
                                        seeds=seeds)
    ref = FC.fused_corruption_reference(img, choice, seeds)
    diff = (out - ref).abs().amax((1, 2, 3))
    per_branch = [diff[choice == c].max().item() for c in range(4)]
    noise = out[1] - 128.0
    nmean, nstd = noise.mean().item(), noise.std().item()
    require(per_branch[0] == 0 and per_branch[2] == 0,
            f"corrupt clean/blur not bit-exact: {per_branch}")
    require(per_branch[1] <= 1 and per_branch[3] <= 1,
            f"corrupt noise/lowres beyond 1 LSB: {per_branch}")
    require(abs(nmean + 0.5) <= 0.5 and abs(nstd - 15.0) <= 0.5,
            f"noise mean {nmean} std {nstd}")
    return img, choice, seeds, per_branch, nmean, nstd


def phase_train_kernels(dev):
    """Each training kernel vs its plain version at the train path's
    shapes. Tolerances: f32 outputs 1e-4 x max|ref| (f32 sums in another
    order); f32 sums over B x H x W (weight gradients, BN statistics and
    their gradients) 1e-3 x max|ref| (~1e6-term sums in another order);
    bf16 2e-2 x max|ref|, but K3-b 1e-3 in both dtypes (a product of bf16
    values is exact in f32, so only the order of the f32 sums differs, and
    2e-2 would pass a kernel that drops 1% of its pixels). The bf16 K3
    kernels are held against the plain version in f32 on the same bf16
    values; the bf16 front against the
    plain front in bf16, which rounds y1, a1 and y2 where the kernels do:
    the pre-BN y1 of a 1024 px batch has channels whose spread is a few
    bf16 steps of their mean, so the gradient of k1 through BN1 is a
    different function of bf16-rounded and of exact y1 (the f32 plain
    front on bf16 inputs differs from the bf16 one by 5% of max|dk1| at
    (2, 256, 256) on the CPU and by 55% at the training shape on the
    card). K1: clean and blur bit-exact, lowres and noise within
    1 LSB (the plain version replays the kernel's noise bits; the
    transcendentals differ by ulps), noise on a mid-grey image with mean
    -0.5 +- 0.5 (the truncation to integers takes 0.5 off a symmetric
    noise) and std 15 +- 0.5. Timings as phase_kernels; the plain
    versions run under PyTorch's default flags."""
    import torch
    from robust_object_detection_tpu_torch.ops import conv3x3 as C
    from robust_object_detection_tpu_torch.ops import fused_corrupt as FC
    from robust_object_detection_tpu_torch.ops import yolo_front as TF

    g = torch.Generator(dev).manual_seed(SEED + 1)
    results = {}

    # K3-b and K3-f as dX: C2f_0 bottleneck convs, (16, 256, 256, 48) -> 48
    x = torch.randn(TRAIN_BATCH, 256, 256, 48, device=dev, generator=g)
    dy = torch.randn(TRAIN_BATCH, 256, 256, 48, device=dev, generator=g)
    k = torch.randn(3, 3, 48, 48, device=dev, generator=g) * 0.1
    wg = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[-1]
        xd, dyd, kd = x.to(dtype), dy.to(dtype), k.to(dtype)
        log = []
        err = check_conv3x3_backward(C, xd, dyd, kd, 1e-3, log)
        ms = time_ms(lambda: C.conv3x3_wgrad(xd, dyd))
        plain_ms = time_ms(lambda: C.conv3x3_wgrad_reference(xd, dyd))
        xv, dyv = xd.permute(0, 3, 1, 2), dyd.permute(0, 3, 1, 2)
        lib_ms = time_ms(lambda: torch.nn.grad.conv2d_weight(
            xv, (48, 48, 3, 3), dyv, padding=1))
        print(f"[train-kernels] {'; '.join(log)}; wgrad kernel {ms} ms "
              f"plain {plain_ms} ms (cuDNN, with its layout copies) library "
              f"{lib_ms} ms (torch.nn.grad.conv2d_weight alone)")
        wg[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                        **work(name, (x.numel() + dy.numel()) * esize(dtype)
                               + k.numel() * 4,
                               2 * k.numel() * x.numel() // 48, lib_ms))
    results["conv3x3_wgrad"] = wg
    del x, dy

    # K2-f train + K2-b: the front, (16, 1024, 1024, 3) -> 48 -> 96
    xf = torch.rand(TRAIN_BATCH, IMG_SIZE, IMG_SIZE, 3, device=dev,
                    generator=g)
    k1 = torch.randn(3, 3, 3, 48, device=dev, generator=g) * 0.2
    k2 = torch.randn(3, 3, 48, 96, device=dev, generator=g) * 0.1
    sc1 = torch.rand(48, device=dev, generator=g) + 0.5
    bi1 = torch.randn(48, device=dev, generator=g) * 0.1
    cot = (torch.randn(TRAIN_BATCH, IMG_SIZE // 4, IMG_SIZE // 4, 96,
                       device=dev, generator=g),
           *(torch.randn(c, device=dev, generator=g) * 0.1
             for c in (48, 48, 96, 96)))
    fwd, bwd = {}, {}
    for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
        name = str(dtype).split(".")[-1]
        stol = 1e-3 if dtype == torch.float32 else tol
        xd = xf.to(dtype)
        params = [t.clone().requires_grad_() for t in (k1, sc1, bi1, k2)]
        rparams = [t.clone().requires_grad_() for t in (k1, sc1, bi1, k2)]
        cots = (cot[0].to(dtype), *cot[1:])
        log = []
        out = TF.front_fused(xd, *params)
        with torch.backends.cudnn.flags(allow_tf32=False):
            ref = TF.front_fused_reference(xd, *rparams)
            err = check(f"front train y2 {name}", out[0], ref[0], tol, log)
            for i, s in enumerate(("mean1", "var1", "mean2", "var2")):
                check(f"{s} {name}", out[i + 1], ref[i + 1], stol, log)
            grads = torch.autograd.grad(out, params, cots)
            rgrads = torch.autograd.grad(ref, rparams, cots)
        gerr = max(check(f"d{n} {name}", a, b, stol, log) for n, a, b in
                   zip(("k1", "sc1", "bi1", "k2"), grads, rgrads))
        del out, ref, grads, rgrads
        with torch.no_grad():
            ms = time_ms(lambda: TF.front_fused(xd, *params))
            plain_ms = time_ms(lambda: TF.front_fused_reference(xd, *params))
        out = TF.front_fused(xd, *params)
        pout = TF.front_fused_reference(xd, *params)
        bms = time_ms(lambda: torch.autograd.grad(out, params, cots,
                                                  retain_graph=True))
        bplain = time_ms(lambda: torch.autograd.grad(pout, params, cots,
                                                     retain_graph=True))
        # K2-b (and the forward's statistics) twice: the same bits
        again = [torch.autograd.grad(out, params, cots, retain_graph=True)
                 for _ in range(2)]
        require(all(torch.equal(a, b) for a, b in zip(*again)),
                f"front backward {name} is not deterministic")
        with torch.no_grad():
            stats = [TF.front_fused(xd, *params)[1:] for _ in range(2)]
        require(all(torch.equal(a, b) for a, b in zip(*stats)),
                f"front train statistics {name} are not deterministic")
        log.append("K2-b and the statistics bit-identical twice")
        parts = {}
        if dtype == torch.bfloat16:
            with torch.no_grad():
                parts["forward"] = front_parts(
                    lambda: TF.front_fused(xd, *params), "train-kernels",
                    "front train forward bfloat16 (16,1024,1024,3)")
            # K2-b called directly, on this thread (autograd runs it on its
            # own), on the tensors the forward saved for it
            saved = out[0].grad_fn.saved_tensors
            parts["backward"] = front_parts(
                lambda: TF.front_fused_backward(*saved, *cots),
                "train-kernels", "front backward bfloat16 (16,1024,1024,3)")
            del saved
        del out, pout, again, stats
        print(f"[train-kernels] {'; '.join(log)}; front train forward "
              f"kernel {ms} ms plain {plain_ms} ms; backward kernel {bms} "
              f"ms plain {bplain} ms (autograd of the plain front, cuDNN)")
        fwd[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                         **front_work(name, TRAIN_BATCH, esize(dtype)))
        bwd[name] = dict(max_abs_err=gerr, ms=bms, plain_ms=bplain,
                         **front_work(name, TRAIN_BATCH, esize(dtype), True))
        for key, rec in (("forward", fwd), ("backward", bwd)):
            if key in parts:
                rec[name]["parts"] = parts[key]
    results["yolo_front_train"] = fwd
    results["yolo_front_bwd"] = bwd
    del xf, cot

    # K1: (16, 1024, 1024, 3) f32, all four branches, one mid-grey image
    img, choice, seeds, per_branch, nmean, nstd = check_corrupt(
        FC, g, dev, TRAIN_BATCH)
    ms = time_ms(lambda: FC.fused_random_corruption(img, None, choice=choice,
                                                    seeds=seeds))
    plain_ms = time_ms(lambda: FC.fused_corruption_reference(img, choice,
                                                             seeds))
    print(f"[train-kernels] corrupt f32 (16,1024,1024,3): max abs diff by "
          f"branch (clean, noise, blur, lowres) {per_branch}; mid-grey "
          f"noise mean {nmean} std {nstd}; kernel {ms} ms plain {plain_ms} "
          f"ms")
    # reads and writes the batch once; per element about 2 x 9 operations
    # in the blurred quarter, 10 in the noised and 8 in the low-res one
    results["corrupt"] = {"float32": dict(
        max_abs_err=max(per_branch), ms=ms, plain_ms=plain_ms,
        **work("float32", 2 * img.numel() * 4, img.numel() // 4 * 36))}
    del img

    # the new wrappers refuse CUDA tensors they do not take
    small = torch.zeros(1, 8, 8, 4, device=dev)
    counters = (C.conv3x3_wgrad, TF.front_fused, FC.fused_random_corruption)
    bad = (lambda: C.conv3x3_wgrad(small, small.half()),
           lambda: C.conv3x3_wgrad(small[:, :, ::2], small[:, :, ::2]),
           lambda: TF.front_fused(torch.zeros(1, 9, 8, 3, device=dev),
                                  k1, sc1, bi1, k2),
           lambda: FC.fused_random_corruption(
               torch.zeros(1, 9, 8, 3, device=dev), None, choice=[0],
               seeds=[0]))
    require_refused("train-kernels", bad, counters)
    torch.cuda.synchronize()
    return results


def detection_batch(rng, n: int, size: int, per_image: int, max_boxes: int):
    """uint8 images and padded GT as bench.py builds them."""
    import numpy as np
    images = rng.randint(0, 255, (n, size, size, 3), dtype=np.uint8)
    gb = np.zeros((n, max_boxes, 4), np.float32)
    gc = np.full((n, max_boxes), -1, np.int64)
    for i in range(n):
        xy = rng.rand(per_image, 2) * (size - size * 100 // 1024)
        wh = rng.rand(per_image, 2) * (size * 60 // 1024) + 8
        gb[i, :per_image] = np.concatenate([xy, xy + wh], 1)
        gc[i, :per_image] = rng.randint(0, 6, per_image)
    return images, gb, gc


def phase_train_model_check(dev):
    """One YOLOv8m f32 train step (no corruption, no HSV/flip) on the card
    (kernels, TF32 off) and on the CPU (plain versions), same weights and
    batch: loss within 1e-4 relative, each parameter's gradient within
    1e-3 x max|ref| of its leaf."""
    import numpy as np
    import torch
    from robust_object_detection_tpu_torch.core.config import \
        CorruptionConfig
    from robust_object_detection_tpu_torch.models import yolov8 as Y
    from robust_object_detection_tpu_torch.train import detector as D

    images, gb, gc = detection_batch(np.random.RandomState(SEED + 2), 2, 128,
                                     8, 16)
    tx, _ = D.make_optimizer()
    step = D.make_train_step(128, CorruptionConfig(), augment=False)
    res = {}
    for name, device in (("card", dev), ("cpu", torch.device("cpu"))):
        model = Y.create(6, "m", torch.float32, device,
                         torch.Generator().manual_seed(SEED), train=True)
        state = D.init_state(model, tx)
        # the gradients as backward leaves them (the optimizer's foreach
        # nesterov update adds the momentum into .grad in place on CUDA)
        grads = {}
        for n, p in model.named_parameters():
            if p.requires_grad:
                p.register_post_accumulate_grad_hook(
                    lambda p, n=n: grads.__setitem__(n, p.grad.detach().cpu()))
        with torch.backends.cudnn.flags(allow_tf32=False):
            m = step(state, torch.from_numpy(images).to(device),
                     torch.from_numpy(gb).to(device),
                     torch.from_numpy(gc).to(device),
                     torch.Generator(device).manual_seed(SEED))
        res[name] = (m, grads)
    (mc, gcard), (mr, gref) = res["card"], res["cpu"]
    loss_rel = abs(mc["loss"].item() - mr["loss"].item()) / abs(
        mr["loss"].item())
    require(gcard.keys() == gref.keys(), "gradient leaves differ")
    worst, worst_name = 0.0, ""
    for n, r in gref.items():
        e = ((gcard[n] - r).abs().max() / (r.abs().max() + 1e-12)).item()
        if e > worst:
            worst, worst_name = e, n
    print(f"[train-model] YOLOv8m f32 128px train step card vs CPU: loss "
          f"{mc['loss'].item()} vs {mr['loss'].item()} (rel {loss_rel}, "
          f"tol 1e-4); num_fg {mc['num_fg'].item()} vs "
          f"{mr['num_fg'].item()}; worst gradient rel err {worst} at "
          f"{worst_name} over {len(gref)} leaves (tol 1e-3)")
    require(loss_rel <= 1e-4, f"train-step loss differs by {loss_rel}")
    require(math.isfinite(worst) and worst <= 1e-3,
            f"gradient {worst_name} differs by {worst} x max|ref|")


def phase_training(dev):
    """The training slice through the port's entry points; returns the
    launch counts of the timed steps."""
    import numpy as np
    import torch
    from robust_object_detection_tpu_torch.core.config import \
        CorruptionConfig
    from robust_object_detection_tpu_torch.models import yolov8 as Y
    from robust_object_detection_tpu_torch.ops import conv3x3 as C
    from robust_object_detection_tpu_torch.ops import fused_corrupt as FC
    from robust_object_detection_tpu_torch.ops import yolo_front as TF
    from robust_object_detection_tpu_torch.train import detector as D

    model = Y.create(6, "m", torch.bfloat16, dev,
                     torch.Generator().manual_seed(SEED), train=True,
                     bn_dtype=torch.bfloat16)
    tx, _ = D.make_optimizer()
    state = D.init_state(model, tx)
    step = D.make_train_step(IMG_SIZE, CorruptionConfig(), augment=True,
                             base_augment=True)
    images, gb, gc = detection_batch(np.random.RandomState(SEED),
                                     TRAIN_BATCH, IMG_SIZE, GT_PER_IMAGE,
                                     MAX_BOXES)
    images, gb, gc = (torch.from_numpy(a).to(dev) for a in (images, gb, gc))
    gen = torch.Generator(dev).manual_seed(SEED)

    m = step(state, images, gb, gc, gen)          # warm-up, off the count
    torch.cuda.synchronize()
    require(math.isfinite(m["loss"].item()), "warm-up loss not finite")
    bn = model.model[2].m[0].cv1.bn
    stats0 = (bn.running_mean.clone(), bn.running_var.clone(),
              model.model[0].bn.running_var.clone())
    ema0 = {n: e.clone() for n, e in state.ema.items()}

    counters = {"corrupt": FC.fused_random_corruption,
                "yolo_front_train": TF.front_fused,
                "yolo_front_bwd": TF.front_fused_backward,
                "conv3x3": C.conv3x3, "conv3x3_wgrad": C.conv3x3_wgrad}
    for f in counters.values():
        f.launches = 0
    torch.cuda.reset_peak_memory_stats(dev)
    times = []
    for i in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        m = step(state, images, gb, gc, gen)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        vals = {k: v.item() for k, v in m.items()}
        print(f"[train] step {i}: {vals}")
        require(math.isfinite(vals["loss"]) and
                math.isfinite(vals["grad_norm"]),
                f"step {i}: loss or grad_norm not finite")
    launches = {k: f.launches for k, f in counters.items()}
    peak = torch.cuda.max_memory_allocated(dev)

    per_step = {"corrupt": 1, "yolo_front_train": 1, "yolo_front_bwd": 1,
                "conv3x3": 8, "conv3x3_wgrad": 4}
    expect = {k: v * TRAIN_STEPS for k, v in per_step.items()}
    print(f"[train] launches {launches} expected {expect}")
    require(launches == expect, f"launch counts {launches} != {expect}")
    moved = [not torch.equal(a, b) for a, b in zip(
        stats0, (bn.running_mean, bn.running_var,
                 model.model[0].bn.running_var))]
    ema_moved = sum(not torch.equal(ema0[n], e) for n, e in state.ema.items())
    print(f"[train] BN running stats moved {moved}; EMA leaves moved "
          f"{ema_moved}/{len(ema0)}")
    require(all(moved), "BatchNorm running statistics did not move")
    require(ema_moved > 0, "the EMA did not move")
    ms = statistics.median(times)
    print(f"[train] YOLOv8m bf16 1024px batch {TRAIN_BATCH}, augment + "
          f"HSV/flip: step ms {times} median {ms} = "
          f"{TRAIN_BATCH / (ms / 1e3)} images/s; peak memory "
          f"{peak} bytes ({peak / 2 ** 30} GiB)")
    return launches


RTDETR_LEVELS = ((128, 128), (64, 64), (32, 32))   # P3, P4, P5 at 1024 px
RTDETR_QUERIES, RTDETR_HEADS, RTDETR_DH, RTDETR_POINTS = 300, 8, 32, 4


def stem_inputs(g, b, h, w, dev):
    """Random HGStem parameters (cm 32) and an image batch in [0, 1]."""
    import torch
    cm = 32

    def rn(*shape, scale):
        return torch.randn(*shape, device=dev, generator=g) * scale

    def ru(c):
        return torch.rand(c, device=dev, generator=g) + 0.5

    x = torch.rand(b, h, w, 3, device=dev, generator=g)
    kers = [rn(3, 3, 3, cm, scale=0.2), rn(2, 2, cm, cm // 2, scale=0.2),
            rn(2, 2, cm // 2, cm, scale=0.2), rn(3, 3, 2 * cm, cm, scale=0.1)]
    sizes = (cm, cm // 2, cm)
    affine = [(ru(c), rn(c, scale=0.1)) for c in sizes]
    means = [rn(c, scale=0.1) for c in sizes]
    variances = [ru(c) for c in sizes]
    return x, kers, affine, means, variances


def stem_args(x, kers, affine, means, variances, dtype):
    k1, k2a, k2b, k3 = (k.to(dtype) for k in kers)
    (s1, b1), (s2a, b2a), (s2b, b2b) = affine
    return (x.to(dtype), k1, s1, b1, k2a, s2a, b2a, k2b, s2b, b2b, k3, means,
            variances)


def deform_inputs(g, shapes, b, q, heads, dh, points, dev):
    """Values, sampling locations in [-0.1, 1.1] (some taps fall outside
    the maps) and softmaxed attention weights."""
    import torch
    hw = sum(h * w for h, w in shapes)
    n_l = len(shapes)
    values = torch.randn(b, hw, heads, dh, device=dev, generator=g)
    loc = torch.rand(b, q, heads, n_l, points, 2, device=dev,
                     generator=g) * 1.2 - 0.1
    attn = torch.softmax(torch.randn(b, q, heads, n_l * points, device=dev,
                                     generator=g), -1)
    return values, loc, attn.reshape(b, q, heads, n_l, points)


def phase_rtdetr_kernels(dev):
    """K4-f and K5 forward vs their plain versions, at the RT-DETR-L
    sweep's shapes and at one odd shape each. Tolerances: f32 (TF32 off)
    1e-4 x max|ref| (f32 sums in another order); bf16 K4-f 2e-2 x max|ref|
    against the f32 chain on the same bf16 values (the kernel stores a1,
    a2a, a2b and y3 in bf16: three roundings deep); bf16 K5 1e-2 x
    max|ref| (one rounding of the f32 sum)."""
    import torch
    import torch.nn.functional as F
    from robust_object_detection_tpu_torch.ops import deform as DF
    from robust_object_detection_tpu_torch.ops import stem as ST

    g = torch.Generator(dev).manual_seed(SEED + 3)
    results = {}

    # K4-f: (8, 1024, 1024, 3) -> (8, 256, 256, 32), and H != W
    stem = {}
    for shape in ((BATCH, IMG_SIZE, IMG_SIZE), (2, 36, 52)):
        raw = stem_inputs(g, *shape, dev)
        main = shape[0] == BATCH
        for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
            name = str(dtype).split(".")[-1]
            args = stem_args(*raw, dtype)
            out = ST.stem_fused_inference(*args)
            with torch.backends.cudnn.flags(allow_tf32=False):
                ref = ST.stem_reference(*(a.float() if torch.is_tensor(a)
                                          else a for a in args))
            log = []
            err = check(f"hgstem {name} {shape}", out, ref, tol, log)
            if not main:
                print(f"[rtdetr-kernels] {log[0]}")
                continue
            ms = time_ms(lambda: ST.stem_fused_inference(*args))
            plain_ms = time_ms(lambda: ST.stem_reference(*args))
            if dtype == torch.bfloat16:
                stem_parts(lambda: ST.stem_fused_inference(*args),
                           "rtdetr-kernels", f"K4-f eval {shape}")
            # cuDNN's time for each conv stage alone (channels-last views,
            # default flags): there is no one call for the chain
            b, h, w = shape
            stages = {}
            for stage, cin, k, side, stride, pad in (
                    ("stem1", 3, args[1], h, 2, 1),
                    ("stem2a", 32, args[4], h // 2 + 1, 1, 0),
                    ("stem2b", 16, args[7], h // 2 + 1, 1, 0),
                    ("stem3", 64, args[10], h // 2, 2, 1)):
                xs = torch.rand(b, side, side, cin, device=dev,
                                generator=g).to(dtype).permute(0, 3, 1, 2)
                kv = k.permute(3, 2, 0, 1)
                stages[stage] = time_ms(lambda: F.conv2d(
                    xs, kv, stride=stride, padding=pad))
            print(f"[rtdetr-kernels] {log[0]}; kernel {ms} ms plain "
                  f"{plain_ms} ms (cuDNN convs + elementwise, default "
                  f"flags); cuDNN alone per conv stage {stages} (sum "
                  f"{sum(stages.values())} ms; no single library call "
                  f"computes the chain)")
            px2, px4 = b * (h // 2) * (w // 2), b * (h // 4) * (w // 4)
            flops = 2 * (27 * 32 + 128 * 16 + 64 * 32) * px2 \
                + 2 * 576 * 32 * px4
            nbytes = (b * h * w * 3 + px4 * 32
                      + sum(k.numel() for k in raw[1])) * esize(dtype)
            stem[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                              **work(name, nbytes, flops))
        del raw, args, out, ref
    results["hgstem"] = stem

    # K5 forward: values (8, 21504, 8, 32), 300 queries, 3 levels x 4
    # points; and non-square levels with a Q that divides nothing
    deform = {}
    for shapes, b, q, heads, dh, pts in (
            (RTDETR_LEVELS, BATCH, RTDETR_QUERIES, RTDETR_HEADS, RTDETR_DH,
             RTDETR_POINTS),
            (((6, 10), (3, 5)), 2, 7, 3, 32, 2)):
        values, loc, attn = deform_inputs(g, shapes, b, q, heads, dh, pts,
                                          dev)
        main = b == BATCH
        for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 1e-2)):
            name = str(dtype).split(".")[-1]
            vd = values.to(dtype)
            out = DF.ms_deform_attn_slots(vd, shapes, loc, attn)
            ref = DF.ms_deform_attn_ref(vd.float(), shapes, loc, attn)
            log = []
            err = check(f"ms_deform_attn {name} levels {shapes} Q {q}", out,
                        ref, tol, log)
            if not main:
                print(f"[rtdetr-kernels] {log[0]}")
                continue
            ms = time_ms(lambda: DF.ms_deform_attn_slots(vd, shapes, loc,
                                                         attn))
            plain_ms = time_ms(lambda: DF.ms_deform_attn_ref(vd, shapes, loc,
                                                             attn))
            # what this run's data needs: the distinct (batch, cell, head)
            # rows its in-map taps touch, once each, and 2 operations per
            # in-map tap and channel
            rows, taps = touched_rows(DF, loc, shapes, values.shape[1],
                                      heads)
            nbytes = rows * dh * esize(dtype) + (loc.numel() + attn.numel()) \
                * 4 + out.numel() * esize(dtype)
            print(f"[rtdetr-kernels] {log[0]}; kernel {ms} ms plain "
                  f"{plain_ms} ms (torch.gather + elementwise); {taps} "
                  f"in-map taps touch {rows} distinct rows of "
                  f"{dh * esize(dtype)} bytes; no single PyTorch call "
                  f"computes it")
            deform[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                **work(name, nbytes, 2 * taps * dh))
        del values, loc, attn
    results["ms_deform_attn"] = deform

    # the wrappers refuse CUDA tensors they do not take
    raw = stem_inputs(g, 1, 8, 8, dev)
    args = stem_args(*raw, torch.float32)
    values, loc, attn = deform_inputs(g, ((4, 4), (2, 2)), 1, 3, 2, 8, 2, dev)
    shapes = ((4, 4), (2, 2))
    counters = (ST.stem_fused_inference, DF.ms_deform_attn_slots)
    bad = (lambda: ST.stem_fused_inference(args[0][:, :6], *args[1:]),
           lambda: ST.stem_fused_inference(args[0].half(), *args[1:]),
           lambda: ST.stem_fused_inference(args[0][:, :, ::2], *args[1:]),
           lambda: DF.ms_deform_attn_slots(values.half(), shapes, loc, attn),
           lambda: DF.ms_deform_attn_slots(values, ((4, 4), (2, 3)), loc,
                                           attn))
    require_refused("rtdetr-kernels", bad, counters)
    torch.cuda.synchronize()
    return results


def selected_anchors(model, x):
    """One forward of an RT-DETR; returns (outputs, the anchor index of
    every selected query (B, Q)), read off the encoder score head."""
    import torch
    from robust_object_detection_tpu_torch.models import rtdetr as R

    seen = []
    dec = model.model[28]
    hook = dec.enc_score_head.register_forward_hook(
        lambda mod, args, out: seen.append(out))
    try:
        outs = model(x)
    finally:
        hook.remove()
    scores = seen[0].amax(-1)
    size = x.shape[1]
    _, valid = R.build_anchors([(size // s, size // s) for s in (8, 16, 32)])
    scores = scores.masked_fill(~torch.from_numpy(valid).to(scores.device),
                                -1e4)
    return outs, R.top_k(scores, min(dec.cfg.queries, scores.shape[1]))[1]


def phase_rtdetr_model_check(dev):
    """RT-DETR-L f32 on the card (hand kernels, TF32 off) vs the same
    weights on the CPU (plain versions), 2 x 128 x 128 input (336 anchors,
    300 queries). Queries are matched by their anchor: near-tied encoder
    scores may come out in another order on the two devices, which moves
    rows and nothing else. Last-layer logits and boxes within 2e-3 x
    max|ref|; decoded scores (sorted) within 2e-3."""
    import torch
    from robust_object_detection_tpu_torch.models import rtdetr as R

    gpu = R.create(6, torch.float32, dev, torch.Generator().manual_seed(SEED))
    cpu = R.create(6, torch.float32, torch.device("cpu"),
                   torch.Generator().manual_seed(SEED))
    x = torch.rand(2, 128, 128, 3, generator=torch.Generator().manual_seed(1))
    with torch.no_grad(), torch.backends.cudnn.flags(allow_tf32=False):
        outs, sel = selected_anchors(gpu, x.to(dev))
        refs, rsel = selected_anchors(cpu, x)
    sel = sel.cpu()
    worst = 0.0
    for b in range(x.shape[0]):
        require(set(sel[b].tolist()) == set(rsel[b].tolist()),
                f"image {b}: the card selected other anchors than the CPU")
        rows, rrows = torch.argsort(sel[b]), torch.argsort(rsel[b])
        for key in ("logits", "boxes"):
            o, r = outs[key][-1, b].cpu()[rows], refs[key][-1, b][rrows]
            require(o.shape == r.shape and bool(torch.isfinite(o).all()),
                    f"{key}: shape or non-finite values")
            err, scale = max_err(o, r)
            worst = max(worst, err / scale)
    s_card = R.postprocess({k: v.cpu() for k, v in outs.items()}, 128)[1]
    s_cpu = R.postprocess(refs, 128)[1]
    s_err = (s_card - s_cpu).abs().max().item()
    moved = int((sel != rsel).sum().item())
    print(f"[rtdetr-model] RT-DETR-L f32 128px card vs CPU: same anchors "
          f"selected ({moved} of {sel.numel()} in another order); "
          f"last-layer logits / boxes max rel err {worst} (tol 2e-3); top-"
          f"{s_cpu.shape[1]} decoded scores max abs err {s_err} (tol 2e-3)")
    require(math.isfinite(worst) and worst <= 2e-3,
            f"card outputs differ from the CPU reference by {worst}")
    require(s_err <= 2e-3, f"decoded scores differ by {s_err}")


def phase_rtdetr_sweep(dev):
    """The RT-DETR-L sweep (NMS-free predict step); returns the launch
    counts of its run."""
    import torch
    from robust_object_detection_tpu_torch.models import rtdetr as R
    from robust_object_detection_tpu_torch.ops import conv3x3 as C
    from robust_object_detection_tpu_torch.ops import deform as DF
    from robust_object_detection_tpu_torch.ops import stem as ST
    from robust_object_detection_tpu_torch.train import rtdetr as RT

    model = R.create(6, torch.bfloat16, dev,
                     torch.Generator().manual_seed(SEED))
    launches, (boxes, scores, classes, valid) = run_sweep(
        dev, "rtdetr-sweep", "RT-DETR-L", model,
        RT.make_predict_step(IMG_SIZE),
        {"hgstem": ST.stem_fused_inference,
         "ms_deform_attn": DF.ms_deform_attn_slots, "conv3x3": C.conv3x3},
        {"hgstem": 1, "ms_deform_attn": 6, "conv3x3": 6})
    require(boxes.shape == (4, BATCH, 300, 4) and bool(valid.all()),
            "the NMS-free decode returns all 300 queries, valid")
    require(bool(((scores > 0) & (scores < 1)).all()
                 and ((classes >= 0) & (classes < 6)).all()),
            "scores outside (0, 1) or classes outside 0..5")
    print(f"[rtdetr-sweep] score range by pass (Clean, Noise, Blur, LowRes): "
          f"{[(s.min().item(), s.max().item()) for s in scores]}")
    return launches


def stem_train_params(g, dev):
    """Random HGStem parameters in stem_fused's order (f32 masters)."""
    _, kers, affine, _, _ = stem_inputs(g, 1, 4, 4, dev)
    (s1, b1), (s2a, b2a), (s2b, b2b) = affine
    return [kers[0], s1, b1, kers[1], s2a, b2a, kers[2], s2b, b2b, kers[3]]


STEM_PARAMS = ("k1", "sc1", "bi1", "k2a", "sc2a", "bi2a", "k2b", "sc2b",
               "bi2b", "k3")


def stem_work(dtype: str, b: int, h: int, w: int, elt: int, backward: bool):
    """The train-mode stem at (b, h, w, 3) as a function: the forward reads
    x and the filters and writes y3 (and 8 statistics vectors); its VJP
    reads x, y3, the filters and dy3 and writes the f32 filter and affine
    gradients. What either keeps in between (y1, y2a, y2b, the concat) is
    this implementation's choice and no part of the bound. Operations: the
    four convs forward; backward dW of all four and dX of three (none into
    the image)."""
    px2, px4 = b * (h // 2) * (w // 2), b * (h // 4) * (w // 4)
    f1, f2 = 2 * 27 * 32 * px2, 2 * 128 * 16 * px2
    f3 = 2 * 576 * 32 * px4
    n_filters = 27 * 32 + 2 * 128 * 16 + 576 * 32
    if backward:
        nbytes = (b * h * w * 3 + 2 * px4 * 32 + n_filters) * elt \
            + (n_filters + 6 * 32) * 4
        return work(dtype, nbytes, f1 + 2 * (2 * f2 + f3))
    nbytes = (b * h * w * 3 + px4 * 32 + n_filters) * elt + 8 * 32 * 4
    return work(dtype, nbytes, f1 + 2 * f2 + f3)


def phase_rtdetr_train_kernels(dev):
    """K4-f train, K4-b, K5 backward and K6 vs their plain versions at the
    RT-DETR-L train step's shapes and at one odd shape each. Tolerances,
    each x max|ref|: K4-f train y3 1e-4 in f32 (TF32 off) and 2e-2 in bf16,
    its eight batch statistics 1e-3 and 2e-2 (sums over B x H x W); K4-b's
    ten gradients 1e-3 in f32 and 8e-2 in bf16 (0.25 at the odd bf16
    shape, whose sums run over 936 pixels only; its f32 check holds the
    edges), against the autograd of the plain chain in the same dtype,
    which rounds the stored tensors where the kernels do (a last-bit
    difference of a stored bf16 y flips roundings four tensors down the
    chain); K4-b twice gives identical bits. K5 backward against the
    autograd of the plain gather version in f32 on the same values:
    d(values) 1e-4 in f32 (f32 atomics: another order every run) and 2e-2
    in bf16 (one rounding of the f32 sum), d(loc) and d(attn) 1e-4 and
    1e-3, and the same bits for d(loc) and d(attn) under a permutation of
    the queries. K6: the same assignment
    and capped flags as the plain round loop + greedy completion, by
    equality, on costs that converge, on a batch built to hit the round
    cap (as many valid GTs as queries) and with an image without GT. The
    kernels of earlier paths that this step also launches are held at the
    shapes it gives them: K5 forward at 428 queries (1e-4 / 1e-2), K3-b and
    K3-f as dX at (8, 256, 256, 48) and K1 at (8, 1024, 1024, 3), with the
    tolerances of phase_train_kernels."""
    import torch
    import torch.nn.functional as F
    from robust_object_detection_tpu_torch.ops import assignment as AS
    from robust_object_detection_tpu_torch.ops import conv3x3 as C
    from robust_object_detection_tpu_torch.ops import deform as DF
    from robust_object_detection_tpu_torch.ops import fused_corrupt as FC
    from robust_object_detection_tpu_torch.ops import stem as ST

    g = torch.Generator(dev).manual_seed(SEED + 4)
    results = {}

    # K4-f train and K4-b: (8, 1024, 1024, 3), and H != W
    fwd, bwd = {}, {}
    params = stem_train_params(g, dev)
    for shape in ((RTDETR_TRAIN_BATCH, IMG_SIZE, IMG_SIZE), (2, 36, 52)):
        b, h, w = shape
        main = b == RTDETR_TRAIN_BATCH
        x = torch.rand(b, h, w, 3, device=dev, generator=g)
        cots = [torch.randn(b, h // 4, w // 4, 32, device=dev, generator=g)]
        cots += [torch.randn(c, device=dev, generator=g) * 0.1
                 for c in (32, 16, 32, 32) * 2]
        for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
            name = str(dtype).split(".")[-1]
            stol = 1e-3 if dtype == torch.float32 else tol
            gtol = 1e-3 if dtype == torch.float32 else 8e-2
            if dtype == torch.bfloat16 and not main:
                gtol = 0.25      # 936 pixels: each flipped rounding shows
            xd = x.to(dtype)
            ps = [t.clone().requires_grad_() for t in params]
            rs = [t.clone().requires_grad_() for t in params]
            cd = [cots[0].to(dtype)] + cots[1:]
            log = []
            out = ST.stem_fused(xd, *ps)
            flat = (out[0], *out[1], *out[2])
            with torch.backends.cudnn.flags(allow_tf32=False):
                ref = ST.stem_train_reference(xd, *rs)
                rflat = (ref[0], *ref[1], *ref[2])
                err = check(f"hgstem train y3 {name} {shape}", flat[0],
                            rflat[0].float(), tol, log)
                for i in range(8):
                    check(f"{'mean' if i < 4 else 'var'}{i % 4} {name}",
                          flat[1 + i], rflat[1 + i], stol, log)
                grads = torch.autograd.grad(flat, ps, cd, retain_graph=True)
                rgrads = torch.autograd.grad(rflat, rs, cd)
            gerr = max(check(f"d{n} {name}", a, r, gtol, log)
                       for n, a, r in zip(STEM_PARAMS, grads, rgrads))
            again = torch.autograd.grad(flat, ps, cd)
            require(all(torch.equal(a, c) for a, c in zip(grads, again)),
                    "K4-b is not deterministic")
            del out, flat, ref, rflat, grads, rgrads, again
            if not main:
                print(f"[rtdetr-train-kernels] {'; '.join(log)}")
                continue
            with torch.no_grad():
                ms = time_ms(lambda: ST.stem_fused(xd, *ps))
                plain_ms = time_ms(lambda: ST.stem_train_reference(xd, *ps))
                if dtype == torch.bfloat16:
                    stem_parts(lambda: ST.stem_fused(xd, *ps),
                               "rtdetr-train-kernels", f"K4-f train {shape}")
            out = ST.stem_fused(xd, *ps)
            flat = (out[0], *out[1], *out[2])
            bms = time_ms(lambda: torch.autograd.grad(flat, ps, cd,
                                                      retain_graph=True))
            if dtype == torch.bfloat16:
                stem_parts(lambda: torch.autograd.grad(flat, ps, cd,
                                                       retain_graph=True),
                           "rtdetr-train-kernels", f"K4-b {shape}")
            del out, flat
            pout = ST.stem_train_reference(xd, *ps)
            pflat = (pout[0], *pout[1], *pout[2])
            bplain = time_ms(lambda: torch.autograd.grad(pflat, ps, cd,
                                                         retain_graph=True))
            del pout, pflat
            # cuDNN alone, stage by stage (channels-last views, default
            # flags): no one call computes the chain's backward
            stages = {}
            for stage, cin, cout, k, side, stride, pad, need_dx in (
                    ("stem1", 3, 32, 3, h, 2, 1, False),
                    ("stem2a", 32, 16, 2, h // 2 + 1, 1, 0, True),
                    ("stem2b", 16, 32, 2, h // 2 + 1, 1, 0, True),
                    ("stem3", 64, 32, 3, h // 2, 2, 1, True)):
                xs = torch.rand(b, side, side, cin, device=dev,
                                generator=g).to(dtype).permute(0, 3, 1, 2)
                kv = torch.randn(cout, cin, k, k, device=dev,
                                 generator=g).to(dtype)
                dys = torch.randn_like(F.conv2d(xs, kv, stride=stride,
                                                padding=pad))
                t = time_ms(lambda: torch.nn.grad.conv2d_weight(
                    xs, kv.shape, dys, stride=stride, padding=pad))
                if need_dx:
                    t += time_ms(lambda: torch.nn.grad.conv2d_input(
                        xs.shape, kv, dys, stride=stride, padding=pad))
                stages[stage] = t
                del xs, dys
            print(f"[rtdetr-train-kernels] {'; '.join(log)}; K4-f train "
                  f"kernel {ms} ms plain {plain_ms} ms (cuDNN convs + "
                  f"elementwise); K4-b kernel {bms} ms plain {bplain} ms "
                  f"(autograd of the plain chain); cuDNN alone per stage "
                  f"(conv2d_weight + conv2d_input) {stages} (sum "
                  f"{sum(stages.values())} ms; no single library call "
                  f"computes either)")
            fwd[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                             **stem_work(name, b, h, w, esize(dtype), False))
            bwd[name] = dict(max_abs_err=gerr, ms=bms, plain_ms=bplain,
                             **stem_work(name, b, h, w, esize(dtype), True))
        del x, cots
    results["hgstem_train"] = fwd
    results["hgstem_bwd"] = bwd
    torch.cuda.empty_cache()

    # K5 backward: values (8, 21504, 8, 32), 300 + 128 queries, 3 levels x
    # 4 points; and non-square levels with a Q that divides nothing
    dbwd = {}
    q_train = RTDETR_QUERIES + 2 * 2 * 32
    for shapes, b, q, heads, dh, pts in (
            (RTDETR_LEVELS, RTDETR_TRAIN_BATCH, q_train, RTDETR_HEADS,
             RTDETR_DH, RTDETR_POINTS),
            (((6, 10), (3, 5)), 2, 7, 3, 32, 2)):
        values, loc, attn = deform_inputs(g, shapes, b, q, heads, dh, pts,
                                          dev)
        dout = torch.randn(b, q, heads, dh, device=dev, generator=g)
        main = b == RTDETR_TRAIN_BATCH
        for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
            name = str(dtype).split(".")[-1]
            vd, dd = values.to(dtype), dout.to(dtype)
            dv, dloc, dattn = DF.ms_deform_attn_backward(vd, shapes, loc,
                                                         attn, dd)
            leaves = [t.clone().requires_grad_()
                      for t in (vd.float(), loc, attn)]
            rdv, rdloc, rdattn = torch.autograd.grad(
                DF.ms_deform_attn_ref(leaves[0], shapes, leaves[1],
                                      leaves[2]), leaves, dd.float())
            log = []
            ltol = 1e-4 if dtype == torch.float32 else 1e-3
            err = check(f"ms_deform_attn bwd d(values) {name} levels "
                        f"{shapes} Q {q}", dv, rdv, tol, log)
            err = max(err, check(f"d(loc) {name}", dloc, rdloc, ltol, log),
                      check(f"d(attn) {name}", dattn, rdattn, ltol, log))
            perm = torch.randperm(q, device=dev, generator=g)
            _, ploc, pattn = DF.ms_deform_attn_backward(
                vd, shapes, loc[:, perm].contiguous(),
                attn[:, perm].contiguous(), dd[:, perm].contiguous())
            require(torch.equal(ploc, dloc[:, perm])
                    and torch.equal(pattn, dattn[:, perm]),
                    "d(loc) / d(attn) change bits with the query order")
            del leaves, rdv, rdloc, rdattn, ploc, pattn
            if not main:
                print(f"[rtdetr-train-kernels] {'; '.join(log)}")
                continue
            # the forward at this path's 428 queries (the sweep's 300 are
            # held in phase_rtdetr_kernels), same tolerances as there
            check(f"ms_deform_attn fwd {name} Q {q}",
                  DF.ms_deform_attn_slots(vd, shapes, loc, attn),
                  DF.ms_deform_attn_ref(vd.float(), shapes, loc, attn),
                  1e-4 if dtype == torch.float32 else 1e-2, log)
            ms = time_ms(lambda: DF.ms_deform_attn_backward(vd, shapes, loc,
                                                            attn, dd))
            leaves = [t.clone().requires_grad_() for t in (vd, loc, attn)]
            pout = DF.ms_deform_attn_ref(leaves[0], shapes, leaves[1],
                                         leaves[2])
            plain_ms = time_ms(lambda: torch.autograd.grad(
                pout, leaves, dd, retain_graph=True))
            del leaves, pout
            # what this run's data needs: the distinct value rows its
            # in-map taps touch read once, d(values) written once, and 4
            # operations per in-map tap and channel
            rows, taps = touched_rows(DF, loc, shapes, values.shape[1],
                                      heads)
            elt = esize(dtype)
            nbytes = (rows * dh + values.numel() + 2 * dout.numel()) * elt \
                + 2 * (loc.numel() + attn.numel()) * 4
            print(f"[rtdetr-train-kernels] {'; '.join(log)}; kernel {ms} ms "
                  f"(zero fill, atomics and cast of the f32 d(values) "
                  f"included) plain {plain_ms} ms (autograd of torch.gather "
                  f"+ elementwise); {taps} in-map taps, {rows} distinct "
                  f"rows; no single PyTorch call computes it")
            dbwd[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                              **work(name, nbytes, 4 * taps * dh))
        del values, loc, attn, dout
    results["ms_deform_attn_bwd"] = dbwd
    torch.cuda.empty_cache()

    # the kernels this path shares with the YOLOv8m train step, at its own
    # batch of 8: K3-b and K3-f as dX on the stage-1 HGBlock's convs,
    # (8, 256, 256, 48) -> 48 (the forward at this shape is held in
    # phase_kernels), and K1 on (8, 1024, 1024, 3); tolerances as in
    # phase_train_kernels, no timing
    x = torch.randn(RTDETR_TRAIN_BATCH, 256, 256, 48, device=dev, generator=g)
    dy = torch.randn(RTDETR_TRAIN_BATCH, 256, 256, 48, device=dev,
                     generator=g)
    k = torch.randn(3, 3, 48, 48, device=dev, generator=g) * 0.1
    log = []
    for dtype in (torch.float32, torch.bfloat16):
        check_conv3x3_backward(C, x.to(dtype), dy.to(dtype), k.to(dtype),
                               1e-3, log)
    print(f"[rtdetr-train-kernels] {'; '.join(log)}")
    del x, dy
    img, _, _, per_branch, nmean, nstd = check_corrupt(FC, g, dev,
                                                       RTDETR_TRAIN_BATCH)
    print(f"[rtdetr-train-kernels] corrupt f32 {tuple(img.shape)}: max abs "
          f"diff by branch (clean, noise, blur, lowres) {per_branch}; "
          f"mid-grey noise mean {nmean} std {nstd}")
    del img
    torch.cuda.empty_cache()

    # K6: cost (8, 300, 300), 80 valid GTs an image (the train step's);
    # the same with 300 valid GTs, which hits the 16-round cap so that the
    # greedy completion runs; and Q 7, M 5 with an image without GT
    auction = {}
    cases = (("train", 8, 300, 300, 80, False), ("capped", 8, 300, 300, 300,
                                                 False),
             ("odd", 3, 7, 5, 3, True))
    for tag, b, q, m, n_valid, empty_image in cases:
        cost = torch.rand(b, q, m, device=dev, generator=g) * 4
        valid = torch.zeros(b, m, dtype=torch.bool, device=dev)
        valid[:, :n_valid] = True
        if empty_image:
            valid[0] = False
        cost = torch.where(valid[:, None, :], cost,
                           torch.full_like(cost, AS.BIG))
        owner, capped = AS.auction_assignment(cost, valid, max_rounds=16)
        powner, pcapped = AS.auction_assignment_plain(cost, valid,
                                                      max_rounds=16)
        same = bool(torch.equal(owner, powner)
                    and torch.equal(capped, pcapped))
        n_capped = int(capped.sum().item())
        matched = (owner >= 0).sum(1).tolist()
        print(f"[rtdetr-train-kernels] auction {tag} (B {b}, Q {q}, M {m}, "
              f"{n_valid} valid): equal to the plain version {same}; capped "
              f"images {n_capped}; matched per image {matched}")
        require(same, f"auction {tag}: kernel and plain version differ")
        if tag == "capped":
            require(n_capped == b, "the capped case did not hit the cap")
            cms = time_ms(lambda: AS.auction_assignment(cost, valid,
                                                        max_rounds=16))
            print(f"[rtdetr-train-kernels] auction capped: kernel {cms} ms "
                  f"(16 rounds, then {q} greedy picks an image)")
        if tag != "train":
            continue
        ms = time_ms(lambda: AS.auction_assignment(cost, valid,
                                                   max_rounds=16))
        plain_ms = time_ms(lambda: AS.auction_assignment_plain(
            cost, valid, max_rounds=16), iters=3, warmup=1)
        print(f"[rtdetr-train-kernels] auction train shape: kernel {ms} ms "
              f"(transpose of the cost included) plain {plain_ms} ms (a "
              f"tensor pass and a host sync per round); no single PyTorch "
              f"call computes it")
        # reads the cost once, writes the assignment; a dozen compares per
        # (GT, query) pair and round at most
        auction["float32"] = dict(
            max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
            **work("float32", cost.numel() * 4 + valid.numel() + b * q * 4,
                   16 * 4 * n_valid * q * b))
    results["auction"] = auction

    # the new wrappers refuse CUDA tensors they do not take
    x = torch.rand(1, 8, 8, 3, device=dev, generator=g)
    values, loc, attn = deform_inputs(g, ((4, 4), (2, 2)), 1, 3, 2, 8, 2, dev)
    cost = torch.zeros(1, 4, 3, device=dev)
    valid = torch.ones(1, 3, dtype=torch.bool, device=dev)
    counters = (ST.stem_fused, ST.stem_fused_backward,
                DF.ms_deform_attn_backward, AS.auction_assignment)
    bad = (lambda: ST.stem_fused(x[:, :6], *params),
           lambda: ST.stem_fused(x.half(), *params),
           lambda: ST.stem_fused(x, params[0].cpu(), *params[1:]),
           lambda: DF.ms_deform_attn_backward(values, ((4, 4), (2, 2)), loc,
                                              attn, values[:, :2]),
           lambda: AS.auction_assignment(cost.double(), valid),
           lambda: AS.auction_assignment(cost, valid[:, :2]),
           lambda: AS.auction_assignment(cost, valid.cpu()))
    require_refused("rtdetr-train-kernels", bad, counters)
    torch.cuda.synchronize()
    return results


def phase_rtdetr_train_model_check(dev):
    """Forward, loss and backward of one RT-DETR-L f32 train batch at 128
    px, batch 2, on the card (kernels, TF32 off) and on the CPU (plain
    versions): the same weights, images, boxes and denoising queries (drawn
    once on the CPU). The encoder score kernel is zeroed, so every valid
    anchor scores exactly its bias and both devices select the same
    anchors in the same order (near-tied scores would reorder the queries,
    and the auction's eps-optimal result depends on their order).

    Card and CPU costs differ by f32 noise, which can flip a near-tied
    match and with it a tenth of the loss's gradient. So the card runs
    first with its own matcher (K6) and the CPU run takes the card's seven
    assignments instead of solving its own; every one of them is also
    solved again by the plain version on the CPU from the card's own cost
    tensor and must be equal.

    What is held: the loss within 2e-3 relative; those assignments; the
    gradients by direction and size: through ~120 train-mode BatchNorms
    f32 noise grows to ~1e-3 of
    the deep pre-activations, which flips that share of the ReLU masks and
    moves every leaf's gradient by a few per cent in L2 (card vs CPU as
    CPU vs the JAX reference, tests/test_torch_rtdetr_train_step.py), so:
    global cosine >= 0.99, and for each leaf that carries more than 1e-4
    of the gradient's norm a relative L2 error <= 0.15. This phase holds
    the wiring on the card (which wrapper gets which tensors), not the
    last digits: that no term of the gradient is missing is shown without
    the noise, in float64, by the CPU test named above (every leaf within
    1e-6 of the reference), and each kernel is held against its plain
    version at this path's shapes in phase_rtdetr_train_kernels. A control
    is printed beside it: the card once more with the plain versions in
    the wrappers' place, whose distance from the CPU run is f32 noise
    alone."""
    import numpy as np
    import torch
    from robust_object_detection_tpu_torch.models import layers as L
    from robust_object_detection_tpu_torch.models import rtdetr as R
    from robust_object_detection_tpu_torch.ops import assignment as AS
    from robust_object_detection_tpu_torch.ops import conv3x3 as C
    from robust_object_detection_tpu_torch.ops import deform as DF
    from robust_object_detection_tpu_torch.ops import stem as ST
    from robust_object_detection_tpu_torch.train import rtdetr as RT

    size, nb = 128, 2
    images, gb, gc = detection_batch(np.random.RandomState(SEED + 5), nb, size,
                                     8, 16)
    x = torch.from_numpy(images).float() / 255.0
    gb, gc = torch.from_numpy(gb), torch.from_numpy(gc)
    gt_n = RT.to_norm_cxcywh(gb, size)
    dn, dn_gt, dn_active = RT.build_dn_queries(
        gt_n, gc, torch.Generator().manual_seed(SEED), max_gt=8)

    solved = []
    solve = RT.auction_assignment

    def recording(cost, valid, **kw):
        owner, capped = solve(cost, valid, **kw)
        solved.append((cost, valid, owner, capped, kw))
        return owner, capped

    def replaying(cost, valid, **kw):
        _, _, owner, capped, _ = solved[replaying.calls]
        replaying.calls += 1
        return owner.to(cost.device), capped.to(cost.device)

    replaying.calls = 0

    # the control: the card again with every wrapper replaced by its plain
    # version, so its distance from the CPU run is f32 noise alone
    plain = ((R, "stem_fused", ST.stem_train_reference),
             (L, "conv3x3", C.conv3x3_reference),
             (R, "ms_deform_attn_slots", DF.ms_deform_attn_ref))
    kernel_versions = [(mod, attr, getattr(mod, attr))
                       for mod, attr, _ in plain]

    res = {}
    for name, device in (("card", dev), ("cpu", torch.device("cpu")),
                         ("card-plain", dev)):
        model = R.create(6, torch.float32, device,
                         torch.Generator().manual_seed(SEED), train=True)
        with torch.no_grad():
            model.model[28].enc_score_head.weight.zero_()
        to = lambda t: t.to(device)
        RT.auction_assignment = recording if name == "card" else replaying
        replaying.calls = 0
        for mod, attr, fn in plain if name == "card-plain" else ():
            setattr(mod, attr, fn)
        try:
            with torch.backends.cudnn.flags(allow_tf32=False):
                outs = model(to(x), {k: to(v) for k, v in dn.items()})
                loss, metrics = RT.rtdetr_loss(outs, to(gb), to(gc), size)
                for li in range(outs["dn_logits"].shape[0]):
                    loss = loss + RT.dn_loss(
                        outs["dn_logits"][li], outs["dn_boxes"][li],
                        to(dn_gt), to(dn_active), to(gt_n), to(gc))
                loss.backward()
        finally:
            RT.auction_assignment = solve
            for mod, attr, fn in kernel_versions:
                setattr(mod, attr, fn)
        require(len(solved) == 7
                and replaying.calls == (0 if name == "card" else 7),
                f"{name}: {len(solved)} matchings solved, "
                f"{replaying.calls} replayed, not 7")
        res[name] = (loss.item(), {k: v.item() for k, v in metrics.items()},
                     {n: p.grad.detach().cpu().double()
                      for n, p in model.named_parameters()})
    (lc, mc, gcard), (lr, mr, gref) = res["card"], res["cpu"]
    for i, (cost, valid, owner, capped, kw) in enumerate(solved):
        powner, pcapped = AS.auction_assignment(cost.cpu(), valid.cpu(), **kw)
        require(torch.equal(owner.cpu(), powner)
                and torch.equal(capped.cpu(), pcapped),
                f"matching {i}: K6 and the plain version differ on the "
                f"card's cost tensor")
    loss_rel = abs(lc - lr) / abs(lr)
    require(gcard.keys() == gref.keys(), "gradient leaves differ")
    norms = {n: r.norm().item() for n, r in gref.items()}
    total = math.sqrt(sum(v * v for v in norms.values()))

    def against_cpu(grads):
        """(cosine, norm, worst relative L2 error over the significant
        leaves, its name, their count) of grads against the CPU run's."""
        dot = sum((grads[n] * r).sum().item() for n, r in gref.items())
        size = math.sqrt(sum(g.norm().item() ** 2 for g in grads.values()))
        errs = {n: ((grads[n] - r).norm() / norms[n]).item()
                for n, r in gref.items() if norms[n] > 1e-4 * total}
        name = max(errs, key=errs.get)
        return dot / (total * size), size, errs[name], name, len(errs)

    cos, card_total, worst, worst_name, significant = against_cpu(gcard)
    pcos, _, pworst, pworst_name, _ = against_cpu(res["card-plain"][2])
    print(f"[rtdetr-train-model] RT-DETR-L f32 128px train batch card vs "
          f"CPU: loss {lc} vs {lr} (rel {loss_rel}, tol 2e-3); metrics {mc} "
          f"vs {mr}; 7 matchings of K6 equal to the plain version on the "
          f"card's costs (capped image-matchings {mc['matcher_capped']}); "
          f"gradient cosine {cos} (>= 0.99), norm {card_total} vs {total}; "
          f"worst relative L2 error {worst} at {worst_name} over "
          f"{significant} significant of {len(gref)} leaves (tol 0.15); "
          f"control, the card with the plain versions vs CPU: loss "
          f"{res['card-plain'][0]}, cosine {pcos}, worst relative L2 error "
          f"{pworst} at {pworst_name}")
    require(loss_rel <= 2e-3, f"train loss differs by {loss_rel}")
    require(math.isfinite(cos) and cos >= 0.99,
            f"gradient cosine {cos} < 0.99")
    require(abs(card_total - total) <= 0.05 * total, "gradient norms differ")
    require(math.isfinite(worst) and worst <= 0.15,
            f"gradient {worst_name} differs by {worst} in L2")


def phase_rtdetr_training(dev):
    """The RT-DETR-L training slice through the port's entry points;
    returns the launch counts of the timed steps."""
    import numpy as np
    import torch
    from robust_object_detection_tpu_torch.core.config import \
        CorruptionConfig
    from robust_object_detection_tpu_torch.models import rtdetr as R
    from robust_object_detection_tpu_torch.ops import assignment as AS
    from robust_object_detection_tpu_torch.ops import conv3x3 as C
    from robust_object_detection_tpu_torch.ops import deform as DF
    from robust_object_detection_tpu_torch.ops import fused_corrupt as FC
    from robust_object_detection_tpu_torch.ops import stem as ST
    from robust_object_detection_tpu_torch.train import rtdetr as RT

    nb = RTDETR_TRAIN_BATCH
    model = R.create(6, torch.bfloat16, dev,
                     torch.Generator().manual_seed(SEED), train=True,
                     bn_dtype=torch.bfloat16)
    tx, _ = RT.make_optimizer()
    state = RT.init_state(model, tx)
    step = RT.make_train_step(IMG_SIZE, CorruptionConfig(), augment=True,
                              base_augment=True)
    images, gb, gc = detection_batch(np.random.RandomState(SEED), nb,
                                     IMG_SIZE, GT_PER_IMAGE, MAX_BOXES)
    images, gb, gc = (torch.from_numpy(a).to(dev) for a in (images, gb, gc))
    gen = torch.Generator(dev).manual_seed(SEED)

    m = step(state, images, gb, gc, gen)          # warm-up, off the count
    torch.cuda.synchronize()
    require(math.isfinite(m["loss"].item()), "warm-up loss not finite")
    bns = (model.model[0].stem1.bn, model.model[0].stem3.bn,
           model.model[1].m[0].bn, model.model[28].input_proj[0][1])
    stats0 = [(bn.running_mean.clone(), bn.running_var.clone())
              for bn in bns]
    ema0 = {n: e.clone() for n, e in state.ema.items()}

    counters = {"corrupt": FC.fused_random_corruption,
                "hgstem_train": ST.stem_fused,
                "hgstem_bwd": ST.stem_fused_backward,
                "conv3x3": C.conv3x3, "conv3x3_wgrad": C.conv3x3_wgrad,
                "ms_deform_attn": DF.ms_deform_attn_slots,
                "ms_deform_attn_bwd": DF.ms_deform_attn_backward,
                "auction": AS.auction_assignment}
    for f in counters.values():
        f.launches = 0
    torch.cuda.reset_peak_memory_stats(dev)
    times = []
    for i in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        m = step(state, images, gb, gc, gen)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        vals = {k: v.item() for k, v in m.items()}
        print(f"[rtdetr-train] step {i}: {vals}")
        require(math.isfinite(vals["loss"]) and
                math.isfinite(vals["grad_norm"]),
                f"step {i}: loss or grad_norm not finite")
    launches = {k: f.launches for k, f in counters.items()}
    peak = torch.cuda.max_memory_allocated(dev)

    per_step = {"corrupt": 1, "hgstem_train": 1, "hgstem_bwd": 1,
                "conv3x3": 12, "conv3x3_wgrad": 6, "ms_deform_attn": 6,
                "ms_deform_attn_bwd": 6, "auction": 7}
    expect = {k: v * TRAIN_STEPS for k, v in per_step.items()}
    print(f"[rtdetr-train] launches {launches} expected {expect}")
    require(launches == expect, f"launch counts {launches} != {expect}")
    moved = [not torch.equal(a, bn.running_mean)
             and not torch.equal(b, bn.running_var)
             for (a, b), bn in zip(stats0, bns)]
    ema_moved = sum(not torch.equal(ema0[n], e) for n, e in state.ema.items())
    no_grad = [n for n, p in model.named_parameters() if p.grad is None]
    print(f"[rtdetr-train] BN running stats moved {moved}; EMA leaves moved "
          f"{ema_moved}/{len(ema0)}; parameters without a gradient "
          f"{len(no_grad)}")
    require(all(moved), "BatchNorm running statistics did not move")
    require(ema_moved > 0, "the EMA did not move")
    require(not no_grad, f"parameters without a gradient: {no_grad[:5]}")
    ms = statistics.median(times)
    print(f"[rtdetr-train] RT-DETR-L bf16 1024px batch {nb}, augment + "
          f"HSV/flip + CDN (428 queries): step ms {times} median {ms} = "
          f"{nb / (ms / 1e3)} images/s; peak memory {peak} bytes "
          f"({peak / 2 ** 30} GiB)")
    return launches


def touched_rows(DF, loc, shapes, hw, heads):
    """(distinct (batch, cell, head) value rows the in-map taps of `loc`
    touch, number of in-map taps): what a run's data makes a gather read."""
    import torch
    b = loc.shape[0]
    idx, wgt = DF.tap_geometry(loc, shapes)
    live = wgt != 0
    bi = torch.arange(b, device=loc.device).view(b, 1, 1, 1, 1, 1)
    hi = torch.arange(heads, device=loc.device).view(1, 1, heads, 1, 1, 1)
    rows = torch.unique(((bi * hw + idx) * heads + hi)[live]).numel()
    return rows, int(live.sum().item())


def grid_sample_level(F, v, sx, sy):
    """``bilinear_sample(v, sx, sy)`` as one ``grid_sample`` call: v (B, H,
    W, heads, dh) as (B * heads, dh, H, W), the samples as a (B * heads, Q,
    P, 2) grid in [-1, 1] (pixel = (g + 1) * size / 2 - 0.5). Returns (B,
    Q, heads, P, dh)."""
    import torch
    b, h, w, heads, dh = v.shape
    q, p = sx.shape[1], sx.shape[3]
    vm = v.permute(0, 3, 4, 1, 2).reshape(b * heads, dh, h, w)
    grid = torch.stack([(sx + 0.5) * (2.0 / w) - 1, (sy + 0.5) * (2.0 / h)
                        - 1], -1).permute(0, 2, 1, 3, 4).reshape(
        b * heads, q, p, 2).to(v.dtype)
    out = F.grid_sample(vm, grid, mode="bilinear", padding_mode="zeros",
                        align_corners=False)           # (B*heads, dh, Q, P)
    return out.reshape(b, heads, dh, q, p).permute(0, 3, 1, 4, 2)


def phase_sorted_kernels(dev):
    """K5-g2 forward and backward (both layouts) and K5-g1 vs their plain
    versions, at the RT-DETR-L decoder's shapes and at one odd shape
    (levels (6, 10) and (3, 5), 7 queries, samples outside the maps, tap
    counts that are no multiple of 32, maps under 2048 cells). Tolerances,
    each x max|ref|. K5-g2 forward: 1e-4 for f32 and for bf16 values alike
    (the out is f32, so both are the plain version's f32 products summed in
    another order). K5-g2 backward against the plain backward in f32 on the
    same values: d(values) 1e-4 in f32 and 1e-2 in bf16 (one rounding of
    the f32 sum), d(loc) and d(attn) 1e-4 and 1e-3. K5-g1 against
    ``index_add_``: 1e-4 (f32 only; the same terms, perhaps in another
    order); ``bilinear_sample`` against the autograd of its plain version
    in f32: out 1e-4, d(v) 1e-4 in f32 and 1e-2 for a bf16 map, d(sx) and
    d(sy) 1e-4 and 1e-3. Every backward runs twice and must return the same
    bits. ``grid_sample`` computes ``bilinear_sample``'s function and is
    timed beside it; its f32 output must agree within 1e-4."""
    import torch
    import torch.nn.functional as F
    from robust_object_detection_tpu_torch.ops import deform as DF

    g = torch.Generator(dev).manual_seed(SEED + 5)
    results = {}
    tag = "[sorted-kernels]"
    q_train = RTDETR_QUERIES + 2 * 2 * 32

    fwd, bwd = {}, {}
    for shapes, b, q, heads, dh, pts in (
            (RTDETR_LEVELS, BATCH, RTDETR_QUERIES, RTDETR_HEADS, RTDETR_DH,
             RTDETR_POINTS),
            (RTDETR_LEVELS, RTDETR_TRAIN_BATCH, q_train, RTDETR_HEADS,
             RTDETR_DH, RTDETR_POINTS),
            (((6, 10), (3, 5)), 2, 7, 3, 32, 2)):
        values, loc, attn = deform_inputs(g, shapes, b, q, heads, dh, pts,
                                          dev)
        dout = torch.randn(b, q, heads, dh, device=dev, generator=g)
        hw = values.shape[1]
        timed = q == q_train
        if timed:
            rows, taps = touched_rows(DF, loc, shapes, hw, heads)
            # the library's sort alone, on this run's keys
            idx, _ = DF.tap_geometry(loc, shapes)
            t = q * len(shapes) * pts * 4
            sb = (t - 1).bit_length()
            keys = ((idx.permute(0, 2, 1, 3, 4, 5).reshape(b * heads, t)
                     << sb) | torch.arange(t, device=dev)).int()
            sort_ms = time_ms(lambda: torch.sort(keys, dim=-1))
            print(f"{tag} torch.sort alone on the int32 keys "
                  f"{tuple(keys.shape)}: {sort_ms} ms")
            del idx, keys
        for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 1e-2)):
            name = str(dtype).split(".")[-1]
            elt = esize(dtype)
            vd = values.to(dtype)
            ltol = 1e-4 if dtype == torch.float32 else 1e-3
            ref = DF.ms_deform_attn_ref(vd.float(), shapes, loc, attn)
            rdv, rdloc, rdattn = DF.ms_deform_attn_backward_ref(
                vd.float(), shapes, loc, attn, dout)
            for transposed in (False, True):
                layout = "values_t" if transposed else "values"
                entry = DF.ms_deform_attn_t if transposed \
                    else DF.ms_deform_attn
                given = DF.values_to_t(vd) if transposed else vd
                log = []
                out = entry(given, shapes, loc, attn)
                require(out.dtype == torch.float32, "K5-g2 out is not f32")
                ferr = check(f"ms_deform_attn_sorted {layout} {name} levels "
                             f"{shapes} Q {q}", out, ref, 1e-4, log)
                grads = DF.ms_deform_attn_sorted_backward(
                    given, shapes, loc, attn, dout, transposed)
                require(grads[0].dtype == dtype
                        and grads[0].shape == given.shape,
                        "K5-g2 d(values) is not in values' dtype and layout")
                dv = DF.values_from_t(grads[0]) if transposed else grads[0]
                berr = max(check(f"bwd d(values) {name}", dv, rdv, tol, log),
                           check(f"d(loc) {name}", grads[1], rdloc, ltol,
                                 log),
                           check(f"d(attn) {name}", grads[2], rdattn, ltol,
                                 log))
                again = DF.ms_deform_attn_sorted_backward(
                    given, shapes, loc, attn, dout, transposed)
                require(all(torch.equal(a, c) for a, c in zip(grads, again)),
                        f"K5-g2 backward ({layout}, {name}) is not "
                        f"deterministic")
                del out, grads, again, dv
                if not timed:
                    print(f"{tag} {'; '.join(log)}; second backward: "
                          f"identical bits")
                    continue
                ms = time_ms(lambda: entry(given, shapes, loc, attn))
                bms = time_ms(lambda: DF.ms_deform_attn_sorted_backward(
                    given, shapes, loc, attn, dout, transposed))
                print(f"{tag} {'; '.join(log)}; second backward: identical "
                      f"bits; forward kernel {ms} ms; backward {bms} ms "
                      f"(taps kernel + torch.sort + d(values) kernel)")
                if transposed:
                    continue
                plain_ms = time_ms(lambda: DF.ms_deform_attn_ref(
                    vd, shapes, loc, attn))
                bplain = time_ms(lambda: DF.ms_deform_attn_backward_ref(
                    vd, shapes, loc, attn, dout))
                print(f"{tag} {name} plain forward {plain_ms} ms "
                      f"(torch.gather + elementwise), plain backward "
                      f"{bplain} ms (gather + index_add_); {taps} in-map "
                      f"taps touch {rows} distinct rows of {dh * elt} bytes")
                io = (loc.numel() + attn.numel() + dout.numel()) * 4
                fwd[name] = dict(max_abs_err=ferr, ms=ms, plain_ms=plain_ms,
                                 **work(name, rows * dh * elt + io,
                                        2 * taps * dh))
                bwd[name] = dict(
                    max_abs_err=berr, ms=bms, plain_ms=bplain,
                    **work(name, (rows * dh + values.numel()) * elt + 2 * io
                           - dout.numel() * 4, 4 * taps * dh))
            del vd, ref, rdv, rdloc, rdattn
        del values, loc, attn, dout
    results["ms_deform_attn_sorted"] = fwd
    results["ms_deform_attn_sorted_bwd"] = bwd
    torch.cuda.empty_cache()

    # K5-g1, one level at a time: the three RT-DETR-L levels at 428 and 300
    # queries (T = Q * 4 points * 4 taps), and (6, 10) with 7 queries
    stamp = {}
    cases = [(BATCH, q, RTDETR_HEADS, RTDETR_DH, RTDETR_POINTS, h, w)
             for q in (q_train, RTDETR_QUERIES) for h, w in RTDETR_LEVELS]
    for b, q, heads, dh, pts, h, w in cases + [(2, 7, 3, 32, 2, 6, 10)]:
        hw = h * w
        sx = torch.rand(b, q, heads, pts, device=dev, generator=g) \
            * (w * 1.2) - 0.1 * w - 0.5
        sy = torch.rand(b, q, heads, pts, device=dev, generator=g) \
            * (h * 1.2) - 0.1 * h - 0.5
        idx = DF.tap_geometry(
            torch.stack([(sx + 0.5) / w, (sy + 0.5) / h], -1)[:, :, :, None],
            ((h, w),))[0]                              # (B,Q,heads,1,P,4)
        idx = idx.permute(0, 2, 1, 3, 4, 5).reshape(b, heads, -1).int()
        t = idx.shape[-1]
        gw = torch.randn(b, heads, dh, t, device=dev, generator=g)
        log = []
        dv = DF.stamp_scatter(idx, gw, hw)
        err = check(f"stamp_scatter f32 hw {hw} T {t} rows {b * heads}", dv,
                    DF.stamp_scatter_ref(idx, gw, hw), 1e-4, log)
        require(torch.equal(DF.stamp_scatter(idx, gw, hw), dv),
                "K5-g1 is not deterministic")
        wide = idx.long()[:, :, None, :].expand(-1, -1, dh, -1)

        def library():
            return torch.zeros(b, heads, dh, hw, device=dev).scatter_add_(
                3, wide, gw)
        check("scatter_add_", library(), dv, 1e-4, log)

        # bilinear_sample's three gradients through the kernel
        v = torch.randn(b, h, w, heads, dh, device=dev, generator=g)
        cot = torch.randn(b, q, heads, pts, dh, device=dev, generator=g)
        level_ms = {}
        for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 1e-2)):
            name = str(dtype).split(".")[-1]
            stol = 1e-4 if dtype == torch.float32 else 1e-3
            leaves = [x.clone().requires_grad_()
                      for x in (v.to(dtype), sx, sy)]
            refs = [x.clone().requires_grad_()
                    for x in (v.to(dtype).float(), sx, sy)]
            out = DF.bilinear_sample(*leaves)
            rout = DF.bilinear_sample_ref(*refs)
            grads = torch.autograd.grad(out, leaves, cot, retain_graph=True)
            rgrads = torch.autograd.grad(rout, refs, cot)
            check(f"bilinear_sample {name} out", out, rout.detach(), 1e-4,
                  log)
            check(f"d(v) {name}", grads[0], rgrads[0], tol, log)
            check(f"d(sx) {name}", grads[1], rgrads[1], stol, log)
            check(f"d(sy) {name}", grads[2], rgrads[2], stol, log)
            again = torch.autograd.grad(out, leaves, cot)
            require(all(torch.equal(a, c) for a, c in zip(grads, again)),
                    f"bilinear_sample's backward ({name}) is not "
                    f"deterministic")
            lib_out = grid_sample_level(F, leaves[0], sx, sy)
            if dtype == torch.float32:
                check("grid_sample f32 out", lib_out, rout.detach(), 1e-4,
                      log)
            if q == q_train:
                def ours():
                    o = DF.bilinear_sample(*leaves)
                    return torch.autograd.grad(o, leaves, cot)

                def theirs():
                    o = grid_sample_level(F, leaves[0], leaves[1], leaves[2])
                    return torch.autograd.grad(o, leaves, cot.to(o.dtype))
                level_ms[name] = (time_ms(ours), time_ms(theirs))
            del leaves, refs, out, rout, grads, rgrads, again, lib_out
        if q != q_train:
            print(f"{tag} {'; '.join(log)}; second runs: identical bits")
            continue
        ms = time_ms(lambda: DF.stamp_scatter(idx, gw, hw))
        plain_ms = time_ms(lambda: DF.stamp_scatter_ref(idx, gw, hw))
        lib_ms = time_ms(library)
        print(f"{tag} {'; '.join(log)}; second runs: identical bits; "
              f"stamp_scatter {ms} ms (key packing + torch.sort + kernel) "
              f"plain {plain_ms} ms (index_add_ with its layout copies) "
              f"library {lib_ms} ms (zeros + scatter_add_); bilinear_sample "
              f"forward + backward vs grid_sample forward + backward, ms: "
              f"{level_ms}")
        if hw == RTDETR_LEVELS[0][0] * RTDETR_LEVELS[0][1]:
            stamp["float32"] = dict(
                max_abs_err=err, ms=ms, plain_ms=plain_ms,
                **work("float32", (idx.numel() + gw.numel() + dv.numel()) * 4,
                       gw.numel(), lib_ms))
        del idx, gw, dv, wide, v, cot
    results["stamp_scatter"] = stamp
    torch.cuda.empty_cache()

    # the new wrappers refuse CUDA tensors they do not take
    shapes = ((4, 4), (2, 2))
    values, loc, attn = deform_inputs(g, shapes, 1, 3, 2, 8, 2, dev)
    idx = torch.zeros(1, 2, 5, dtype=torch.int32, device=dev)
    gw = torch.zeros(1, 2, 8, 5, device=dev)
    counters = (DF.ms_deform_attn_sorted_forward,
                DF.ms_deform_attn_sorted_backward, DF.stamp_scatter)
    bad = (lambda: DF.ms_deform_attn(values.half(), shapes, loc, attn),
           lambda: DF.ms_deform_attn_t(values, shapes, loc, attn),
           lambda: DF.ms_deform_attn_t(values.permute(0, 2, 3, 1), shapes,
                                       loc, attn),
           lambda: DF.ms_deform_attn(values, ((4, 4), (2, 3)), loc, attn),
           lambda: DF.ms_deform_attn_sorted_backward(values, shapes, loc,
                                                     attn, values[:, :2]),
           lambda: DF.stamp_scatter(idx, gw.double(), 16),
           lambda: DF.stamp_scatter(idx[:, :, :4], gw, 16),
           lambda: DF.stamp_scatter(idx.cpu(), gw, 16),
           lambda: DF.bilinear_sample(values.reshape(1, 4, 5, 2, 8),
                                      loc[..., 0, :, 0].double(),
                                      loc[..., 0, :, 1]))
    require_refused("sorted-kernels", bad, counters)
    torch.cuda.synchronize()
    return results


DECODER_LAYERS = 6


def phase_deform_generations(dev):
    """The RT-DETR-L decoder's sampling workload (6 layers, batch 8, 428
    queries, 8 heads x 32, 3 levels x 4 points) through the public entry
    point of each earlier generation, forward and backward: ms_deform_attn,
    ms_deform_attn_t and the per-level composition over bilinear_sample.
    Every output and gradient is held against ms_deform_attn_slots (K5) on
    the same inputs: f32 within 1e-4 x max|ref|; bf16 values at K5's bf16
    bar, out 1e-2 (K5 rounds its out to bf16, these return f32), d(values)
    2e-2 (two bf16 roundings of f32 sums taken in another order), d(loc)
    and d(attn) 1e-3. Returns the launch counts of the run."""
    import torch
    from robust_object_detection_tpu_torch.ops import deform as DF

    shapes = RTDETR_LEVELS
    b, q, heads, dh, pts = (RTDETR_TRAIN_BATCH, RTDETR_QUERIES + 2 * 2 * 32,
                            RTDETR_HEADS, RTDETR_DH, RTDETR_POINTS)
    counters = {"ms_deform_attn_sorted": DF.ms_deform_attn_sorted_forward,
                "ms_deform_attn_sorted_bwd":
                    DF.ms_deform_attn_sorted_backward,
                "stamp_scatter": DF.stamp_scatter}
    total = {k: 0 for k in counters}

    def per_level(values, loc, attn):
        out, off = 0, 0
        for l, (h, w) in enumerate(shapes):
            v = values[:, off:off + h * w].reshape(b, h, w, heads, dh)
            sampled = DF.bilinear_sample(v, loc[..., l, :, 0] * w - 0.5,
                                         loc[..., l, :, 1] * h - 0.5)
            out = out + (sampled * attn[..., l, :, None]).sum(-2)
            off += h * w
        return out

    generations = (
        ("ms_deform_attn", lambda v: v, lambda d: d,
         lambda v, l, a: DF.ms_deform_attn(v, shapes, l, a)),
        ("ms_deform_attn_t", DF.values_to_t, DF.values_from_t,
         lambda v, l, a: DF.ms_deform_attn_t(v, shapes, l, a)),
        ("bilinear_sample x 3 levels", lambda v: v, lambda d: d, per_level))

    def slots(v, l, a):
        return DF.ms_deform_attn_slots(v, shapes, l, a)

    def leaves_of(values, loc, attn):
        return [t.clone().requires_grad_() for t in (values, loc, attn)]

    def run(fn, leaves, dout):
        out = fn(*leaves)
        out.backward(dout.to(out.dtype))
        return [out.detach()] + [t.grad for t in leaves]

    def timed_layers(fn, lay, layers):
        """fn forward + backward on every layer: (results, ms per call);
        the leaves are laid out and cloned before the clock starts."""
        todo = [(leaves_of(lay(v), l, a), d) for v, l, a, d in layers]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = [run(fn, leaves, d) for leaves, d in todo]
        torch.cuda.synchronize()
        return got, (time.perf_counter() - t0) * 1e3 / len(layers)

    for dtype, tols in ((torch.bfloat16, (1e-2, 2e-2, 1e-3, 1e-3)),
                        (torch.float32, (1e-4,) * 4)):
        name = str(dtype).split(".")[-1]
        g = torch.Generator(dev).manual_seed(SEED + 6)
        layers = []
        for _ in range(DECODER_LAYERS):
            values, loc, attn = deform_inputs(g, shapes, b, q, heads, dh,
                                              pts, dev)
            dout = torch.randn(b, q, heads, dh, device=dev,
                               generator=g).to(dtype)
            layers.append((values.to(dtype), loc, attn, dout))
        del values
        # every generation and the yardstick once at full depth, off the
        # count: the allocator then holds the blocks the counted run needs
        for _, lay, _, fn in generations + (("", lambda v: v, None, slots),):
            timed_layers(fn, lay, layers)
        # the yardstick (K5) on the same inputs, before the count starts
        refs, k5_ms = timed_layers(slots, lambda v: v, layers)

        for f in counters.values():
            f.launches = 0
        outs, ms = {}, {}
        for gen, lay, unlay, fn in generations:
            got, ms[gen] = timed_layers(fn, lay, layers)
            outs[gen] = [[o, unlay(dv), dl, da] for o, dv, dl, da in got]
            del got
        launches = {k: f.launches for k, f in counters.items()}
        expect = {"ms_deform_attn_sorted": 2 * DECODER_LAYERS,
                  "ms_deform_attn_sorted_bwd": 2 * DECODER_LAYERS,
                  "stamp_scatter": len(shapes) * DECODER_LAYERS}
        print(f"[generations] {name}: launches {launches} expected {expect}")
        require(launches == expect, f"launch counts {launches} != {expect}")
        for k, n in launches.items():
            total[k] += n

        ms["ms_deform_attn_slots (K5)"] = k5_ms
        for gen, got in outs.items():
            log = []
            for layer_out, layer_ref in zip(got, refs):
                require(layer_out[0].dtype == torch.float32
                        and layer_out[1].dtype == dtype,
                        f"{gen}: out must be f32 and d(values) {name}")
                for what, o, r, tol in zip(("out", "d(values)", "d(loc)",
                                            "d(attn)"), layer_out, layer_ref,
                                           tols):
                    require(bool(torch.isfinite(o).all()),
                            f"{gen} {what} is not finite")
                    check(f"{what}", o, r.float(), tol, log)
            print(f"[generations] {name} {gen} vs K5, layer 0: "
                  f"{'; '.join(log[:4])}; {DECODER_LAYERS} layers passed")
        print(f"[generations] {name} values {tuple(layers[0][0].shape)} Q "
              f"{q}: ms per forward + backward call (host clock over "
              f"{DECODER_LAYERS} calls): {ms}")
        del layers, refs, outs
        torch.cuda.empty_cache()
    return total


# the bf16 tensor-core kernels: K3's (csrc/conv3x3_tc.cuh), K2's and K4's
# stride-2 convs (csrc/front_tc.cuh, each instantiated for both) and K4's
# 2x2 convs (csrc/stem_tc.cuh)
TC_KERNELS = ("conv3x3_tc_kernel", "wgrad_tc_kernel", "front_p1_kernel",
              "front_p2_kernel", "front_da1_tc_kernel", "front_dk2_tc_kernel",
              "front_dk1_tc_kernel", "stem2x2_tc_kernel",
              "stem2x2_dx_tc_kernel", "stem2x2_wgrad_tc_kernel")


def ptxas_report(log: str):
    """(entry function, resource line) pairs from nvcc's -Xptxas=-v output:
    the stack / spill line and the registers line of each kernel."""
    out, fn = [], None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function '|Function properties "
                      r"for )([^' ]+)", line)
        if m:
            fn = m.group(1)
        elif fn and ("registers" in line or "spill" in line):
            out.append((fn, line.split(" : ", 1)[-1].strip()))
    return out


def sass_opcodes(so, names):
    """{function: {opcode: count}} of the SASS (cuobjdump -sass) of the
    kernels in the built library whose names contain one of `names`."""
    from robust_object_detection_tpu_torch import kernels
    tool = Path(kernels.nvcc_path()).parent / "cuobjdump"
    res = subprocess.run([str(tool), "-sass", str(so)], capture_output=True,
                         text=True, timeout=300)
    require(res.returncode == 0, f"cuobjdump failed: {res.stderr[-500:]}")
    counts, fn = {}, None
    for line in res.stdout.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            fn = m.group(1) if any(n in m.group(1) for n in names) else None
            if fn:
                counts[fn] = {}
            continue
        m = fn and re.match(r"\s*/\*[0-9a-f]+\*/\s+(?:@!?U?P\w+\s+)?"
                            r"([A-Z][A-Z0-9_]*)", line)
        if m:
            op = m.group(1)
            counts[fn][op] = counts[fn].get(op, 0) + 1
    return counts


def main() -> int:
    import torch
    print(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda}")
    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is False; this smoke run "
              "needs a CUDA card", file=sys.stderr)
        return 1
    from robust_object_detection_tpu_torch import kernels

    print(f"[env] nvcc: {run_cmd([kernels.nvcc_path(), '--version'])}"
          .replace("\n", " | "))
    print(run_cmd(["nvidia-smi", "--query-gpu=name,power.limit",
                   "--format=csv,noheader"]))
    dev = torch.device("cuda", 0)
    print(f"[env] device {torch.cuda.get_device_name(0)} "
          f"count {torch.cuda.device_count()}")

    t0 = time.perf_counter()
    so = kernels.build()
    kernels.load()
    print(f"[build] {so.name} in {time.perf_counter() - t0} s")
    for fn, line in ptxas_report(kernels.build_log()):
        print(f"[build] {fn}: {line}")
    sass = sass_opcodes(so, TC_KERNELS)
    for fn, ops in sass.items():
        print(f"[build] SASS of {fn}: HMMA {ops.get('HMMA', 0)} HGMMA "
              f"{ops.get('HGMMA', 0)} LDSM {ops.get('LDSM', 0)} LDGSTS "
              f"{ops.get('LDGSTS', 0)} FFMA {ops.get('FFMA', 0)}")
    for name in TC_KERNELS:
        found = [ops for fn, ops in sass.items() if name in fn]
        require(found and all(ops.get("HMMA", 0) + ops.get("HGMMA", 0) > 0
                              for ops in found),
                f"{name}: no tensor-core instruction in its SASS")

    kres = phase_kernels(dev)
    phase_model_check(dev)
    launches = phase_sweep(dev)
    kres.update(phase_train_kernels(dev))
    phase_train_model_check(dev)
    train_launches = phase_training(dev)
    kres.update(phase_rtdetr_kernels(dev))
    phase_rtdetr_model_check(dev)
    rtdetr_launches = phase_rtdetr_sweep(dev)
    kres.update(phase_rtdetr_train_kernels(dev))
    phase_rtdetr_train_model_check(dev)
    rtdetr_train_launches = phase_rtdetr_training(dev)
    kres.update(phase_sorted_kernels(dev))
    generation_launches = phase_deform_generations(dev)
    # a kernel may run on several paths; each count comes from its own
    # path's run, zeroed just before it
    for path in (train_launches, rtdetr_launches, rtdetr_train_launches,
                 generation_launches):
        for name, n in path.items():
            launches[name] = launches.get(name, 0) + n

    src = "robust_object_detection_tpu_torch/csrc/"
    ref = "robust_object_detection_tpu/ops/"
    summary = []
    for name, source, replaces, dtype in (
            ("conv3x3", "conv3x3.cu", "pallas_conv.py:37", "bfloat16"),
            ("yolo_front", "yolo_front.cu", "pallas_yolo_front.py:109",
             "bfloat16"),
            ("conv3x3_wgrad", "conv3x3_wgrad.cu", "pallas_conv.py:62",
             "bfloat16"),
            ("yolo_front_train", "yolo_front.cu", "pallas_yolo_front.py:109",
             "bfloat16"),
            ("yolo_front_bwd", "yolo_front_bwd.cu",
             "pallas_yolo_front.py:200", "bfloat16"),
            ("corrupt", "corrupt.cu", "pallas_corrupt.py:52", "float32"),
            ("hgstem", "hgstem.cu", "pallas_stem.py:170", "bfloat16"),
            ("ms_deform_attn", "ms_deform_attn.cu", "deform.py:798",
             "bfloat16"),
            ("hgstem_train", "hgstem.cu", "pallas_stem.py:170", "bfloat16"),
            ("hgstem_bwd", "hgstem_bwd.cu", "pallas_stem.py:601",
             "bfloat16"),
            ("ms_deform_attn_bwd", "ms_deform_attn.cu", "deform.py:901",
             "bfloat16"),
            ("auction", "auction.cu", "assignment.py:113", "float32"),
            ("ms_deform_attn_sorted", "ms_deform_attn_sorted.cu",
             "deform.py:398", "bfloat16"),
            ("ms_deform_attn_sorted_bwd", "ms_deform_attn_sorted.cu",
             "deform.py:524", "bfloat16"),
            ("stamp_scatter", "stamp_scatter.cu", "deform.py:170",
             "float32")):
        r = kres[name][dtype]
        bound_ms, bound_by = bound(r)
        summary.append({"name": name, "route": "cuda", "source": src + source,
                        "replaces": ref + replaces,
                        "launches": launches[name],
                        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": bound_ms,
                        "bound_by": bound_by,
                        "library_ms": r["library_ms"]})
        if name in ("conv3x3", "conv3x3_wgrad", "yolo_front",
                    "yolo_front_train", "yolo_front_bwd", "hgstem",
                    "hgstem_train", "hgstem_bwd"):
            # K3's, K2's and K4's route by dtype: tensor cores
            # (conv3x3_tc.cuh, front_tc.cuh, stem_tc.cuh) for bf16, the
            # CUDA-core kernels for f32
            summary[-1]["dtype_routes"] = {"bfloat16": "tc",
                                           "float32": "cuda-core"}
    print(json.dumps({"kernels": summary}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
