#!/usr/bin/env python3
"""Times of the deformable-attention kernels on one CUDA card, and where a
call's time goes.

    python3 tools/profile_torch_deform.py [--root DIR] [--queries 428]

At the RT-DETR-L decoder's shapes (values (8, 21504, 8, 32), 3 levels x 4
points, seeded random inputs as in chip_smoke.py), bf16 and f32 values:

  1. K5 forward (``ms_deform_attn_slots``) at 300 and 428 queries, on
     uniform and on clustered samples (chip_smoke.clustered_loc: 200
     centres per batch and head): CUDA-event medians (10 calls after 3
     warm-ups), the host's time to enqueue one call (20 calls, no
     synchronize), the profiler's device ms of each launch and a SHA-256
     of the out;
  2. the backwards at --queries, on uniform and on clustered samples: K5
     backward and K5-g2 backward in both layouts (``values``,
     ``values_t``), events, enqueue and the device ms of each launch (the
     taps kernel and the scatter), with a SHA-256 of each d(values), so
     that two trees' bits can be compared; K5-g2 forward in both layouts
     the same way (events, enqueue, device ms by launch: for values_t the
     relayout and the gather; a SHA-256 of the out), and ``grid_sample``
     level by level on values_t's layout, forward only, beside it;
  3. K5-g1 (``stamp_scatter``) at each level, uniform and clustered cells,
     with gw in the reference's layout and, where the package takes it,
     in the row layout (the transpose of a contiguous (B, heads, T, dh)):
     events, enqueue, device ms by launch, ``scatter_add_`` into zeros
     beside it, and a SHA-256 of each output, so that two trees' bits can
     be compared.

--root names another checkout whose port package is measured instead of
this one's (its kernels are built there), so that two trees can be timed in
one call on one card: run the tool in turns (parent, this, this, parent).
Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import hashlib
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", type=Path, default=ROOT,
                    help="checkout whose port package is measured")
    ap.add_argument("--queries", type=int, default=428)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import chip_smoke as S  # this checkout's inputs, whichever is measured
    sys.path.insert(0, str(args.root.resolve()))

    import torch
    import torch.nn.functional as F

    from robust_object_detection_tpu_torch import kernels
    from robust_object_detection_tpu_torch.ops import deform as DF

    if not torch.cuda.is_available():
        print("FAIL: needs a CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    print(S.run_cmd(["nvidia-smi", "--query-gpu=name,power.limit",
                     "--format=csv,noheader"]))
    tree = Path(DF.__file__).resolve().parents[2].name
    tag = f"deform {tree}"
    print(f"[{tag}] package {Path(DF.__file__).resolve().parents[1]}")
    kernels.build()
    kernels.load()
    rows_layout = hasattr(DF, "_gw_strides")   # the row layout of K5-g1

    def host_us(fn, calls=20):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        return (t1 - t0) / calls * 1e6

    def by_launch(fn):
        seq = S.device_ms_by_launch(fn)
        if seq is None:
            return "; ".join(f"{S.short_kernel_name(k)} x{n} {ms}"
                             for ms, n, k in S.device_ms_by_kernel(fn))
        return "; ".join(f"{S.short_kernel_name(k)} {ms}" for ms, k in seq)

    def report(what, fn):
        print(f"[{tag}] {what}: events {S.time_ms(fn)} ms; enqueue "
              f"{host_us(fn)} us a call; device ms by launch: "
              f"{by_launch(fn)}")

    shapes = S.RTDETR_LEVELS
    b, heads, dh, pts = S.BATCH, S.RTDETR_HEADS, S.RTDETR_DH, S.RTDETR_POINTS
    g = torch.Generator(dev).manual_seed(S.SEED + 5)

    def digest(t):
        return hashlib.sha256(t.contiguous().view(torch.uint8).cpu().numpy()
                              .tobytes()).hexdigest()[:16]

    # 1. K5 forward
    for q in sorted({S.RTDETR_QUERIES, args.queries}):
        for clustered in (False, True):
            values, loc, attn = S.deform_inputs(g, shapes, b, q, heads, dh,
                                                pts, dev, clustered)
            for dtype in (torch.bfloat16, torch.float32):
                vd = values.to(dtype)
                name = str(dtype).split(".")[-1]
                what = "clustered" if clustered else "uniform"
                fn = (lambda: DF.ms_deform_attn_slots(vd, shapes, loc, attn))
                report(f"K5 forward {name} Q {q} {what} (sha256 out "
                       f"{digest(fn())})", fn)
    del values, loc, attn

    # 2. the backwards (and K5-g2 forward), uniform and clustered
    q = args.queries
    for clustered in (False, True):
        what = "clustered" if clustered else "uniform"
        values, loc, attn = S.deform_inputs(g, shapes, b, q, heads, dh, pts,
                                            dev, clustered)
        dout = torch.randn(b, q, heads, dh, device=dev, generator=g)
        for dtype in (torch.bfloat16, torch.float32):
            name = str(dtype).split(".")[-1]
            vd = values.to(dtype)
            vt = DF.values_to_t(vd)
            dd = dout.to(dtype)
            calls = {
                "K5 backward": lambda: DF.ms_deform_attn_backward(
                    vd, shapes, loc, attn, dd),
                "K5-g2 backward values":
                    lambda: DF.ms_deform_attn_sorted_backward(
                        vd, shapes, loc, attn, dout),
                "K5-g2 backward values_t":
                    lambda: DF.ms_deform_attn_sorted_backward(
                        vt, shapes, loc, attn, dout, True)}
            for call, fn in calls.items():
                grads = fn()
                report(f"{call} {name} Q {q} {what} (sha256 d(values) "
                       f"{digest(grads[0])} d(loc) {digest(grads[1])} "
                       f"d(attn) {digest(grads[2])})", fn)
                del grads
            forwards = {
                "values": lambda: DF.ms_deform_attn(vd, shapes, loc, attn),
                "values_t": lambda: DF.ms_deform_attn_t(vt, shapes, loc,
                                                        attn)}
            for layout, fn in forwards.items():
                report(f"K5-g2 forward {layout} {name} Q {q} {what} (sha256 "
                       f"out {digest(fn())})", fn)
            gs = (lambda: S.grid_sample_deform(F, vt, shapes, loc, attn))
            print(f"[{tag}] {name} Q {q} {what}: grid_sample level by level "
                  f"on values_t + the weighted sum, forward only: events "
                  f"{S.time_ms(gs)} ms; device ms "
                  f"{sum(d for d, _, _ in S.device_ms_by_kernel(gs))}")
        del values, vd, vt, loc, attn, dout, dd

    # 3. K5-g1, one level at a time
    for clustered in (False, True):
        what = "clustered" if clustered else "uniform"
        for h, w in shapes:
            hw = h * w
            if clustered:
                lc = S.clustered_loc(g, b, q, heads, 1, pts, dev)[:, :, :, 0]
            else:
                lc = torch.rand(b, q, heads, pts, 2, device=dev,
                                generator=g) * 1.2 - 0.1
            idx = DF.tap_geometry(lc[:, :, :, None], ((h, w),))[0]
            idx = idx.permute(0, 2, 1, 3, 4, 5).reshape(b, heads, -1).int()
            t = idx.shape[-1]
            gw = torch.randn(b, heads, dh, t, device=dev, generator=g)
            wide = idx.long()[:, :, None, :].expand(-1, -1, dh, -1)
            lib = S.time_ms(lambda: torch.zeros(
                b, heads, dh, hw, device=dev).scatter_add_(3, wide, gw))
            layouts = {"reference": gw}
            if rows_layout:
                layouts["rows"] = gw.transpose(2, 3).contiguous() \
                    .transpose(2, 3)
            for layout, given in layouts.items():
                out = DF.stamp_scatter(idx, given, hw)
                report(f"K5-g1 hw {hw} T {t} {what} {layout} layout "
                       f"(sha256 {digest(out)}; zeros + scatter_add_ {lib} "
                       f"ms)",
                       lambda: DF.stamp_scatter(idx, given, hw))
            del idx, gw, wide, layouts, given, out
    return 0


if __name__ == "__main__":
    sys.exit(main())
