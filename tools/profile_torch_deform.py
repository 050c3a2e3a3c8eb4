#!/usr/bin/env python3
"""Times of the three generations of the deformable-attention kernels on
one CUDA card, and where a sorted-tap backward's time goes.

    python3 tools/profile_torch_deform.py [--root DIR] [--queries 428]

At the RT-DETR-L decoder's shapes (values (8, 21504, 8, 32), 3 levels x 4
points, seeded random inputs as in chip_smoke.py), bf16 and f32 values:

  1. CUDA-event medians (10 calls after 3 warm-ups) of K5 forward and
     backward (``ms_deform_attn_slots``), K5-g2 forward and backward in both
     layouts (``ms_deform_attn`` / ``ms_deform_attn_t``; the backward's
     ``torch.sort`` inside the timed call) and K5-g1 (``stamp_scatter``,
     key packing and sort inside) at each level, with ``scatter_add_`` into
     zeros beside it;
  2. under torch.profiler, the device time by kernel of 10 K5-g2 backwards
     (bf16, both layouts) and of 10 K5-g1 calls at the largest and the
     smallest level: the hand kernels by name, the library sort's kernels
     and the elementwise key packing.

--root names another checkout whose port package is measured instead of
this one's (its kernels are built there), so that two trees can be timed in
one call on one card. Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", type=Path, default=ROOT,
                    help="checkout whose port package is measured")
    ap.add_argument("--queries", type=int, default=428)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(args.root.resolve()))

    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as S
    from robust_object_detection_tpu_torch import kernels
    from robust_object_detection_tpu_torch.ops import deform as DF

    if not torch.cuda.is_available():
        print("FAIL: needs a CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    print(S.run_cmd(["nvidia-smi", "--query-gpu=name,power.limit",
                     "--format=csv,noheader"]))
    print(f"[deform] package {Path(DF.__file__).resolve().parents[1]}")
    kernels.load()

    shapes = S.RTDETR_LEVELS
    b, q, heads, dh, pts = (S.BATCH, args.queries, S.RTDETR_HEADS,
                            S.RTDETR_DH, S.RTDETR_POINTS)
    g = torch.Generator(dev).manual_seed(S.SEED + 5)
    values, loc, attn = S.deform_inputs(g, shapes, b, q, heads, dh, pts, dev)
    dout = torch.randn(b, q, heads, dh, device=dev, generator=g)

    def device_ms_by_kernel(fn, calls=10):
        """Device ms per call of every kernel fn launches, largest first."""
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        rows = [(e.device_time_total / 1e3 / calls, e.count // calls, e.key)
                for e in prof.key_averages() if e.device_time_total > 0
                and e.device_type == torch.autograd.DeviceType.CUDA]
        return sorted(rows, reverse=True)

    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).split(".")[-1]
        vd = values.to(dtype)
        vt = DF.values_to_t(vd)
        dd = dout.to(dtype)
        times = {
            "K5 forward": S.time_ms(lambda: DF.ms_deform_attn_slots(
                vd, shapes, loc, attn)),
            "K5 backward": S.time_ms(lambda: DF.ms_deform_attn_backward(
                vd, shapes, loc, attn, dd)),
            "K5-g2 forward values": S.time_ms(lambda: DF.ms_deform_attn(
                vd, shapes, loc, attn)),
            "K5-g2 forward values_t": S.time_ms(lambda: DF.ms_deform_attn_t(
                vt, shapes, loc, attn)),
            "K5-g2 backward values": S.time_ms(
                lambda: DF.ms_deform_attn_sorted_backward(
                    vd, shapes, loc, attn, dout)),
            "K5-g2 backward values_t": S.time_ms(
                lambda: DF.ms_deform_attn_sorted_backward(
                    vt, shapes, loc, attn, dout, True)),
        }
        print(f"[deform] {name} values {tuple(vd.shape)} Q {q}, ms: {times}")
        if dtype != torch.bfloat16:
            continue
        for layout, given, flag in (("values", vd, False),
                                    ("values_t", vt, True)):
            rows = device_ms_by_kernel(
                lambda: DF.ms_deform_attn_sorted_backward(
                    given, shapes, loc, attn, dout, flag))
            print(f"[deform] K5-g2 backward {name} {layout}: device ms per "
                  f"call by kernel (sum {sum(r[0] for r in rows)}):")
            for ms, n, key in rows:
                print(f"    {ms:9.4f}  x{n}  {key[:110]}")
    del values, vd, vt

    for h, w in shapes:
        hw, t = h * w, q * pts * 4
        idx = torch.randint(0, hw, (b, heads, t), device=dev, generator=g,
                            dtype=torch.int32)
        gw = torch.randn(b, heads, dh, t, device=dev, generator=g)
        wide = idx.long()[:, :, None, :].expand(-1, -1, dh, -1)
        ms = S.time_ms(lambda: DF.stamp_scatter(idx, gw, hw))
        lib = S.time_ms(lambda: torch.zeros(
            b, heads, dh, hw, device=dev).scatter_add_(3, wide, gw))
        print(f"[deform] K5-g1 stamp_scatter hw {hw} T {t} rows {b * heads} "
              f"(uniform random cells): {ms} ms; zeros + scatter_add_ "
              f"{lib} ms")
        if (h, w) in (shapes[0], shapes[-1]):
            rows = device_ms_by_kernel(lambda: DF.stamp_scatter(idx, gw, hw))
            print(f"[deform] K5-g1 hw {hw}: device ms per call by kernel "
                  f"(sum {sum(r[0] for r in rows)}):")
            for kms, n, key in rows:
                print(f"    {kms:9.4f}  x{n}  {key[:110]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
