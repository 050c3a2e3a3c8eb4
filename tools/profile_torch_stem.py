#!/usr/bin/env python3
"""Times of K4 (the HGNetv2 stem kernels) on one CUDA card.

    python3 tools/profile_torch_stem.py [--root DIR] [--dtype bfloat16]

At the RT-DETR-L paths' shapes, with seeded random inputs as in
chip_smoke.py: K4-f eval on (8, 1024, 1024, 3) -> 32 (the sweep's
forward), K4-f train and K4-b on (8, 1024, 1024, 3) (the train step's):

  1. CUDA-event medians (10 calls after 3 warm-ups) of each, and the
     host's time to enqueue one call (20 calls, no synchronize);
  2. under torch.profiler, the device ms of every launch of a call in
     launch order (stem1, stem2a, stem2b, pool / assemble, stem3, the
     statistics finalizes; each launch of K4-b, with PyTorch's own casts
     and fills of the autograd backward), and their sum.

--root names another checkout whose port package is measured instead of
this one's (its kernels are built there), so that two trees can be timed
in one call on one card (parent, this, this, parent). Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as S  # noqa: E402  (time_ms, stem_parts, stem inputs)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", type=Path, default=ROOT,
                    help="checkout whose port package is measured")
    ap.add_argument("--dtype", default="bfloat16",
                    choices=("bfloat16", "float32"))
    args = ap.parse_args()
    sys.path.insert(0, str(args.root.resolve()))

    import torch

    from robust_object_detection_tpu_torch import kernels
    from robust_object_detection_tpu_torch.ops import stem as ST

    if not torch.cuda.is_available():
        print("FAIL: needs a CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    dtype = getattr(torch, args.dtype)
    print(S.run_cmd(["nvidia-smi", "--query-gpu=name,power.limit",
                     "--format=csv,noheader"]))
    tag = f"stem {Path(ST.__file__).resolve().parents[2].name}"
    print(f"[{tag}] package {Path(ST.__file__).resolve().parents[1]}")
    kernels.build()
    kernels.load()

    def host_us(fn, calls=20):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        return (t1 - t0) / calls * 1e6

    def report(what, fn):
        print(f"[{tag}] {what} {args.dtype}: events {S.time_ms(fn)} ms; "
              f"enqueue {host_us(fn)} us a call")
        S.stem_parts(fn, tag, what)

    g = torch.Generator(dev).manual_seed(S.SEED)
    b, side = S.BATCH, S.IMG_SIZE
    ev = S.stem_args(*S.stem_inputs(g, b, side, side, dev), dtype)
    report(f"K4-f eval ({b}, {side}, {side}, 3)",
           lambda: ST.stem_fused_inference(*ev))
    del ev

    b = S.RTDETR_TRAIN_BATCH
    x = torch.rand(b, side, side, 3, device=dev, generator=g).to(dtype)
    params = [t.clone().requires_grad_() for t in S.stem_train_params(g, dev)]
    cots = [torch.randn(b, side // 4, side // 4, 32, device=dev,
                        generator=g).to(dtype)]
    cots += [torch.randn(c, device=dev, generator=g) * 0.1
             for c in (32, 16, 32, 32) * 2]
    with torch.no_grad():
        report(f"K4-f train ({b}, {side}, {side}, 3)",
               lambda: ST.stem_fused(x, *params))
    out = ST.stem_fused(x, *params)
    flat = (out[0], *out[1], *out[2])
    report(f"K4-b ({b}, {side}, {side}, 3)",
           lambda: torch.autograd.grad(flat, params, cots, retain_graph=True))
    print(f"[{tag}] peak memory {torch.cuda.max_memory_allocated(dev)} bytes")
    return 0


if __name__ == "__main__":
    sys.exit(main())
