#!/usr/bin/env python3
"""Times of K2 (the YOLOv8 P1/P2 front kernels) on one CUDA card.

    python3 tools/profile_torch_front.py [--root DIR] [--dtype bfloat16]

At the model paths' shapes, with seeded random inputs as in chip_smoke.py:
K2-f eval on (8, 1024, 1024, 3) -> 48 -> 96, K2-f train and K2-b on
(16, 1024, 1024, 3) -> 48 -> 96:

  1. CUDA-event medians (10 calls after 3 warm-ups) of each, and the
     host's time to enqueue one call (20 calls, no synchronize);
  2. under torch.profiler, the device ms a call of every kernel each one
     launches (K2-b: the autograd backward of the train front, so PyTorch's
     casts of the cotangents are listed too) and their sum.

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

import chip_smoke as S  # noqa: E402  (time_ms, device_ms_by_kernel)


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
    from robust_object_detection_tpu_torch.ops import yolo_front as TF

    if not torch.cuda.is_available():
        print("FAIL: needs a CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    dtype = getattr(torch, args.dtype)
    print(S.run_cmd(["nvidia-smi", "--query-gpu=name,power.limit",
                     "--format=csv,noheader"]))
    tag = f"[front {Path(TF.__file__).resolve().parents[2].name}]"
    print(f"{tag} package {Path(TF.__file__).resolve().parents[1]}")
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
        ms = S.time_ms(fn)
        print(f"{tag} {what} {args.dtype}: events {ms} ms; enqueue "
              f"{host_us(fn)} us a call")
        rows = S.device_ms_by_kernel(fn)
        for kms, n, key in rows:
            print(f"    {kms:9.4f}  x{n}  {key[:110]}")
        print(f"    {sum(r[0] for r in rows):9.4f}  device ms a call in all")

    g = torch.Generator(dev).manual_seed(S.SEED)
    k1 = (torch.randn(3, 3, 3, 48, device=dev, generator=g) * 0.2)
    k2 = (torch.randn(3, 3, 48, 96, device=dev, generator=g) * 0.1)
    sc1 = torch.rand(48, device=dev, generator=g) + 0.5
    bi1 = torch.randn(48, device=dev, generator=g) * 0.1
    means = (torch.randn(48, device=dev, generator=g) * 0.1,
             torch.zeros(96, device=dev))
    variances = (torch.rand(48, device=dev, generator=g) + 0.5,
                 torch.ones(96, device=dev))

    x = torch.rand(S.BATCH, S.IMG_SIZE, S.IMG_SIZE, 3, device=dev,
                   generator=g).to(dtype)
    ev = (x, k1.to(dtype), sc1, bi1, k2.to(dtype), means, variances)
    report(f"K2-f eval ({S.BATCH}, 1024, 1024, 3) -> 48 -> 96",
           lambda: TF.front_inference(*ev))
    del x, ev

    x = torch.rand(S.TRAIN_BATCH, S.IMG_SIZE, S.IMG_SIZE, 3, device=dev,
                   generator=g).to(dtype)
    params = [t.clone().requires_grad_() for t in (k1, sc1, bi1, k2)]
    cots = (torch.randn(S.TRAIN_BATCH, S.IMG_SIZE // 4, S.IMG_SIZE // 4, 96,
                        device=dev, generator=g).to(dtype),
            *(torch.randn(c, device=dev, generator=g) * 0.1
              for c in (48, 48, 96, 96)))
    with torch.no_grad():
        report(f"K2-f train ({S.TRAIN_BATCH}, 1024, 1024, 3) -> 48 -> 96",
               lambda: TF.front_fused(x, *params))
    out = TF.front_fused(x, *params)
    report(f"K2-b ({S.TRAIN_BATCH}, 1024, 1024, 3) -> 48 -> 96",
           lambda: torch.autograd.grad(out, params, cots, retain_graph=True))
    print(f"{tag} peak memory {torch.cuda.max_memory_allocated(dev)} bytes")
    return 0


if __name__ == "__main__":
    sys.exit(main())
