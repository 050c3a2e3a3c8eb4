#!/usr/bin/env python3
"""Times of K1, the training corruption (``ops.fused_corrupt``,
csrc/corrupt.cu), on one CUDA card, branch by branch.

    python3 tools/profile_torch_corrupt.py [--root DIR]

The YOLOv8m train step's batch, (16, 1024, 1024, 3) f32 integers in
[0, 255] from a seed, through ``fused_random_corruption`` with the choice
given: all 16 images clean, then all noise, all blur, all lowres, and the
four branches in turn (image i takes branch i % 4). For each: CUDA-event
medians (10 calls after 3 warm-ups), the host's time to enqueue one call
(20 calls, no synchronize), the profiler's device ms of each launch, the
bound (the batch read once and written once over 3.35 TB/s) and a SHA-256
of the output, to compare two trees' bits.

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

BRANCHES = (("clean", 0), ("noise", 1), ("blur", 2), ("lowres", 3),
            ("mixed", None))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", type=Path, default=ROOT,
                    help="checkout whose port package is measured")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import chip_smoke as S  # this checkout's helpers, whichever is measured
    sys.path.insert(0, str(args.root.resolve()))

    import torch

    from robust_object_detection_tpu_torch import kernels
    from robust_object_detection_tpu_torch.ops import fused_corrupt as FC

    if not torch.cuda.is_available():
        print("FAIL: needs a CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    print(S.run_cmd(["nvidia-smi", "--query-gpu=name,power.limit",
                     "--format=csv,noheader"]))
    tag = f"corrupt {Path(FC.__file__).resolve().parents[2].name}"
    print(f"[{tag}] package {Path(FC.__file__).resolve().parents[1]}")
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

    def by_launch(fn):
        seq = S.device_ms_by_launch(fn)
        if seq is None:
            return "; ".join(f"{S.short_kernel_name(k)} x{n} {ms}"
                             for ms, n, k in S.device_ms_by_kernel(fn))
        return "; ".join(f"{S.short_kernel_name(k)} {ms}" for ms, k in seq)

    def digest(t):
        return hashlib.sha256(t.contiguous().view(torch.uint8).cpu().numpy()
                              .tobytes()).hexdigest()[:16]

    g = torch.Generator(dev).manual_seed(S.SEED + 12)
    b = S.TRAIN_BATCH
    img = torch.floor(torch.rand(b, S.IMG_SIZE, S.IMG_SIZE, 3, device=dev,
                                 generator=g) * 256)
    seeds = torch.randint(0, 2 ** 30, (b,), device=dev, generator=g,
                          dtype=torch.int32)
    bound_ms = 2 * img.numel() * 4 / S.HBM_BYTES_PER_S * 1e3
    for what, branch in BRANCHES:
        choice = (torch.arange(b, device=dev, dtype=torch.int32) % 4
                  if branch is None else
                  torch.full((b,), branch, device=dev, dtype=torch.int32))

        def call():
            return FC.fused_random_corruption(img, None, choice=choice,
                                              seeds=seeds)[0]
        print(f"[{tag}] {what} {tuple(img.shape)}: events {S.time_ms(call)} "
              f"ms; enqueue {host_us(call)} us a call; device ms by launch: "
              f"{by_launch(call)}; bound {bound_ms} ms (bytes); sha256 "
              f"{digest(call())}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
