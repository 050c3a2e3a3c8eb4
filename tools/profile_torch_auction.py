#!/usr/bin/env python3
"""Times of K6, the auction matcher (``ops.assignment.auction_assignment``,
csrc/auction.cu), on one CUDA card, and the rounds behind them.

    python3 tools/profile_torch_auction.py [--root DIR]

Seeded random costs in [0, 4) with padded GTs at BIG, the RT-DETR-L train
step's matcher shape (B 8, Q 300, M 300, round cap 16):

  * train: 80 valid GTs an image (the step's, bench.py's 80 boxes), which
    converges in a few rounds;
  * capped: 300 valid GTs, every image hits the cap and is completed
    greedily;
  * ties: as capped, costs quantised to 1/64;
  * alike: 80 valid GTs that all rank the queries alike (a cost per query
    plus 0.05 of noise), which caps with 80 GTs, as some of the RT-DETR-L
    step's matchings do; the greedy then takes about one pair a round;
  * past capacity: M 420, all valid, more GT rows than shared memory holds
    (the rest are read where they lie).

For each: CUDA-event medians (10 calls after 3 warm-ups), the host's time
to enqueue one call (20 calls, no synchronize), the profiler's device ms of
each launch, a SHA-256 of owner and capped (to compare two trees' results)
and, where the package has ``auction_assignment_rounds``, each image's
auction rounds and greedy rounds.

--root names another checkout whose port package is measured instead of
this one's (its kernels are built there), so that two trees can be timed in
one call on one card: run the tool in turns (parent, this, this, parent).

--threads 512 1024 also builds this checkout's csrc/auction.cu with each
block size (a copy edited in the build directory, bound with ctypes) and
prints the profiler's device ms of each on every case, with its owner and
capped held equal to the package's. Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

CASES = (("train", 300, 300, 80, None), ("capped", 300, 300, 300, None),
         ("ties", 300, 300, 300, 64), ("alike", 300, 300, 80, None),
         ("past capacity", 300, 420, 420, None))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", type=Path, default=ROOT,
                    help="checkout whose port package is measured")
    ap.add_argument("--threads", type=int, nargs="*", default=[],
                    help="block sizes of auction.cu builds to time")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import chip_smoke as S  # this checkout's helpers, whichever is measured
    sys.path.insert(0, str(args.root.resolve()))

    import torch

    from robust_object_detection_tpu_torch import kernels
    from robust_object_detection_tpu_torch.ops import assignment as AS

    if not torch.cuda.is_available():
        print("FAIL: needs a CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    print(S.run_cmd(["nvidia-smi", "--query-gpu=name,power.limit",
                     "--format=csv,noheader"]))
    tag = f"auction {Path(AS.__file__).resolve().parents[2].name}"
    print(f"[{tag}] package {Path(AS.__file__).resolve().parents[1]}")
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

    def digest(*ts):
        h = hashlib.sha256()
        for t in ts:
            h.update(t.contiguous().view(torch.uint8).cpu().numpy().tobytes())
        return h.hexdigest()[:16]

    variants = {}
    for threads in args.threads:
        src = (ROOT / "robust_object_detection_tpu_torch" / "csrc"
               / "auction.cu").read_text()
        line = "constexpr int AU_THREADS = 1024;"
        assert line in src, line
        cu = kernels.BUILD_DIR / f"auction_threads{threads}.cu"
        cu.write_text(src.replace(line, f"constexpr int AU_THREADS = "
                                        f"{threads};"))
        so = cu.with_suffix(".so")
        subprocess.run([kernels.nvcc_path(), *kernels.NVCC_FLAGS, "-o",
                        str(so), str(cu)], check=True, capture_output=True)
        lib = ctypes.CDLL(str(so))
        lib.auction_assign.argtypes = kernels.SIGNATURES["auction_assign"]
        variants[threads] = lib

    g = torch.Generator(dev).manual_seed(S.SEED + 11)
    for what, q, m, n_valid, quantum in CASES:
        cost = torch.rand(S.RTDETR_TRAIN_BATCH, q, m, device=dev,
                          generator=g) * 4
        if quantum:
            cost = torch.round(cost * quantum) / quantum
        if what == "alike":
            cost = torch.rand(S.RTDETR_TRAIN_BATCH, q, 1, device=dev,
                              generator=g) * 4 + 0.05 * cost / 4
        valid = torch.zeros(S.RTDETR_TRAIN_BATCH, m, dtype=torch.bool,
                            device=dev)
        valid[:, :n_valid] = True
        cost = torch.where(valid[:, None, :], cost,
                           torch.full_like(cost, AS.BIG))

        def call():
            return AS.auction_assignment(cost, valid, max_rounds=16)
        owner, capped = call()
        rounds = "not counted by this tree"
        if hasattr(AS, "auction_assignment_rounds"):
            rounds = AS.auction_assignment_rounds(
                cost, valid, max_rounds=16)[2].tolist()
        print(f"[{tag}] {what} (B {cost.shape[0]}, Q {q}, M {m}, {n_valid} "
              f"valid): events {S.time_ms(call)} ms; enqueue {host_us(call)} "
              f"us a call; device ms by launch: {by_launch(call)}; capped "
              f"{int(capped.sum())}; sha256 {digest(owner, capped.int())}; "
              f"rounds (auction, greedy) by image {rounds}")
        for threads, lib in variants.items():
            plan = kernels.auction_plan(q, m)
            vo = torch.empty_like(owner)
            vc = torch.empty_like(capped)

            def vcall():
                err = lib.auction_assign(
                    cost.data_ptr(), valid.data_ptr(), vo.data_ptr(),
                    vc.data_ptr(), None, cost.shape[0], q, m, plan["qs"],
                    plan["cap"], plan["smem"], 0.005, 16, 1,
                    torch.cuda.current_stream().cuda_stream)
                kernels.check(err, "auction_assign")
            vcall()
            same = torch.equal(vo, owner) and torch.equal(vc, capped)
            print(f"[{tag}] {what}: auction.cu at {threads} threads: device "
                  f"ms {S.device_ms_by_kernel(vcall)[0][0]}; equal to the "
                  f"package's {same}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
