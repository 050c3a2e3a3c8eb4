#!/usr/bin/env python3
"""Where the time of the PyTorch port's train step goes, on one CUDA card.

    python3 tools/profile_torch_train.py [--model yolo|rtdetr] [--steps 5]

Runs a training cell of chip_smoke.py (bench.py's workloads, seeded random
weights, 1024 px, 80 GT boxes per image in 600 slots, augment + HSV/flip,
bf16 convs and BatchNorm outputs: YOLOv8m at batch 16, or with --model
rtdetr RT-DETR-L at batch 8 with contrastive denoising, AdamW and the
auction matcher) and measures, in one process:

  1. the unprofiled step, --steps steps after one warm-up: host wall ms
     per step (each ends in a synchronize), images/s, peak device memory;
  2. one step under torch.profiler: its wall time, and from that same run
     the device's busy time (union of its kernel and memcpy intervals) and
     idle share; kernel launches and the host time in the launch API;
     device time by kernel group (the hand kernels by name).

The device-time table by kernel goes to --out (or its first 30 lines to
stdout). Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402  (detection_batch, run_cmd)
from tools.profile_torch_sweep import (LAUNCH_APIS, kernel_group,  # noqa: E402
                                       union_us)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--model", choices=("yolo", "rtdetr"), default="yolo")
    ap.add_argument("--out", type=Path, default=None,
                    help="write the per-kernel table here (default: its "
                         "first 30 lines to stdout)")
    args = ap.parse_args()

    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from robust_object_detection_tpu_torch import kernels
    from robust_object_detection_tpu_torch.core.config import \
        CorruptionConfig
    from robust_object_detection_tpu_torch.models import rtdetr as R
    from robust_object_detection_tpu_torch.models import yolov8 as Y
    from robust_object_detection_tpu_torch.train import detector as D
    from robust_object_detection_tpu_torch.train import rtdetr as RT

    if not torch.cuda.is_available():
        print("FAIL: needs a CUDA card", file=sys.stderr)
        return 1
    S = chip_smoke
    dev = torch.device("cuda", 0)
    print(S.run_cmd(["nvidia-smi", "--query-gpu=name,power.limit",
                     "--format=csv,noheader"]))
    kernels.build()
    rtdetr = args.model == "rtdetr"
    seeded = torch.Generator().manual_seed(S.SEED)
    if rtdetr:
        n_batch = S.RTDETR_TRAIN_BATCH
        model = R.create(6, torch.bfloat16, dev, seeded, train=True,
                         bn_dtype=torch.bfloat16)
        state = RT.init_state(model, RT.make_optimizer()[0])
        step = RT.make_train_step(S.IMG_SIZE, CorruptionConfig(),
                                  augment=True, base_augment=True)
    else:
        n_batch = S.TRAIN_BATCH
        model = Y.create(6, "m", torch.bfloat16, dev, seeded, train=True,
                         bn_dtype=torch.bfloat16)
        state = D.init_state(model, D.make_optimizer()[0])
        step = D.make_train_step(S.IMG_SIZE, CorruptionConfig(),
                                 augment=True, base_augment=True)
    batch = [torch.from_numpy(a).to(dev) for a in S.detection_batch(
        np.random.RandomState(S.SEED), n_batch, S.IMG_SIZE, S.GT_PER_IMAGE,
        S.MAX_BOXES)]
    gen = torch.Generator(dev).manual_seed(S.SEED)

    # 1. unprofiled steps
    step(state, *batch, gen)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    walls = []
    for _ in range(args.steps):
        t0 = time.perf_counter()
        step(state, *batch, gen)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    peak = torch.cuda.max_memory_allocated(dev)
    ms = statistics.median(walls)
    print(f"[train] {args.model} batch {n_batch}: step ms {walls} median "
          f"{ms} = {n_batch / (ms / 1e3)} images/s; peak memory {peak} "
          f"bytes")

    # 2. one profiled step: wall and device busy time from the same run
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(state, *batch, gen)
        torch.cuda.synchronize()
        prof_wall = (time.perf_counter() - t0) * 1e3
    events = prof.events()
    dev_ev = [e for e in events if e.device_type == DeviceType.CUDA]
    if not dev_ev:
        raise RuntimeError("the profiler recorded no device events")
    busy_ms = union_us((e.time_range.start, e.time_range.end)
                       for e in dev_ev) / 1e3
    launches = [e for e in events if e.name in LAUNCH_APIS]
    launch_ms = sum(e.time_range.elapsed_us() for e in launches) / 1e3
    by_kernel: dict = {}
    for e in dev_ev:
        tot, cnt = by_kernel.get(e.name, (0.0, 0))
        by_kernel[e.name] = (tot + e.time_range.elapsed_us() / 1e3, cnt + 1)
    groups: dict = {}
    for name, (k_ms, cnt) in by_kernel.items():
        g = groups.setdefault(kernel_group(name, rtdetr), [0.0, 0])
        g[0] += k_ms
        g[1] += cnt
    print(f"[profiled step] wall {prof_wall} ms, device busy {busy_ms} ms, "
          f"idle share {1 - busy_ms / prof_wall}; {len(launches)} kernel "
          f"launches, {launch_ms} ms host time in the launch API")
    for g, (k_ms, cnt) in sorted(groups.items(), key=lambda kv: -kv[1][0]):
        print(f"[profiled step] {g}: {k_ms} ms device, {cnt} kernels")

    table = [f"{k_ms:12.3f} ms {cnt:7d}  {name[:160]}"
             for name, (k_ms, cnt) in sorted(by_kernel.items(),
                                             key=lambda kv: -kv[1][0])]
    if args.out is None:
        print("\n".join(table[:30]))
    else:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text("\n".join(table) + "\n")
    print(json.dumps({
        "step_ms": walls, "median_step_ms": ms,
        "model": args.model, "batch": n_batch,
        "images_per_sec": n_batch / (ms / 1e3), "peak_bytes": peak,
        "profiled_wall_ms": prof_wall, "device_busy_ms": busy_ms,
        "kernel_launches": len(launches), "launch_api_ms": launch_ms,
        "device_ms_by_group": {g: v[0] for g, v in groups.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
