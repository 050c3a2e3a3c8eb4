#!/usr/bin/env python3
"""Where the time of the PyTorch port's 4-pass sweep goes, on one CUDA card.

    python3 tools/profile_torch_sweep.py [--model yolo|rtdetr] [--images 64]
                                         [--batch 8] [--root DIR]

Runs a sweep of chip_smoke.py (YOLOv8m or RT-DETR-L, nc=6, seeded random
weights, bf16, a 1024 canvas, synthetic 768x1024 images) and measures, in
one process:

  1. per batch, CUDA events (median of 10 calls after 3 warm-ups): the
     fused step (4 passes), one predict pass, and its parts: the forward
     and the decode (YOLO: box decode, then multi-label NMS; RT-DETR: the
     NMS-free top-k);
  2. the unprofiled sweep, 3 runs: wall seconds and image-passes per second;
  3. one sweep under torch.profiler: its wall time, and from that same run
     the device's busy time (union of its kernel and memcpy intervals) and
     idle share; kernel launches and the host time spent in the launch
     API; device time by kernel group.

The device-time table by kernel goes to --out. --root names another
checkout whose port package is measured instead of this one's (its kernels
are built there), so that two trees can be compared in one call on one
card. Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import json
import math
import re
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402  (synthetic_samples, time_ms)

LAUNCH_APIS = {"cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
               "cuLaunchKernelEx"}


def kernel_group(name: str, rtdetr: bool = False) -> str:
    """The group of a device kernel by its name. `rtdetr`: the stride-2
    weight gradients, the BN-chain kernels and the front_tc.cuh /
    front_tf32.cuh kernels belong to K4 (the HGNetv2 stem, whose stride-2
    convs run them), not to K2 (the YOLO front's; no path runs both). The
    CUDA-core kernels that the f32 routes ran before their split-TF32
    kernels are kept by name, for measuring an older checkout (--root)."""
    if "conv3x3_tc_kernel" in name or "conv3x3_tf32_kernel" in name:
        return "K3-f conv3x3"
    if re.search(r"front_p[12]_kernel", name):
        return "K4-f hgstem" if rtdetr else "K2-f yolo_front"
    if re.search(r"e2_prep_kernel|front_d(a1|k1|k2)_tc_kernel", name):
        return "K4-b hgstem_bwd" if rtdetr else "K2-b yolo_front_bwd"
    if re.search(r"front_p[12]_tf32_kernel", name):
        return "K4-f hgstem" if rtdetr else "K2-f yolo_front"
    if re.search(r"e2_prep_f32_kernel|front_d(a1|k1|k2)_tf32_kernel", name):
        return "K4-b hgstem_bwd" if rtdetr else "K2-b yolo_front_bwd"
    if re.search(r"stem2x2_t(c|f32)_kernel|pool2x2_(vec|f32)_kernel|"
                 r"assemble_train_(vec|f32)_kernel", name):
        return "K4-f hgstem"
    if re.search(r"stem2x2_(dx|wgrad)_t(c|f32)_kernel|"
                 r"assemble_bwd_(vec|f32)_kernel", name):
        return "K4-b hgstem_bwd"
    if "wgrad_tc_kernel" in name or "wgrad_tf32_kernel" in name:
        return "K3-b conv3x3_wgrad"
    m = re.search(r"conv3x3_tile_kernel<[^,>]+, (\d), [^,>]+, (\d)", name)
    if m:       # stride, then the activation (1: ReLU, the HGNetv2 stem)
        if m.group(2) == "1":
            return "K4-f hgstem"
        return "K2-f yolo_front" if m.group(1) == "2" else "K3-f conv3x3"
    if re.search(r"conv2x2_relu_kernel|pool2x2_kernel|assemble_train_kernel",
                 name):
        return "K4-f hgstem"
    if re.search(r"stem3_dx_kernel|assemble_bwd_kernel|conv2x2_dx_kernel",
                 name):
        return "K4-b hgstem_bwd"
    if "ms_deform_attn_bwd_kernel" in name:
        return "K5 bwd ms_deform_attn"
    if "ms_deform_attn_kernel" in name:
        return "K5 ms_deform_attn"
    if "auction_kernel" in name:
        return "K6 auction"
    front_bwd = "K4-b hgstem_bwd" if rtdetr else "K2-b yolo_front_bwd"
    m = re.search(r"wgrad_partial_kernel<[^,>]+, (\d), [^,>]+, (\d)", name)
    if m:       # stride, then the input transform's activation (1: ReLU)
        if m.group(1) == "2" or m.group(2) == "1":
            return front_bwd
        return "K3-b conv3x3_wgrad"
    if re.search(r"front_da1_kernel|bn_chain_kernel|stat_cotangent", name):
        return front_bwd
    if re.search(r"finalize_partials_kernel|sum_chunks_(tc_)?kernel", name):
        return "hand-kernel partial sums (K2-f, K2-b, K3-b, K4-f, K4-b)"
    if re.search(r"corrupt_(tile_)?kernel", name):
        return "K1 corrupt"
    low = name.lower()
    if low.startswith(("memcpy", "memset")):
        return "memcpy/memset"
    if "bn_fw" in low or "batch_norm" in low:
        return "cuDNN batch norm"
    if any(t in low for t in ("xmma", "implicit_gemm", "nvjet", "cutlass",
                              "gemm", "conv")):
        return "cuDNN/cuBLAS conv"
    if "elementwise" in low or "catarray" in low or "upsample" in low:
        return "PyTorch elementwise"
    if "layer_norm" in low or "softmax" in low or "attention" in low \
            or "fmha" in low or "flash" in low:
        return "PyTorch attention / layer norm / softmax"
    if "reduce" in low:
        return "PyTorch reductions"
    return "other (topk, sort, gather, scatter, ...)"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--model", choices=("yolo", "rtdetr"), default="yolo")
    ap.add_argument("--images", type=int, default=64)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--out", type=Path,
                    default=ROOT / "chiprun_out" / "profile_torch_sweep.txt")
    ap.add_argument("--root", type=Path, default=ROOT,
                    help="checkout whose port package is measured")
    args = ap.parse_args()
    sys.path.insert(0, str(args.root.resolve()))
    if args.model == "rtdetr" and args.out == ap.get_default("out"):
        args.out = args.out.with_name("profile_torch_sweep_rtdetr.txt")

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from robust_object_detection_tpu_torch import kernels
    from robust_object_detection_tpu_torch.eval import fused_sweep as FS
    from robust_object_detection_tpu_torch.models import rtdetr as R
    from robust_object_detection_tpu_torch.models import yolov8 as Y
    from robust_object_detection_tpu_torch.ops import image as image_ops
    from robust_object_detection_tpu_torch.ops import nms as nms_ops
    from robust_object_detection_tpu_torch.train import detector as D
    from robust_object_detection_tpu_torch.train import rtdetr as RT

    if not torch.cuda.is_available():
        print("FAIL: needs a CUDA card", file=sys.stderr)
        return 1
    size, bs = chip_smoke.IMG_SIZE, args.batch
    dev = torch.device("cuda", 0)
    print(chip_smoke.run_cmd(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"]))
    print(f"[sweep] package {Path(kernels.__file__).resolve().parents[1]}")
    kernels.build()
    seeded = torch.Generator().manual_seed(chip_smoke.SEED)
    if args.model == "yolo":
        model = Y.create(6, "m", torch.bfloat16, dev, seeded)
        predict = D.make_predict_step(size)
    else:
        model = R.create(6, torch.bfloat16, dev, seeded)
        predict = RT.make_predict_step(size)
    images, samples = chip_smoke.synthetic_samples(args.images)

    def loader(sample):
        return images[sample.image_id]

    # 1. per-batch parts, CUDA events
    import numpy as np
    batch = torch.from_numpy(np.stack(
        [images[s.image_id] for s in samples[:bs]])).to(dev)
    step = FS.make_fused_step(predict, None, chip_smoke.NATIVE_HW, size)
    gen = torch.Generator(dev).manual_seed(chip_smoke.SEED)
    canvas, _, _ = image_ops.letterbox(batch.float(), size)
    with torch.inference_mode():
        x = canvas / 255.0
        outs = model(x)
        parts = {
            "fused step (4 passes)": lambda: step(model, None, batch, gen),
            "predict (1 pass)": lambda: predict(model, canvas),
            "forward": lambda: model(x),
        }
        if args.model == "yolo":
            boxes, scores = Y.decode(outs, size)
            n, c = scores.shape[1:]
            parts["decode"] = lambda: Y.decode(outs, size)
            parts["multi-label NMS"] = lambda: nms_ops.multilabel_nms(
                boxes, scores, min(30000, n * c), 300, 0.7, 0.001)
        else:
            parts["decode (NMS-free top-k)"] = lambda: R.postprocess(
                outs, size, 300)
        per_batch = {k: chip_smoke.time_ms(fn) for k, fn in parts.items()}
    for k, ms in per_batch.items():
        print(f"[batch {bs}] {k}: {ms} ms")

    # 2. unprofiled sweeps (the first batch of a run warms the allocator)
    FS.run_fused_sweep(predict, model, None, None, samples[:bs], size, bs,
                       load_image=loader)
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = FS.run_fused_sweep(predict, model, None, None, samples, size,
                                 bs, load_image=loader)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    passes = out["images_evaluated"]
    rates = [passes / w for w in walls]
    print(f"[sweep] {args.images} images x 4 passes, batch {bs}: wall s "
          f"{walls}, images/s {rates}")

    # 3. one profiled sweep: wall and device busy time from the same run
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        FS.run_fused_sweep(predict, model, None, None, samples, size, bs,
                           load_image=loader)
        torch.cuda.synchronize()
        prof_wall = time.perf_counter() - t0
    events = prof.events()
    # kernels and copies only: a GPU-side user annotation (the
    # optimizer's step range) spans the card's idle gaps too
    dev_ev = [e for e in events if e.device_type == DeviceType.CUDA
              and not getattr(e, "is_user_annotation", False)]
    if not dev_ev:
        raise RuntimeError("the profiler recorded no device events")
    busy_ms = chip_smoke.union_us((e.time_range.start, e.time_range.end)
                       for e in dev_ev) / 1e3
    launches = [e for e in events if e.name in LAUNCH_APIS]
    launch_ms = sum(e.time_range.elapsed_us() for e in launches) / 1e3
    by_kernel: dict = {}
    for e in dev_ev:
        tot, cnt = by_kernel.get(e.name, (0.0, 0))
        by_kernel[e.name] = (tot + e.time_range.elapsed_us() / 1e3, cnt + 1)
    groups: dict = {}
    for name, (ms, cnt) in by_kernel.items():
        g = groups.setdefault(kernel_group(name, args.model == "rtdetr"),
                              [0.0, 0])
        g[0] += ms
        g[1] += cnt
    forwards = 4 * math.ceil(args.images / bs)
    print(f"[profiled sweep] wall {prof_wall * 1e3} ms, device busy "
          f"{busy_ms} ms, idle share {1 - busy_ms / (prof_wall * 1e3)}; "
          f"{len(launches)} kernel launches, {launch_ms} ms host time in "
          f"the launch API; {forwards} forwards")
    for g, (ms, cnt) in sorted(groups.items(), key=lambda kv: -kv[1][0]):
        print(f"[profiled sweep] {g}: {ms} ms device, {cnt} kernels, "
              f"{ms / forwards} ms per forward")

    args.out.parent.mkdir(parents=True, exist_ok=True)
    with open(args.out, "w") as f:
        for name, (ms, cnt) in sorted(by_kernel.items(),
                                      key=lambda kv: -kv[1][0]):
            f.write(f"{ms:12.3f} ms {cnt:7d}  {name[:160]}\n")
    print(json.dumps({
        "model": args.model, "per_batch_ms": per_batch, "sweep_wall_s": walls,
        "sweep_images_per_sec": rates,
        "median_images_per_sec": statistics.median(rates),
        "profiled_wall_ms": prof_wall * 1e3, "device_busy_ms": busy_ms,
        "kernel_launches": len(launches), "launch_api_ms": launch_ms,
        "device_ms_by_group": {g: v[0] for g, v in groups.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
