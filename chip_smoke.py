#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Drives the port's serving path, the 4-pass robustness sweep, once at full
width: YOLOv8m (nc=6, seeded random weights, bf16, eval mode) at a 1024
canvas over 64 synthetic 768x1024 images in batches of 8. Phases:

  1. environment: torch / CUDA / nvcc versions, the card's name and power
     limit; exits non-zero without a CUDA card;
  2. build: compiles the kernels of csrc/ with nvcc from this checkout;
  3. kernels: each hand-written kernel against its plain PyTorch version
     at the main path's shapes (f32 with TF32 off: max abs err <=
     1e-4 x max|ref|; bf16: <= 1e-2 x max|ref|), with CUDA-event timings
     (median of 10 calls after 3 warm-ups) of both, and the kernels'
     refusal of CUDA tensors they do not take;
  4. model check: YOLOv8m f32 logits on the card (kernels, TF32 off)
     against the same weights on the CPU (plain versions) at 128 px;
  5. the sweep: launch counters zeroed just before it and read just after
     (front 1 and conv3x3 4 per forward, x 4 passes x batches), finite
     per-variant mAPs, detections per image, images/sec.

Any failed check raises, so the script exits non-zero and prints no
result. The line before the last is the kernel summary
``{"kernels": [...]}``; the last line is ``{"ok": true, "device": ...}``.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
from collections import namedtuple
from pathlib import Path

IMG_SIZE = 1024
BATCH = 8
N_IMAGES = 64
NATIVE_HW = (768, 1024)
SEED = 0

# the fields of a clean val-split sample that run_fused_sweep reads
Sample = namedtuple("Sample", "image_path image_id width height "
                              "boxes_xyxy classes")


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


def max_err(out, ref):
    """(max abs error, max |ref|) of out against the f32 reference."""
    return ((out.float() - ref).abs().max().item(),
            ref.abs().max().item())


def phase_kernels(dev):
    """Each kernel vs its plain version at the main path's shapes."""
    import torch
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
        name = str(dtype).split(".")[-1]
        print(f"[kernels] conv3x3 {name} (8,256,256,48)->48: max_abs_err "
              f"{err} (max|ref| {scale}, tol {tol * scale}) kernel {ms} ms "
              f"plain {plain_ms} ms (cuDNN, default flags)")
        require(math.isfinite(err) and err <= tol * scale,
                f"conv3x3 {name} error {err} > {tol} x {scale}")
        conv[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms)
    results["conv3x3"] = conv

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
        front[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms)
    results["yolo_front"] = front

    # the kernels refuse CUDA tensors they do not take, and launch nothing
    refused = 0
    before = (C.conv3x3.launches, TF.front_inference.launches)
    for bad in (lambda: C.conv3x3(x[:, :, ::2], k),
                lambda: C.conv3x3(x.half(), k.half()),
                lambda: TF.front_inference(xf[:, :1023], k1, sc1, bi1, k2,
                                           means, variances)):
        try:
            bad()
        except ValueError:
            refused += 1
    require(refused == 3, f"only {refused}/3 bad CUDA inputs were refused")
    require((C.conv3x3.launches, TF.front_inference.launches) == before,
            "a refused call launched a kernel")
    print("[kernels] bad CUDA inputs refused: 3/3")
    torch.cuda.synchronize()
    return results


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


def phase_sweep(dev):
    """The 4-pass sweep through the port's entry points; returns the
    launch counts of its run."""
    import numpy as np
    import torch
    from robust_object_detection_tpu_torch.eval import fused_sweep as FS
    from robust_object_detection_tpu_torch.models import yolov8 as Y
    from robust_object_detection_tpu_torch.ops import conv3x3 as C
    from robust_object_detection_tpu_torch.ops import yolo_front as TF
    from robust_object_detection_tpu_torch.train import detector as D

    model = Y.create(6, "m", torch.bfloat16, dev,
                     torch.Generator().manual_seed(SEED))
    predict = D.make_predict_step(IMG_SIZE)
    images, samples = synthetic_samples(N_IMAGES)

    def loader(sample):
        return images[sample.image_id]

    # warm-up batch (cuDNN algorithm choice, allocator), off the count
    FS.run_fused_sweep(predict, model, None, None, samples[:BATCH], IMG_SIZE,
                       BATCH, load_image=loader)
    torch.cuda.synchronize()

    C.conv3x3.launches = 0
    TF.front_inference.launches = 0
    t0 = time.perf_counter()
    out = FS.run_fused_sweep(predict, model, None, None, samples, IMG_SIZE,
                             BATCH, seed=SEED, load_image=loader)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = {"conv3x3": C.conv3x3.launches,
                "yolo_front": TF.front_inference.launches}

    forwards = 4 * math.ceil(N_IMAGES / BATCH)
    expect = {"conv3x3": 4 * forwards, "yolo_front": forwards}
    print(f"[sweep] launches {launches} expected {expect}")
    require(launches == expect, f"launch counts {launches} != {expect}")
    require(out["images_evaluated"] == 4 * N_IMAGES, "images_evaluated")
    for variant, summary in out["corrupted"].items():
        m50, m5095 = summary["mAP50"], summary["mAP50_95"]
        print(f"[sweep] {variant}: mAP50 {m50} mAP50-95 {m5095}")
        require(all(math.isfinite(v) and 0.0 <= v <= 1.0
                    for v in (m50, m5095)), f"{variant} mAP not finite")
    rate = out["images_evaluated"] / elapsed
    print(f"[sweep] YOLOv8m bf16 1024px, {N_IMAGES} images 768x1024 x 4 "
          f"passes, batch {BATCH}: {elapsed} s, {rate} images/s "
          f"(host scoring included)")

    # detections per image per pass, from one more fused step (not counted)
    step = FS.make_fused_step(predict, None, NATIVE_HW, IMG_SIZE)
    batch = torch.from_numpy(np.stack([images[s.image_id]
                                       for s in samples[:BATCH]])).to(dev)
    boxes, scores, _, valid = step(
        model, None, batch, torch.Generator(dev).manual_seed(SEED))
    require(bool(torch.isfinite(boxes).all() and torch.isfinite(scores).all()),
            "non-finite detections")
    per_img = valid.sum(-1).float().mean(-1).tolist()
    print(f"[sweep] detections per image by pass (Clean, Noise, Blur, "
          f"LowRes): {per_img}")
    return launches


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
    for line in kernels.build_log().splitlines():
        if "registers" in line or "spill" in line:
            print(f"[build] {line.strip()}")

    kres = phase_kernels(dev)
    phase_model_check(dev)
    launches = phase_sweep(dev)

    src = "robust_object_detection_tpu_torch/csrc/"
    ref = "robust_object_detection_tpu/ops/"
    summary = []
    for name, source, replaces in (
            ("conv3x3", src + "conv3x3.cu", ref + "pallas_conv.py:37"),
            ("yolo_front", src + "yolo_front.cu",
             ref + "pallas_yolo_front.py:109")):
        r = kres[name]["bfloat16"]
        summary.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": launches[name],
                        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                        "plain_ms": r["plain_ms"]})
    print(json.dumps({"kernels": summary}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
