"""Miniature end-to-end run of the whole workflow through the PyTorch port's
CLI, on a synthetic BMP split: convert -> validate -> frozen testsets ->
U-Net -> restored testsets -> YOLOv8m (baseline and augmented), RT-DETR-L
and Faster R-CNN -> the disk sweep over the testsets and the restored
testsets -> the fused 8-pass sweep -> figures and demo strips.

The detectors are built at their published widths from seeded random
weights and trained for a few steps, so every mAP sits near 0: the run
shows that every stage chains through the public entry points. A BMP split
needs neither PIL nor cv2; the figures need matplotlib and the demo strips
cv2, and are skipped where those are missing.

Usage:
    python examples/full_pipeline_synthetic_torch.py [--work DIR]
        [--device cuda|cpu] [--img-size 128] [--steps 2]
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from robust_object_detection_tpu_torch import cli  # noqa: E402
from robust_object_detection_tpu_torch.core import config as config_lib  # noqa: E402,E501
from robust_object_detection_tpu_torch.data import synthetic  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--work", default=None)
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card")
    ap.add_argument("--img-size", type=int, default=128)
    ap.add_argument("--steps", type=int, default=2)
    args = ap.parse_args(argv)
    work = Path(args.work or tempfile.mkdtemp(prefix="rod_torch_e2e_"))
    dev = ["--device", args.device] if args.device else []
    img = str(args.img_size)
    t0 = time.time()

    def run(*cmd):
        t = time.time()
        out = cli.main(list(cmd) + dev)
        print(f"[example] {cmd[0]}: {time.time() - t:.1f} s", flush=True)
        return out

    # data preparation ----------------------------------------------------
    raw = {s: synthetic.make_det_split(work / "raw" / s, n_images=n,
                                       seed=seed, ext="bmp",
                                       size_range=((96, 160), (128, 200)))
           for s, n, seed in (("train", 8, 1), ("val", 4, 2))}
    proc = work / "processed"
    for s in ("train", "val"):
        run("convert-det-coco", "--src", str(raw[s]), "--out",
            str(proc / "visdrone_coco6"), "--split", s)
        run("convert-det-yolo", "--src", str(raw[s]), "--out",
            str(proc / "visdrone_yolo6"), "--split", s)
    run("validate", "--root", str(raw["val"]), "--kind", "visdrone-det")
    run("validate", "--root", str(proc / "visdrone_coco6"), "--kind", "coco")
    run("validate", "--root", str(proc / "visdrone_yolo6"), "--kind", "yolo")
    testsets = work / "testsets"
    run("build-testsets", "--processed-root", str(proc), "--out",
        str(testsets))

    # restoration ---------------------------------------------------------
    cfg = config_lib.ExperimentConfig()
    cfg = config_lib.override(cfg, restoration=config_lib.override(
        cfg.restoration, patch_size=64, batch_size=4))
    cfg_path = work / "config.json"
    config_lib.save(cfg, cfg_path)
    coco = proc / "visdrone_coco6"
    exp = work / "experiments"
    run("train-restoration", "--train-dir", str(coco / "images" / "train"),
        "--val-dir", str(coco / "images" / "val"), "--out",
        str(exp / "restoration"), "--max-steps", str(args.steps),
        "--config", str(cfg_path))
    run("restore-testsets", "--testset-root", str(testsets), "--unet-dir",
        str(exp / "restoration"), "--batch-size", "2")

    # detectors -----------------------------------------------------------
    common = ["--data-root", str(coco), "--epochs", "1", "--max-steps",
              str(args.steps), "--img-size", img]
    ckpts = {}
    for name, model, extra in (
            ("yolo_baseline", "yolo", ["--batch-size", "4"]),
            ("yolo_augmented", "yolo", ["--batch-size", "4", "--augment"]),
            ("rtdetr_augmented", "rtdetr", ["--batch-size", "4",
                                            "--augment"]),
            ("frcnn_augmented", "frcnn", ["--batch-size", "2",
                                          "--augment"])):
        out = exp / name
        run("train-detector", "--model", model, "--out", str(out), *common,
            *extra)
        ckpts[name] = f"{name}={model}:{out}"

    # evaluation ----------------------------------------------------------
    sweep = ["--testset-root", str(testsets), "--img-size", img,
             "--batch-size", "2", "--out", str(exp)]
    run("eval", *(a for c in ckpts.values() for a in ("--model", c)),
        *sweep)
    run("eval-restored", "--model", ckpts["yolo_baseline"], *sweep)
    run("eval-vid", "--model", ckpts["yolo_augmented"], *sweep)
    even = synthetic.make_det_split(work / "raw" / "even", n_images=4,
                                    seed=3, ext="bmp",
                                    size_range=((96, 97), (128, 129)))
    run("convert-det-coco", "--src", str(even), "--out",
        str(work / "even"), "--split", "val")
    run("eval-fused", "--model", ckpts["yolo_baseline"], "--model",
        ckpts["rtdetr_augmented"], "--data-root", str(work / "even"),
        "--unet-dir", str(exp / "restoration"), "--img-size", img,
        "--batch-size", "2", "--mt19937-parity", "coco6", "--out", str(exp))
    results = json.loads((exp / "eval_results.json").read_text())
    for name, per_variant in results.items():
        print(f"[example] {name}: " + ", ".join(
            f"{v} {s['mAP50']:.4f}" for v, s in per_variant.items()))

    # reports -------------------------------------------------------------
    if importlib.util.find_spec("matplotlib"):
        run("plot", "--results", str(exp / "eval_results.json"), "--out",
            str(exp / "figures"))
        run("plot-three", "--results", str(exp / "eval_results.json"),
            "--restored", str(exp / "eval_restored_results.json"), "--out",
            str(exp / "figures"))
        run("plot-vid", "--results", str(exp / "vid_eval_results.json"),
            "--out", str(exp / "figures"))
    else:
        print("[example] plots skipped: no matplotlib")
    if importlib.util.find_spec("cv2"):
        run("demo", "--base", f"yolo:{exp / 'yolo_baseline'}", "--aug",
            f"yolo:{exp / 'yolo_augmented'}", "--data-root", str(coco),
            "--img-size", img, "--n", "2", "--out", str(exp / "demo"))
    else:
        print("[example] demo skipped: no cv2")
    print(f"[example] done in {time.time() - t0:.1f} s under {work}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
