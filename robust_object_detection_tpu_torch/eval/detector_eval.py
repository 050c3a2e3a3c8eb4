"""Detector evaluation: testset sweep -> COCO mAP -> JSON/CSV tables
(counterpart of robust_object_detection_tpu/eval/detector_eval.py).

Each (model, testset) run is a fixed-shape batched predict on the card;
detections come back as fixed-capacity (max_det) tensors with validity
masks, are rescaled to original image coordinates on the host and feed
the port's COCOeval-parity scorer (eval/coco_map.py). The artifacts are
the reference's: eval_results.json / .csv with mAP50, mAP50_95, per-class
AP@50, and the summary, per-class and degradation tables.

A predict fn is any of the port's predict steps: ``predict_fn(model,
images (B, H, W, 3) uint8) -> (boxes (B, K, 4) canvas xyxy, scores,
classes, valid)`` (train.detector / train.rtdetr / train.frcnn
``make_predict_step``). Faster R-CNN also runs at torchvision-native
resolution through :class:`BucketedPredict`.
"""

from __future__ import annotations

import functools
import time
from pathlib import Path
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch

from ..core import artifacts
from ..core.profiling import span
from ..data import pipeline as pipe
from ..data.visdrone import CLASS_NAMES
from ..parallel import mesh as mesh_lib
from . import coco_map

TESTSET_VARIANTS = ("Test_Clean", "Test_Noise", "Test_Blur", "Test_LowRes")


def _device_of(state, device) -> torch.device:
    """The device the caller names, else the one the model (or a train
    state's model) lives on."""
    if device is not None:
        return torch.device(device)
    return next(getattr(state, "model", state).parameters()).device


def evaluate_on_samples(predict_fn: Callable, state, samples,
                        img_size: int, batch_size: int,
                        device: Optional[torch.device] = None,
                        max_boxes: int = 600,
                        load_image: Callable = pipe.load_image_rgb,
                        mesh: Optional[mesh_lib.MeshContext] = None) -> Dict:
    """Run a predict fn over samples; score the detections.

    mesh: a data-parallel mesh (parallel/mesh.make_mesh; the reference's
    ctx): each data rank predicts its rows of every batch (batch_size must
    divide over the data axis), the detections are gathered, and every
    rank scores the same set, so the summary is the unsharded one.

    state: the model module (it is what the predict fn runs); device: where
    the images go (default: the model's). Spans (core/profiling.span):
    ``eval/decode_wait``, ``eval/h2d``, ``eval/device_compute`` (the
    launch; the card's time is in a device trace), ``eval/postprocess``
    with ``eval/d2h`` (the host waiting for each batch's detections), and
    ``eval/score``."""
    if isinstance(predict_fn, BucketedPredict):
        return evaluate_bucketed(
            predict_fn.factory, state, samples, batch_size, device,
            max_boxes, predict_fn.min_side, predict_fn.max_side,
            predict_fn.bucket_mult, predict_fn.pad_value, load_image, mesh)
    t0 = time.time()
    detections, ground_truth, n_images = _collect_detections(
        predict_fn, state, samples, img_size, batch_size, device, max_boxes,
        load_image=load_image, mesh=mesh)
    elapsed = time.time() - t0
    return _score(detections, ground_truth, n_images, elapsed)


def _collect_detections(predict_fn: Callable, state, samples,
                        img_size, batch_size: int,
                        device: Optional[torch.device], max_boxes: int,
                        scale_fn=None, pad_value=114,
                        load_image: Callable = pipe.load_image_rgb,
                        mesh: Optional[mesh_lib.MeshContext] = None):
    """The predict half of evaluate_on_samples: (detections, gt, n_images).

    img_size may be an (H, W) canvas, scale_fn a per-sample resize-scale
    override, and pad_value the canvas padding (the aspect-bucket path)."""
    device = _device_of(state, device)
    detections: Dict[int, coco_map.Detections] = {}
    ground_truth: Dict[int, coco_map.GroundTruth] = {}
    n_images = 0
    # enqueue the whole testset, then fetch: the host decodes batch k+1
    # while the card runs batch k
    pending = []
    it = iter(pipe.prefetch(pipe.make_batches(
        samples, batch_size, img_size, max_boxes=max_boxes,
        scale_fn=scale_fn, pad_value=pad_value, load_image=load_image)))
    while True:
        with span("eval/decode_wait"):
            batch = next(it, None)
        if batch is None:
            break
        with span("eval/h2d"):
            # a data rank predicts its rows; the outputs are gathered
            images = torch.from_numpy(np.ascontiguousarray(
                mesh_lib.shard_batch(mesh, batch.images))).to(device)
        with span("eval/device_compute"):
            outputs = mesh_lib.gather_rows(mesh, predict_fn(state, images))
        meta = (batch.image_ids, batch.scales, batch.num_valid)
        pending.append((meta, outputs))
    with span("eval/postprocess"):
        for (image_ids, scales, num_valid), outputs in pending:
            with span("eval/d2h"):
                boxes, scores, classes, valid = (t.cpu().numpy()
                                                 for t in outputs)
            for i in range(num_valid):
                img_id = int(image_ids[i])
                v = valid[i]
                b = boxes[i][v] / scales[i]           # canvas -> original px
                sample = samples[n_images + i]
                b[:, 0::2] = b[:, 0::2].clip(0, sample.width)
                b[:, 1::2] = b[:, 1::2].clip(0, sample.height)
                xywh = np.concatenate([b[:, :2], b[:, 2:] - b[:, :2]], 1)
                detections[img_id] = coco_map.Detections(
                    boxes=xywh, scores=scores[i][v],
                    classes=classes[i][v].astype(np.int64) + 1)
                gb = sample.boxes_xyxy
                gt_xywh = (np.concatenate([gb[:, :2], gb[:, 2:] - gb[:, :2]],
                                          1)
                           if len(gb) else np.zeros((0, 4), np.float32))
                ground_truth[img_id] = coco_map.GroundTruth(
                    boxes=gt_xywh, classes=sample.classes.astype(np.int64) + 1)
            n_images += num_valid
    return detections, ground_truth, n_images


def _score(detections, ground_truth, n_images: int, elapsed: float) -> Dict:
    with span("eval/score"):
        result = coco_map.evaluate(detections, ground_truth,
                                   categories=list(range(1, 7)))
    summary = coco_map.summarize(result)
    summary["per_class_ap50"] = {
        CLASS_NAMES[c - 1]: v for c, v in result.per_class_ap50.items()}
    summary["images"] = n_images
    summary["images_per_sec"] = round(n_images / max(elapsed, 1e-9), 2)
    return summary


class BucketedPredict:
    """Marker wrapper routing eval through the aspect-bucket path.

    Wraps a `factory((H, W)) -> predict fn`; anywhere a plain predict_fn
    is accepted (evaluate_on_samples / evaluate_testsets / sweep), one of
    these evaluates at torchvision-native resolution via
    evaluate_bucketed instead of the square letterbox. The factory is
    memoised, so each bucket builds its predict fn once per process."""

    def __init__(self, factory: Callable, min_side: float = 800.0,
                 max_side: float = 1333.0, bucket_mult: int = 64,
                 pad_value=(124, 116, 104)):
        self.factory = functools.lru_cache(maxsize=None)(factory)
        self.min_side = min_side
        self.max_side = max_side
        self.bucket_mult = bucket_mult
        # default pad = imagenet-mean pixel: torchvision batch_images
        # zero-pads the NORMALISED tensor, i.e. mean-pads in pixel space
        self.pad_value = pad_value


def tv_target(h: int, w: int, min_side: float = 800.0,
              max_side: float = 1333.0):
    """torchvision GeneralizedRCNNTransform target: scale so the short side
    reaches min_side unless the long side would exceed max_side. Returns
    (target_h, target_w, scale)."""
    scale = min(min_side / min(h, w), max_side / max(h, w))
    return round(h * scale), round(w * scale), scale


def evaluate_bucketed(predict_factory: Callable, state, samples,
                      batch_size: int,
                      device: Optional[torch.device] = None,
                      max_boxes: int = 600, min_side: float = 800.0,
                      max_side: float = 1333.0, bucket_mult: int = 64,
                      pad_value=(124, 116, 104),
                      load_image: Callable = pipe.load_image_rgb,
                      mesh: Optional[mesh_lib.MeshContext] = None) -> Dict:
    """Aspect-bucket eval at torchvision-native resolution (FRCNN parity).

    Each image is resized by exactly the GeneralizedRCNNTransform scale
    (min800/max1333, see tv_target) and padded into the smallest
    bucket_mult-aligned canvas that fits, so the model sees every image at
    the reference's scale through a handful of canvas shapes.
    predict_factory((H, W)) -> predict fn for that canvas."""
    groups: Dict[tuple, list] = {}
    scales: Dict[int, float] = {}
    for s in samples:
        th, tw, sc = tv_target(s.height, s.width, min_side, max_side)
        bucket = (-(-th // bucket_mult) * bucket_mult,
                  -(-tw // bucket_mult) * bucket_mult)
        groups.setdefault(bucket, []).append(s)
        scales[s.image_id] = sc

    detections: Dict[int, coco_map.Detections] = {}
    ground_truth: Dict[int, coco_map.GroundTruth] = {}
    n_images = 0
    t0 = time.time()
    for bucket in sorted(groups):
        group = groups[bucket]
        d, g, m = _collect_detections(
            predict_factory(bucket), state, group, bucket, batch_size,
            device, max_boxes, scale_fn=lambda s: scales[s.image_id],
            pad_value=pad_value, load_image=load_image, mesh=mesh)
        detections.update(d)
        ground_truth.update(g)
        n_images += m
    elapsed = time.time() - t0
    summary = _score(detections, ground_truth, n_images, elapsed)
    summary["buckets"] = {f"{bh}x{bw}": len(groups[(bh, bw)])
                          for bh, bw in sorted(groups)}
    return summary


def evaluate_testsets(predict_fn: Callable, state, testset_root: str | Path,
                      img_size: int, batch_size: int,
                      device: Optional[torch.device] = None,
                      variants: Sequence[str] = TESTSET_VARIANTS,
                      layout: str = "coco6") -> Dict[str, Dict]:
    """One model over the 4 frozen testsets -> {variant: summary}."""
    root = Path(testset_root) / layout
    out = {}
    for variant in variants:
        vdir = root / variant
        samples = (pipe.index_coco(vdir, "val")
                   if layout.startswith("coco6")
                   else pipe.index_yolo(vdir, "val"))
        out[variant] = evaluate_on_samples(
            predict_fn, state, samples, img_size, batch_size, device)
    return out


def sweep(models: Dict[str, tuple], testset_root: str | Path,
          img_size: int, batch_size: int, out_dir: str | Path,
          device: Optional[torch.device] = None,
          layout: str = "coco6",
          results_name: str = "eval_results",
          resume: bool = True) -> Dict:
    """The full (model x testset) sweep + artifact output.

    models: name -> (predict_fn, model). Writes <out_dir>/<results_name>
    .json and .csv in the reference's shape and prints the summary,
    per-class and degradation tables. Each (model, testset) cell is
    persisted to <results_name>.partial.json the moment it is scored; a
    restarted sweep skips completed cells, and the partial file goes once
    the full artifacts land (resume=False starts from zero)."""
    import json
    out_dir = Path(out_dir)
    partial_path = out_dir / f"{results_name}.partial.json"
    done: Dict[str, Dict] = {}
    if resume and partial_path.exists():
        try:
            done = json.loads(partial_path.read_text())
        except json.JSONDecodeError:
            # a kill mid-write can leave a truncated partial file: restart
            # from zero rather than fail the resume path
            done = {}
    results: Dict[str, Dict[str, Dict]] = {}
    for name, (predict_fn, state) in models.items():
        per_variant: Dict[str, Dict] = {}
        for variant in TESTSET_VARIANTS:
            cell = f"{name}/{variant}"
            if cell in done:
                per_variant[variant] = done[cell]
                continue
            per_variant.update(evaluate_testsets(
                predict_fn, state, testset_root, img_size, batch_size,
                device, variants=(variant,), layout=layout))
            done[cell] = per_variant[variant]
            artifacts.write_json(partial_path, done)
        results[name] = per_variant

    rows = []
    for name, per_variant in results.items():
        for variant, summary in per_variant.items():
            rows.append({"model": name, "testset": variant,
                         "mAP50": round(summary["mAP50"], 4),
                         "mAP50_95": round(summary["mAP50_95"], 4),
                         "images_per_sec": summary["images_per_sec"]})
    artifacts.write_json(out_dir / f"{results_name}.json", results)
    artifacts.write_csv(out_dir / f"{results_name}.csv", rows)
    partial_path.unlink(missing_ok=True)

    print(artifacts.format_table(
        ["model", "testset", "mAP50", "mAP50_95", "img/s"],
        [[r["model"], r["testset"], r["mAP50"], r["mAP50_95"],
          r["images_per_sec"]] for r in rows]))
    print()
    print(per_class_table(results))
    print()
    print(degradation_table(results))
    comparison = comparison_table(results)
    if comparison:
        # Aug - Base deltas, printed on every sweep as the reference does;
        # empty when no _baseline/_augmented model-name pairs are present
        print()
        print("Aug - Base mAP50 difference:")
        print(comparison)
    return results


def per_class_table(results: Dict[str, Dict[str, Dict]],
                    variant: str = "Test_Clean") -> str:
    """Per-class AP@50 on one testset."""
    rows = []
    for name, per_variant in results.items():
        per_class = per_variant.get(variant, {}).get("per_class_ap50", {})
        rows.append([name] + [round(per_class.get(c, 0.0), 4)
                              for c in CLASS_NAMES])
    return (f"per-class AP@50 ({variant}):\n"
            + artifacts.format_table(["model"] + list(CLASS_NAMES), rows))


def degradation_table(results: Dict[str, Dict[str, Dict]]) -> str:
    """Per-model % mAP50 drop vs Clean."""
    rows = []
    for name, per_variant in results.items():
        clean = per_variant.get("Test_Clean", {}).get("mAP50", 0.0)
        row = [name]
        for variant in ("Test_Noise", "Test_Blur", "Test_LowRes"):
            v = per_variant.get(variant, {}).get("mAP50", 0.0)
            drop = 100.0 * (clean - v) / clean if clean > 0 else 0.0
            row.append(round(drop, 1))
        rows.append(row)
    return artifacts.format_table(
        ["model", "Noise drop%", "Blur drop%", "LowRes drop%"], rows,
        floatfmt="{:.1f}")


def comparison_table(results: Dict[str, Dict[str, Dict]],
                     base_suffix: str = "_baseline",
                     aug_suffix: str = "_augmented") -> str:
    """Aug - Base mAP50 difference per testset."""
    rows = []
    for base in (m for m in results if m.endswith(base_suffix)):
        stem = base[: -len(base_suffix)]
        aug = stem + aug_suffix
        if aug not in results:
            continue
        row = [stem]
        for variant in TESTSET_VARIANTS:
            d = (results[aug][variant]["mAP50"]
                 - results[base][variant]["mAP50"])
            row.append(round(d, 4))
        rows.append(row)
    if not rows:
        return ""
    return artifacts.format_table(
        ["model", "Clean", "Noise", "Blur", "LowRes"], rows)
