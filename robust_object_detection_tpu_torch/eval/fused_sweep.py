"""Fused on-device robustness sweep, corrupted stream (counterpart of
robust_object_detection_tpu/eval/fused_sweep.py).

Clean uint8 images go to the device once per batch; there each batch
becomes the four variants Clean / Noise sigma 15 / Blur k9 / LowRes 0.5x,
each variant is letterboxed and detected, and only the fixed-capacity
detection tensors come back to the host for COCO mAP (eval/coco_map.py,
the port's copy of the reference's host scorer).

This is the 4-pass sweep the reference runs without a U-Net. The restored
stream (U-Net over the corrupted variants, 8 passes) is not ported yet:
``unet_model`` must be None.

Noise: by default drawn on the device from a ``torch.Generator`` seeded by
``seed`` — distributionally the reference's, not the same numbers. With
``mt19937_rng`` the noise planes are drawn on the host from the frozen
MT19937 stream (``host_noise`` mode), exactly as the reference's testset
builder draws them, so the port and the reference see identical inputs.
"""

from __future__ import annotations

import time
from pathlib import Path
from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch

from ..core.config import CorruptionConfig
from ..data.pipeline import load_image_rgb
from ..data.visdrone import CLASS_NAMES
from ..ops import corrupt as corrupt_ops
from ..ops import image as image_ops
from . import coco_map

TESTSET_VARIANTS = ("Test_Clean", "Test_Noise", "Test_Blur", "Test_LowRes")


def make_fused_step(predict_fn: Callable, unet_model,
                    native_hw: Tuple[int, int], img_size: int,
                    cfg: CorruptionConfig = CorruptionConfig(),
                    host_noise: bool = False) -> Callable:
    """Build the per-batch sweep step for one native image size.

    predict_fn(det_state, canvas (B, S, S, 3) f32 in [0, 255]) ->
    (boxes, scores, classes, valid) (train.detector.make_predict_step for
    YOLOv8, train.rtdetr.make_predict_step for RT-DETR).

    Returns step(det_state, unet_vars, clean_u8 (B, H, W, 3), key) ->
    (boxes (4, B, K, 4) canvas coords, scores (4, B, K), classes (4, B, K),
    valid (4, B, K)), passes in the order Clean, Noise, Blur, LowRes.
    `key` is a torch.Generator on the batch's device, or with
    host_noise=True a (B, H, W, 3) f32 noise-plane batch added to the
    clean pixels (clip + truncate, as the frozen-testset builder).
    """
    if unet_model is not None:
        raise NotImplementedError("the restored (U-Net) stream is not "
                                  "ported yet; pass unet_model=None")
    h, w = native_hw
    if h % 2 or w % 2:
        raise ValueError(f"fused sweep needs even native dims, got {h}x{w}")

    def step(det_state, unet_vars, clean_u8: torch.Tensor, key):
        x = clean_u8.float()
        if host_noise:
            noised = image_ops.quantize_trunc(x + key)
        else:
            noised = corrupt_ops.apply_noise(x, key, cfg.noise_sigma)
        blurred = corrupt_ops.apply_motion_blur(x, cfg.blur_kernel,
                                                cfg.blur_angle_deg)
        low = corrupt_ops.apply_lowres(x, cfg.downscale_factor)
        outs = []
        # sequential over passes: peak memory is one detector forward
        for img in (x, noised, blurred, low):
            canvas, _, _ = image_ops.letterbox(img, img_size)
            outs.append(predict_fn(det_state, canvas))
        return tuple(torch.stack(parts) for parts in zip(*outs))

    return step


def frozen_noise_rng(skip_splits: Sequence[Sequence] = (),
                     sigma: float = 15.0,
                     seed: int = 42) -> "np.random.RandomState":
    """RandomState positioned at the frozen noise stream for one layout
    (the reference threads one RandomState(42) across layouts, yolo6
    first; pass the yolo6 split's samples as skip_splits for coco6)."""
    rng = np.random.RandomState(seed)
    for split in skip_splits:
        for s in sorted(split, key=lambda s: Path(s.image_path).name):
            rng.normal(0.0, sigma, (s.height, s.width, 3))
    return rng


def _mt19937_states(samples: Sequence, sigma: float,
                    rng: "np.random.RandomState") -> Dict[int, tuple]:
    """Per-sample MT19937 state snapshots in sorted file order (the disk
    builder's order), keyed by image_id."""
    states: Dict[int, tuple] = {}
    for s in sorted(samples, key=lambda s: Path(s.image_path).name):
        states[int(s.image_id)] = rng.get_state()
        rng.normal(0.0, sigma, (s.height, s.width, 3))
    return states


def _draw_noise(state: tuple, sigma: float, h: int, w: int) -> np.ndarray:
    """One frozen-stream noise plane, channel-reversed BGR->RGB."""
    r = np.random.RandomState()
    r.set_state(state)
    return np.ascontiguousarray(
        r.normal(0.0, sigma, (h, w, 3)).astype(np.float32)[..., ::-1])


def _score(detections, ground_truth, n_images: int, elapsed: float) -> Dict:
    """The reference's host scorer (eval/detector_eval._score)."""
    result = coco_map.evaluate(detections, ground_truth,
                               categories=list(range(1, 7)))
    summary = coco_map.summarize(result)
    summary["per_class_ap50"] = {
        CLASS_NAMES[c - 1]: v for c, v in result.per_class_ap50.items()}
    summary["images"] = n_images
    summary["images_per_sec"] = round(n_images / max(elapsed, 1e-9), 2)
    return summary


def run_fused_sweep(predict_fn: Callable, det_state, unet_model, unet_vars,
                    samples: Sequence, img_size: int, batch_size: int,
                    cfg: CorruptionConfig = CorruptionConfig(),
                    seed: int = 0, num_threads: int = 8,
                    mt19937_rng=None,
                    load_image: Callable = load_image_rgb) -> Dict:
    """The 4-pass fused sweep over an indexed clean val split.

    det_state: the detector module (its device is the sweep's device).
    samples: data/pipeline.Sample list of CLEAN images, grouped by native
    size; partial batches are padded to full batch shape. Every batch is
    enqueued before the first fetch, so host decode of batch k+1 overlaps
    device work on batch k. load_image(sample) -> (H, W, 3) uint8 RGB
    (default: decode from disk).

    Returns {"corrupted": {variant: summary}, "images_per_sec",
    "images_evaluated", "wall_seconds"}; summaries as detector_eval's.
    """
    from concurrent.futures import ThreadPoolExecutor

    if unet_model is not None:
        raise NotImplementedError("the restored (U-Net) stream is not "
                                  "ported yet; pass unet_model=None")
    device = next(det_state.parameters()).device
    noise_states = (None if mt19937_rng is None else
                    _mt19937_states(samples, cfg.noise_sigma, mt19937_rng))

    groups: Dict[Tuple[int, int], List] = {}
    for s in samples:
        groups.setdefault((s.height, s.width), []).append(s)

    dets: Dict[str, Dict] = {v: {} for v in TESTSET_VARIANTS}
    gts: Dict[int, coco_map.GroundTruth] = {}
    gen = torch.Generator(device).manual_seed(seed)
    n_images = 0
    t0 = time.time()

    with ThreadPoolExecutor(num_threads) as pool:
        pending = []
        for (h, w), group in sorted(groups.items()):
            step = make_fused_step(predict_fn, None, (h, w), img_size, cfg,
                                   host_noise=noise_states is not None)
            scale = min(img_size / h, img_size / w)
            for start in range(0, len(group), batch_size):
                chunk = group[start:start + batch_size]
                batch = np.zeros((batch_size, h, w, 3), np.uint8)
                for i, im in enumerate(pool.map(load_image, chunk)):
                    batch[i] = im
                if noise_states is None:
                    key = gen
                else:
                    nb = np.zeros((batch_size, h, w, 3), np.float32)
                    planes = pool.map(
                        lambda s: _draw_noise(noise_states[int(s.image_id)],
                                              cfg.noise_sigma, h, w), chunk)
                    for i, p in enumerate(planes):
                        nb[i] = p
                    key = torch.from_numpy(nb).to(device)
                outs = step(det_state, unet_vars,
                            torch.from_numpy(batch).to(device), key)
                pending.append((chunk, scale, outs))
        for chunk, scale, outs in pending:
            boxes, scores, classes, valid = (t.cpu().numpy() for t in outs)
            for i, sample in enumerate(chunk):
                img_id = int(sample.image_id)
                gb = sample.boxes_xyxy
                gt_xywh = (np.concatenate(
                    [gb[:, :2], gb[:, 2:] - gb[:, :2]], 1)
                    if len(gb) else np.zeros((0, 4), np.float32))
                gts[img_id] = coco_map.GroundTruth(
                    boxes=gt_xywh, classes=sample.classes.astype(np.int64) + 1)
                for p, variant in enumerate(TESTSET_VARIANTS):
                    v = valid[p, i]
                    b = boxes[p, i][v] / scale
                    b[:, 0::2] = b[:, 0::2].clip(0, sample.width)
                    b[:, 1::2] = b[:, 1::2].clip(0, sample.height)
                    xywh = np.concatenate([b[:, :2], b[:, 2:] - b[:, :2]], 1)
                    dets[variant][img_id] = coco_map.Detections(
                        boxes=xywh, scores=scores[p, i][v],
                        classes=classes[p, i][v].astype(np.int64) + 1)
            n_images += len(chunk)

    predict_elapsed = time.time() - t0
    scored = {v: _score(dets[v], gts, n_images, predict_elapsed)
              for v in TESTSET_VARIANTS}
    elapsed = time.time() - t0
    n_passes = len(TESTSET_VARIANTS)
    return {"images_evaluated": n_images * n_passes,
            "wall_seconds": round(elapsed, 2),
            "images_per_sec": round(n_images * n_passes
                                    / max(elapsed, 1e-9), 2),
            "corrupted": scored}
