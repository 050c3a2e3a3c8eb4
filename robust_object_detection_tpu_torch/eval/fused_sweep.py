"""Fused on-device robustness sweep (counterpart of
robust_object_detection_tpu/eval/fused_sweep.py).

Clean uint8 images go to the device once per batch; there each batch
becomes the four variants Clean / Noise sigma 15 / Blur k9 / LowRes 0.5x,
each variant is letterboxed and detected, and only the fixed-capacity
detection tensors come back to the host for COCO mAP (eval/coco_map.py,
the port's copy of the reference's host scorer). That is the corrupted
stream: 4 passes.

With a U-Net (``unet_model``, models/unet.py) the restored stream follows:
each corrupted variant is reflect-padded to a multiple of 16, restored
(/255, forward, floor(clip(y * 255 + 0.5, 0, 255)), i.e.
``unet.apply_u8``), cropped and detected; Clean passes through. The pass
order is corrupted[Clean, Noise, Blur, LowRes], then restored[the same],
8 passes, run one at a time, so peak memory is one U-Net forward plus one
detector forward.

Noise: by default drawn on the device from a ``torch.Generator`` seeded by
``seed`` — distributionally the reference's, not the same numbers. With
``mt19937_rng`` the noise planes are drawn on the host from the frozen
MT19937 stream (``host_noise`` mode), exactly as the reference's testset
builder draws them, so the port and the reference see identical inputs.
"""

from __future__ import annotations

import itertools
import time
from pathlib import Path
from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch

from ..core.config import CorruptionConfig
from ..core.profiling import span
from ..data.pipeline import load_image_rgb
from ..data.visdrone import CLASS_NAMES
from ..models import unet as unet_lib
from ..ops import corrupt as corrupt_ops
from ..ops import image as image_ops
from . import coco_map

TESTSET_VARIANTS = ("Test_Clean", "Test_Noise", "Test_Blur", "Test_LowRes")
STRATEGIES = ("corrupted", "restored")


def make_fused_step(predict_fn: Callable, unet_model,
                    native_hw: Tuple[int, int], img_size: int,
                    cfg: CorruptionConfig = CorruptionConfig(),
                    host_noise: bool = False) -> Callable:
    """Build the per-batch sweep step for one native image size.

    predict_fn(det_state, canvas (B, S, S, 3) f32 in [0, 255]) ->
    (boxes, scores, classes, valid) (train.detector.make_predict_step for
    YOLOv8, train.rtdetr.make_predict_step for RT-DETR). unet_model: a
    models/unet.RestorationUNet on the batch's device (put in eval mode
    here), or None for the corrupted stream alone.

    Returns step(det_state, unet_vars, clean_u8 (B, H, W, 3), key) ->
    (boxes (P, B, K, 4) canvas coords, scores (P, B, K), classes (P, B, K),
    valid (P, B, K)), P = 8 with a U-Net (corrupted[Clean, Noise, Blur,
    LowRes], then restored[the same]), else 4. unet_vars is unused (a
    port module carries its weights); it keeps the reference's signature.
    `key` is a torch.Generator on the batch's device, or with
    host_noise=True a (B, H, W, 3) f32 noise-plane batch added to the
    clean pixels (clip + truncate, as the frozen-testset builder).
    """
    h, w = native_hw
    if h % 2 or w % 2:
        raise ValueError(f"fused sweep needs even native dims, got {h}x{w}")
    if unet_model is not None:
        unet_model.eval()

    def restore(img: torch.Tensor) -> torch.Tensor:
        with span("sweep.restore"):
            x = image_ops.pad_to_multiple(img.to(torch.uint8), 16)
            return unet_lib.apply_u8(unet_model, x)[:, :h, :w].float()

    def step(det_state, unet_vars, clean_u8: torch.Tensor, key):
        with span("sweep.corrupt"):
            x = clean_u8.float()
            if host_noise:
                noised = image_ops.quantize_trunc(x + key)
            else:
                noised = corrupt_ops.apply_noise(x, key, cfg.noise_sigma)
            blurred = corrupt_ops.apply_motion_blur(x, cfg.blur_kernel,
                                                    cfg.blur_angle_deg)
            low = corrupt_ops.apply_lowres(x, cfg.downscale_factor)
        variants = (x, noised, blurred, low)

        def detect(p: int, img, restored: bool = False):
            with span("sweep.pass", pass_=p):
                if restored:
                    img = restore(img)
                with span("sweep.letterbox"):
                    canvas, _, _ = image_ops.letterbox(img, img_size)
                return predict_fn(det_state, canvas)
        # one pass at a time: peak memory is one detector forward (plus
        # one U-Net forward on the restored stream)
        outs = [detect(p, img) for p, img in enumerate(variants)]
        if unet_model is not None:
            outs.append(detect(4, x))
            outs += [detect(p, img, restored=True)
                     for p, img in enumerate(variants[1:], start=5)]
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
    """The fused sweep over an indexed clean val split: 8 passes with a
    U-Net, 4 without.

    det_state: the detector module (its device is the sweep's device).
    unet_model: a U-Net on the same device, or None. samples:
    data/pipeline.Sample list of CLEAN images, grouped by native size;
    partial batches are padded to full batch shape. Every batch is
    enqueued before the first fetch, so host decode of batch k+1 overlaps
    device work on batch k. load_image(sample) -> (H, W, 3) uint8 RGB
    (default: decode from disk).

    Returns {"corrupted": {variant: summary}, ["restored": {variant:
    summary},] "images_per_sec", "images_evaluated", "wall_seconds"};
    summaries as detector_eval's. images_evaluated counts image-passes.

    Spans (core/profiling.span): ``sweep.call`` (``call=``, a count of the
    process's calls) around the call; in it, batch by batch
    (``batch=``), ``sweep.load`` (host batch assembly), ``sweep.batch``
    (``sweep.upload``, ``sweep.corrupt``, then each ``sweep.pass``
    (``pass_=``) with ``sweep.restore``, ``sweep.letterbox`` and the
    predict step's spans), then ``sweep.fetch`` (the host waiting for a
    batch's outputs) and ``sweep.collect`` (their COCO records), and last
    ``sweep.score``.
    """
    with span("sweep.call", call=next(_CALLS)):
        return _sweep(predict_fn, det_state, unet_model, unet_vars, samples,
                      img_size, batch_size, cfg, seed, num_threads,
                      mt19937_rng, load_image)


_CALLS = itertools.count()


def _sweep(predict_fn, det_state, unet_model, unet_vars, samples, img_size,
           batch_size, cfg, seed, num_threads, mt19937_rng, load_image):
    from concurrent.futures import ThreadPoolExecutor

    device = next(det_state.parameters()).device
    noise_states = (None if mt19937_rng is None else
                    _mt19937_states(samples, cfg.noise_sigma, mt19937_rng))

    groups: Dict[Tuple[int, int], List] = {}
    for s in samples:
        groups.setdefault((s.height, s.width), []).append(s)

    strategies = STRATEGIES if unet_model is not None else STRATEGIES[:1]
    n_passes = 4 * len(strategies)
    dets: Dict[str, Dict[str, Dict]] = {
        st: {v: {} for v in TESTSET_VARIANTS} for st in strategies}
    gts: Dict[int, coco_map.GroundTruth] = {}
    gen = torch.Generator(device).manual_seed(seed)
    n_images = 0
    t0 = time.time()

    with ThreadPoolExecutor(num_threads) as pool:
        pending = []
        for (h, w), group in sorted(groups.items()):
            step = make_fused_step(predict_fn, unet_model, (h, w), img_size,
                                   cfg, host_noise=noise_states is not None)
            scale = min(img_size / h, img_size / w)
            for start in range(0, len(group), batch_size):
                j = len(pending)
                chunk = group[start:start + batch_size]
                with span("sweep.load", batch=j):
                    batch = np.zeros((batch_size, h, w, 3), np.uint8)
                    for i, im in enumerate(pool.map(load_image, chunk)):
                        batch[i] = im
                    if noise_states is not None:
                        nb = np.zeros((batch_size, h, w, 3), np.float32)
                        planes = pool.map(
                            lambda s: _draw_noise(
                                noise_states[int(s.image_id)],
                                cfg.noise_sigma, h, w), chunk)
                        for i, p in enumerate(planes):
                            nb[i] = p
                with span("sweep.batch", batch=j):
                    with span("sweep.upload"):
                        clean = torch.from_numpy(batch).to(device)
                        key = (gen if noise_states is None
                               else torch.from_numpy(nb).to(device))
                    outs = step(det_state, unet_vars, clean, key)
                pending.append((chunk, scale, outs))
        for j, (chunk, scale, outs) in enumerate(pending):
            with span("sweep.fetch", batch=j):
                boxes, scores, classes, valid = (t.cpu().numpy()
                                                 for t in outs)
            with span("sweep.collect", batch=j):
                for i, sample in enumerate(chunk):
                    img_id = int(sample.image_id)
                    gb = sample.boxes_xyxy
                    gt_xywh = (np.concatenate(
                        [gb[:, :2], gb[:, 2:] - gb[:, :2]], 1)
                        if len(gb) else np.zeros((0, 4), np.float32))
                    gts[img_id] = coco_map.GroundTruth(
                        boxes=gt_xywh,
                        classes=sample.classes.astype(np.int64) + 1)
                    for p in range(n_passes):
                        v = valid[p, i]
                        b = boxes[p, i][v] / scale
                        b[:, 0::2] = b[:, 0::2].clip(0, sample.width)
                        b[:, 1::2] = b[:, 1::2].clip(0, sample.height)
                        xywh = np.concatenate([b[:, :2], b[:, 2:] - b[:, :2]],
                                              1)
                        dets[strategies[p // 4]][TESTSET_VARIANTS[p % 4]][
                            img_id] = coco_map.Detections(
                            boxes=xywh, scores=scores[p, i][v],
                            classes=classes[p, i][v].astype(np.int64) + 1)
            n_images += len(chunk)

    predict_elapsed = time.time() - t0
    with span("sweep.score"):
        scored = {st: {v: _score(dets[st][v], gts, n_images,
                                 predict_elapsed)
                       for v in TESTSET_VARIANTS} for st in strategies}
    elapsed = time.time() - t0
    out: Dict = {"images_evaluated": n_images * n_passes,
                 "wall_seconds": round(elapsed, 2),
                 "images_per_sec": round(n_images * n_passes
                                         / max(elapsed, 1e-9), 2)}
    out.update(scored)
    return out
