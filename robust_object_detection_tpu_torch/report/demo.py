"""Demo inference strips: [Clean+GT | Blur+Baseline | Blur+Augmented]
(counterpart of robust_object_detection_tpu/report/demo.py). Host only:
cv2 is imported at the call for its box and text drawing, images are read,
resized and written through data/imageio.py, and the detectors are the
port's predict steps on their own device.

Reference counterpart: demo_inference.py — picks 5 annotation-dense val
images (top-50 by annotation count, seeded sample, :69-84), renders a
3-panel side-by-side strip per model pair with per-class colours, score
labels, panel title bars and 480-px height normalisation (:197-259);
confidence threshold 0.35 (:58); output filename encodes GT/base/aug
detection counts.
"""

from __future__ import annotations

from pathlib import Path
from typing import Callable, Dict, List, Sequence

import numpy as np

from ..data import imageio
from ..data.pipeline import Sample, load_letterboxed
from ..data.visdrone import CLASS_NAMES

CONF_THRESHOLD = 0.35
PANEL_HEIGHT = 480
# BGR-ish distinct colours per class (RGB order here)
CLASS_COLORS = ((255, 56, 56), (56, 168, 255), (72, 219, 112),
                (255, 178, 29), (207, 112, 255), (255, 255, 90))


def pick_dense_images(samples: Sequence[Sample], n: int = 5,
                      pool: int = 50, seed: int = 42) -> List[int]:
    """Top-`pool` by annotation count, seeded sample of n
    (demo_inference.py:69-84)."""
    order = np.argsort([-len(s.classes) for s in samples], kind="stable")
    top = order[:pool]
    rng = np.random.RandomState(seed)
    return sorted(rng.choice(top, size=min(n, len(top)),
                             replace=False).tolist())


def _draw_boxes(img: np.ndarray, boxes: np.ndarray, classes: np.ndarray,
                scores: np.ndarray | None = None) -> np.ndarray:
    import cv2
    out = np.ascontiguousarray(img[:, :, ::-1])       # RGB -> BGR for cv2
    for i, (box, cls) in enumerate(zip(boxes, classes)):
        c = CLASS_COLORS[int(cls) % len(CLASS_COLORS)][::-1]
        x1, y1, x2, y2 = (int(v) for v in box)
        cv2.rectangle(out, (x1, y1), (x2, y2), c, 2)
        label = CLASS_NAMES[int(cls) % len(CLASS_NAMES)]
        if scores is not None:
            label += f" {scores[i]:.2f}"
        cv2.putText(out, label, (x1, max(y1 - 3, 10)),
                    cv2.FONT_HERSHEY_SIMPLEX, 0.4, c, 1, cv2.LINE_AA)
    return out[:, :, ::-1]


def _panel(img: np.ndarray, title: str) -> np.ndarray:
    import cv2
    h, w = img.shape[:2]
    scale = PANEL_HEIGHT / h
    img = imageio.resize_linear_u8(img[:, :, ::-1], int(w * scale),
                                   PANEL_HEIGHT)
    bar = np.full((28, img.shape[1], 3), 32, np.uint8)
    cv2.putText(bar, title, (8, 20), cv2.FONT_HERSHEY_SIMPLEX, 0.6,
                (255, 255, 255), 1, cv2.LINE_AA)
    return np.concatenate([bar, img], axis=0)[:, :, ::-1]


def render_strip(sample: Sample, corrupt_img: np.ndarray,
                 base_dets: Dict, aug_dets: Dict,
                 out_path: Path) -> Path:
    """Compose and write one [Clean+GT | Corrupt+Base | Corrupt+Aug] strip.

    base_dets/aug_dets: {"boxes": (N,4) xyxy px, "classes": (N,),
    "scores": (N,)} already thresholded.
    """
    clean = imageio.read_rgb(sample.image_path)
    p1 = _panel(_draw_boxes(clean, sample.boxes_xyxy, sample.classes),
                f"Clean + GT ({len(sample.classes)})")
    p2 = _panel(_draw_boxes(corrupt_img, base_dets["boxes"],
                            base_dets["classes"], base_dets["scores"]),
                f"Blur + Baseline ({len(base_dets['classes'])})")
    p3 = _panel(_draw_boxes(corrupt_img, aug_dets["boxes"],
                            aug_dets["classes"], aug_dets["scores"]),
                f"Blur + Augmented ({len(aug_dets['classes'])})")
    strip = np.concatenate([p1, p2, p3], axis=1)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    imageio.write_rgb(out_path, strip, quality=92)
    return out_path


def run_demo(samples: Sequence[Sample], predict_base: Callable,
             predict_aug: Callable, state_base, state_aug,
             out_dir: str | Path, img_size: int, model_name: str,
             n_images: int = 5, conf: float = CONF_THRESHOLD) -> List[Path]:
    """Generate demo strips for one (baseline, augmented) model pair.

    predict_*(model, images_u8 (1, S, S, 3)) -> (boxes, scores, classes,
    valid) in canvas coords: the port's predict steps, each run on its
    model's device (state_* are the modules)."""
    import torch
    from ..ops.corrupt import apply_motion_blur

    def blur(img: np.ndarray) -> np.ndarray:
        return apply_motion_blur(torch.from_numpy(img).float()
                                 ).numpy().astype(np.uint8)

    out_dir = Path(out_dir)
    picks = pick_dense_images(samples, n_images)
    paths = []
    for idx in picks:
        sample = samples[idx]
        canvas, scale = load_letterboxed(sample, img_size)
        blurred = blur(canvas)

        def detect(predict, state):
            dev = next(state.parameters()).device
            boxes, scores, classes, valid = (
                t.cpu().numpy() for t in predict(
                    state, torch.from_numpy(blurred[None]).to(dev)))
            keep = valid[0] & (scores[0] >= conf)
            return {"boxes": boxes[0][keep] / scale,
                    "scores": scores[0][keep],
                    "classes": classes[0][keep]}

        base = detect(predict_base, state_base)
        aug = detect(predict_aug, state_aug)
        # full-res blur of the original for display
        disp = blur(imageio.read_rgb(sample.image_path))
        name = (f"{model_name}_{sample.image_path.stem}"
                f"_gt{len(sample.classes)}_base{len(base['classes'])}"
                f"_aug{len(aug['classes'])}.jpg")
        paths.append(render_strip(sample, disp, base, aug, out_dir / name))
    return paths
