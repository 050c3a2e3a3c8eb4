"""Fixed-shape batched data pipeline for eval (counterpart of
robust_object_detection_tpu/data/pipeline.py).

  * host threads decode images and letterbox them to ONE static canvas
    (cv2's bilinear resize, top-left anchored, as ops.image.letterbox),
  * ground truth is padded to a fixed capacity (class -1 marks padding),
    so every batch has identical shapes,
  * a bounded background thread (``prefetch``) overlaps host decode with
    the card's work.

Decode and resize go through data/imageio.py: ``.bmp`` in numpy, JPEG and
PNG through PIL imported at the call, the resize a numpy copy of cv2's
INTER_LINEAR, so a BMP split runs where neither PIL nor cv2 is installed.
Callers may also serve images from memory (``load_image=``).
"""

from __future__ import annotations

import dataclasses
import queue
import threading
from pathlib import Path
from typing import Callable, Iterator, List, Sequence

import numpy as np

from . import imageio
from .convert import load_coco


@dataclasses.dataclass
class Sample:
    """One indexed example (host metadata only; pixels load lazily)."""
    image_path: Path
    image_id: int
    width: int
    height: int
    boxes_xyxy: np.ndarray    # (N, 4) pixels, original image coords
    classes: np.ndarray       # (N,) int32 0-based


@dataclasses.dataclass
class Batch:
    """A fixed-shape batch. All arrays have static leading dim B."""
    images: np.ndarray        # (B, H, W, 3) uint8 letterboxed
    boxes: np.ndarray         # (B, M, 4) float32 xyxy in CANVAS coords
    classes: np.ndarray       # (B, M) int32, -1 = padding
    image_ids: np.ndarray     # (B,) int64, -1 = padded slot
    scales: np.ndarray        # (B,) float32 letterbox scale (canvas = orig*s)
    num_valid: int            # images that are real (rest pad the batch)


def index_coco(root: str | Path, split: str = "val",
               ann_file: str | Path | None = None) -> List[Sample]:
    """Index a COCO-layout dataset directory into Samples:
    root/images/<split>/*.jpg + root/annotations/instances_<split>.json."""
    root = Path(root)
    ann_file = ann_file or root / "annotations" / f"instances_{split}.json"
    idx = load_coco(ann_file)
    img_dir = root / "images" / split
    samples = []
    for img_id in sorted(idx["images"]):
        meta = idx["images"][img_id]
        anns = idx["anns_by_image"][img_id]
        if anns:
            xywh = np.asarray([a["bbox"] for a in anns], np.float32)
            boxes = np.concatenate(
                [xywh[:, :2], xywh[:, :2] + xywh[:, 2:]], axis=1)
            classes = np.asarray(
                [a["category_id"] - 1 for a in anns], np.int32)
        else:
            boxes = np.zeros((0, 4), np.float32)
            classes = np.zeros(0, np.int32)
        samples.append(Sample(
            image_path=img_dir / meta["file_name"], image_id=img_id,
            width=meta["width"], height=meta["height"],
            boxes_xyxy=boxes, classes=classes))
    return samples


def index_yolo(root: str | Path, split: str = "val") -> List[Sample]:
    """Index a YOLO-layout dataset (images/<split> + labels/<split>)."""
    root = Path(root)
    samples = []
    img_paths = sorted(p for p in (root / "images" / split).glob("*.*")
                       if p.suffix.lower() in imageio.IMAGE_EXTS)
    for i, p in enumerate(img_paths):
        w, h = imageio.image_size(p)
        lbl = root / "labels" / split / (p.stem + ".txt")
        boxes, classes = [], []
        if lbl.exists():
            for line in lbl.read_text().splitlines():
                parts = line.split()
                if len(parts) != 5:
                    continue
                c = int(parts[0])
                xc, yc, bw, bh = (float(v) for v in parts[1:])
                boxes.append([(xc - bw / 2) * w, (yc - bh / 2) * h,
                              (xc + bw / 2) * w, (yc + bh / 2) * h])
                classes.append(c)
        samples.append(Sample(
            image_path=p, image_id=i + 1, width=w, height=h,
            boxes_xyxy=np.asarray(boxes, np.float32).reshape(-1, 4),
            classes=np.asarray(classes, np.int32)))
    return samples


def _hw(size) -> tuple[int, int]:
    """int (square) or (H, W) canvas spec -> (H, W)."""
    return (size, size) if isinstance(size, int) else (size[0], size[1])


def load_image_rgb(sample: Sample) -> np.ndarray:
    """Decode one image to native-resolution RGB uint8 (no letterbox)."""
    return imageio.read_rgb(sample.image_path)


def load_letterboxed(sample: Sample, size, pad_value=114,
                     scale: float | None = None,
                     load_image: Callable = load_image_rgb
                     ) -> tuple[np.ndarray, float]:
    """Decode + letterbox one image on the host (cv2's bilinear through
    imageio.resize_linear_u8, top-left anchor).

    size: int (square) or (H, W) canvas. `scale` overrides the
    fit-to-canvas scale (the aspect-bucket eval resizes by torchvision's
    min800/max1333 rule, then pads to the bucket canvas); the scaled image
    is clipped to the canvas if rounding lands 1 px over. pad_value:
    scalar or per-channel RGB tuple. load_image(sample) -> (H, W, 3) uint8
    RGB. Returns (canvas uint8 (H, W, 3) RGB, scale)."""
    img = load_image(sample)
    ch, cw = _hw(size)
    h, w = img.shape[:2]
    if scale is None:
        scale = min(ch / h, cw / w)
    nh, nw = min(round(h * scale), ch), min(round(w * scale), cw)
    if (nh, nw) != (h, w):
        img = imageio.resize_linear_u8(img, nw, nh)
    canvas = np.full((ch, cw, 3), pad_value, np.uint8)
    canvas[:nh, :nw] = img
    return canvas, float(scale)


def make_batches(samples: Sequence[Sample], batch_size: int, image_size,
                 max_boxes: int = 600, shuffle: bool = False,
                 seed: int = 0, drop_remainder: bool = False,
                 num_threads: int = 8, scale_fn=None, pad_value=114,
                 load_image: Callable = load_image_rgb) -> Iterator[Batch]:
    """Yield fixed-shape Batches; decode work fans out over host threads.

    image_size: int (square) or (H, W) canvas. scale_fn(sample) -> float
    overrides the fit-to-canvas scale per sample; pad_value the canvas
    padding; load_image the decoder (see load_letterboxed)."""
    from concurrent.futures import ThreadPoolExecutor

    canvas_h, canvas_w = _hw(image_size)
    order = np.arange(len(samples))
    if shuffle:
        np.random.RandomState(seed).shuffle(order)

    def load_one(sample: Sample):
        canvas, scale = load_letterboxed(
            sample, (canvas_h, canvas_w), pad_value=pad_value,
            scale=scale_fn(sample) if scale_fn else None,
            load_image=load_image)
        m = min(len(sample.boxes_xyxy), max_boxes)
        boxes = np.zeros((max_boxes, 4), np.float32)
        classes = np.full((max_boxes,), -1, np.int32)
        if m:
            boxes[:m] = sample.boxes_xyxy[:m] * scale
            classes[:m] = sample.classes[:m]
        return canvas, boxes, classes, sample.image_id, scale

    with ThreadPoolExecutor(max_workers=num_threads) as pool:
        for start in range(0, len(order), batch_size):
            idxs = order[start:start + batch_size]
            if len(idxs) < batch_size and drop_remainder:
                return
            loaded = list(pool.map(lambda i: load_one(samples[i]), idxs))
            n = len(loaded)
            images = np.zeros((batch_size, canvas_h, canvas_w, 3),
                              np.uint8)
            boxes = np.zeros((batch_size, max_boxes, 4), np.float32)
            classes = np.full((batch_size, max_boxes), -1, np.int32)
            ids = np.full((batch_size,), -1, np.int64)
            scales = np.ones((batch_size,), np.float32)
            for j, (c, b, cl, iid, s) in enumerate(loaded):
                images[j], boxes[j], classes[j], ids[j], scales[j] = \
                    c, b, cl, iid, s
            yield Batch(images=images, boxes=boxes, classes=classes,
                        image_ids=ids, scales=scales, num_valid=n)


def prefetch(it: Iterator, depth: int = 2) -> Iterator:
    """Run `it` in a background thread with a bounded queue (overlaps host
    decode with device compute)."""
    q: queue.Queue = queue.Queue(maxsize=depth)
    sentinel = object()
    err: list = []

    def worker():
        try:
            for item in it:
                q.put(item)
        except BaseException as e:  # propagate into consumer
            err.append(e)
        finally:
            q.put(sentinel)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    while True:
        item = q.get()
        if item is sentinel:
            if err:
                raise err[0]
            return
        yield item
