"""VisDrone annotation parsing (DET + VID), class filtering, box clamping
(counterpart of robust_object_detection_tpu/data/visdrone.py; image sizes
come from the header through data/imageio.py, so no image library is
needed).

Reference semantics reproduced (with file:line citations so parity can be
audited):

  * DET annotation line: ``x,y,w,h,score,class,truncation,occlusion``
    (convert_visdrone_to_coco.py:42-53).
  * Only classes [1, 4, 5, 6, 9, 10] are kept — pedestrian, car, van, truck,
    bus, motor — remapped to contiguous ids (convert_visdrone_to_coco.py:10-21;
    COCO uses 1..6, YOLO uses 0..5).
  * Rows with score <= 0 are dropped ("ignored regions",
    convert_visdrone_to_coco.py:128-134).
  * Boxes are clamped to the image rectangle and dropped if degenerate after
    clamping (convert_visdrone_to_coco.py:64-77,140-143).
  * VID annotation line: ``frame_index,target_id,x,y,w,h,score,category,
    truncation,occlusion`` (convert_visdrone_vid_to_yolo.py:4-5); track ids
    are deliberately ignored — frames become independent images
    (convert_visdrone_vid_to_yolo.py:90).
  * Empty images/frames are kept (convert_visdrone_to_yolo.py:25-26,
    convert_visdrone_vid_to_yolo.py:53).
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Dict, Iterator, List, Tuple

import numpy as np

from . import imageio

# VisDrone raw category ids kept, in order (reference USED_CLASSES).
USED_CLASSES: Tuple[int, ...] = (1, 4, 5, 6, 9, 10)
CLASS_NAMES: Tuple[str, ...] = ("pedestrian", "car", "van", "truck", "bus",
                                "motor")
NUM_CLASSES = len(USED_CLASSES)

# raw VisDrone id -> contiguous 0-based index
_RAW_TO_INDEX: Dict[int, int] = {c: i for i, c in enumerate(USED_CLASSES)}


@dataclasses.dataclass
class ImageRecord:
    """One image with filtered, clamped annotations.

    boxes are float32 xywh in pixels; classes are 0-based contiguous indices.
    """
    image_path: Path
    width: int
    height: int
    boxes: np.ndarray        # (N, 4) xywh float32
    classes: np.ndarray      # (N,) int32, 0..5
    # audit counters (reference prints kept/removed stats,
    # convert_visdrone_to_coco.py:199-215)
    n_raw: int = 0
    n_removed: int = 0


@dataclasses.dataclass
class ParseStats:
    images: int = 0
    empty_images: int = 0
    boxes_kept: int = 0
    boxes_removed: int = 0

    def update(self, rec: ImageRecord) -> None:
        self.images += 1
        if len(rec.boxes) == 0:
            self.empty_images += 1
        self.boxes_kept += len(rec.boxes)
        self.boxes_removed += rec.n_removed


def clamp_boxes(boxes: np.ndarray, width: int, height: int) -> np.ndarray:
    """Clamp xywh boxes to the image rectangle; returns clamped xywh.

    Mirrors the reference clamp (convert_visdrone_to_coco.py:64-77): x1,y1
    clipped to [0, W/H), x2,y2 clipped to (x1, W/H]; degenerate boxes get
    non-positive w/h and are filtered by the caller.
    """
    if len(boxes) == 0:
        return boxes.reshape(0, 4).astype(np.float32)
    x1 = np.clip(boxes[:, 0], 0, width - 1)
    y1 = np.clip(boxes[:, 1], 0, height - 1)
    x2 = np.clip(boxes[:, 0] + boxes[:, 2], 0, width)
    y2 = np.clip(boxes[:, 1] + boxes[:, 3], 0, height)
    return np.stack([x1, y1, x2 - x1, y2 - y1], axis=1).astype(np.float32)


def parse_det_annotation(txt: str) -> Tuple[np.ndarray, np.ndarray, int, int]:
    """Parse one DET annotation file's text.

    Returns (boxes xywh (N,4) float32, class indices (N,) int32, n_raw,
    n_removed_by_filter). Rows with score<=0 or unused class are removed
    (convert_visdrone_to_coco.py:128-134).
    """
    boxes: List[List[float]] = []
    classes: List[int] = []
    n_raw = 0
    for line in txt.splitlines():
        line = line.strip().rstrip(",")
        if not line:
            continue
        parts = line.split(",")
        if len(parts) < 6:
            continue
        n_raw += 1
        x, y, w, h = (float(parts[0]), float(parts[1]), float(parts[2]),
                      float(parts[3]))
        score = int(float(parts[4]))
        cat = int(float(parts[5]))
        if score <= 0 or cat not in _RAW_TO_INDEX:
            continue
        boxes.append([x, y, w, h])
        classes.append(_RAW_TO_INDEX[cat])
    b = np.asarray(boxes, np.float32).reshape(-1, 4)
    c = np.asarray(classes, np.int32)
    return b, c, n_raw, n_raw - len(b)


def _image_size(path: Path) -> Tuple[int, int]:
    return imageio.image_size(path)  # (W, H)


def iter_det_records(split_dir: str | Path) -> Iterator[ImageRecord]:
    """Iterate images of a VisDrone-DET split directory.

    Layout: ``<split>/images/*.jpg`` + ``<split>/annotations/*.txt``
    (reference paths.py:8-9 expects this structure).
    """
    split_dir = Path(split_dir)
    img_dir = split_dir / "images"
    ann_dir = split_dir / "annotations"
    for img_path in sorted(p for p in img_dir.glob("*.*")
                           if p.suffix.lower() in imageio.IMAGE_EXTS):
        w, h = _image_size(img_path)
        ann_path = ann_dir / (img_path.stem + ".txt")
        if ann_path.exists():
            raw_boxes, classes, n_raw, n_rm = parse_det_annotation(
                ann_path.read_text())
        else:
            raw_boxes = np.zeros((0, 4), np.float32)
            classes = np.zeros((0,), np.int32)
            n_raw = n_rm = 0
        boxes = clamp_boxes(raw_boxes, w, h)
        # Drop boxes degenerate after clamping (convert_visdrone_to_coco.py:140-143).
        ok = (boxes[:, 2] > 0) & (boxes[:, 3] > 0) if len(boxes) else \
            np.zeros(0, bool)
        n_rm += int(len(boxes) - ok.sum()) if len(boxes) else 0
        yield ImageRecord(image_path=img_path, width=w, height=h,
                          boxes=boxes[ok] if len(boxes) else boxes,
                          classes=classes[ok] if len(classes) else classes,
                          n_raw=n_raw, n_removed=n_rm)


def parse_vid_annotation(txt: str) -> Dict[int, Tuple[np.ndarray, np.ndarray]]:
    """Parse one VID sequence annotation file into frame -> (boxes, classes).

    Line format: frame,target_id,x,y,w,h,score,category,trunc,occl
    (convert_visdrone_vid_to_yolo.py:4-5). target_id ignored (:90); same
    score/class filters as DET.
    """
    frames: Dict[int, Tuple[List[List[float]], List[int]]] = {}
    for line in txt.splitlines():
        line = line.strip().rstrip(",")
        if not line:
            continue
        parts = line.split(",")
        if len(parts) < 8:
            continue
        frame = int(float(parts[0]))
        x, y, w, h = (float(parts[2]), float(parts[3]), float(parts[4]),
                      float(parts[5]))
        score = int(float(parts[6]))
        cat = int(float(parts[7]))
        if score <= 0 or cat not in _RAW_TO_INDEX:
            continue
        frames.setdefault(frame, ([], []))
        frames[frame][0].append([x, y, w, h])
        frames[frame][1].append(_RAW_TO_INDEX[cat])
    return {
        f: (np.asarray(b, np.float32).reshape(-1, 4),
            np.asarray(c, np.int32))
        for f, (b, c) in frames.items()
    }


def iter_vid_records(split_dir: str | Path) -> Iterator[ImageRecord]:
    """Iterate frames of a VisDrone-VID split as independent images.

    Layout: ``<split>/sequences/<seq>/{frame:07d}.jpg`` +
    ``<split>/annotations/<seq>.txt`` (convert_visdrone_vid_to_yolo.py:36-50).
    Frames without annotations are kept as empty images (:53,184-187).
    """
    split_dir = Path(split_dir)
    seq_root = split_dir / "sequences"
    ann_dir = split_dir / "annotations"
    for seq_dir in sorted(p for p in seq_root.iterdir() if p.is_dir()):
        ann_path = ann_dir / (seq_dir.name + ".txt")
        frames = (parse_vid_annotation(ann_path.read_text())
                  if ann_path.exists() else {})
        for img_path in sorted(seq_dir.glob("*.jpg")):
            frame_id = int(img_path.stem)
            w, h = _image_size(img_path)
            raw_boxes, classes = frames.get(
                frame_id, (np.zeros((0, 4), np.float32),
                           np.zeros((0,), np.int32)))
            boxes = clamp_boxes(raw_boxes, w, h)
            ok = (boxes[:, 2] > 0) & (boxes[:, 3] > 0) if len(boxes) else \
                np.zeros(0, bool)
            yield ImageRecord(
                image_path=img_path, width=w, height=h,
                boxes=boxes[ok] if len(boxes) else boxes,
                classes=classes[ok] if len(classes) else classes,
                n_raw=len(raw_boxes),
                n_removed=int(len(boxes) - ok.sum()) if len(boxes) else 0)
