"""The indexed-sample record and image decode (the port's own copy of
``Sample`` and ``load_image_rgb`` of
robust_object_detection_tpu/data/pipeline.py). The dataset indexers, the
letterboxing loader and the batcher are not ported yet.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np


@dataclasses.dataclass
class Sample:
    """One indexed example (host metadata only; pixels load lazily)."""
    image_path: Path
    image_id: int
    width: int
    height: int
    boxes_xyxy: np.ndarray    # (N, 4) pixels, original image coords
    classes: np.ndarray       # (N,) int32 0-based


def load_image_rgb(sample: Sample) -> np.ndarray:
    """Decode one image to native-resolution RGB uint8 (no letterbox).
    cv2 / PIL are imported here, at the call: a machine without them can
    still run the sweep over in-memory images (``load_image=``)."""
    import cv2
    img = cv2.imread(str(sample.image_path), cv2.IMREAD_COLOR)
    if img is None:  # fall back to PIL for non-JPEG content
        from PIL import Image
        return np.asarray(Image.open(sample.image_path).convert("RGB"))
    return img[:, :, ::-1]  # BGR -> RGB
