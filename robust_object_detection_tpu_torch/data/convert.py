"""COCO annotation loading (the port's own copy of ``load_coco`` of
robust_object_detection_tpu/data/convert.py, which ``data/pipeline.
index_coco`` reads). The VisDrone -> COCO / YOLO converters are not ported
yet.
"""

from __future__ import annotations

import json
from pathlib import Path


def load_coco(ann_file: str | Path) -> dict:
    """Load a COCO annotation json and index it: returns dict with
    images (id->meta), anns_by_image (id->list), categories."""
    coco = json.loads(Path(ann_file).read_text())
    images = {im["id"]: im for im in coco["images"]}
    anns_by_image = {im_id: [] for im_id in images}
    for ann in coco["annotations"]:
        anns_by_image[ann["image_id"]].append(ann)
    return {"images": images, "anns_by_image": anns_by_image,
            "categories": coco["categories"]}
