"""VisDrone -> COCO / YOLO layout conversion (counterpart of
robust_object_detection_tpu/data/convert.py; host only, no image library:
images are copied as they are).

Counterparts of the reference converters:
  * convert_visdrone_to_coco.py  -> :func:`convert_det_to_coco`
  * convert_visdrone_to_yolo.py  -> :func:`convert_det_to_yolo`
  * convert_visdrone_vid_to_yolo.py -> :func:`convert_vid_to_yolo`

On-disk layouts match the reference so its downstream consumers (and our
own pipelines) see the same files:
  * COCO: ``<out>/images/{train,val}/*.jpg`` +
    ``<out>/annotations/instances_{train,val}.json``
    (convert_visdrone_to_coco.py:174-175).
  * YOLO: ``<out>/{images,labels}/{train,val}/...`` + ``data.yaml``
    (convert_visdrone_to_yolo.py:131-149); labels ``cls x_c y_c w h``
    normalised, 6-decimal (:107-119); empty label files kept (:25-26).
"""

from __future__ import annotations

import json
import shutil
from pathlib import Path
from typing import Iterable

import numpy as np

from .visdrone import (CLASS_NAMES, ImageRecord, ParseStats, iter_det_records,
                       iter_vid_records)


def _coco_categories() -> list:
    # category_id 1..6 (convert_visdrone_to_coco.py:14-21).
    return [{"id": i + 1, "name": n, "supercategory": "none"}
            for i, n in enumerate(CLASS_NAMES)]


def records_to_coco(records: Iterable[ImageRecord]) -> tuple[dict, ParseStats]:
    """Build a COCO dict (in-memory) from image records."""
    stats = ParseStats()
    images, annotations = [], []
    ann_id = 1
    for img_id, rec in enumerate(records, start=1):
        stats.update(rec)
        images.append({
            "id": img_id,
            "file_name": rec.image_path.name,
            "width": rec.width,
            "height": rec.height,
        })
        for box, cls in zip(rec.boxes, rec.classes):
            x, y, w, h = (float(box[0]), float(box[1]), float(box[2]),
                          float(box[3]))
            annotations.append({
                "id": ann_id,
                "image_id": img_id,
                "category_id": int(cls) + 1,
                "bbox": [x, y, w, h],
                "area": w * h,
                "iscrowd": 0,
            })
            ann_id += 1
    return ({"images": images, "annotations": annotations,
             "categories": _coco_categories()}, stats)


def convert_det_to_coco(split_dir: str | Path, out_root: str | Path,
                        split: str, copy_images: bool = True) -> ParseStats:
    """VisDrone-DET split -> COCO layout under ``out_root``."""
    out_root = Path(out_root)
    img_out = out_root / "images" / split
    ann_out = out_root / "annotations"
    img_out.mkdir(parents=True, exist_ok=True)
    ann_out.mkdir(parents=True, exist_ok=True)

    records = []
    for rec in iter_det_records(split_dir):
        if copy_images:
            dst = img_out / rec.image_path.name
            if not dst.exists():
                shutil.copy2(rec.image_path, dst)
            rec = ImageRecord(dst, rec.width, rec.height, rec.boxes,
                              rec.classes, rec.n_raw, rec.n_removed)
        records.append(rec)
    coco, stats = records_to_coco(records)
    (ann_out / f"instances_{split}.json").write_text(json.dumps(coco))
    return stats


def _write_yolo_labels(rec: ImageRecord, label_path: Path) -> None:
    """YOLO normalised label lines, 6-decimal (convert_visdrone_to_yolo.py:107-119).
    Empty files are written for empty images (:131-134)."""
    lines = []
    for box, cls in zip(rec.boxes, rec.classes):
        xc = (box[0] + box[2] / 2) / rec.width
        yc = (box[1] + box[3] / 2) / rec.height
        w = box[2] / rec.width
        h = box[3] / rec.height
        lines.append(f"{int(cls)} {xc:.6f} {yc:.6f} {w:.6f} {h:.6f}")
    label_path.write_text("\n".join(lines) + ("\n" if lines else ""))


def write_data_yaml(out_root: Path, train_rel: str = "images/train",
                    val_rel: str = "images/val") -> None:
    """Emit data.yaml (convert_visdrone_to_yolo.py:138-149)."""
    names = "\n".join(f"  {i}: {n}" for i, n in enumerate(CLASS_NAMES))
    out_root.joinpath("data.yaml").write_text(
        f"path: {out_root.resolve()}\n"
        f"train: {train_rel}\n"
        f"val: {val_rel}\n"
        f"nc: {len(CLASS_NAMES)}\n"
        f"names:\n{names}\n")


def convert_det_to_yolo(split_dir: str | Path, out_root: str | Path,
                        split: str, copy_images: bool = True) -> ParseStats:
    """VisDrone-DET split -> YOLO layout under ``out_root``."""
    out_root = Path(out_root)
    img_out = out_root / "images" / split
    lbl_out = out_root / "labels" / split
    img_out.mkdir(parents=True, exist_ok=True)
    lbl_out.mkdir(parents=True, exist_ok=True)

    stats = ParseStats()
    for rec in iter_det_records(split_dir):
        stats.update(rec)
        if copy_images:
            dst = img_out / rec.image_path.name
            if not dst.exists():
                shutil.copy2(rec.image_path, dst)
        _write_yolo_labels(rec, lbl_out / (rec.image_path.stem + ".txt"))
    write_data_yaml(out_root)
    return stats


def convert_vid_to_yolo(split_dir: str | Path, out_root: str | Path,
                        split: str) -> ParseStats:
    """VisDrone-VID split -> YOLO layout; frames flattened to independent
    images named ``{seq}_{frame:07d}.jpg`` (convert_visdrone_vid_to_yolo.py:149-152)."""
    out_root = Path(out_root)
    img_out = out_root / "images" / split
    lbl_out = out_root / "labels" / split
    img_out.mkdir(parents=True, exist_ok=True)
    lbl_out.mkdir(parents=True, exist_ok=True)

    stats = ParseStats()
    for rec in iter_vid_records(split_dir):
        stats.update(rec)
        seq = rec.image_path.parent.name
        frame_id = int(rec.image_path.stem)
        stem = f"{seq}_{frame_id:07d}"
        dst = img_out / (stem + ".jpg")
        if not dst.exists():
            shutil.copy2(rec.image_path, dst)
        _write_yolo_labels(rec, lbl_out / (stem + ".txt"))
    write_data_yaml(out_root)
    return stats


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


def coco_ground_truth(ann_file: str | Path):
    """COCO json -> {image_id: (boxes xywh, category_ids, iscrowd, areas)}
    as numpy arrays, for the mAP scorer."""
    idx = load_coco(ann_file)
    out = {}
    for img_id, anns in idx["anns_by_image"].items():
        if anns:
            boxes = np.asarray([a["bbox"] for a in anns], np.float32)
            cats = np.asarray([a["category_id"] for a in anns], np.int32)
            crowd = np.asarray([a.get("iscrowd", 0) for a in anns], bool)
            areas = np.asarray([a.get("area", a["bbox"][2] * a["bbox"][3])
                                for a in anns], np.float32)
        else:
            boxes = np.zeros((0, 4), np.float32)
            cats = np.zeros(0, np.int32)
            crowd = np.zeros(0, bool)
            areas = np.zeros(0, np.float32)
        out[img_id] = (boxes, cats, crowd, areas)
    return out, idx["images"]
