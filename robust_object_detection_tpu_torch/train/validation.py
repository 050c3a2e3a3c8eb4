"""Validation during training and best-checkpoint-by-mAP selection
(counterpart of robust_object_detection_tpu/train/validation.py).

The reference's Faster R-CNN trainers run a COCOeval and keep ``best.pth``
by val mAP (train_frcnn_baseline.py:198-208) and log ``mAP50`` /
``mAP50_95`` into history.jsonl (train_frcnn_baseline.py:105-107). Here a
trainer runs the same predict step the eval sweep uses
(eval/detector_eval.py) over the val split every ``val_interval`` epochs;
the summary lands in history.jsonl and ``CheckpointManager.save_best``
keeps the best-mAP50 weights.
"""

from __future__ import annotations

from pathlib import Path
from typing import Callable, Dict, List, Optional

import torch

from ..data import pipeline as pipe
from ..eval import detector_eval
from ..parallel import mesh as mesh_lib


def index_val_samples(data_root: str | Path,
                      layout: str = "coco") -> List[pipe.Sample]:
    """Index the val split of a dataset root; [] when the split is absent
    (synthetic smoke runs often ship train-only roots)."""
    root = Path(data_root)
    try:
        if layout == "coco":
            if not (root / "annotations" / "instances_val.json").exists():
                return []
            return pipe.index_coco(root, "val")
        if not (root / "images" / "val").is_dir():
            return []
        return pipe.index_yolo(root, "val")
    except (FileNotFoundError, NotADirectoryError):
        return []


def run_validation(predict_fn: Callable, state,
                   val_samples: List[pipe.Sample], img_size: int,
                   batch_size: int, ctx: Optional[torch.device] = None,
                   max_boxes: int = 600,
                   load_image: Callable = pipe.load_image_rgb,
                   mesh: Optional[mesh_lib.MeshContext] = None
                   ) -> Dict[str, float]:
    """One val pass -> {"mAP50", "mAP50_95"} via the COCOeval-parity scorer.
    state: what the predict fn runs (a model, or a train state for the
    EMA predict steps of train.detector / train.rtdetr); ctx: the device
    the images go to (None: the model's); load_image: the decoder
    (data.pipeline.make_batches); mesh: the data-parallel mesh the pass
    is sharded over (eval.detector_eval.evaluate_on_samples). The primary
    process's numbers are broadcast, so every rank makes the same
    best-checkpoint decision."""
    summary = detector_eval.evaluate_on_samples(
        predict_fn, state, val_samples, img_size, batch_size, ctx,
        max_boxes=max_boxes, load_image=load_image, mesh=mesh)
    vals = mesh_lib.broadcast_floats(
        mesh, [summary["mAP50"], summary["mAP50_95"]])
    return {"mAP50": round(vals[0], 5), "mAP50_95": round(vals[1], 5)}


def should_validate(epoch: int, epochs: int, val_interval: int,
                    have_val: bool) -> bool:
    """Validate every `val_interval` epochs and always on the final epoch.

    val_interval=0 disables periodic validation but keeps the final pass
    (the reference FRCNN pattern: single COCOeval after the last epoch)."""
    if not have_val:
        return False
    if epoch == epochs:
        return True
    return val_interval > 0 and epoch % val_interval == 0
