"""Worker-process input pipeline (counterpart of
robust_object_detection_tpu/data/grain_pipeline.py, which runs on Grain).

The same fixed-shape ``pipeline.Batch`` contract through
``torch.utils.data``: a map-style dataset of letterboxed records, a
sampler over this process's record shard (optionally shuffled for one
epoch), and a ``DataLoader`` with ``num_workers`` worker processes for
parallel decode (0: in the calling process).

  * a record is one ``pipeline.load_letterboxed`` canvas with its boxes
    scaled and padded to ``max_boxes`` (classes -1);
  * batches come in sampler order; a short last batch is padded by
    repeating its last record, with image_id -1 on the padding rows (as the
    reference; ``pipeline.make_batches`` pads with zeros);
  * a shard is the contiguous, equal slice Grain's ``IndexSampler`` gives
    under ``ShardOptions(drop_remainder=True)``; the default is this
    process's shard (``parallel/distributed.shard_options``): all records
    on one process;
  * ``shuffle`` permutes the shard's records with numpy's RandomState from
    `seed`, as ``pipeline.make_batches`` does (Grain's own order is not
    reproduced).

Workers are spawned (the multiprocessing context is named, never the
platform's default fork): the parent may hold a CUDA context, and a worker
decodes through numpy and the port's ctypes codec, returns numpy only and
never touches CUDA. The batches stay numpy (uint8 images).
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np
from torch.utils.data import DataLoader, Dataset

from ..parallel import distributed as dist
from . import pipeline as pipe

MP_CONTEXT = "spawn"


class _SampleSource(Dataset):
    """Map-style dataset over indexed Samples: record i is sample i
    letterboxed, with its ground truth padded to `max_boxes`."""

    def __init__(self, samples: Sequence[pipe.Sample], image_size: int,
                 max_boxes: int):
        self._samples = list(samples)
        self._size = image_size
        self._max_boxes = max_boxes

    def __len__(self) -> int:
        return len(self._samples)

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        s = self._samples[idx]
        canvas, scale = pipe.load_letterboxed(s, self._size)
        m = min(len(s.boxes_xyxy), self._max_boxes)
        boxes = np.zeros((self._max_boxes, 4), np.float32)
        classes = np.full((self._max_boxes,), -1, np.int32)
        if m:
            boxes[:m] = s.boxes_xyxy[:m] * scale
            classes[:m] = s.classes[:m]
        return {"image": canvas, "boxes": boxes, "classes": classes,
                "image_id": np.int64(s.image_id),
                "scale": np.float32(scale)}


def _stack(records: List[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    """collate_fn: stack each field's numpy arrays (no torch tensors)."""
    return {k: np.stack([r[k] for r in records]) for k in records[0]}


def shard_indices(n: int, shard: dist.ShardOptions) -> np.ndarray:
    """The record indices of `shard` among n records, in order: slice
    shard_index of shard_count equal contiguous slices of n // shard_count
    records (Grain's IndexSampler under drop_remainder=True)."""
    if not 0 <= shard.shard_index < shard.shard_count:
        raise ValueError(f"shard {shard.shard_index} of "
                         f"{shard.shard_count}")
    size = n // shard.shard_count
    return np.arange(shard.shard_index * size,
                     (shard.shard_index + 1) * size)


def make_batches_workers(samples: Sequence[pipe.Sample], batch_size: int,
                         image_size: int, max_boxes: int = 600,
                         shuffle: bool = False, seed: int = 0,
                         num_workers: int = 0,
                         shard: Optional[dist.ShardOptions] = None
                         ) -> Iterator[pipe.Batch]:
    """Yield fixed-shape Batches of this process's record shard through a
    ``DataLoader`` with `num_workers` spawned worker processes (0: the
    calling process). A short last batch is padded to `batch_size` by
    repeating its last record, num_valid marking the real rows and
    image_id -1 the padding."""
    order = shard_indices(len(samples), shard or dist.shard_options())
    if shuffle:
        np.random.RandomState(seed).shuffle(order)
    loader = DataLoader(
        _SampleSource(samples, image_size, max_boxes),
        batch_size=batch_size, sampler=order.tolist(), drop_last=False,
        num_workers=num_workers, collate_fn=_stack,
        multiprocessing_context=MP_CONTEXT if num_workers else None)
    for rec in loader:
        n = rec["image"].shape[0]
        if n < batch_size:
            pad = batch_size - n
            rec = {k: np.concatenate(
                [v, np.repeat(v[-1:], pad, axis=0)]) for k, v in rec.items()}
            rec["image_id"][n:] = -1
        yield pipe.Batch(images=rec["image"], boxes=rec["boxes"],
                         classes=rec["classes"], image_ids=rec["image_id"],
                         scales=rec["scale"], num_valid=n)
