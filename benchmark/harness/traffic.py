"""The one generator of the benchmark's inputs: everything a run feeds the
program is made here from ``--seed`` and the traffic mix's parameters, so
the same seed gives the same inputs, and every traffic file is data.

``detection_pool`` follows ``chip_smoke.detection_batch`` (commit bdbb134:
uniform uint8 images, GT boxes drawn over the canvas, -1 padding) and
``sweep_split`` follows ``chip_smoke.synthetic_samples`` (in-memory images
with GT boxes), each with its sizes taken from the traffic file.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np

TAGS = {"weights": 1, "data": 2, "steps": 3, "sample": 4, "unet": 5,
        "calibrate": 6}


def sub_seed(seed: int, tag: str) -> int:
    """A 63-bit seed for one use of a run's seed (weights, data, the
    step generator, the sample the reference checks)."""
    ss = np.random.SeedSequence([seed % 2 ** 64, TAGS[tag]])
    return int(ss.generate_state(2, np.uint64)[0] >> np.uint64(1))


def gt_boxes(rng: np.random.Generator, n: int, size_hw: Tuple[int, int],
             per_image: Tuple[int, int], box_px: Tuple[float, float],
             num_classes: int, slots: int):
    """(boxes (n, slots, 4) xyxy px, classes (n, slots) with -1 padding):
    per image a count in [per_image[0], per_image[1]], sides uniform in
    box_px, corners uniform over the image."""
    h, w = size_hw
    boxes = np.zeros((n, slots, 4), np.float32)
    classes = np.full((n, slots), -1, np.int64)
    lo, hi = per_image
    for i in range(n):
        m = int(rng.integers(lo, hi + 1))
        wh = rng.random((m, 2)) * (box_px[1] - box_px[0]) + box_px[0]
        xy = rng.random((m, 2)) * (np.array([w, h]) - wh)
        boxes[i, :m] = np.concatenate([xy, xy + wh], 1)
        classes[i, :m] = rng.integers(0, num_classes, m)
    return boxes, classes


def detection_pool(traffic: dict, imgsz: int, num_classes: int, seed: int,
                   device) -> List[tuple]:
    """`traffic["pool"]` distinct train batches (images (B, S, S, 3) uint8,
    boxes (B, slots, 4) f32, classes (B, slots) int64), all on `device`.
    The images are drawn on the device, in one call."""
    import torch

    b, pool = traffic["batch"], traffic["pool"]
    gen = torch.Generator(device).manual_seed(sub_seed(seed, "data"))
    images = torch.randint(0, 256, (pool, b, imgsz, imgsz, 3),
                           generator=gen, device=device, dtype=torch.uint8)
    rng = np.random.default_rng(sub_seed(seed, "data"))
    boxes, classes = gt_boxes(rng, pool * b, (imgsz, imgsz),
                              tuple(traffic["gt_per_image"]),
                              tuple(traffic["box_px"]), num_classes,
                              traffic["gt_slots"])
    boxes = torch.from_numpy(boxes).to(device).view(pool, b, -1, 4)
    classes = torch.from_numpy(classes).to(device).view(pool, b, -1)
    return [(images[i], boxes[i], classes[i]) for i in range(pool)]


@dataclasses.dataclass
class SweepSample:
    """What the sweep reads of a val image: its id, size and GT."""
    image_id: int
    width: int
    height: int
    boxes_xyxy: np.ndarray
    classes: np.ndarray


def sweep_split(traffic: dict, num_classes: int, seed: int
                ) -> Tuple[Dict[int, np.ndarray], List[SweepSample]]:
    """`traffic["images"]` in-memory uint8 images of `traffic["native_hw"]`
    with GT boxes, keyed by image id (from 1)."""
    h, w = traffic["native_hw"]
    n = traffic["images"]
    rng = np.random.default_rng(sub_seed(seed, "data"))
    pixels = rng.integers(0, 256, (n, h, w, 3), dtype=np.uint8)
    boxes, classes = gt_boxes(rng, n, (h, w), tuple(traffic["gt_per_image"]),
                              tuple(traffic["box_px"]), num_classes,
                              traffic["gt_per_image"][1])
    images, samples = {}, []
    for i in range(n):
        keep = classes[i] >= 0
        images[i + 1] = pixels[i]
        samples.append(SweepSample(i + 1, w, h, boxes[i][keep],
                                   classes[i][keep].astype(np.int32)))
    return images, samples
