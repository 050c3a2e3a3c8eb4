"""Candidate sets for the NMS walk's checks (tests/test_torch_nms.py,
tests/test_torch_gpu.py, chip_smoke.py's NMS phase), seeded by numpy and
sorted as ``torch.topk(sorted=True)`` leaves them: by non-increasing
score. Imports neither jax nor the package."""

import numpy as np
import torch


def ulp_pairs(n: int = 4096, seed: int = 0, ratio: float = 0.7):
    """n images of two candidates each: a box with fractional corners
    (score 0.9), then the same box cut to about `ratio` of its width (score
    0.8), so that the f32 IoUs, as the loop rounds them, crowd a few ulps
    around `ratio`, and products and sums round (an FMA would move some by
    an ulp). Returns boxes (n, 2, 4) f32, scores (n, 2) f32 and each image's
    IoU (numpy f32)."""
    rng = np.random.RandomState(seed)
    f = np.float32
    x, y = (rng.rand(2, n) * 100).astype(f)
    w, h = (rng.rand(2, n) * 50 + 20).astype(f)
    cut = ratio + (rng.rand(n) - 0.5) * 4e-6
    a = np.stack([x, y, x + w, y + h], 1).astype(f)
    c = np.stack([x, y, (x + w * cut).astype(f), y + h], 1).astype(f)
    ka = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    ca = (c[:, 2] - c[:, 0]) * (c[:, 3] - c[:, 1])
    iw = np.minimum(a[:, 2], c[:, 2]) - np.maximum(a[:, 0], c[:, 0])
    ih = np.minimum(a[:, 3], c[:, 3]) - np.maximum(a[:, 1], c[:, 1])
    inter = iw * ih
    iou = inter / ((ka + ca) - inter)
    boxes = torch.from_numpy(np.stack([a, c], 1))
    scores = torch.from_numpy(np.repeat(f([[0.9, 0.8]]), n, 0))
    return boxes, scores, iou


def densest_iou(iou) -> float:
    """The IoU value most images share: a threshold there decides the most
    images by a tie (not suppressed) or an ulp."""
    vals, counts = np.unique(iou, return_counts=True)
    return float(vals[np.argmax(counts)])


def crowd(b: int, k: int, n_classes: int, seed: int = 0,
          extent: float = 1024.0, objects: int = 400, jitter: float = 6.0,
          levels: int = 0, dtype=np.float32):
    """b images of k sorted candidates: boxes jittered around `objects`
    objects an image (sizes 16-200 px on an `extent` canvas), so that a
    pick suppresses its neighbours and the walk runs past many candidates;
    classes uniform in [0, n_classes) (int32); scores uniform in (0, 1], or
    on `levels` values when levels > 0 (long runs of exact ties). Returns
    boxes (b, k, 4), scores (b, k), classes (b, k)."""
    rng = np.random.RandomState(seed)
    obj_xy = rng.rand(b, objects, 2) * extent
    obj_wh = rng.rand(b, objects, 2) * 184 + 16
    pick = rng.randint(0, objects, (b, k))
    rows = np.arange(b)[:, None]
    xy = obj_xy[rows, pick] + rng.randn(b, k, 2) * jitter
    wh = obj_wh[rows, pick] * (1 + rng.randn(b, k, 2) * 0.05)
    boxes = np.concatenate([xy - wh / 2, xy + wh / 2], -1).astype(dtype)
    if levels:
        scores = (rng.randint(1, levels + 1, (b, k)) / levels).astype(dtype)
    else:
        scores = (1.0 - rng.rand(b, k)).astype(dtype)
    classes = rng.randint(0, n_classes, (b, k)).astype(np.int32)
    order = np.argsort(-scores, axis=1, kind="stable")
    return (torch.from_numpy(np.take_along_axis(boxes, order[..., None], 1)),
            torch.from_numpy(np.take_along_axis(scores, order, 1)),
            torch.from_numpy(np.take_along_axis(classes, order, 1)))
