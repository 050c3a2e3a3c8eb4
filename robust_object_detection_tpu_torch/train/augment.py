"""Detector training augmentations (counterpart of
robust_object_detection_tpu/train/augment.py): HSV jitter, horizontal flip
and random erasing on the card; mosaic and random affine on the host.

Each on-card random op is a deterministic core fed its draws
(:func:`hsv_jitter` takes the gains, :func:`flip_lr` the flip mask,
:func:`erase` the erasing uniforms) and a wrapper that draws them from a
``torch.Generator`` on the batch's device. The cores compute in the image's
dtype: the train step runs this chain in bf16, as the reference does.

The host half (:func:`mosaic_batches`, :func:`mosaic4`,
:func:`affine_matrix`, :func:`random_affine_host`) draws from an
``np.random.RandomState`` in the reference's call order, so for one seed it
yields the reference's batches: the images byte for byte, the boxes and
classes equal. The affine warp is a numpy copy of PIL's
``Image.transform(AFFINE, BILINEAR)`` (:func:`warp_affine`); neither PIL nor
cv2 is imported, since the card's machine has neither.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch


def rgb_to_hsv(rgb: torch.Tensor) -> torch.Tensor:
    """(..., 3) float [0, 1] RGB -> HSV (h in [0, 1))."""
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    mx = rgb.amax(-1)
    mn = rgb.amin(-1)
    d = mx - mn
    safe = torch.where(d == 0, torch.ones_like(d), d)
    h = torch.where(mx == r, (g - b) / safe % 6.0,
                    torch.where(mx == g, (b - r) / safe + 2.0,
                                (r - g) / safe + 4.0))
    h = torch.where(d == 0, torch.zeros_like(h), h) / 6.0
    s = torch.where(mx == 0, torch.zeros_like(d),
                    d / torch.where(mx == 0, torch.ones_like(mx), mx))
    return torch.stack([h, s, mx], -1)


def hsv_to_rgb(hsv: torch.Tensor) -> torch.Tensor:
    h, s, v = hsv[..., 0] * 6.0, hsv[..., 1], hsv[..., 2]
    i = torch.floor(h)
    f = h - i
    p = v * (1 - s)
    q = v * (1 - s * f)
    t = v * (1 - s * (1 - f))
    i = i.to(torch.int32) % 6

    def select(*vals):
        out = vals[5]
        for k in range(4, -1, -1):
            out = torch.where(i == k, vals[k], out)
        return out
    return torch.stack([select(v, q, p, p, t, v), select(t, v, v, q, p, p),
                        select(p, p, t, v, v, q)], -1)


def hsv_jitter(img: torch.Tensor, dh: torch.Tensor, ds: torch.Tensor,
               dv: torch.Tensor) -> torch.Tensor:
    """img (B, H, W, 3) float [0, 255]; dh additive hue (wraps), ds and dv
    multiplicative saturation and value gains, each (B,) in img's dtype."""
    dh, ds, dv = (g.to(img.dtype).view(-1, 1, 1) for g in (dh, ds, dv))
    hsv = rgb_to_hsv(img / 255.0)
    h = (hsv[..., 0] + dh) % 1.0
    s = torch.clamp(hsv[..., 1] * ds, 0.0, 1.0)
    v = torch.clamp(hsv[..., 2] * dv, 0.0, 1.0)
    return hsv_to_rgb(torch.stack([h, s, v], -1)) * 255.0


def random_hsv(img: torch.Tensor, generator: torch.Generator,
               hgain: float = 0.015, sgain: float = 0.7,
               vgain: float = 0.4, total: Optional[int] = None,
               rows: slice = slice(None)) -> torch.Tensor:
    """Per-image HSV jitter, Ultralytics augment_hsv gains: uniform in
    [-hgain, hgain] (hue, additive) and [1 - g, 1 + g] (saturation, value).
    img may be the `rows` of a global batch of `total` images (a
    data-parallel rank's): the gains are drawn for all `total` and sliced,
    so every rank draws what one process would."""
    b = img.shape[0] if total is None else total
    u = torch.rand(3, b, generator=generator, device=img.device)[:, rows]
    return hsv_jitter(img, (2 * u[0] - 1) * hgain, 1 + (2 * u[1] - 1) * sgain,
                      1 + (2 * u[2] - 1) * vgain)


def flip_lr(img: torch.Tensor, boxes: torch.Tensor, classes: torch.Tensor,
            flip: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Horizontal flip of the images where flip (B,) is true, with their
    xyxy canvas boxes (B, M, 4); padded boxes (class -1) stay as they are."""
    w = img.shape[2]
    f = flip.to(torch.bool).view(-1, 1, 1, 1)
    img = torch.where(f, img.flip(2), img)
    fb = torch.stack([w - boxes[..., 2], boxes[..., 1], w - boxes[..., 0],
                      boxes[..., 3]], -1)
    keep = f[:, :, 0, :] & (classes >= 0)[..., None]
    return img, torch.where(keep, fb, boxes)


def random_flip_lr(img: torch.Tensor, boxes: torch.Tensor,
                   classes: torch.Tensor, generator: torch.Generator,
                   total: Optional[int] = None, rows: slice = slice(None)
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """p = 0.5 horizontal flip of each image and its boxes; `total` and
    `rows` as :func:`random_hsv`'s."""
    b = img.shape[0] if total is None else total
    flip = torch.rand(b, generator=generator, device=img.device)[rows] < 0.5
    return flip_lr(img, boxes, classes, flip)


# ── On-card: random erasing ──────────────────────────────────────────────

def erase(img: torch.Tensor, area: torch.Tensor, log_ratio: torch.Tensor,
          uy: torch.Tensor, ux: torch.Tensor, apply: torch.Tensor,
          fill: float = 114.0) -> torch.Tensor:
    """Fill one rectangle of img (H, W, 3) float with `fill` where `apply`:
    area the rectangle's share of H x W, log_ratio the log of its aspect
    (h / w), uy and ux in [0, 1) its corner's place in the free range;
    f32 scalars, the reference's arithmetic."""
    h, w = img.shape[0], img.shape[1]
    dev = img.device
    area = area.float() * h * w
    ratio = torch.exp(log_ratio.float())
    eh = torch.clamp(torch.sqrt(area * ratio), 1, h)
    ew = torch.clamp(torch.sqrt(area / ratio), 1, w)
    y0 = uy.float() * (h - eh)
    x0 = ux.float() * (w - ew)
    ys = torch.arange(h, dtype=torch.float32, device=dev)[:, None]
    xs = torch.arange(w, dtype=torch.float32, device=dev)[None, :]
    inside = (ys >= y0) & (ys < y0 + eh) & (xs >= x0) & (xs < x0 + ew)
    return torch.where((inside & apply)[..., None],
                       torch.full_like(img, fill), img)


def random_erasing(img: torch.Tensor, generator: torch.Generator,
                   p: float = 0.4, area_range=(0.02, 0.33),
                   ratio_range=(0.3, 3.3), fill: float = 114.0
                   ) -> torch.Tensor:
    """torchvision-style RandomErasing of one (H, W, 3) float image, with
    probability p. Ultralytics carries erasing=0.4 in its args but applies
    it to classification training only, so the detection trainers do not
    enable it, as in the reference."""
    u = torch.rand(5, generator=generator, device=img.device)
    lo, hi = math.log(ratio_range[0]), math.log(ratio_range[1])
    return erase(img, area_range[0] + u[0] * (area_range[1] - area_range[0]),
                 lo + u[1] * (hi - lo), u[2], u[3], u[4] < p, fill)


# ── Host: mosaic composition ─────────────────────────────────────────────

def mosaic_centre(rng: np.random.RandomState, size: int) -> Tuple[int, int]:
    """The (cy, cx) draws of one mosaic, in the reference's order."""
    s = size
    cy = rng.randint(s // 2, 3 * s // 2 + 1)
    cx = rng.randint(s // 2, 3 * s // 2 + 1)
    return cy, cx


def compose_mosaic(loaded: Sequence[tuple], size: int, cy: int, cx: int,
                   max_boxes: int, pad_value: int = 114):
    """4 letterboxed (canvas (s, s, 3) uint8, boxes (M, 4) canvas xyxy,
    classes (M,) with -1 padding) in the quadrants of a 2s canvas, cropped
    back to s around (cy, cx); boxes clipped to the crop, those 2 px or
    less wide or high dropped. Returns the same structure."""
    s = size
    big = np.full((2 * s, 2 * s, 3), pad_value, np.uint8)
    all_boxes, all_classes = [], []
    offs = [(0, 0), (0, s), (s, 0), (s, s)]
    for (canvas, boxes, classes), (oy, ox) in zip(loaded, offs):
        big[oy:oy + s, ox:ox + s] = canvas
        valid = classes >= 0
        bb = boxes[valid].copy()
        if len(bb):
            bb[:, 0::2] += ox
            bb[:, 1::2] += oy
            all_boxes.append(bb)
            all_classes.append(classes[valid])
    y0, x0 = cy - s // 2, cx - s // 2
    crop = big[y0:y0 + s, x0:x0 + s]

    out_boxes = np.zeros((max_boxes, 4), np.float32)
    out_classes = np.full((max_boxes,), -1, np.int32)
    if all_boxes:
        bb = np.concatenate(all_boxes)
        cc = np.concatenate(all_classes)
        bb[:, 0::2] -= x0
        bb[:, 1::2] -= y0
        bb[:, 0::2] = bb[:, 0::2].clip(0, s)
        bb[:, 1::2] = bb[:, 1::2].clip(0, s)
        keep = (bb[:, 2] - bb[:, 0] > 2) & (bb[:, 3] - bb[:, 1] > 2)
        bb, cc = bb[keep], cc[keep]
        m = min(len(bb), max_boxes)
        out_boxes[:m] = bb[:m]
        out_classes[:m] = cc[:m]
    return crop, out_boxes, out_classes


def mosaic4(loaded: Sequence[tuple], size: int, rng: np.random.RandomState,
            max_boxes: int, pad_value: int = 114):
    """One size x size mosaic of 4 letterboxed samples around a centre
    drawn from `rng` (the capability core of Ultralytics' Mosaic)."""
    cy, cx = mosaic_centre(rng, size)
    return compose_mosaic(loaded, size, cy, cx, max_boxes, pad_value)


# ── Host: random affine (Ultralytics RandomPerspective, perspective 0) ───

def affine_matrix(rng: np.random.RandomState, size: int,
                  degrees: float = 0.0, translate: float = 0.1,
                  scale: float = 0.5, shear: float = 0.0):
    """(3x3 output <- input matrix, the sampled scale s): centre, rotate
    and scale, shear, translate (Ultralytics' random_perspective with
    perspective 0; the reference run's degrees 0, translate 0.1, scale 0.5,
    shear 0). Six uniforms from `rng`: angle, scale, shear x, shear y,
    translate x, translate y."""
    c = np.eye(3)
    c[0, 2] = -size / 2
    c[1, 2] = -size / 2
    r = np.eye(3)
    a = np.deg2rad(rng.uniform(-degrees, degrees))
    s = rng.uniform(1 - scale, 1 + scale)
    r[:2, :2] = s * np.asarray([[np.cos(a), -np.sin(a)],
                                [np.sin(a), np.cos(a)]])
    sh = np.eye(3)
    sh[0, 1] = np.tan(np.deg2rad(rng.uniform(-shear, shear)))
    sh[1, 0] = np.tan(np.deg2rad(rng.uniform(-shear, shear)))
    t = np.eye(3)
    t[0, 2] = rng.uniform(0.5 - translate, 0.5 + translate) * size
    t[1, 2] = rng.uniform(0.5 - translate, 0.5 + translate) * size
    return t @ sh @ r @ c, s


def warp_affine(img: np.ndarray, inv: np.ndarray, pad_value: int = 114,
                rows: int = 128) -> np.ndarray:
    """PIL's ``Image.transform(size, AFFINE, inv[:2], BILINEAR,
    fillcolor)`` of a uint8 (H, W, 3) image, in float64 numpy: each output
    pixel centre (x + 0.5, y + 0.5) maps through `inv` (output -> input);
    a point outside [0, W) x [0, H) takes the fill; else, shifted by -0.5,
    the bilinear blend of its four edge-clamped neighbours, along x in
    both rows and then along y, as PIL blends, truncated to uint8. Runs
    `rows` output rows at a time (cache-sized pieces)."""
    h, w = img.shape[:2]
    a = inv[:2].ravel()
    flat = img.reshape(-1, 3)
    out = np.empty_like(img)
    xs = np.arange(w, dtype=np.float64) + 0.5
    for r0 in range(0, h, rows):
        ys = np.arange(r0, min(r0 + rows, h), dtype=np.float64)[:, None] \
            + 0.5
        xin = a[0] * xs + a[1] * ys + a[2]
        yin = a[3] * xs + a[4] * ys + a[5]
        inside = (xin >= 0.0) & (xin < w) & (yin >= 0.0) & (yin < h)
        xin -= 0.5
        yin -= 0.5
        x0 = np.floor(xin)
        y0 = np.floor(yin)
        dx = (xin - x0)[..., None]
        dy = (yin - y0)[..., None]
        x0 = x0.astype(np.intp)
        y0 = y0.astype(np.intp)
        xa, xb = np.clip(x0, 0, w - 1), np.clip(x0 + 1, 0, w - 1)
        ya, yb = np.clip(y0, 0, h - 1) * w, np.clip(y0 + 1, 0, h - 1) * w

        def blend_x(row):
            left = np.take(flat, row + xa, axis=0).astype(np.float64)
            right = np.take(flat, row + xb, axis=0).astype(np.float64)
            return left + (right - left) * dx
        v1, v2 = blend_x(ya), blend_x(yb)
        v = (v1 + (v2 - v1) * dy).astype(np.uint8)
        v[~inside] = pad_value
        out[r0:r0 + rows] = v
    return out


def warp_boxes(boxes: np.ndarray, classes: np.ndarray, m: np.ndarray,
               s: float, size: int, max_boxes: int):
    """Boxes through the affine `m` by their 4 corners, clipped to the
    canvas, then Ultralytics' box_candidates (w, h > 2 px, aspect < 100,
    area over the scale-adjusted original area > 0.1): float32 corners
    times the float64 matrix, cast to float32, as the reference. Returns
    (boxes (max_boxes, 4), classes (max_boxes,)) with -1 padding."""
    new_boxes = np.zeros((max_boxes, 4), np.float32)
    new_classes = np.full((max_boxes,), -1, np.int32)
    valid = classes >= 0
    bb = boxes[valid]
    cc = classes[valid]
    if len(bb):
        corners = np.stack([bb[:, [0, 1]], bb[:, [2, 1]],
                            bb[:, [0, 3]], bb[:, [2, 3]]], 1)   # (N,4,2)
        ones = np.ones((*corners.shape[:2], 1), np.float32)
        warped = np.concatenate([corners, ones], -1) @ m.T[:, :2]
        nb = np.concatenate([warped.min(1), warped.max(1)],
                            -1).astype(np.float32)
        w0 = bb[:, 2] - bb[:, 0]
        h0 = bb[:, 3] - bb[:, 1]
        nb[:, 0::2] = nb[:, 0::2].clip(0, size)
        nb[:, 1::2] = nb[:, 1::2].clip(0, size)
        w1 = nb[:, 2] - nb[:, 0]
        h1 = nb[:, 3] - nb[:, 1]
        ar = np.maximum(w1 / (h1 + 1e-16), h1 / (w1 + 1e-16))
        keep = ((w1 > 2) & (h1 > 2) & (ar < 100) &
                (w1 * h1 / (w0 * h0 * s * s + 1e-16) > 0.1))
        nb, cc = nb[keep], cc[keep]
        k = min(len(nb), max_boxes)
        new_boxes[:k] = nb[:k]
        new_classes[:k] = cc[:k]
    return new_boxes, new_classes


def apply_affine(img: np.ndarray, boxes: np.ndarray, classes: np.ndarray,
                 m: np.ndarray, s: float, max_boxes: Optional[int] = None,
                 pad_value: int = 114):
    """Warp one (img, boxes, classes) sample by the affine `m` (sampled
    scale `s`)."""
    size = img.shape[0]
    out = warp_affine(img, np.linalg.inv(m), pad_value)
    new_boxes, new_classes = warp_boxes(
        boxes, classes, m, s, size,
        len(boxes) if max_boxes is None else max_boxes)
    return out, new_boxes, new_classes


def random_affine_host(img: np.ndarray, boxes: np.ndarray,
                       classes: np.ndarray, rng: np.random.RandomState,
                       degrees: float = 0.0, translate: float = 0.1,
                       scale: float = 0.5, shear: float = 0.0,
                       max_boxes: Optional[int] = None,
                       pad_value: int = 114):
    """Warp one sample by an affine drawn from `rng` (:func:`affine_matrix`).
    Host-side like the reference (cv2.warpAffine inside the Ultralytics
    dataloader): it follows mosaic in the same host stage, and the step on
    the card stays shape-static. Returns (img, boxes, classes) with -1
    padding."""
    m, s = affine_matrix(rng, img.shape[0], degrees, translate, scale, shear)
    return apply_affine(img, boxes, classes, m, s, max_boxes, pad_value)


def mosaic_batches(samples, batch_size: int, image_size: int,
                   max_boxes: int = 600, seed: int = 0,
                   num_threads: int = 8, affine: bool = True,
                   degrees: float = 0.0, translate: float = 0.1,
                   scale: float = 0.5, shear: float = 0.0,
                   load_image: Optional[Callable] = None):
    """Batch iterator where every example is a 4-image mosaic, followed by
    a random affine (Ultralytics' Mosaic then random_perspective; the
    reference run's knobs).

    One epoch = len(samples) mosaics; the 4 sources of each mosaic are the
    epoch-shuffled stream plus 3 uniformly random picks. Draws, in the
    reference's order: the permutation, then per batch the 3 picks of each
    image, then image by image the mosaic centre and the affine's six
    uniforms. The loads, the compositions and the warps then run on a
    thread pool. load_image(sample) -> (H, W, 3) uint8 RGB, as
    ``data.pipeline.make_batches`` takes it. Yields ``data.pipeline.Batch``
    with make_batches' shapes, so a train loop can switch per epoch
    (close_mosaic)."""
    from concurrent.futures import ThreadPoolExecutor

    from ..data import pipeline as pipe

    load_image = load_image or pipe.load_image_rgb
    rng = np.random.RandomState(seed)
    order = rng.permutation(len(samples))

    def load_one(idx: int):
        s = samples[idx]
        canvas, sc = pipe.load_letterboxed(s, image_size,
                                           load_image=load_image)
        m = min(len(s.boxes_xyxy), max_boxes)
        boxes = np.zeros((max_boxes, 4), np.float32)
        classes = np.full((max_boxes,), -1, np.int32)
        if m:
            boxes[:m] = s.boxes_xyxy[:m] * sc
            classes[:m] = s.classes[:m]
        return canvas, boxes, classes

    def build(loaded, centre, mat):
        out = compose_mosaic(loaded, image_size, *centre, max_boxes)
        if mat is not None:
            out = apply_affine(*out, *mat, max_boxes=max_boxes)
        return out

    with ThreadPoolExecutor(max_workers=num_threads) as pool:
        for start in range(0, len(order) - batch_size + 1, batch_size):
            idxs = []
            for j in range(batch_size):
                extra = rng.randint(0, len(samples), 3)
                idxs.extend([order[start + j], *extra.tolist()])
            draws = []
            for _ in range(batch_size):
                centre = mosaic_centre(rng, image_size)
                mat = (affine_matrix(rng, image_size, degrees, translate,
                                     scale, shear) if affine else None)
                draws.append((centre, mat))
            loaded = list(pool.map(load_one, idxs))
            built = list(pool.map(
                lambda j: build(loaded[4 * j:4 * j + 4], *draws[j]),
                range(batch_size)))
            images = np.zeros((batch_size, image_size, image_size, 3),
                              np.uint8)
            boxes = np.zeros((batch_size, max_boxes, 4), np.float32)
            classes = np.full((batch_size, max_boxes), -1, np.int32)
            for j, (im, bb, cc) in enumerate(built):
                images[j], boxes[j], classes[j] = im, bb, cc
            yield pipe.Batch(images=images, boxes=boxes, classes=classes,
                             image_ids=np.full((batch_size,), -1, np.int64),
                             scales=np.ones((batch_size,), np.float32),
                             num_valid=batch_size)
