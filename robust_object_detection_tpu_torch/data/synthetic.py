"""Synthetic mini-VisDrone generator for tests (counterpart of
robust_object_detection_tpu/data/synthetic.py: the same seed gives the same
files, byte for byte). Images are written through data/imageio.py, whose
JPEG, PNG and BMP writers give Pillow's bytes and need no image library.

The reference has no test suite (SURVEY.md §4); our converter/pipeline tests
run against a generated miniature dataset with the exact VisDrone on-disk
conventions (DET: images/ + annotations/ txt with
``x,y,w,h,score,class,trunc,occl`` rows; VID: sequences/<seq>/<frame>.jpg +
annotations/<seq>.txt).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from . import imageio
from .visdrone import USED_CLASSES


def make_det_split(root: str | Path, n_images: int = 6, seed: int = 0,
                   size_range=((64, 128), (64, 128)),
                   ext: str = "jpg") -> Path:
    """Create a VisDrone-DET-style split with random images + annotations.

    Includes the edge cases the reference handles: ignored rows (score 0),
    unused classes, out-of-bounds boxes needing clamping, and one empty image.
    ext="png" gives a lossless source (the fused-sweep MT19937 bit-parity
    tests need pixel-exact round trips through the testset builder).
    """
    root = Path(root)
    (root / "images").mkdir(parents=True, exist_ok=True)
    (root / "annotations").mkdir(parents=True, exist_ok=True)
    rng = np.random.RandomState(seed)
    for i in range(n_images):
        h = int(rng.randint(*size_range[0]))
        w = int(rng.randint(*size_range[1]))
        img = rng.randint(0, 255, (h, w, 3), dtype=np.uint8)
        name = f"img{i:04d}"
        imageio.write_rgb(root / "images" / f"{name}.{ext}", img,
                          quality=95)
        lines = []
        if i != n_images - 1:  # last image left empty
            for _ in range(int(rng.randint(1, 6))):
                x = int(rng.randint(0, w - 8))
                y = int(rng.randint(0, h - 8))
                bw = int(rng.randint(4, max(5, w - x)))
                bh = int(rng.randint(4, max(5, h - y)))
                cat = int(rng.choice(USED_CLASSES))
                lines.append(f"{x},{y},{bw},{bh},1,{cat},0,0")
            # an ignored region (score 0) and an unused class (7)
            lines.append(f"0,0,10,10,0,1,0,0")
            lines.append(f"5,5,10,10,1,7,0,0")
            # an out-of-bounds box that must be clamped
            lines.append(f"{w - 4},{h - 4},20,20,1,4,0,0")
        (root / "annotations" / f"{name}.txt").write_text(
            "\n".join(lines) + "\n")
    return root


def make_vid_split(root: str | Path, n_seqs: int = 2, frames_per_seq: int = 3,
                   seed: int = 0, hw=(64, 96)) -> Path:
    """Create a VisDrone-VID-style split (sequences of frames + per-seq txt)."""
    root = Path(root)
    (root / "annotations").mkdir(parents=True, exist_ok=True)
    rng = np.random.RandomState(seed)
    h, w = hw
    for s in range(n_seqs):
        seq = f"uav{s:04d}"
        seq_dir = root / "sequences" / seq
        seq_dir.mkdir(parents=True, exist_ok=True)
        lines = []
        for f in range(1, frames_per_seq + 1):
            img = rng.randint(0, 255, (h, w, 3), dtype=np.uint8)
            imageio.write_rgb(seq_dir / f"{f:07d}.jpg", img, quality=95)
            for tid in range(int(rng.randint(0, 3))):
                x = int(rng.randint(0, w - 10))
                y = int(rng.randint(0, h - 10))
                cat = int(rng.choice(USED_CLASSES))
                lines.append(f"{f},{tid},{x},{y},8,8,1,{cat},0,0")
        (root / "annotations" / f"{seq}.txt").write_text(
            "\n".join(lines) + "\n")
    return root


def make_smooth_images(root: str | Path, n_images: int = 8, hw=(96, 96),
                       seed: int = 0, ext: str = "png") -> Path:
    """Natural-image stand-ins for restoration training: smooth gradients
    plus soft discs. Random-pixel images carry no learnable structure (a
    denoiser cannot beat the noise floor on white noise); these have the
    low-frequency content the U-Net's learning-signal tests need
    (reference trains on VisDrone frames — train_restoration.py:60-76)."""
    root = Path(root)
    root.mkdir(parents=True, exist_ok=True)
    rng = np.random.RandomState(seed)
    h, w = hw
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    for i in range(n_images):
        img = np.zeros((h, w, 3), np.float32)
        for c in range(3):
            gx, gy = rng.uniform(-1, 1, 2)
            img[..., c] = 128 + gx * (xx - w / 2) * 128 / w \
                + gy * (yy - h / 2) * 128 / h
        for _ in range(int(rng.randint(2, 5))):   # soft discs
            cy, cx = rng.uniform(0, h), rng.uniform(0, w)
            r = rng.uniform(h / 8, h / 3)
            mask = np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * r * r))
            img += mask[..., None] * rng.uniform(-80, 80, 3)
        arr = np.clip(img, 0, 255).astype(np.uint8)
        imageio.write_rgb(root / f"im{i:04d}.{ext}", arr, quality=None)
    return root


def make_textured_images(root: str | Path, n_images: int = 8, hw=(96, 96),
                         seed: int = 0, ext: str = "png") -> Path:
    """Textured stand-ins with real high-frequency content.

    make_smooth_images is right for the noise learning-signal tests but
    DEGENERATE for blur/lowres: a smooth gradient is almost
    blur-invariant (corrupted input sits at 55-67 dB PSNR), so
    restoration "gain" is meaningless there. These add hard-edged
    rectangles, oriented sinusoidal gratings, and fine checker patches
    on the smooth base, pulling blurred/downscaled input PSNR into the
    realistic 25-35 dB band the per-corruption evaluation needs (the
    reference's VisDrone frames are texture-rich street scenes)."""
    root = Path(root)
    root.mkdir(parents=True, exist_ok=True)
    rng = np.random.RandomState(seed)
    h, w = hw
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    for i in range(n_images):
        img = np.zeros((h, w, 3), np.float32)
        for c in range(3):
            gx, gy = rng.uniform(-1, 1, 2)
            img[..., c] = 128 + gx * (xx - w / 2) * 96 / w \
                + gy * (yy - h / 2) * 96 / h
        for _ in range(int(rng.randint(4, 9))):   # hard-edged rectangles
            y0, x0 = rng.randint(0, h - 8), rng.randint(0, w - 8)
            hh = rng.randint(h // 16, h // 3)
            ww = rng.randint(w // 16, w // 3)
            img[y0:y0 + hh, x0:x0 + ww] += rng.uniform(-90, 90, 3)
        for _ in range(int(rng.randint(2, 4))):   # oriented gratings
            fx, fy = rng.uniform(-0.35, 0.35, 2)  # cycles/px (mid-high)
            phase = rng.uniform(0, 2 * np.pi)
            amp = rng.uniform(12, 36)
            wave = np.sin(2 * np.pi * (fx * xx + fy * yy) + phase)
            img += (wave * amp)[..., None] * rng.uniform(0.3, 1.0, 3)
        # one fine checker patch (the hardest lowres content)
        y0, x0 = rng.randint(0, h // 2), rng.randint(0, w // 2)
        hh = ww = min(h, w) // 4
        per = int(rng.randint(2, 5))
        checker = (((yy[:hh, :ww] // per) + (xx[:hh, :ww] // per)) % 2)
        img[y0:y0 + hh, x0:x0 + ww] += \
            (checker * rng.uniform(30, 60))[..., None]
        arr = np.clip(img, 0, 255).astype(np.uint8)
        imageio.write_rgb(root / f"im{i:04d}.{ext}", arr, quality=None)
    return root
