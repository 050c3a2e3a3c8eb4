"""Frozen corrupted testset builder (counterpart of
robust_object_detection_tpu/data/testsets.py).

Builds the four frozen val testsets Test_Clean / Test_Noise / Test_Blur /
Test_LowRes in the YOLO and COCO layouts under ``<root>/{yolo6,coco6}``,
as the reference does:

  * ONE numpy MT19937 ``RandomState(42)`` per build, threaded yolo6 then
    coco6 (``build_all``); only Noise draws, ``normal(0, sigma,
    img.shape)`` per image in sorted file order, channel-reversed before
    the add (the draw lands on a BGR layout), then f32 add, clip, uint8
    truncation, on the host. Noise images are bit-equal to the
    reference's.
  * Blur and LowRes run on the card unless a device is named, uint8 in and
    uint8 out, through the port's ops (``ops/corrupt.apply_motion_blur``
    in true f32, ``ops/image.resize_area`` + ``resize_bilinear`` with the
    LowRes size ``int(h * f), int(w * f)``), within 1 LSB of cv2, the
    reference's own bar.
  * Labels and annotations are copied unchanged; every YOLO variant gets a
    ``data.yaml`` pointing val at ``images/val``.

Images are read and written through data/imageio.py (``.bmp`` in numpy,
JPEG and PNG through PIL at the call): ``.jpg`` is re-encoded at quality
95, lossless formats round-trip exactly.
"""

from __future__ import annotations

import shutil
from pathlib import Path
from typing import Callable, Dict, Optional

import numpy as np
import torch

from ..core.config import CorruptionConfig
from ..core.profiling import StageTimer
from ..models.layers import resolve_device
from ..ops import corrupt as corrupt_ops
from ..ops import image as image_ops
from . import imageio

VARIANTS = ("Test_Clean", "Test_Noise", "Test_Blur", "Test_LowRes")
SEED = 42


def blur_u8(img: torch.Tensor, cfg: CorruptionConfig) -> torch.Tensor:
    """uint8 HWC -> motion-blurred uint8 HWC (round half to even)."""
    y = corrupt_ops.apply_motion_blur(img.float(), cfg.blur_kernel,
                                      cfg.blur_angle_deg)
    return torch.floor(torch.clamp(y, 0, 255)).to(torch.uint8)


def lowres_u8(img: torch.Tensor, factor: float) -> torch.Tensor:
    """uint8 HWC -> INTER_AREA down to (int(h f), int(w f)), INTER_LINEAR
    back up, each rounded half up -> uint8 HWC."""
    h, w = img.shape[0], img.shape[1]
    small = image_ops.resize_area(img.float(), int(h * factor),
                                  int(w * factor))
    small = image_ops.quantize_round_half_up(small)
    up = image_ops.quantize_round_half_up(
        image_ops.resize_bilinear(small, h, w))
    return torch.floor(torch.clamp(up, 0, 255)).to(torch.uint8)


def make_corruptors(cfg: CorruptionConfig, rng: np.random.RandomState,
                    timer: Optional[StageTimer] = None,
                    device: Optional[torch.device] = None,
                    ) -> Dict[str, Callable[[np.ndarray], np.ndarray]]:
    """Variant name -> (uint8 HWC -> uint8 HWC) corruption fn. Blur and
    lowres run on `device` (None: the CUDA card); the timer's stages split
    their upload + launch ("build/dispatch") from the fetch
    ("build/fetch")."""
    timer = timer if timer is not None else StageTimer()
    device = resolve_device(device)

    def clean(img: np.ndarray) -> np.ndarray:
        return img

    def noise(img: np.ndarray) -> np.ndarray:
        with timer.stage("build/host_noise"):
            n = rng.normal(0.0, cfg.noise_sigma, img.shape).astype(np.float32)
            x = img.astype(np.float32) + n[..., ::-1]
            return np.clip(x, 0, 255).astype(np.uint8)

    def on_device(fn):
        def run(img: np.ndarray) -> np.ndarray:
            with timer.stage("build/dispatch"):
                r = fn(torch.from_numpy(img.copy()).to(device))
            with timer.stage("build/fetch"):
                return r.cpu().numpy()
        return run

    return {"Test_Clean": clean, "Test_Noise": noise,
            "Test_Blur": on_device(lambda x: blur_u8(x, cfg)),
            "Test_LowRes": on_device(
                lambda x: lowres_u8(x, cfg.downscale_factor))}


def list_images(img_dir: Path) -> list[Path]:
    """Image files of a directory in sorted name order."""
    return sorted(p for p in img_dir.glob("*.*")
                  if p.suffix.lower() in imageio.IMAGE_EXTS)


def _corrupt_dir(src_imgs: list[Path], fn, img_out: Path,
                 num_threads: int = 8, lookahead: int = 8) -> None:
    """read -> corrupt -> write for one variant directory. Corruption runs
    in file order (the noise stream's draw order is part of the frozen
    testset); decode is prefetched `lookahead` deep and encode runs on the
    pool, overlapping the corruption."""
    from collections import deque
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(num_threads) as pool:
        reads: deque = deque()
        writes: deque = deque()
        idx = 0
        for p in src_imgs:
            while idx < len(src_imgs) and len(reads) < lookahead:
                reads.append(pool.submit(imageio.read_rgb, src_imgs[idx]))
                idx += 1
            img = reads.popleft().result()
            writes.append(pool.submit(imageio.write_rgb, img_out / p.name,
                                      fn(img)))
            while len(writes) > 4 * num_threads:    # bound buffered arrays
                writes.popleft().result()
        for w in writes:
            w.result()


def _variant_data_yaml(variant_dir: Path) -> None:
    from .visdrone import CLASS_NAMES
    names = "\n".join(f"  {i}: {n}" for i, n in enumerate(CLASS_NAMES))
    variant_dir.joinpath("data.yaml").write_text(
        f"path: {variant_dir.resolve()}\n"
        f"train: images/val\n"
        f"val: images/val\n"
        f"nc: {len(CLASS_NAMES)}\n"
        f"names:\n{names}\n")


def build_yolo_testsets(yolo_root: str | Path, out_root: str | Path,
                        cfg: CorruptionConfig = CorruptionConfig(),
                        seed: int = SEED,
                        rng: Optional[np.random.RandomState] = None,
                        device: Optional[torch.device] = None) -> None:
    """YOLO-layout frozen testsets. `rng` is the shared MT19937 stream
    (fresh from `seed` when the builder runs alone)."""
    yolo_root, out_root = Path(yolo_root), Path(out_root)
    src_imgs = list_images(yolo_root / "images" / "val")
    src_lbl = yolo_root / "labels" / "val"
    rng = np.random.RandomState(seed) if rng is None else rng
    fns = make_corruptors(cfg, rng, device=device)
    for variant in VARIANTS:
        vdir = out_root / "yolo6" / variant
        img_out = vdir / "images" / "val"
        lbl_out = vdir / "labels" / "val"
        img_out.mkdir(parents=True, exist_ok=True)
        lbl_out.mkdir(parents=True, exist_ok=True)
        _corrupt_dir(src_imgs, fns[variant], img_out)
        for p in src_imgs:
            lbl = src_lbl / (p.stem + ".txt")
            if lbl.exists():
                shutil.copy2(lbl, lbl_out / lbl.name)
        _variant_data_yaml(vdir)


def build_coco_testsets(coco_root: str | Path, out_root: str | Path,
                        cfg: CorruptionConfig = CorruptionConfig(),
                        seed: int = SEED,
                        rng: Optional[np.random.RandomState] = None,
                        timer: Optional[StageTimer] = None,
                        device: Optional[torch.device] = None) -> None:
    """COCO-layout frozen testsets."""
    coco_root, out_root = Path(coco_root), Path(out_root)
    src_imgs = list_images(coco_root / "images" / "val")
    ann = coco_root / "annotations" / "instances_val.json"
    rng = np.random.RandomState(seed) if rng is None else rng
    fns = make_corruptors(cfg, rng, timer=timer, device=device)
    for variant in VARIANTS:
        vdir = out_root / "coco6" / variant
        img_out = vdir / "images" / "val"
        ann_out = vdir / "annotations"
        img_out.mkdir(parents=True, exist_ok=True)
        ann_out.mkdir(parents=True, exist_ok=True)
        _corrupt_dir(src_imgs, fns[variant], img_out)
        if ann.exists():
            shutil.copy2(ann, ann_out / "instances_val.json")


def build_all(processed_root: str | Path, testset_root: str | Path,
              cfg: CorruptionConfig = CorruptionConfig(),
              seed: int = SEED,
              device: Optional[torch.device] = None) -> None:
    """Both layouts from ``<processed_root>/visdrone_{yolo6,coco6}``, one
    RandomState threaded yolo6 -> coco6."""
    processed_root = Path(processed_root)
    rng = np.random.RandomState(seed)
    build_yolo_testsets(processed_root / "visdrone_yolo6", testset_root, cfg,
                        seed, rng=rng, device=device)
    build_coco_testsets(processed_root / "visdrone_coco6", testset_root, cfg,
                        seed, rng=rng, device=device)


def testset_manifest(testset_root: str | Path) -> dict:
    """Audit summary: per layout / variant, image count + the first 16 hex
    digits of the SHA-256 of the images' bytes in name order."""
    import hashlib
    out = {}
    root = Path(testset_root)
    for fmt in ("yolo6", "coco6"):
        for variant in VARIANTS:
            img_dir = root / fmt / variant / "images" / "val"
            if not img_dir.exists():
                continue
            files = list_images(img_dir)
            h = hashlib.sha256()
            for f in files:
                h.update(f.read_bytes())
            out[f"{fmt}/{variant}"] = {
                "images": len(files), "sha256_16": h.hexdigest()[:16]}
    return out
