"""Testset restoration (counterpart of
robust_object_detection_tpu/data/restore.py): the U-Net over the frozen
corrupted testsets, written as ``<root>/{coco6,yolo6}_restored``.

Noise / Blur / LowRes images are restored at full resolution (reflect pad
to a multiple of 16, forward, re-quantise, crop); Clean is copied
unchanged; labels, annotations and ``data.yaml`` are copied, with
``data.yaml``'s paths pointing at the restored root. Images are grouped by
padded shape and run in batches through ``models/unet.apply_u8`` (uint8 to
the card and back); batch k + 1 is decoded and launched before batch k is
fetched and encoded. data/imageio.py reads and writes the files (``.bmp``
in numpy, JPEG and PNG through PIL at the call).
"""

from __future__ import annotations

import shutil
from collections import defaultdict
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core.profiling import StageTimer
from ..models import unet as unet_lib
from . import imageio
from .testsets import VARIANTS, list_images

RESTORE_VARIANTS = ("Test_Noise", "Test_Blur", "Test_LowRes")


def restore_images(model: unet_lib.RestorationUNet, paths: List[Path],
                   out_dir: Path, batch_size: int = 8,
                   num_threads: int = 8,
                   timer: Optional[StageTimer] = None) -> int:
    """Restore `paths` into `out_dir` (same names) with `model` on its own
    device; returns the count. Every batch is full (a trailing chunk is
    padded with zeros and its rows dropped after the fetch)."""
    from concurrent.futures import ThreadPoolExecutor

    timer = timer if timer is not None else StageTimer()
    device = next(model.parameters()).device
    out_dir.mkdir(parents=True, exist_ok=True)
    groups: Dict[Tuple[int, int], List[Path]] = defaultdict(list)
    shapes: Dict[Path, Tuple[int, int]] = {}
    with ThreadPoolExecutor(num_threads) as pool:
        with timer.stage("restore/index_sizes"):
            sizes = list(pool.map(imageio.image_size, paths))
    for p, (w, h) in zip(paths, sizes):
        groups[(h + (-h) % 16, w + (-w) % 16)].append(p)
        shapes[p] = (h, w)

    n = 0
    with ThreadPoolExecutor(num_threads) as pool:

        def drain(inflight) -> None:
            nonlocal n
            chunk, out_dev = inflight
            with timer.stage("restore/fetch"):
                out = out_dev[:len(chunk)].cpu().numpy()
            with timer.stage("restore/encode"):
                writes = [pool.submit(imageio.write_rgb, out_dir / p.name,
                                      out[i, :shapes[p][0], :shapes[p][1]])
                          for i, p in enumerate(chunk)]
                for job in writes:
                    job.result()
            n += len(chunk)

        inflight = None
        for (ph, pw), group in sorted(groups.items()):
            for start in range(0, len(group), batch_size):
                chunk = group[start:start + batch_size]
                with timer.stage("restore/decode_pad"):
                    batch = np.zeros((batch_size, ph, pw, 3), np.uint8)
                    for i, im in enumerate(pool.map(imageio.read_rgb, chunk)):
                        h, w = im.shape[:2]
                        batch[i] = np.pad(
                            im, ((0, ph - h), (0, pw - w), (0, 0)),
                            mode="reflect")
                with timer.stage("restore/dispatch"):
                    out_dev = unet_lib.apply_u8(
                        model, torch.from_numpy(batch).to(device))
                if inflight is not None:
                    drain(inflight)
                inflight = (chunk, out_dev)
        if inflight is not None:
            drain(inflight)
    return n


def restore_testsets(testset_root: str | Path, unet_dir: str | Path,
                     channels=(32, 64, 128, 256), batch_size: int = 8,
                     timer: Optional[StageTimer] = None,
                     device: Optional[torch.device] = None) -> dict:
    """Build ``{coco6,yolo6}_restored`` next to the frozen testsets with
    the best U-Net under `unet_dir` on `device` (None: the CUDA card);
    returns the image count per layout / variant."""
    from ..train.restoration import load_best
    testset_root = Path(testset_root)
    model = load_best(unet_dir, channels, device)

    counts = {}
    for fmt in ("coco6", "yolo6"):
        src_root = testset_root / fmt
        dst_root = testset_root / f"{fmt}_restored"
        if not src_root.exists():
            continue
        for variant in VARIANTS:
            src = src_root / variant
            dst = dst_root / variant
            if not src.exists():
                continue
            # everything but the images: labels, annotations, data.yaml
            for item in src.rglob("*"):
                rel = item.relative_to(src)
                if "images" in rel.parts:
                    continue
                if item.is_dir():
                    (dst / rel).mkdir(parents=True, exist_ok=True)
                else:
                    (dst / rel).parent.mkdir(parents=True, exist_ok=True)
                    shutil.copy2(item, dst / rel)
            y = dst / "data.yaml"
            if y.exists():
                y.write_text(y.read_text().replace(
                    str(src.resolve()), str(dst.resolve())))
            img_src = src / "images" / "val"
            img_dst = dst / "images" / "val"
            paths = list_images(img_src)
            if variant in RESTORE_VARIANTS:
                counts[f"{fmt}/{variant}"] = restore_images(
                    model, paths, img_dst, batch_size, timer=timer)
            else:
                img_dst.mkdir(parents=True, exist_ok=True)
                for p in paths:
                    shutil.copy2(p, img_dst / p.name)
                counts[f"{fmt}/{variant}"] = len(paths)
    return counts
