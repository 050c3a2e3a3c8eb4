"""The port's testset restoration (data/restore.py) against the
reference's: frozen testsets of a 3-image synthetic split (PNG, odd
sizes, so images are reflect-padded to 16 and grouped by padded shape,
one group split across batches of 2), restored by
``restore_testsets`` from a port checkpoint of a narrow U-Net (8, 16, 32,
64) and by the reference's ``restore_images`` with the same variables.
Restored PNGs within 1 LSB (a y * 255 + 0.5 on an integer flips a byte
under another f32 summation order); Clean copied byte for byte; labels,
annotations and data.yaml copied, data.yaml pointing at the restored
root."""

import numpy as np
import pytest
import torch

from robust_object_detection_tpu.data import convert as jconvert
from robust_object_detection_tpu.data import restore as JRS
from robust_object_detection_tpu.data import synthetic
from robust_object_detection_tpu.models import unet as JU
from robust_object_detection_tpu_torch.core.checkpoint import (
    CheckpointManager)
from robust_object_detection_tpu_torch.data import restore as TRS
from robust_object_detection_tpu_torch.data import testsets as TT
from robust_object_detection_tpu_torch.models import convert

from _torch_unet_vars import NARROW, jax_unet, jnp_tree

torch.set_num_threads(1)


def _read(path):
    from PIL import Image
    return np.asarray(Image.open(path).convert("RGB")).astype(int)


@pytest.fixture(scope="module")
def restored(tmp_path_factory):
    root = tmp_path_factory.mktemp("restore")
    split = synthetic.make_det_split(root / "raw", n_images=3, ext="png",
                                     size_range=((40, 41), (50, 52)))
    proc = root / "processed"
    jconvert.convert_det_to_coco(split, proc / "visdrone_coco6", "val")
    jconvert.convert_det_to_yolo(split, proc / "visdrone_yolo6", "val")
    TT.build_all(proc, root / "testsets", device="cpu")
    jmodel, v = jax_unet()
    ckpt = CheckpointManager(root / "unet")
    ckpt.save_best(1, convert.unet_from_jax_variables(v["params"],
                                                      v["batch_stats"]), 1.0)
    counts = TRS.restore_testsets(root / "testsets", root / "unet", NARROW,
                                  batch_size=2, device="cpu")
    return root, jmodel, v, counts


def test_restored_images_match_reference(restored):
    root, jmodel, v, counts = restored
    assert counts == {f"{fmt}/{var}": 3 for fmt in ("coco6", "yolo6")
                      for var in TT.VARIANTS}
    apply = JU.jit_apply_u8(jmodel)
    flips = 0
    for fmt in ("coco6", "yolo6"):
        for variant in TRS.RESTORE_VARIANTS:
            src = root / "testsets" / fmt / variant / "images" / "val"
            paths = TT.list_images(src)
            jout = root / "jax" / fmt / variant
            assert JRS.restore_images(apply, jnp_tree(v), paths, jout,
                                      batch_size=2) == 3
            tout = (root / "testsets" / f"{fmt}_restored" / variant
                    / "images" / "val")
            for p in paths:
                got, ref = _read(tout / p.name), _read(jout / p.name)
                assert got.shape == ref.shape == _read(p).shape
                diff = np.abs(got - ref)
                assert diff.max() <= 1, (fmt, variant, p.name)
                flips += int((diff > 0).sum())
                assert not np.array_equal(got, _read(p))   # restored
    assert flips <= 1e-3 * 3 * 3 * 2 * 40 * 51 * 3


def test_clean_and_metadata_copied(restored):
    root = restored[0]
    for fmt in ("coco6", "yolo6"):
        for variant in TT.VARIANTS:
            src = root / "testsets" / fmt / variant
            dst = root / "testsets" / f"{fmt}_restored" / variant
            for f in src.rglob("*"):
                rel = f.relative_to(src)
                if not f.is_file() or ("images" in rel.parts
                                       and variant != "Test_Clean"):
                    continue
                got = (dst / rel).read_bytes()
                if rel.name == "data.yaml":
                    assert str(dst.resolve()) in got.decode()
                    got = got.replace(str(dst.resolve()).encode(),
                                      str(src.resolve()).encode())
                assert got == f.read_bytes(), (fmt, variant, rel)


def test_restore_needs_a_checkpoint(tmp_path):
    with pytest.raises(FileNotFoundError):
        TRS.restore_testsets(tmp_path, tmp_path / "none", NARROW,
                             device="cpu")
