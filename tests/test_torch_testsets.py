"""The port's frozen-testset builder (data/testsets.py) against the
reference's, on a 3-image synthetic split (PNG, so every pixel reaches the
files exactly; odd image sizes, so LowRes takes the general INTER_AREA):
``build_all`` on both, blur and lowres on the CPU here.

Noise and Clean PNGs byte-equal (the same MT19937 stream, yolo6 then
coco6); Blur and LowRes within 1 LSB, the reference's own bar against
cv2 (both sides round f32 sums taken in another order); the same
manifest keys and image counts, and the same hashes wherever the images
are byte-equal; labels, annotations and data.yaml alike."""

import numpy as np
import pytest
import torch

from robust_object_detection_tpu.data import convert as jconvert
from robust_object_detection_tpu.data import synthetic
from robust_object_detection_tpu.data import testsets as JT
from robust_object_detection_tpu_torch.core.config import CorruptionConfig
from robust_object_detection_tpu_torch.data import testsets as TT

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    root = tmp_path_factory.mktemp("testsets")
    split = synthetic.make_det_split(root / "raw", n_images=3, ext="png")
    proc = root / "processed"
    jconvert.convert_det_to_coco(split, proc / "visdrone_coco6", "val")
    jconvert.convert_det_to_yolo(split, proc / "visdrone_yolo6", "val")
    JT.build_all(proc, root / "jax")
    TT.build_all(proc, root / "port", device="cpu")
    return root


def _read(path):
    from PIL import Image
    return np.asarray(Image.open(path).convert("RGB")).astype(int)


def test_variants_and_manifest_match_reference(built):
    jm = JT.testset_manifest(built / "jax")
    tm = TT.testset_manifest(built / "port")
    assert TT.VARIANTS == JT.VARIANTS
    assert tm.keys() == jm.keys() and len(tm) == 8
    for key in tm:
        assert tm[key]["images"] == jm[key]["images"] == 3
        fmt, variant = key.split("/")
        tdir = built / "port" / fmt / variant / "images" / "val"
        jdir = built / "jax" / fmt / variant / "images" / "val"
        names = sorted(p.name for p in jdir.iterdir())
        assert sorted(p.name for p in tdir.iterdir()) == names
        same = True
        for name in names:
            tb, jb = (tdir / name).read_bytes(), (jdir / name).read_bytes()
            if variant in ("Test_Clean", "Test_Noise"):
                assert tb == jb, (key, name)
            else:
                diff = np.abs(_read(tdir / name) - _read(jdir / name))
                assert diff.max() <= 1, (key, name)
            same &= tb == jb
        assert (tm[key]["sha256_16"] == jm[key]["sha256_16"]) == same, key


def test_noise_is_the_reference_stream(built):
    """Noise differs from Clean, and the coco6 Noise images continue the
    stream after yolo6's (not a second RandomState(42))."""
    t = built / "port"
    for name in ("img0000.png", "img0002.png"):
        clean = _read(t / "yolo6" / "Test_Clean" / "images" / "val" / name)
        y = _read(t / "yolo6" / "Test_Noise" / "images" / "val" / name)
        c = _read(t / "coco6" / "Test_Noise" / "images" / "val" / name)
        assert np.abs(y - clean).mean() > 1.0
        assert not np.array_equal(y, c)


def test_labels_annotations_and_yaml(built):
    for fmt in ("yolo6", "coco6"):
        for variant in TT.VARIANTS:
            tdir = built / "port" / fmt / variant
            jdir = built / "jax" / fmt / variant
            files = sorted(str(p.relative_to(jdir)) for p in jdir.rglob("*")
                           if p.is_file() and "images" not in p.parts)
            assert files == sorted(str(p.relative_to(tdir))
                                   for p in tdir.rglob("*")
                                   if p.is_file() and "images" not in p.parts)
            for f in files:
                tb = (tdir / f).read_text()
                jb = (jdir / f).read_text()
                if f == "data.yaml":
                    jb = jb.replace(str(jdir.resolve()), str(tdir.resolve()))
                    assert "val: images/val" in tb
                assert tb == jb, (fmt, variant, f)


def test_corruptors_on_one_image():
    """make_corruptors alone: Noise equal to the reference's for one
    RandomState(42) draw, Blur / LowRes within 1 LSB at an odd size."""
    img = np.random.RandomState(5).randint(0, 256, (37, 51, 3)).astype(
        np.uint8)
    cfg = CorruptionConfig()
    tf = TT.make_corruptors(cfg, np.random.RandomState(42), device="cpu")
    jf = JT.make_corruptors(JT.CorruptionConfig(), np.random.RandomState(42))
    np.testing.assert_array_equal(tf["Test_Noise"](img), jf["Test_Noise"](img))
    np.testing.assert_array_equal(tf["Test_Clean"](img), img)
    for v in ("Test_Blur", "Test_LowRes"):
        out, ref = tf[v](img), np.asarray(jf[v](img))
        assert out.dtype == np.uint8 and out.shape == img.shape
        assert np.abs(out.astype(int) - ref.astype(int)).max() <= 1, v
