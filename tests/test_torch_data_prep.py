"""The port's data preparation (data/visdrone.py, data/convert.py,
data/synthetic.py) against the reference's, on the same files.

  * the synthetic splits (DET in JPEG, PNG and BMP; VID; the smooth and
    textured restoration sets) are the reference's bytes for a seed;
  * the DET and VID records, the COCO JSON, the YOLO labels, data.yaml and
    the VID flattening equal the reference's byte for byte (data.yaml up
    to its absolute root path);
  * ``coco_ground_truth`` gives the reference's arrays;
  * a BMP split prepares without PIL or cv2.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from robust_object_detection_tpu.data import convert as JC
from robust_object_detection_tpu.data import synthetic as JS
from robust_object_detection_tpu.data import visdrone as JV
from robust_object_detection_tpu_torch.data import convert as TC
from robust_object_detection_tpu_torch.data import synthetic as TS
from robust_object_detection_tpu_torch.data import visdrone as TV

ROOT = Path(__file__).resolve().parent.parent


def _files(root: Path):
    return sorted(str(p.relative_to(root)) for p in root.rglob("*")
                  if p.is_file())


def _assert_trees_equal(ours: Path, ref: Path, yaml_root: bool = False):
    names = _files(ref)
    assert names and _files(ours) == names
    for n in names:
        a, b = (ours / n).read_bytes(), (ref / n).read_bytes()
        if yaml_root and n.endswith("data.yaml"):
            b = b.replace(str(ref.resolve()).encode(),
                          str(ours.resolve()).encode())
        assert a == b, n


@pytest.mark.parametrize("ext", ["jpg", "png", "bmp"])
def test_det_split_bytes(ext, tmp_path):
    kw = dict(n_images=4, seed=3, size_range=((30, 70), (41, 90)), ext=ext)
    _assert_trees_equal(TS.make_det_split(tmp_path / "t", **kw),
                        JS.make_det_split(tmp_path / "r", **kw))


def test_vid_and_restoration_sets_bytes(tmp_path):
    _assert_trees_equal(TS.make_vid_split(tmp_path / "tv", seed=2),
                        JS.make_vid_split(tmp_path / "rv", seed=2))
    for ext in ("png", "jpg", "bmp"):
        for fn in ("make_smooth_images", "make_textured_images"):
            kw = dict(n_images=2, hw=(40, 56), seed=1, ext=ext)
            _assert_trees_equal(getattr(TS, fn)(tmp_path / f"t{fn}{ext}",
                                                **kw),
                                getattr(JS, fn)(tmp_path / f"r{fn}{ext}",
                                                **kw))


def _assert_records_equal(ours, ref):
    assert len(ours) == len(ref) > 0
    for o, r in zip(ours, ref):
        assert (o.image_path, o.width, o.height, o.n_raw, o.n_removed) == (
            r.image_path, r.width, r.height, r.n_raw, r.n_removed)
        np.testing.assert_array_equal(o.boxes, r.boxes)
        np.testing.assert_array_equal(o.classes, r.classes)
        assert o.boxes.dtype == r.boxes.dtype
        assert o.classes.dtype == r.classes.dtype


@pytest.mark.parametrize("ext", ["jpg", "bmp"])
def test_det_records_and_converters(ext, tmp_path):
    split = JS.make_det_split(tmp_path / "raw", n_images=5, seed=1,
                              size_range=((40, 64), (48, 80)), ext=ext)
    _assert_records_equal(list(TV.iter_det_records(split)),
                          list(JV.iter_det_records(split)))
    for split_name in ("train", "val"):
        t = TC.convert_det_to_coco(split, tmp_path / "tc", split_name)
        r = JC.convert_det_to_coco(split, tmp_path / "rc", split_name)
        assert vars(t) == vars(r)
        t = TC.convert_det_to_yolo(split, tmp_path / "ty", split_name)
        r = JC.convert_det_to_yolo(split, tmp_path / "ry", split_name)
        assert vars(t) == vars(r)
    _assert_trees_equal(tmp_path / "tc", tmp_path / "rc")
    _assert_trees_equal(tmp_path / "ty", tmp_path / "ry", yaml_root=True)
    ann = tmp_path / "tc" / "annotations" / "instances_val.json"
    (tg, ti), (rg, ri) = TC.coco_ground_truth(ann), JC.coco_ground_truth(ann)
    assert ti == ri and tg.keys() == rg.keys()
    for k in tg:
        for a, b in zip(tg[k], rg[k]):
            np.testing.assert_array_equal(a, b)
            assert a.dtype == b.dtype
    coco, stats = TC.records_to_coco(TV.iter_det_records(split))
    assert (coco, vars(stats)) == (lambda c, s: (c, vars(s)))(
        *JC.records_to_coco(JV.iter_det_records(split)))


def test_vid_records_and_flattening(tmp_path):
    split = JS.make_vid_split(tmp_path / "vid", n_seqs=3, frames_per_seq=4,
                              seed=5)
    _assert_records_equal(list(TV.iter_vid_records(split)),
                          list(JV.iter_vid_records(split)))
    t = TC.convert_vid_to_yolo(split, tmp_path / "t", "train")
    r = JC.convert_vid_to_yolo(split, tmp_path / "r", "train")
    assert vars(t) == vars(r)
    _assert_trees_equal(tmp_path / "t", tmp_path / "r", yaml_root=True)


def test_parsers_and_clamp():
    txt = ("10,20,30,40,1,1,0,0\n5,5,3,3,0,4,0,0\n1,2,3,4,1,7,0,0,\n"
           "bad\n-5,-5,20,20,1,10,0,0\n")
    for a, b in zip(TV.parse_det_annotation(txt),
                    JV.parse_det_annotation(txt)):
        np.testing.assert_array_equal(a, b)
    vid = "1,3,10,20,8,8,1,1,0,0\n2,4,0,0,5,5,1,4,0,0\n2,5,1,1,1,1,0,4,0,0\n"
    t, r = TV.parse_vid_annotation(vid), JV.parse_vid_annotation(vid)
    assert t.keys() == r.keys()
    for k in t:
        for a, b in zip(t[k], r[k]):
            np.testing.assert_array_equal(a, b)
    boxes = np.asarray([[-3, 4, 10, 10], [50, 50, 30, 30], [8, 8, 0, 5]],
                       np.float32)
    np.testing.assert_array_equal(TV.clamp_boxes(boxes, 60, 55),
                                  JV.clamp_boxes(boxes, 60, 55))
    assert TV.USED_CLASSES == JV.USED_CLASSES
    assert TV.CLASS_NAMES == JV.CLASS_NAMES


_NO_LIBS = r"""
import sys
sys.modules["PIL"] = None
sys.modules["cv2"] = None
from pathlib import Path
from robust_object_detection_tpu_torch.data import convert, pipeline, synthetic
root = Path(sys.argv[1])
split = synthetic.make_det_split(root / "raw", n_images=3, ext="bmp",
                                 size_range=((30, 40), (50, 60)))
print(convert.convert_det_to_coco(split, root / "coco", "val"))
print(convert.convert_det_to_yolo(split, root / "yolo", "val"))
s = pipeline.index_yolo(root / "yolo", "val")
canvas, scale = pipeline.load_letterboxed(s[0], 64)
print(len(s), canvas.shape)
"""


def test_bmp_split_prepares_without_pil_or_cv2(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run([sys.executable, "-c", _NO_LIBS, str(tmp_path)],
                         cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.splitlines()[-1] == "3 (64, 64, 3)"
