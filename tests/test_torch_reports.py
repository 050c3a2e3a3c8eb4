"""The port's reports (report/plots.py, report/demo.py) and scorer fixtures
(eval/parity_fixtures.py) against the reference's.

  * the figure suites (``plot``, ``plot-three``, ``plot-vid``) write the
    reference's file names;
  * ``render_strip`` writes the reference's strip (the same JPEG bytes:
    the panel resize is imageio's copy of cv2's INTER_LINEAR), and
    ``pick_dense_images`` picks the same images;
  * ``run_demo`` over the port's predict steps writes a strip per pick,
    named as the reference names them;
  * the canned evaluation case, its COCO dicts and ``our_stats`` equal the
    reference's; the pycocotools leg skips where pycocotools is missing.
"""

import numpy as np
import pytest
import torch

from robust_object_detection_tpu.data import convert as jconvert
from robust_object_detection_tpu.data import pipeline as jpipe
from robust_object_detection_tpu.data import synthetic
from robust_object_detection_tpu.eval import parity_fixtures as JP
from robust_object_detection_tpu.report import demo as JD
from robust_object_detection_tpu.report import plots as JPL
from robust_object_detection_tpu_torch.data import pipeline as tpipe
from robust_object_detection_tpu_torch.eval import parity_fixtures as TP
from robust_object_detection_tpu_torch.models import yolov8 as TY
from robust_object_detection_tpu_torch.report import demo as TD
from robust_object_detection_tpu_torch.report import plots as TPL
from robust_object_detection_tpu_torch.train import detector as TDET

torch.set_num_threads(1)

VARIANTS = ("Test_Clean", "Test_Noise", "Test_Blur", "Test_LowRes")


def _results(seed, names):
    rng = np.random.RandomState(seed)
    return {m: {v: {"mAP50": float(rng.uniform(0.1, 0.6)),
                    "mAP50_95": float(rng.uniform(0.05, 0.3)),
                    "per_class_ap50": {c: float(rng.uniform(0, 0.7))
                                       for c in ("pedestrian", "car")}}
                for v in VARIANTS} for m in names}


def _names(paths, root):
    return [str(p.relative_to(root)) for p in paths]


@pytest.mark.parametrize("prefix", ["", "vid_"])
def test_det_suite_file_names(prefix, tmp_path):
    res = _results(0, ("yolo_baseline", "yolo_augmented", "frcnn_baseline"))
    t = TPL.det_figure_suite(res, tmp_path / "t", prefix=prefix)
    r = JPL.det_figure_suite(res, tmp_path / "r", prefix=prefix)
    assert _names(t, tmp_path / "t") == _names(r, tmp_path / "r")
    assert all(p.exists() and p.stat().st_size > 0 for p in t)


def test_three_strategy_suite_and_curve_file_names(tmp_path):
    res = _results(1, ("yolo_baseline", "yolo_augmented", "rtdetr_baseline",
                       "rtdetr_augmented"))
    restored = _results(2, ("yolo_baseline", "rtdetr_baseline"))
    t = TPL.three_strategy_suite(res, restored, tmp_path / "t")
    r = JPL.three_strategy_suite(res, restored, tmp_path / "r")
    assert _names(t, tmp_path / "t") == _names(r, tmp_path / "r")
    hist = [{"epoch": i, "train_loss": 1.0 / (i + 1), "val_psnr": 20 + i}
            for i in range(3)]
    assert TPL.training_curves(hist, tmp_path / "t").name == \
        JPL.training_curves(hist, tmp_path / "r").name


@pytest.fixture(scope="module")
def split(tmp_path_factory):
    root = tmp_path_factory.mktemp("reports")
    raw = synthetic.make_det_split(root / "raw", n_images=5, seed=2,
                                   size_range=((40, 64), (50, 90)))
    jconvert.convert_det_to_coco(raw, root / "coco", "val")
    return root / "coco"


def test_render_strip_equals_reference(split, tmp_path):
    tsamples = tpipe.index_coco(split, "val")
    jsamples = jpipe.index_coco(split, "val")
    assert TD.pick_dense_images(tsamples, 3) == JD.pick_dense_images(
        jsamples, 3)
    rng = np.random.RandomState(0)
    for ts, js in zip(tsamples[:2], jsamples[:2]):
        corrupt = rng.randint(0, 256, (ts.height, ts.width, 3)).astype(
            np.uint8)
        dets = {"boxes": np.asarray([[2, 3, 20, 30], [10, 5, 40, 25]],
                                    np.float32),
                "classes": np.asarray([0, 4]),
                "scores": np.asarray([0.9, 0.41])}
        aug = {k: v[:1] for k, v in dets.items()}
        t = TD.render_strip(ts, corrupt, dets, aug, tmp_path / "t.jpg")
        r = JD.render_strip(js, corrupt, dets, aug, tmp_path / "r.jpg")
        assert t.read_bytes() == r.read_bytes()


def test_run_demo_with_the_port_predict_step(split, tmp_path):
    model = TY.create(6, "n", device="cpu")
    predict = TDET.make_predict_step(64)
    samples = tpipe.index_coco(split, "val")
    paths = TD.run_demo(samples, predict, predict, model, model,
                        tmp_path, 64, "yolo", n_images=2)
    picks = JD.pick_dense_images(jpipe.index_coco(split, "val"), 2)
    assert len(paths) == 2
    for p, i in zip(paths, picks):
        s = samples[i]
        assert p.name.startswith(f"yolo_{s.image_path.stem}_gt"
                                 f"{len(s.classes)}_base")
        assert p.suffix == ".jpg" and p.stat().st_size > 0


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_canned_case_and_stats_equal_reference(seed):
    td, tg = TP.make_canned_eval_case(seed)
    jd, jg = JP.make_canned_eval_case(seed)
    assert td.keys() == jd.keys() and tg.keys() == jg.keys()
    for k in td:
        for ours, ref in ((td[k], jd[k]), (tg[k], jg[k])):
            assert vars(ours).keys() == vars(ref).keys()
            for f in vars(ref):
                np.testing.assert_array_equal(getattr(ours, f),
                                              getattr(ref, f))
    assert TP.to_coco_dicts(td, tg) == JP.to_coco_dicts(jd, jg)
    ts, js = TP.our_stats(td, tg), JP.our_stats(jd, jg)
    assert ts.keys() == js.keys()
    for k in ts:
        assert ts[k] == pytest.approx(js[k], abs=1e-12), k
    assert TP.CATEGORIES == JP.CATEGORIES
    assert TP.FIXTURE_PATH == JP.FIXTURE_PATH


def test_fixture_io(tmp_path):
    assert TP.load_fixture(tmp_path / "none.json") is None
    (tmp_path / "f.json").write_text('{"format": 1, "cases": []}')
    assert TP.load_fixture(tmp_path / "f.json") == JP.load_fixture(
        tmp_path / "f.json")


def test_pycocotools_leg():
    pytest.importorskip("pycocotools")
    det, gt = TP.make_canned_eval_case(0)
    ref = TP.run_pycocotools(det, gt)
    ours = TP.our_stats(det, gt)
    for k in ref:
        assert ours[k] == pytest.approx(ref[k], abs=1e-6), k
