"""The port's disk-path eval (data/pipeline.py, eval/detector_eval.py)
against the reference's, on a split written by the reference's
data/synthetic + data/convert, with the same small Faster R-CNN on both
sides (test_torch_frcnn's: blocks (1, 1, 1, 1), weights carried across by
``convert.frcnn_from_jax_variables``, class logits x10).

Indexing, letterboxing and batching are held equal. The evals are held on
their buckets, their image counts and their mAPs within 1e-3, with ground
truth made from the reference's own detections on the clean split, so that
the mAPs sit near 1 and a wrong box lowers them. The three tables' text is
held equal on one results dict.
"""

import shutil

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from robust_object_detection_tpu.data import convert as dconvert
from robust_object_detection_tpu.data import pipeline as jpipe
from robust_object_detection_tpu.data import synthetic
from robust_object_detection_tpu.eval import detector_eval as jde
from robust_object_detection_tpu.models import frcnn as JF
from robust_object_detection_tpu_torch.data import pipeline as tpipe
from robust_object_detection_tpu_torch.eval import detector_eval as tde
from robust_object_detection_tpu_torch.eval import fused_sweep as tfs
from robust_object_detection_tpu_torch.models import frcnn as TF
from robust_object_detection_tpu_torch.ops import corrupt as tc
from robust_object_detection_tpu_torch.ops import image as timage
from robust_object_detection_tpu_torch.train import frcnn as TT

from test_torch_frcnn import (SMALL, assert_detections_match, jax_frcnn,
                              jax_predict, port_frcnn)

torch.set_num_threads(1)

IMG = 64
# a small native-resolution rule, so the split's 40-56 x 64-100 images land
# in two 32-aligned buckets the small model takes
BUCKET = dict(min_side=64.0, max_side=128.0, bucket_mult=32)


@pytest.fixture(scope="module")
def split(tmp_path_factory):
    root = tmp_path_factory.mktemp("split")
    raw = synthetic.make_det_split(root / "raw", n_images=5,
                                   size_range=((40, 56), (64, 100)))
    dconvert.convert_det_to_coco(raw, root / "coco", "val")
    dconvert.convert_det_to_yolo(raw, root / "yolo", "val")
    return root


@pytest.fixture(scope="module")
def frcnn():
    jm, v = jax_frcnn(JF.FrcnnConfig(**SMALL))
    head = v["params"]["box_head"]["Dense_1"]
    head["kernel"] = head["kernel"] * 10.0
    return jm, v, port_frcnn(SMALL, v)


def _assert_samples_equal(out, ref):
    assert len(out) == len(ref) > 0
    for o, r in zip(out, ref):
        assert (str(o.image_path), o.image_id, o.width, o.height) == (
            str(r.image_path), r.image_id, r.width, r.height)
        np.testing.assert_array_equal(o.boxes_xyxy, r.boxes_xyxy)
        np.testing.assert_array_equal(o.classes, r.classes)
        assert o.boxes_xyxy.dtype == r.boxes_xyxy.dtype
        assert o.classes.dtype == r.classes.dtype


def test_index_coco_and_yolo(split):
    _assert_samples_equal(tpipe.index_coco(split / "coco", "val"),
                          jpipe.index_coco(split / "coco", "val"))
    _assert_samples_equal(tpipe.index_yolo(split / "yolo", "val"),
                          jpipe.index_yolo(split / "yolo", "val"))


@pytest.mark.parametrize("size,pad,scale", [
    (64, 114, None),                      # square letterbox, resized
    ((64, 128), TF.PAD_RGB, None),        # rectangular canvas
    ((96, 128), TF.PAD_RGB, 1.0),         # bucket at native scale: no resize
    ((64, 96), TF.PAD_RGB, 0.9)])         # bucket at a tv_target scale
def test_load_letterboxed(split, size, pad, scale):
    for t, r in zip(tpipe.index_coco(split / "coco", "val"),
                    jpipe.index_coco(split / "coco", "val")):
        out = tpipe.load_letterboxed(t, size, pad, scale)
        ref = jpipe.load_letterboxed(r, size, pad, scale)
        np.testing.assert_array_equal(out[0], ref[0])
        assert out[1] == ref[1]


def test_load_letterboxed_in_memory_needs_no_resize():
    """A canvas at the image's own size takes pixels from `load_image` as
    they are (the card's machine has no cv2)."""
    img = np.random.RandomState(0).randint(0, 256, (40, 70, 3), np.uint8)
    s = tpipe.Sample("mem.png", 1, 70, 40, np.zeros((0, 4), np.float32),
                     np.zeros(0, np.int32))
    canvas, scale = tpipe.load_letterboxed(s, (64, 128), TF.PAD_RGB, 1.0,
                                           load_image=lambda _: img)
    assert scale == 1.0
    np.testing.assert_array_equal(canvas[:40, :70], img)
    assert (canvas[40:] == TF.PAD_RGB).all() and (
        canvas[:, 70:] == TF.PAD_RGB).all()


@pytest.mark.parametrize("shuffle", [False, True])
def test_make_batches(split, shuffle):
    kw = dict(max_boxes=4, shuffle=shuffle, seed=3)
    out = list(tpipe.make_batches(tpipe.index_coco(split / "coco", "val"),
                                  2, (64, 96), **kw))
    ref = list(jpipe.make_batches(jpipe.index_coco(split / "coco", "val"),
                                  2, (64, 96), **kw))
    assert len(out) == len(ref) == 3 and out[-1].num_valid == 1
    for o, r in zip(out, ref):
        for f in ("images", "boxes", "classes", "image_ids", "scales"):
            a, b = getattr(o, f), getattr(r, f)
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        assert o.num_valid == r.num_valid


def test_prefetch_passes_items_and_errors():
    assert list(tpipe.prefetch(iter(range(5)), depth=2)) == list(range(5))

    def broken():
        yield 1
        raise ValueError("decode failed")
    with pytest.raises(ValueError):
        list(tpipe.prefetch(broken()))


def _pseudo_gt(samples, detections):
    """The samples with the reference's detections (score > 0.3) as their
    ground truth."""
    out = []
    for s in samples:
        d = detections[int(s.image_id)]
        keep = d.scores > 0.3
        xywh = d.boxes[keep]
        out.append(tpipe.Sample(
            s.image_path, s.image_id, s.width, s.height,
            np.concatenate([xywh[:, :2], xywh[:, :2] + xywh[:, 2:]],
                           1).astype(np.float32),
            (d.classes[keep] - 1).astype(np.int32)))
    return out


def test_evaluate_bucketed_matches_reference(split, frcnn):
    jm, v, tm = frcnn
    samples = tpipe.index_coco(split / "coco", "val")
    jfactory = jde.BucketedPredict(
        lambda hw: jax_predict(jm, v, hw)[0], **BUCKET,
        pad_value=JF.PAD_RGB)
    state = jax_predict(jm, v, IMG)[1]
    # ground truth: the reference's detections at native resolution
    groups, dets = {}, {}
    for s in samples:
        groups.setdefault(_bucket(s), []).append(s)
    for bucket, group in groups.items():
        d, _, _ = jde._collect_detections(
            jfactory.factory(bucket), state, group, bucket, 2, None, 600,
            scale_fn=_scale, pad_value=JF.PAD_RGB)
        dets.update(d)
    gt = _pseudo_gt(samples, dets)
    assert sum(len(s.boxes_xyxy) for s in gt) > 10

    ref = jde.evaluate_on_samples(jfactory, state, gt, IMG, 2)
    tfactory = tde.BucketedPredict(lambda hw: TT.make_predict_step(tm, hw),
                                   **BUCKET, pad_value=TF.PAD_RGB)
    out = tde.evaluate_on_samples(tfactory, tm, gt, IMG, 2)
    assert out["buckets"] == ref["buckets"] == {
        f"{h}x{w}": len(g) for (h, w), g in sorted(groups.items())}
    assert len(groups) >= 2
    assert out["images"] == ref["images"] == 5
    assert ref["mAP50"] > 0.5
    for k in ("mAP50", "mAP50_95"):
        assert abs(out[k] - ref[k]) <= 1e-3, (k, out[k], ref[k])
    assert out["per_class_ap50"].keys() == ref["per_class_ap50"].keys()


def _scale(s):
    return jde.tv_target(s.height, s.width, 64.0, 128.0)[2]


def _bucket(s):
    th, tw, _ = jde.tv_target(s.height, s.width, 64.0, 128.0)
    return (-(-th // 32) * 32, -(-tw // 32) * 32)


def _testset_root(split, root):
    """A frozen-testset layout holding the clean split under every variant
    name (what the eval reads; the corruptions are held elsewhere)."""
    for variant in tde.TESTSET_VARIANTS:
        shutil.copytree(split / "coco", root / "coco6" / variant)
    return root


def test_sweep_writes_the_reference_artifacts(split, frcnn, tmp_path,
                                              capsys):
    jm, v, tm = frcnn
    testsets = _testset_root(split, tmp_path / "testsets")
    jpredict, state = jax_predict(jm, v, IMG)
    tpredict = TT.make_predict_step(tm, IMG)
    names = ("frcnn_baseline", "frcnn_augmented")
    ref = jde.sweep({n: (jpredict, state) for n in names}, testsets, IMG, 2,
                    tmp_path / "ref")
    ref_text = capsys.readouterr().out
    out = tde.sweep({n: (tpredict, tm) for n in names}, testsets, IMG, 2,
                    tmp_path / "out")
    out_text = capsys.readouterr().out
    assert out.keys() == ref.keys()
    for name in names:
        assert out[name].keys() == ref[name].keys()
        for variant, summary in out[name].items():
            r = ref[name][variant]
            assert summary.keys() == r.keys()
            assert summary["images"] == r["images"] == 5
            for k in ("mAP50", "mAP50_95"):
                assert abs(summary[k] - r[k]) <= 1e-3
    for suffix in (".json", ".csv"):
        assert (tmp_path / "out" / f"eval_results{suffix}").exists()
    assert not (tmp_path / "out" / "eval_results.partial.json").exists()
    csv_out = (tmp_path / "out" / "eval_results.csv").read_text().splitlines()
    csv_ref = (tmp_path / "ref" / "eval_results.csv").read_text().splitlines()
    assert csv_out[0] == csv_ref[0]
    assert ([row.split(",")[:2] for row in csv_out]
            == [row.split(",")[:2] for row in csv_ref])
    # the printed tables after the first (which carries images/s)
    assert out_text.split("per-class")[1] == ref_text.split("per-class")[1]
    assert "Aug - Base mAP50 difference" in out_text


def test_evaluate_testsets_resumes_from_partial(split, frcnn, tmp_path):
    _, _, tm = frcnn
    testsets = _testset_root(split, tmp_path / "testsets")
    tpredict = TT.make_predict_step(tm, IMG)
    marker = {"mAP50": 0.25, "mAP50_95": 0.125, "images_per_sec": 1.0}
    from robust_object_detection_tpu_torch.core import artifacts
    artifacts.write_json(tmp_path / "out" / "eval_results.partial.json",
                         {f"m/{v}": marker for v in tde.TESTSET_VARIANTS[:3]})
    res = tde.sweep({"m": (tpredict, tm)}, testsets, IMG, 2, tmp_path / "out")
    assert [res["m"][v] for v in tde.TESTSET_VARIANTS[:3]] == [marker] * 3
    assert res["m"]["Test_LowRes"]["images"] == 5
    direct = tde.evaluate_testsets(tpredict, tm, testsets, IMG, 2,
                                   variants=("Test_LowRes",))
    assert direct["Test_LowRes"]["mAP50"] == res["m"]["Test_LowRes"]["mAP50"]


def test_tables_text_matches_reference():
    rng = np.random.RandomState(0)
    results = {
        name: {v: {"mAP50": float(rng.rand()), "mAP50_95": float(rng.rand()),
                   "per_class_ap50": {c: float(rng.rand())
                                      for c in ("pedestrian", "car", "van",
                                                "truck", "bus", "motor")}}
               for v in tde.TESTSET_VARIANTS}
        for name in ("yolo_baseline", "yolo_augmented", "frcnn_baseline")}
    results["empty"] = {"Test_Clean": {"mAP50": 0.0}}
    for fn in ("per_class_table", "degradation_table", "comparison_table"):
        assert getattr(tde, fn)(results) == getattr(jde, fn)(results)
    assert tde.comparison_table({"a": results["empty"]}) == ""


def test_fused_sweep_four_passes_with_frcnn(frcnn):
    """The fused step with the Faster R-CNN predict step: each of its 4
    passes equals the port's predict on that variant run alone (bit for
    bit) and the reference's predict on the same canvas (matched by box);
    then the whole sweep over an in-memory split."""
    jm, v, tm = frcnn
    tpredict = TT.make_predict_step(tm, IMG)
    jpredict, state = jax_predict(jm, v, IMG)
    rng = np.random.RandomState(5)
    clean = rng.randint(0, 256, (2, 48, 64, 3)).astype(np.uint8)
    noise = rng.randn(2, 48, 64, 3).astype(np.float32) * 15.0
    step = tfs.make_fused_step(tpredict, None, (48, 64), IMG,
                               host_noise=True)
    out = step(tm, None, torch.from_numpy(clean), torch.from_numpy(noise))
    assert out[0].shape == (4, 2, 100, 4)
    x = torch.from_numpy(clean).float()
    variants = (x, timage.quantize_trunc(x + torch.from_numpy(noise)),
                tc.apply_motion_blur(x), tc.apply_lowres(x))
    for p, img in enumerate(variants):
        canvas = timage.letterbox(img, IMG)[0]
        alone = tpredict(tm, canvas)
        for o, a in zip(out, alone):
            torch.testing.assert_close(o[p], a, rtol=0, atol=0)
        ref = jpredict(state, jnp.asarray(canvas.numpy()))
        assert_detections_match(tuple(t[p] for t in out), ref)

    images = {i: rng.randint(0, 256, (48, 64, 3)).astype(np.uint8)
              for i in (1, 2, 3)}
    samples = [tpipe.Sample(f"mem/{i}.png", i, 64, 48,
                            np.array([[4, 4, 30, 40]], np.float32),
                            np.array([i % 6], np.int32)) for i in images]
    res = tfs.run_fused_sweep(tpredict, tm, None, None, samples, IMG, 2,
                              load_image=lambda s: images[s.image_id])
    assert res["images_evaluated"] == 12 and "restored" not in res
    for variant in tfs.TESTSET_VARIANTS:
        assert 0.0 <= res["corrupted"][variant]["mAP50"] <= 1.0
