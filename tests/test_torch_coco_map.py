"""The port's own copies of the host scorer (eval.coco_map, native)
against the reference package's, on random detections: identical
precision / recall tensors and summaries (tolerance 1e-12, the same
arithmetic), by the numpy route and by the C++ matcher, which the port
builds into a cache of its own."""

import numpy as np
import pytest

from robust_object_detection_tpu.eval import coco_map as jmap
from robust_object_detection_tpu_torch import native as tnative
from robust_object_detection_tpu_torch.data import visdrone as tvis
from robust_object_detection_tpu_torch.eval import coco_map as tmap


def _case(seed, n_images=12, n_dt=40, n_gt=25, crowd_frac=0.1):
    rng = np.random.RandomState(seed)
    out = []
    for i in range(n_images):
        nd, ng = rng.randint(0, n_dt), rng.randint(0, n_gt)
        db = np.concatenate([rng.rand(nd, 2) * 200,
                             rng.rand(nd, 2) * 80 + 4], 1).astype(np.float32)
        gb = np.concatenate([rng.rand(ng, 2) * 200,
                             rng.rand(ng, 2) * 80 + 4], 1).astype(np.float32)
        out.append((i, db, rng.rand(nd).astype(np.float32),
                    rng.randint(1, 4, nd), gb, rng.randint(1, 4, ng),
                    rng.rand(ng) < crowd_frac))
    return out


def _build(mod, case):
    dets = {i: mod.Detections(boxes=db, scores=ds, classes=dc)
            for i, db, ds, dc, _, _, _ in case}
    gts = {i: mod.GroundTruth(boxes=gb, classes=gc, iscrowd=cr)
           for i, _, _, _, gb, gc, cr in case}
    return dets, gts


def test_port_native_builds_into_its_own_cache():
    assert tnative.available(), "g++ build of the port's coco_match.cc failed"
    from robust_object_detection_tpu import native as jnative
    assert tnative._SRC != jnative._SRC
    assert "robust_object_detection_tpu_torch" in str(tnative._SRC)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("use_native", [False, True])
def test_port_scorer_matches_reference(seed, use_native):
    case = _case(seed)
    r_ref = jmap.evaluate(*_build(jmap, case), categories=[1, 2, 3],
                          use_native=False)
    r_port = tmap.evaluate(*_build(tmap, case), categories=[1, 2, 3],
                           use_native=use_native)
    np.testing.assert_allclose(r_port.precision, r_ref.precision, atol=1e-12)
    np.testing.assert_allclose(r_port.recall, r_ref.recall, atol=1e-12)
    s_ref, s_port = jmap.summarize(r_ref), tmap.summarize(r_port)
    assert s_ref.keys() == s_port.keys()
    for k in s_ref:
        assert s_port[k] == pytest.approx(s_ref[k], abs=1e-12), k
    assert r_port.per_class_ap50.keys() == r_ref.per_class_ap50.keys()


def test_class_tables_match_reference():
    from robust_object_detection_tpu.data import visdrone as jvis
    assert tvis.CLASS_NAMES == jvis.CLASS_NAMES
    assert tvis.USED_CLASSES == jvis.USED_CLASSES
    assert tvis.NUM_CLASSES == jvis.NUM_CLASSES


def test_sample_record_matches_reference():
    import dataclasses
    from robust_object_detection_tpu.data import pipeline as jpipe
    from robust_object_detection_tpu_torch.data import pipeline as tpipe
    assert ([f.name for f in dataclasses.fields(tpipe.Sample)]
            == [f.name for f in dataclasses.fields(jpipe.Sample)])


def test_load_image_rgb_matches_reference(tmp_path):
    cv2 = pytest.importorskip("cv2")
    from robust_object_detection_tpu.data import pipeline as jpipe
    from robust_object_detection_tpu_torch.data import pipeline as tpipe
    img = np.random.RandomState(0).randint(0, 256, (12, 20, 3), np.uint8)
    path = tmp_path / "a.png"
    cv2.imwrite(str(path), img)
    kw = dict(image_path=path, image_id=1, width=20, height=12,
              boxes_xyxy=np.zeros((0, 4), np.float32),
              classes=np.zeros((0,), np.int32))
    np.testing.assert_array_equal(tpipe.load_image_rgb(tpipe.Sample(**kw)),
                                  jpipe.load_image_rgb(jpipe.Sample(**kw)))
