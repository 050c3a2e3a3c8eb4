"""data/worker_pipeline.make_batches_workers against the reference's
Grain loader (data/grain_pipeline.make_batches_grain) on one 7-image JPEG
split at 64 px: every field of every batch (padding rows included) at 0
and 2 worker processes, Grain's shards, and the shuffle. Grain's own
shuffle order is not reproduced (the port permutes as
``pipeline.make_batches`` does), so shuffled batches are held as a
permutation of the records and against the port's threaded loader."""

import grain.python as gp
import numpy as np
import pytest

from robust_object_detection_tpu.data import convert as jconvert
from robust_object_detection_tpu.data import pipeline as jpipe
from robust_object_detection_tpu.data import synthetic
from robust_object_detection_tpu.data.grain_pipeline import \
    make_batches_grain
from robust_object_detection_tpu_torch.data import pipeline as tpipe
from robust_object_detection_tpu_torch.data import worker_pipeline as W
from robust_object_detection_tpu_torch.parallel import distributed as dist

N_IMAGES, SIZE, MAX_BOXES = 7, 64, 16
FIELDS = ("images", "boxes", "classes", "image_ids", "scales")


@pytest.fixture(scope="module")
def split(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("workers")
    det = synthetic.make_det_split(tmp / "det", n_images=N_IMAGES,
                                   size_range=((40, 56), (40, 56)))
    jconvert.convert_det_to_coco(det, tmp / "coco", "val")
    return (jpipe.index_coco(tmp / "coco", "val"),
            tpipe.index_coco(tmp / "coco", "val"))


def _assert_same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.num_valid == w.num_valid
        for f in FIELDS:
            a, b = getattr(g, f), getattr(w, f)
            assert isinstance(a, np.ndarray) and a.dtype == b.dtype, f
            np.testing.assert_array_equal(a, b, err_msg=f)


@pytest.mark.parametrize("workers", [0, 2])
def test_batches_equal_grain(split, workers):
    jsamples, tsamples = split
    want = list(make_batches_grain(jsamples, 3, SIZE, max_boxes=MAX_BOXES))
    got = list(W.make_batches_workers(tsamples, 3, SIZE, max_boxes=MAX_BOXES,
                                      num_workers=workers))
    _assert_same(got, want)
    last = got[-1]
    assert last.num_valid == 1 and last.images.dtype == np.uint8
    assert (last.image_ids[1:] == -1).all()
    np.testing.assert_array_equal(last.images[1:],
                                  np.repeat(last.images[:1], 2, axis=0))


@pytest.mark.parametrize("index,count", [(0, 2), (1, 2), (0, 3), (1, 3),
                                         (2, 3)])
def test_shards_equal_grain(split, index, count):
    jsamples, tsamples = split
    want = list(make_batches_grain(
        jsamples, 2, SIZE, max_boxes=MAX_BOXES,
        shard_options=gp.ShardOptions(index, count, drop_remainder=True)))
    got = list(W.make_batches_workers(
        tsamples, 2, SIZE, max_boxes=MAX_BOXES,
        shard=dist.ShardOptions(index, count)))
    _assert_same(got, want)
    size = N_IMAGES // count
    ids = np.concatenate([b.image_ids[:b.num_valid] for b in got])
    assert ids.tolist() == [s.image_id for s in
                            tsamples[index * size:(index + 1) * size]]


def test_shuffle_is_a_seeded_permutation(split):
    _, tsamples = split

    def run(seed, workers):
        return list(W.make_batches_workers(
            tsamples, 3, SIZE, max_boxes=MAX_BOXES, shuffle=True, seed=seed,
            num_workers=workers))
    a, b, c = run(3, 0), run(3, 2), run(4, 0)
    _assert_same(b, a)
    ids = [np.concatenate([x.image_ids[:x.num_valid] for x in r])
           for r in (a, c)]
    assert sorted(ids[0].tolist()) == [s.image_id for s in tsamples]
    assert sorted(ids[1].tolist()) == [s.image_id for s in tsamples]
    assert ids[0].tolist() != ids[1].tolist()
    threads = list(tpipe.make_batches(tsamples, 3, SIZE, max_boxes=MAX_BOXES,
                                      shuffle=True, seed=3))
    for g, t in zip(a, threads):
        n = g.num_valid
        for f in FIELDS:
            np.testing.assert_array_equal(getattr(g, f)[:n],
                                          getattr(t, f)[:n])


def test_shard_options_without_a_group():
    assert dist.shard_options() == dist.ShardOptions(0, 1)
    assert W.shard_indices(5, dist.shard_options()).tolist() == \
        [0, 1, 2, 3, 4]
    with pytest.raises(ValueError):
        W.shard_indices(5, dist.ShardOptions(2, 2))
