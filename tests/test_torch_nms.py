"""Port NMS (robust_object_detection_tpu_torch/ops/nms.py) against the
reference JAX ops/nms.py on the same random boxes and distinct scores:
identical valid masks, picked classes and scores; boxes within 1e-4 (they
are gathered, not recomputed, on both sides)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from robust_object_detection_tpu.ops import nms as jn
from robust_object_detection_tpu_torch.ops import nms as tn

torch.set_num_threads(1)


def _boxes(rng, b, n, extent=200.0):
    xy = rng.rand(b, n, 2).astype(np.float32) * extent
    wh = (rng.rand(b, n, 2).astype(np.float32) * 40 + 4)
    return np.concatenate([xy, xy + wh], -1)


def _distinct_scores(rng, shape):
    # a permutation of evenly spaced values: every gap is far above f32 noise
    s = (np.arange(np.prod(shape)) + 1) / (np.prod(shape) + 1)
    return rng.permutation(s).reshape(shape).astype(np.float32)


def _compare(out, ref):
    ob, os_, oc, ov = (t.numpy() for t in out)
    rb, rs, rc, rv = (np.asarray(t) for t in ref)
    np.testing.assert_array_equal(ov, rv)
    np.testing.assert_array_equal(oc, rc)
    np.testing.assert_array_equal(os_, rs)
    np.testing.assert_allclose(ob, rb, atol=1e-4, rtol=0)
    assert ov.sum() > 0


@pytest.mark.parametrize("seed", [0, 1])
def test_multilabel_nms_matches_reference(seed):
    rng = np.random.RandomState(seed)
    boxes = _boxes(rng, 2, 120)
    scores = _distinct_scores(rng, (2, 120, 6))
    scores[scores < 0.3] = 0.0005           # below the score threshold
    kw = dict(num_candidates=300, max_outputs=50, iou_thresh=0.5,
              score_thresh=0.001)
    ref = jn.multilabel_nms(jnp.asarray(boxes), jnp.asarray(scores), **kw)
    out = tn.multilabel_nms(torch.from_numpy(boxes),
                            torch.from_numpy(scores), **kw)
    _compare(out, ref)


@pytest.mark.parametrize("class_aware", [True, False])
def test_batched_nms_matches_reference(class_aware):
    rng = np.random.RandomState(2)
    boxes = _boxes(rng, 3, 150, extent=120.0)
    scores = _distinct_scores(rng, (3, 150))
    classes = rng.randint(0, 6, (3, 150)).astype(np.int32)
    kw = dict(num_candidates=100, max_outputs=40, iou_thresh=0.6,
              score_thresh=0.05, class_aware=class_aware)
    ref = jn.batched_nms(jnp.asarray(boxes), jnp.asarray(scores),
                         jnp.asarray(classes), **kw)
    out = tn.batched_nms(torch.from_numpy(boxes), torch.from_numpy(scores),
                         torch.from_numpy(classes), **kw)
    _compare(out, ref)


def test_nms_fewer_candidates_than_outputs():
    """All live boxes picked, the rest of the slots invalid and zeroed."""
    rng = np.random.RandomState(3)
    boxes = _boxes(rng, 1, 8, extent=1000.0)
    scores = _distinct_scores(rng, (1, 8))
    ob, os_, oc, ov = tn.batched_nms(
        torch.from_numpy(boxes), torch.from_numpy(scores),
        torch.zeros(1, 8, dtype=torch.int32), num_candidates=8,
        max_outputs=12, iou_thresh=0.99, score_thresh=0.0)
    assert ov.sum() == 8 and not ov[0, 8:].any()
    assert torch.all(oc[0, 8:] == -1) and torch.all(ob[0, 8:] == 0)
    assert torch.all(os_[0, :8][:-1] >= os_[0, :8][1:])
