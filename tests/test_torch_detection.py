"""The port's box overlaps, TAL assigner and YOLOv8 loss
(robust_object_detection_tpu_torch/ops/boxes.py, train/detection.py)
against the JAX reference on the same inputs.

The reference's loss runs with ``precise=True`` (f32 metric, exact top-k),
the configuration the port implements. Loss components within rtol 1e-5
(f32 sums in another order), assignments equal: fg_mask and the assigned
gt bit for bit, target boxes and scores to f32 noise. Inputs are YOLOv8n
head outputs at 64 px — from the flax model itself, and from moderate
random logits whose predicted boxes overlap the GTs often (the spread of
tests/test_loss_parity.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robust_object_detection_tpu.models import yolov8 as JY
from robust_object_detection_tpu.ops import boxes as JB
from robust_object_detection_tpu.train import detection as JD
from robust_object_detection_tpu_torch.models import yolov8 as TY
from robust_object_detection_tpu_torch.ops import boxes as TB
from robust_object_detection_tpu_torch.train import detection as TD

torch.set_num_threads(1)

IMG = 64
B, M = 2, 6


def _boxes(rng, *shape, img=IMG):
    xy = rng.uniform(0, img * 0.7, shape + (2,))
    wh = rng.uniform(1, img * 0.5, shape + (2,))
    return np.concatenate([xy, xy + wh], -1).astype(np.float32)


@pytest.mark.parametrize("name", ["iou_elementwise", "giou", "ciou"])
def test_elementwise_overlaps_match_reference(name):
    rng = np.random.RandomState(0)
    a, b = _boxes(rng, 3, 50), _boxes(rng, 3, 50)
    a[0, :5] = b[0, :5]                       # identical pairs
    ref = np.asarray(getattr(JB, name)(jnp.asarray(a), jnp.asarray(b)))
    out = getattr(TB, name)(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("name", ["pairwise_iou", "pairwise_giou",
                                  "pairwise_ciou"])
def test_pairwise_overlaps_match_reference(name):
    rng = np.random.RandomState(1)
    a, b = _boxes(rng, 2, 7), _boxes(rng, 2, 40)
    ref = np.asarray(getattr(JB, name)(jnp.asarray(a), jnp.asarray(b)))
    out = getattr(TB, name)(torch.from_numpy(a), torch.from_numpy(b))
    assert out.shape == (2, 7, 40)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-6)


def test_ciou_gradient_matches_reference():
    """alpha carries no gradient on either side."""
    rng = np.random.RandomState(2)
    a, b = _boxes(rng, 40), _boxes(rng, 40)
    ref = np.asarray(jax.grad(lambda p: JB.ciou(p, jnp.asarray(b)).sum())(
        jnp.asarray(a)))
    at = torch.from_numpy(a).requires_grad_()
    TB.ciou(at, torch.from_numpy(b)).sum().backward()
    np.testing.assert_allclose(at.grad.numpy(), ref, rtol=1e-4, atol=1e-6)


def _gts(rng):
    x1 = rng.uniform(0, IMG * 0.6, (B, M))
    y1 = rng.uniform(0, IMG * 0.6, (B, M))
    w = rng.uniform(IMG * 0.15, IMG * 0.4, (B, M))
    h = rng.uniform(IMG * 0.15, IMG * 0.4, (B, M))
    boxes = np.stack([x1, y1, np.minimum(x1 + w, IMG),
                      np.minimum(y1 + h, IMG)], -1).astype(np.float32)
    classes = rng.randint(0, 6, (B, M)).astype(np.int32)
    classes[1, M - 2:] = -1                   # padded slots
    return boxes, classes


def _model_outputs(seed):
    """Raw YOLOv8n head outputs of the flax model at 64 px (NHWC)."""
    model = JY.create(6, "n")
    variables = JY.init_variables(model, jax.random.key(seed), IMG)
    x = np.random.RandomState(seed).rand(B, IMG, IMG, 3).astype(np.float32)
    outs = model.apply(variables, jnp.asarray(x), train=False)
    return [(np.asarray(b), np.asarray(c)) for b, c in outs]


def _random_outputs(seed):
    """Per-level NHWC head outputs from moderate random logits."""
    rng = np.random.RandomState(seed)
    outs = []
    for s in JY.STRIDES:
        hw = IMG // s
        outs.append(((rng.randn(B, hw, hw, 4 * JY.REG_MAX) * 1.5
                      ).astype(np.float32),
                     (rng.randn(B, hw, hw, 6) - 1.0).astype(np.float32)))
    return outs


def _nchw(outs, requires_grad=False):
    return [tuple(torch.from_numpy(a.transpose(0, 3, 1, 2).copy())
                  .requires_grad_(requires_grad) for a in lvl)
            for lvl in outs]


CASES = [("model", 0), ("random", 0), ("random", 1), ("random", 2)]


def _case(kind, seed):
    outs = _model_outputs(seed) if kind == "model" else _random_outputs(seed)
    return outs, _gts(np.random.RandomState(100 + seed))


@pytest.mark.parametrize("kind,seed", CASES)
def test_task_aligned_assign_matches_reference(kind, seed):
    outs, (gb, gc) = _case(kind, seed)
    jb, jc = JY.flatten_outputs([(jnp.asarray(b), jnp.asarray(c))
                                 for b, c in outs])
    anchors, strides = JY.anchor_points(IMG)
    d = JY.dfl_expectation(jb)
    pred = jnp.concatenate([(anchors - d[..., :2]) * strides[:, None],
                            (anchors + d[..., 2:]) * strides[:, None]], -1)
    anchors_px = jnp.asarray(anchors * strides[:, None])
    ref = JD.task_aligned_assign(jax.nn.sigmoid(jc), pred, anchors_px,
                                 jnp.asarray(gb), jnp.asarray(gc),
                                 precise=True)
    out = TD.task_aligned_assign(
        torch.sigmoid(torch.from_numpy(np.array(jc))),
        torch.from_numpy(np.array(pred)),
        torch.from_numpy(np.array(anchors_px)), torch.from_numpy(gb),
        torch.from_numpy(gc))
    assert np.asarray(ref["fg_mask"]).sum() > 0
    np.testing.assert_array_equal(out["fg_mask"].numpy(), ref["fg_mask"])
    np.testing.assert_array_equal(out["target_gt"].numpy(),
                                  ref["target_gt"])
    np.testing.assert_allclose(out["target_boxes"].numpy(),
                               ref["target_boxes"], rtol=1e-6, atol=1e-5)
    np.testing.assert_allclose(out["target_scores"].numpy(),
                               ref["target_scores"], rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("kind,seed", CASES)
def test_yolo_loss_matches_reference_precise(kind, seed):
    """Components within rtol 1e-5, num_fg equal, and the gradient of the
    total with respect to every head output within 1e-5 x the largest
    reference gradient (a level without foreground anchors has box
    gradients of 0 on one side and ~1e-12 on the other)."""
    outs, (gb, gc) = _case(kind, seed)
    jouts = [(jnp.asarray(b), jnp.asarray(c)) for b, c in outs]

    def jtotal(o):
        return JD.yolo_loss(o, jnp.asarray(gb), jnp.asarray(gc), IMG,
                            precise=True)
    (jloss, jmet), jgrad = jax.value_and_grad(jtotal, has_aux=True)(jouts)

    touts = _nchw(outs, requires_grad=True)
    loss, met = TD.yolo_loss(touts, torch.from_numpy(gb),
                             torch.from_numpy(gc), IMG)
    loss.backward()
    assert int(met["num_fg"]) == int(jmet["num_fg"]) > 0
    for k in ("box", "cls", "dfl"):
        np.testing.assert_allclose(met[k].item(), float(jmet[k]), rtol=1e-5,
                                   err_msg=k)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    pairs = [(t.grad.numpy(), np.asarray(j).transpose(0, 3, 1, 2))
             for lvl, jlvl in zip(touts, jgrad) for t, j in zip(lvl, jlvl)]
    scale = max(np.abs(ref).max() for _, ref in pairs)
    for out, ref in pairs:
        assert np.abs(out - ref).max() <= 1e-5 * scale


def test_dfl_and_bce_match_reference():
    rng = np.random.RandomState(3)
    logits = rng.randn(2, 30, 4, 16).astype(np.float32)
    target = rng.uniform(-1, 17, (2, 30, 4)).astype(np.float32)
    weight = rng.rand(2, 30).astype(np.float32)
    ref = float(JD.dfl_loss(jnp.asarray(logits), jnp.asarray(target),
                            jnp.asarray(weight)))
    out = float(TD.dfl_loss(torch.from_numpy(logits),
                            torch.from_numpy(target),
                            torch.from_numpy(weight)))
    np.testing.assert_allclose(out, ref, rtol=1e-5)
    x = (rng.randn(100) * 20).astype(np.float32)
    t = rng.rand(100).astype(np.float32)
    np.testing.assert_allclose(
        TD.optax_bce(torch.from_numpy(x), torch.from_numpy(t)).numpy(),
        np.asarray(JD.optax_bce(jnp.asarray(x), jnp.asarray(t))),
        rtol=1e-6, atol=1e-6)


def test_padded_gts_are_never_assigned():
    outs, (gb, gc) = _case("random", 4)
    gc[:] = -1
    loss, met = TD.yolo_loss(_nchw(outs), torch.from_numpy(gb),
                             torch.from_numpy(gc), IMG)
    assert int(met["num_fg"]) == 0 and float(met["box"]) == 0.0
    assert torch.isfinite(loss)
    assert TY.anchor_points(IMG)[0].shape[0] == sum(
        (IMG // s) ** 2 for s in TY.STRIDES)
