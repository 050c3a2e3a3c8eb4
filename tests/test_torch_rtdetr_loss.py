"""The port's RT-DETR losses (robust_object_detection_tpu_torch/train/
rtdetr.py) against the reference's: ``hungarian_match``,
``varifocal_loss``, ``_layer_loss``, ``dn_loss`` and ``rtdetr_loss`` on the
same numpy-seeded outputs and targets, values and gradients;
``build_dn_queries`` by its slot structure and noise ranges (the two
frameworks' generators cannot give the same bits).

Tolerances: values rtol 1e-5 (f32 sums in another order); gradients by the
model outputs within 1e-5 x max|ref|; the matcher's assignment and capped
flags by equality (continuous random costs, no ties)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from robust_object_detection_tpu.train import rtdetr as JT
from robust_object_detection_tpu_torch.models import rtdetr as TR
from robust_object_detection_tpu_torch.train import rtdetr as TT

torch.set_num_threads(1)

L, B, Q, M, NC, IMG = 2, 3, 40, 7, 6, 128


def _targets(rng, m=M):
    xy = rng.uniform(0, IMG * 0.6, (B, m, 2))
    wh = rng.uniform(IMG * 0.1, IMG * 0.4, (B, m, 2))
    gb = np.concatenate([xy, np.minimum(xy + wh, IMG)], -1).astype(np.float32)
    gc = rng.randint(0, NC, (B, m)).astype(np.int32)
    gc[1, m - 3:] = -1
    gc[2] = -1                          # an image without ground truth
    return gb, gc


def _outputs(rng, q=Q, d=12):
    def boxes(*shape):
        c = rng.uniform(0.15, 0.85, shape + (2,))
        wh = rng.uniform(0.05, 0.3, shape + (2,))
        return np.concatenate([c, wh], -1).astype(np.float32)
    return {"logits": rng.randn(L, B, q, NC).astype(np.float32),
            "boxes": boxes(L, B, q),
            "enc_logits": rng.randn(B, q, NC).astype(np.float32),
            "enc_boxes": boxes(B, q),
            "dn_logits": rng.randn(L, B, d, NC).astype(np.float32),
            "dn_boxes": boxes(L, B, d)}


def _t(a):
    return torch.from_numpy(np.asarray(a).copy())


def test_box_helpers_match():
    rng = np.random.RandomState(0)
    gb, _ = _targets(rng)
    n = TT.to_norm_cxcywh(_t(gb), IMG)
    np.testing.assert_allclose(n.numpy(),
                               JT.to_norm_cxcywh(jnp.asarray(gb), IMG),
                               rtol=1e-6)
    np.testing.assert_allclose(
        TT._cxcywh_to_xyxy(n).numpy(),
        JT._cxcywh_to_xyxy(jnp.asarray(n.numpy())), rtol=1e-6)


@pytest.mark.parametrize("crowded", [False, True])
def test_hungarian_match_matches(crowded):
    """crowded: more valid GTs than the round cap lets the auction place
    (random costs, 30 GTs on 40 queries), so the greedy completion runs."""
    rng = np.random.RandomState(1)
    gb, gc = _targets(rng, 30 if crowded else M)
    outs = _outputs(rng)
    gt_n = JT.to_norm_cxcywh(jnp.asarray(gb), IMG)
    r_owner, r_iou, r_aux = JT.hungarian_match(
        jnp.asarray(outs["logits"][0]), jnp.asarray(outs["boxes"][0]), gt_n,
        jnp.asarray(gc))
    owner, iou, aux = TT.hungarian_match(_t(outs["logits"][0]),
                                         _t(outs["boxes"][0]),
                                         _t(gt_n), _t(gc))
    np.testing.assert_allclose(aux["cost"].numpy(), r_aux["cost"], rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(aux["capped"].numpy(), r_aux["capped"])
    np.testing.assert_array_equal(owner.numpy(), r_owner)
    np.testing.assert_allclose(iou.numpy(), r_iou, atol=1e-6)
    if crowded:
        assert aux["capped"].any()
    assert (owner[2] == -1).all()
    # the other matchers on the same costs (tests/test_torch_rtdetr_trainer
    # holds all three on more inputs); an unknown one raises
    g_owner, _, _ = JT.hungarian_match(
        jnp.asarray(outs["logits"][0]), jnp.asarray(outs["boxes"][0]), gt_n,
        jnp.asarray(gc), method="greedy")
    owner, _, aux = TT.hungarian_match(_t(outs["logits"][0]),
                                       _t(outs["boxes"][0]), _t(gt_n),
                                       _t(gc), method="greedy")
    np.testing.assert_array_equal(owner.numpy(), g_owner)
    assert not aux["capped"].any()
    with pytest.raises(ValueError, match="method"):
        TT.hungarian_match(_t(outs["logits"][0]), _t(outs["boxes"][0]),
                           _t(gt_n), _t(gc), method="sinkhorn")


def test_varifocal_loss_matches():
    rng = np.random.RandomState(2)
    logits = rng.randn(B, Q, NC).astype(np.float32) * 2
    cls = rng.randint(-1, NC, (B, Q)).astype(np.int32)
    iou = rng.rand(B, Q).astype(np.float32)
    ref, rgrad = jax.value_and_grad(
        lambda x: JT.varifocal_loss(x, jnp.asarray(cls), jnp.asarray(iou)))(
        jnp.asarray(logits))
    x = _t(logits).requires_grad_()
    out = TT.varifocal_loss(x, _t(cls), _t(iou))
    out.backward()
    np.testing.assert_allclose(out.item(), float(ref), rtol=1e-5)
    assert np.abs(x.grad.numpy() - rgrad).max() <= 1e-5 * np.abs(rgrad).max()


def test_layer_loss_matches():
    rng = np.random.RandomState(3)
    gb, gc = _targets(rng)
    outs = _outputs(rng)
    gt_n = JT.to_norm_cxcywh(jnp.asarray(gb), IMG)

    def jl(lg, bx):
        return JT._layer_loss(lg, bx, gt_n, jnp.asarray(gc))
    (ref, rm), rg = jax.value_and_grad(jl, argnums=(0, 1), has_aux=True)(
        jnp.asarray(outs["logits"][1]), jnp.asarray(outs["boxes"][1]))
    lg, bx = _t(outs["logits"][1]).requires_grad_(), \
        _t(outs["boxes"][1]).requires_grad_()
    out, m = TT._layer_loss(lg, bx, _t(gt_n), _t(gc))
    out.backward()
    np.testing.assert_allclose(out.item(), float(ref), rtol=1e-5)
    assert set(m) == set(rm)
    for k in rm:
        np.testing.assert_allclose(float(m[k]), float(rm[k]), rtol=1e-5)
    for g, r in zip((lg.grad, bx.grad), rg):
        assert np.abs(g.numpy() - r).max() <= 1e-5 * np.abs(r).max()


def _dn(gb, gc, seed=0, **kw):
    gt_n = TT.to_norm_cxcywh(_t(gb), IMG)
    return gt_n, TT.build_dn_queries(gt_n, _t(gc),
                                     torch.Generator().manual_seed(seed),
                                     **kw)


def test_dn_loss_matches():
    rng = np.random.RandomState(4)
    gb, gc = _targets(rng)
    outs = _outputs(rng, d=2 * 2 * 3)
    gt_n, (dn, dn_gt, dn_active) = _dn(gb, gc, max_gt=3)

    def jl(lg, bx):
        return JT.dn_loss(lg, bx, jnp.asarray(dn_gt.numpy()),
                          jnp.asarray(dn_active.numpy()),
                          jnp.asarray(gt_n.numpy()), jnp.asarray(gc))
    ref, rg = jax.value_and_grad(jl, argnums=(0, 1))(
        jnp.asarray(outs["dn_logits"][0]), jnp.asarray(outs["dn_boxes"][0]))
    lg, bx = _t(outs["dn_logits"][0]).requires_grad_(), \
        _t(outs["dn_boxes"][0]).requires_grad_()
    out = TT.dn_loss(lg, bx, dn_gt, dn_active, gt_n, _t(gc))
    out.backward()
    np.testing.assert_allclose(out.item(), float(ref), rtol=1e-5)
    for g, r in zip((lg.grad, bx.grad), rg):
        assert np.abs(g.numpy() - r).max() <= 1e-5 * np.abs(r).max()
    # inactive slots weigh nothing
    assert not lg.grad[~dn_active].any()


def test_rtdetr_loss_matches():
    rng = np.random.RandomState(5)
    gb, gc = _targets(rng)
    outs = _outputs(rng)
    keys = ("logits", "boxes", "enc_logits", "enc_boxes")

    def jl(o):
        return JT.rtdetr_loss(o, jnp.asarray(gb), jnp.asarray(gc), IMG)
    (ref, rm), rg = jax.value_and_grad(jl, has_aux=True)(
        {k: jnp.asarray(outs[k]) for k in keys})
    to = {k: _t(outs[k]).requires_grad_() for k in keys}
    out, m = TT.rtdetr_loss(to, _t(gb), _t(gc), IMG)
    out.backward()
    np.testing.assert_allclose(out.item(), float(ref), rtol=1e-5)
    assert set(m) == set(rm) == {"dec_cls", "dec_l1", "dec_giou",
                                 "dec_n_pos", "enc_cls", "matcher_capped"}
    for k in rm:
        np.testing.assert_allclose(float(m[k]), float(rm[k]), rtol=1e-5,
                                   err_msg=k)
    for k in keys:
        r = np.asarray(rg[k])
        assert np.abs(to[k].grad.numpy() - r).max() <= 1e-5 * np.abs(r).max()


def test_build_dn_queries_structure_and_ranges():
    """Slot layout, targets and masks as the reference's (deterministic
    parts equal to its output); noise inside its ranges: a positive's
    centre within 0.5 * 0.4 wh of its GT's, a negative's between 0.5 and 1
    x 0.4 wh away on each axis, sizes within 1 -+ 0.4 hi of the GT's."""
    rng = np.random.RandomState(6)
    gb, gc = _targets(rng)
    groups, max_gt = 2, 5
    gt_n, (dn, dn_gt, dn_active) = _dn(gb, gc, num_groups=groups,
                                       max_gt=max_gt)
    rdn, rdn_gt, rdn_active = JT.build_dn_queries(
        jnp.asarray(gt_n.numpy()), jnp.asarray(gc), jax.random.key(0),
        num_groups=groups, max_gt=max_gt)
    d = 2 * groups * max_gt
    assert dn["classes"].shape == (B, d) and dn["boxes"].shape == (B, d, 4)
    assert dn["classes"].dtype == dn["group_ids"].dtype == torch.int32
    np.testing.assert_array_equal(dn["group_ids"].numpy(), rdn["group_ids"])
    np.testing.assert_array_equal(dn_gt.numpy(), rdn_gt)
    np.testing.assert_array_equal(dn_active.numpy(), rdn_active)
    valid = np.asarray(gc[:, :max_gt] >= 0)
    cls = dn["classes"].numpy().reshape(B, 2 * groups, max_gt)
    assert (cls[np.broadcast_to(~valid[:, None], cls.shape)] == NC).all()
    ok = cls[np.broadcast_to(valid[:, None], cls.shape)]
    assert ok.min() >= 0 and ok.max() < NC
    boxes = dn["boxes"].numpy().reshape(B, 2 * groups, max_gt, 4)
    gt = gt_n.numpy()[:, None, :max_gt]
    shift = np.abs(boxes[..., :2] - gt[..., :2]) / (gt[..., 2:] * 0.4)
    scale = boxes[..., 2:] / gt[..., 2:]
    unclipped = ((boxes > 1e-4 + 1e-6) & (boxes < 1 - 1e-4 - 1e-6)).all(-1)
    for g in range(2 * groups):
        sel = valid & unclipped[:, g]
        lo, hi = (0.0, 0.5) if g % 2 == 0 else (0.5, 1.0)
        assert sel.any()
        assert (shift[:, g][sel] >= lo - 1e-5).all()
        assert (shift[:, g][sel] <= hi + 1e-5).all()
        assert (np.abs(scale[:, g][sel] - 1) <= 0.4 * hi + 1e-5).all()
    # the label noise flips about half of the classes
    src = np.broadcast_to(np.maximum(gc[:, None, :max_gt], 0), cls.shape)
    flipped = (cls != src)[np.broadcast_to(valid[:, None], cls.shape)]
    big = _dn(*_targets(np.random.RandomState(7), 40), max_gt=40)[1][0]
    assert 0.0 < flipped.mean() < 0.9 and big["classes"].shape == (B, 160)


def test_dn_attention_mask_matches():
    from robust_object_detection_tpu.models import rtdetr as JR
    rng = np.random.RandomState(8)
    gid = rng.randint(-1, 2, (B, 8)).astype(np.int32)
    ref = np.asarray(JR._dn_attention_mask(jnp.asarray(gid), 8 + 5))
    out = TR.dn_attention_mask(_t(gid), 8 + 5).numpy()
    np.testing.assert_array_equal(out, ref)
    assert out.any(-1).all()            # no row is fully masked
