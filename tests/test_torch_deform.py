"""Multi-scale deformable attention (K5 forward's module): the port's
plain version against the reference's XLA path (1e-5: the same f32
gather, another summation order) and against the reference's slot-layout
Pallas kernel in interpret mode (2e-2, the bar of tests/test_deform.py: the
TPU kernel multiplies bf16 one-hots)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from robust_object_detection_tpu.ops import deform as JD
from robust_object_detection_tpu_torch.ops import deform as TD

torch.set_num_threads(1)

CASES = {
    "square_p2": dict(shapes=((8, 8), (4, 4)), b=2, heads=2, dh=8, p=2, q=7),
    "p4_production_points": dict(shapes=((8, 8), (4, 4), (2, 2)), b=1,
                                 heads=2, dh=8, p=4, q=5),
    "nonsquare_levels": dict(shapes=((6, 10), (3, 5)), b=1, heads=2, dh=8,
                             p=2, q=3),
    "taps_outside": dict(shapes=((6, 10), (3, 5)), b=2, heads=3, dh=4, p=2,
                         q=9, lo=-0.4, hi=1.4),
    "unsorted_queries_dh32": dict(shapes=((5, 7), (3, 3), (2, 1)), b=2,
                                  heads=2, dh=32, p=4, q=11),
}


def _inputs(seed, shapes, b, heads, dh, p, q, lo=0.0, hi=1.0):
    rng = np.random.default_rng(seed)
    hw = sum(h * w for h, w in shapes)
    n_l = len(shapes)
    values = rng.standard_normal((b, hw, heads, dh)).astype(np.float32)
    loc = rng.uniform(lo, hi, (b, q, heads, n_l, p, 2)).astype(np.float32)
    logits = rng.standard_normal((b, q, heads, n_l * p)).astype(np.float32)
    e = np.exp(logits - logits.max(-1, keepdims=True))
    attn = (e / e.sum(-1, keepdims=True)).reshape(b, q, heads, n_l, p)
    return values, shapes, loc, attn.astype(np.float32)


def _port(values, shapes, loc, attn):
    before = TD.ms_deform_attn_slots.launches
    out = TD.ms_deform_attn_slots(torch.from_numpy(values), shapes,
                                  torch.from_numpy(loc),
                                  torch.from_numpy(attn))
    assert TD.ms_deform_attn_slots.launches == before   # CPU: plain version
    return out.numpy()


@pytest.mark.parametrize("name", list(CASES))
def test_plain_matches_reference_xla_path(name):
    values, shapes, loc, attn = _inputs(0, **CASES[name])
    ref = np.asarray(JD.ms_deform_attn_ref(jnp.asarray(values), shapes,
                                           jnp.asarray(loc),
                                           jnp.asarray(attn)))
    out = _port(values, shapes, loc, attn)
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("name", list(CASES))
def test_plain_matches_interpreted_slot_kernel(name):
    values, shapes, loc, attn = _inputs(1, **CASES[name])
    b, hw, heads, dh = values.shape
    values_t = values.transpose(0, 2, 3, 1).reshape(b, heads, dh, hw)
    JD._INTERPRET = True
    try:
        ref = np.asarray(JD._ms_deform_slots_tpu(
            shapes, jnp.asarray(values_t), jnp.asarray(loc),
            jnp.asarray(attn)))
    finally:
        JD._INTERPRET = False
    np.testing.assert_allclose(_port(values, shapes, loc, attn), ref,
                               atol=2e-2, rtol=2e-2)


def test_tap_geometry_matches_reference():
    _, shapes, loc, _ = _inputs(2, **CASES["taps_outside"])
    idx, w = TD.tap_geometry(torch.from_numpy(loc), shapes)
    ridx, rw, _, _ = JD._geometry_batched(jnp.asarray(loc), shapes)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ridx))
    np.testing.assert_allclose(w.numpy(), np.asarray(rw), atol=1e-6)


def test_grid_sample_second_opinion():
    """F.grid_sample (zeros padding, align_corners=False) samples the same
    function, level by level."""
    values, shapes, loc, attn = _inputs(3, **CASES["taps_outside"])
    out = _port(values, shapes, loc, attn)
    b, hw, heads, dh = values.shape
    q, p = loc.shape[1], loc.shape[4]
    v, l, a = (torch.from_numpy(t) for t in (values, loc, attn))
    acc, start = 0, 0
    for li, (h, w) in enumerate(shapes):
        vl = v[:, start:start + h * w].reshape(b, h, w, heads, dh)
        vl = vl.permute(0, 3, 4, 1, 2).reshape(b * heads, dh, h, w)
        g = (l[:, :, :, li] * 2 - 1).permute(0, 2, 1, 3, 4).reshape(
            b * heads, q, p, 2)
        s = torch.nn.functional.grid_sample(
            vl, g, mode="bilinear", padding_mode="zeros",
            align_corners=False).view(b, heads, dh, q, p)
        acc = acc + (s * a[:, :, :, li].permute(0, 2, 1, 3)[:, :, None]
                     ).sum(-1)
        start += h * w
    np.testing.assert_allclose(out, acc.permute(0, 3, 1, 2).numpy(),
                               atol=1e-5, rtol=1e-5)


def test_query_order_does_not_matter():
    values, shapes, loc, attn = _inputs(4, **CASES["unsorted_queries_dh32"])
    perm = np.random.default_rng(0).permutation(loc.shape[1])
    out = _port(values, shapes, loc, attn)
    outp = _port(values, shapes, np.ascontiguousarray(loc[:, perm]),
                 np.ascontiguousarray(attn[:, perm]))
    np.testing.assert_array_equal(outp, out[:, perm])


def test_bf16_values_round_once():
    values, shapes, loc, attn = _inputs(5, **CASES["square_p2"])
    vb = torch.from_numpy(values).bfloat16()
    out = TD.ms_deform_attn_slots(vb, shapes, torch.from_numpy(loc),
                                  torch.from_numpy(attn))
    ref = TD.ms_deform_attn_ref(vb.float(), shapes, torch.from_numpy(loc),
                                torch.from_numpy(attn))
    assert out.dtype == torch.bfloat16
    assert torch.equal(out, ref.bfloat16())


def test_refuses_bad_inputs():
    values, shapes, loc, attn = (torch.from_numpy(t) if isinstance(
        t, np.ndarray) else t for t in _inputs(6, **CASES["square_p2"]))
    with pytest.raises(ValueError, match="shapes"):
        TD.ms_deform_attn_slots(values, ((8, 8), (4, 5)), loc, attn)
    with pytest.raises(ValueError, match="float32 loc"):
        TD.ms_deform_attn_slots(values, shapes, loc.double(), attn)
    with pytest.raises(ValueError, match="contiguous"):
        TD.ms_deform_attn_slots(values.transpose(2, 3).contiguous()
                                .transpose(2, 3), shapes, loc, attn)
    with pytest.raises(ValueError, match="do not match"):
        TD.ms_deform_attn_slots(values, shapes, loc[:, :, :1], attn)
