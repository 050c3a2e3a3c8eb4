"""Gradients of multi-scale deformable attention (K5 backward's module):
the port's ``ms_deform_attn_slots`` on the CPU (autograd through the plain
gather version) against ``jax.grad`` of the reference's f32
``ms_deform_attn_ref`` (1e-5 x max|ref|: the same f32 products, another
summation order) and against the reference's slot-layout Pallas backward in
interpret mode (3e-2 x max|ref|, the bf16 bar: that kernel multiplies bf16
one-hots and bf16 value tiles). Inputs from a numpy seed."""

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
                             p=2, q=7),
    "taps_outside": dict(shapes=((6, 10), (3, 5)), b=2, heads=3, dh=4, p=2,
                         q=9, lo=-0.4, hi=1.4),
    "dh32": dict(shapes=((5, 7), (3, 3), (2, 1)), b=2, heads=2, dh=32, p=4,
                 q=11),
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
    dout = rng.standard_normal((b, q, heads, dh)).astype(np.float32)
    return values, shapes, loc, attn.astype(np.float32), dout


def _port_grads(values, shapes, loc, attn, dout):
    before = (TD.ms_deform_attn_slots.launches,
              TD.ms_deform_attn_backward.launches)
    leaves = [torch.from_numpy(t.copy()).requires_grad_()
              for t in (values, loc, attn)]
    TD.ms_deform_attn_slots(leaves[0], shapes, leaves[1], leaves[2]).backward(
        torch.from_numpy(dout))
    assert (TD.ms_deform_attn_slots.launches,
            TD.ms_deform_attn_backward.launches) == before   # CPU: plain
    return [t.grad.numpy() for t in leaves]


def _close(out, ref, tol, what):
    assert out.shape == ref.shape
    assert np.abs(out - ref).max() <= tol * np.abs(ref).max(), (
        what, np.abs(out - ref).max(), np.abs(ref).max())


@pytest.mark.parametrize("name", list(CASES))
def test_gradients_match_reference_xla_path(name):
    values, shapes, loc, attn, dout = _inputs(0, **CASES[name])
    ref = jax.grad(lambda v, l, a: jnp.sum(
        JD.ms_deform_attn_ref(v, shapes, l, a) * dout), argnums=(0, 1, 2))(
        jnp.asarray(values), jnp.asarray(loc), jnp.asarray(attn))
    got = _port_grads(values, shapes, loc, attn, dout)
    for what, g, r in zip(("values", "loc", "attn"), got, ref):
        _close(g, np.asarray(r), 1e-5, what)


@pytest.mark.parametrize("name", list(CASES))
def test_gradients_match_interpreted_slot_backward(name):
    values, shapes, loc, attn, dout = _inputs(1, **CASES[name])
    b, hw, heads, dh = values.shape
    values_t = values.transpose(0, 2, 3, 1).reshape(b, heads, dh, hw)
    JD._INTERPRET = True
    try:
        dvt, dloc, dattn = jax.grad(lambda v, l, a: jnp.sum(
            JD._ms_deform_slots_tpu(shapes, v, l, a) * dout),
            argnums=(0, 1, 2))(jnp.asarray(values_t), jnp.asarray(loc),
                               jnp.asarray(attn))
    finally:
        JD._INTERPRET = False
    dv = np.asarray(dvt).reshape(b, heads * dh, hw).transpose(0, 2, 1
                                                              ).reshape(
        b, hw, heads, dh)
    got = _port_grads(values, shapes, loc, attn, dout)
    for what, g, r in zip(("values", "loc", "attn"), got,
                          (dv, np.asarray(dloc), np.asarray(dattn))):
        _close(g, r, 3e-2, what)


def test_taps_outside_the_map_give_no_gradient():
    """A query whose every tap lies outside gets zero d(loc) and d(attn),
    and gives nothing to d(values)."""
    values, shapes, loc, attn, dout = _inputs(2, **CASES["square_p2"])
    loc[:, 0] = 3.0
    dv, dloc, dattn = _port_grads(values, shapes, loc, attn, dout)
    assert not dloc[:, 0].any() and not dattn[:, 0].any()
    dout0 = dout.copy()
    dout0[:, 0] = 0
    dv0, _, _ = _port_grads(values, shapes, loc, attn, dout0)
    np.testing.assert_array_equal(dv, dv0)


def test_query_order_does_not_matter_for_dloc_and_dattn():
    values, shapes, loc, attn, dout = _inputs(3, **CASES["dh32"])
    perm = np.random.default_rng(0).permutation(loc.shape[1])
    _, dloc, dattn = _port_grads(values, shapes, loc, attn, dout)
    _, dlocp, dattnp = _port_grads(
        values, shapes, *(np.ascontiguousarray(t[:, perm])
                          for t in (loc, attn, dout)))
    np.testing.assert_array_equal(dlocp, dloc[:, perm])
    np.testing.assert_array_equal(dattnp, dattn[:, perm])


def test_bf16_values_get_bf16_gradients():
    values, shapes, loc, attn, dout = _inputs(4, **CASES["square_p2"])
    v = torch.from_numpy(values).bfloat16().requires_grad_()
    TD.ms_deform_attn_slots(v, shapes, torch.from_numpy(loc),
                            torch.from_numpy(attn)).backward(
        torch.from_numpy(dout).bfloat16())
    assert v.grad.dtype == torch.bfloat16
    ref, _, _ = _port_grads(v.detach().float().numpy(), shapes, loc, attn,
                            torch.from_numpy(dout).bfloat16().float().numpy())
    _close(v.grad.float().numpy(), ref, 2e-2, "values")


def test_backward_entry_refuses_the_cpu():
    values, shapes, loc, attn, dout = (
        torch.from_numpy(t) if isinstance(t, np.ndarray) else t
        for t in _inputs(5, **CASES["square_p2"]))
    with pytest.raises(ValueError, match="CUDA card"):
        TD.ms_deform_attn_backward(values, shapes, loc, attn, dout)
