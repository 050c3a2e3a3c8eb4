"""The sorted-tap generation of multi-scale deformable attention (K5-g2's
module): the port's ``ms_deform_attn`` and ``ms_deform_attn_t`` on the CPU
(the plain gather version, autograd through ``torch.gather``) and its plain
backward ``ms_deform_attn_backward_ref``, forward and three gradients,

* against the reference's f32 ``ms_deform_attn_ref`` and ``jax.grad`` of it
  (1e-5 x max|ref|: the same f32 products, another summation order), and
* against the reference's sorted-tap Pallas kernels in interpret mode,
  ``_ms_deform_attn_tpu`` / ``_ms_deform_attn_tpu_t`` (forward 2e-2,
  gradients 5e-2, each x max|ref|: those kernels cast the values to bf16,
  multiply bf16 one-hots and pack the per-tap scalars into bf16).

Inputs from a numpy seed."""

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
LAYOUTS = ["values", "values_t"]
COUNTERS = (TD.ms_deform_attn_sorted_forward,
            TD.ms_deform_attn_sorted_backward, TD.stamp_scatter)


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


def _to_t(values):
    """numpy (B, HW, heads, dh) -> (B, heads, dh, HW)."""
    return np.ascontiguousarray(values.transpose(0, 2, 3, 1))


def _from_t(values_t):
    return np.ascontiguousarray(values_t.transpose(0, 3, 1, 2))


def _port(layout, values, shapes, loc, attn, dout):
    """The port's entry point for `layout` on the CPU: (out, d values in the
    (B, HW, heads, dh) layout, d loc, d attn) as numpy; launches nothing."""
    before = [f.launches for f in COUNTERS]
    given = _to_t(values) if layout == "values_t" else values
    entry = TD.ms_deform_attn_t if layout == "values_t" else TD.ms_deform_attn
    leaves = [torch.from_numpy(t.copy()).requires_grad_()
              for t in (given, loc, attn)]
    out = entry(leaves[0], shapes, leaves[1], leaves[2])
    assert out.dtype == torch.float32
    out.backward(torch.from_numpy(dout))
    assert [f.launches for f in COUNTERS] == before     # CPU: plain
    dv = leaves[0].grad.numpy()
    assert dv.shape == given.shape
    return (out.detach().numpy(), _from_t(dv) if layout == "values_t" else dv,
            leaves[1].grad.numpy(), leaves[2].grad.numpy())


def _close(out, ref, tol, what):
    assert out.shape == ref.shape, what
    assert np.abs(out - ref).max() <= tol * np.abs(ref).max(), (
        what, np.abs(out - ref).max(), np.abs(ref).max())


def _xla_reference(values, shapes, loc, attn, dout):
    args = (jnp.asarray(values), jnp.asarray(loc), jnp.asarray(attn))
    out = JD.ms_deform_attn_ref(args[0], shapes, args[1], args[2])
    grads = jax.grad(lambda v, l, a: jnp.sum(
        JD.ms_deform_attn_ref(v, shapes, l, a) * dout), argnums=(0, 1, 2))(
        *args)
    return [np.asarray(t) for t in (out, *grads)]


NAMES = ("out", "d values", "d loc", "d attn")


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("name", list(CASES))
def test_entry_points_match_reference_xla_path(name, layout):
    values, shapes, loc, attn, dout = _inputs(0, **CASES[name])
    ref = _xla_reference(values, shapes, loc, attn, dout)
    got = _port(layout, values, shapes, loc, attn, dout)
    for what, g, r in zip(NAMES, got, ref):
        _close(g, r, 1e-5, what)


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("name", list(CASES))
def test_entry_points_match_interpreted_sorted_kernels(name, layout):
    values, shapes, loc, attn, dout = _inputs(1, **CASES[name])
    if layout == "values_t":
        fn, given = JD._ms_deform_attn_tpu_t, _to_t(values)
    else:
        fn, given = JD._ms_deform_attn_tpu, values
    args = (jnp.asarray(given), jnp.asarray(loc), jnp.asarray(attn))
    JD._INTERPRET = True
    try:
        out = fn(shapes, *args)
        dv, dloc, dattn = jax.grad(lambda v, l, a: jnp.sum(
            fn(shapes, v, l, a) * dout), argnums=(0, 1, 2))(*args)
    finally:
        JD._INTERPRET = False
    dv = np.asarray(dv)
    ref = (np.asarray(out), _from_t(dv) if layout == "values_t" else dv,
           np.asarray(dloc), np.asarray(dattn))
    got = _port(layout, values, shapes, loc, attn, dout)
    for what, g, r, tol in zip(NAMES, got, ref, (2e-2, 5e-2, 5e-2, 5e-2)):
        _close(g, r, tol, what)


@pytest.mark.parametrize("name", list(CASES))
def test_plain_backward_matches_jax_grad(name):
    """The written-out plain backward (what the card's kernels are held
    against) equals ``jax.grad`` of the reference."""
    values, shapes, loc, attn, dout = _inputs(2, **CASES[name])
    ref = _xla_reference(values, shapes, loc, attn, dout)[1:]
    got = TD.ms_deform_attn_backward_ref(
        *(torch.from_numpy(t) if isinstance(t, np.ndarray) else t
          for t in (values, shapes, loc, attn, dout)))
    for what, g, r in zip(NAMES[1:], got, ref):
        _close(g.numpy(), r, 1e-5, what)


@pytest.mark.parametrize("name", ["square_p2", "taps_outside"])
def test_geometry_matches_merged_geometry(name):
    _, shapes, loc, _, _ = _inputs(3, **CASES[name])
    got = TD.tap_geometry_full(torch.from_numpy(loc), shapes)
    want = JD._merged_geometry(jnp.asarray(loc), shapes)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    for what, g, w in zip(("w", "dwx", "dwy"), got[1:], want[1:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6,
                                   err_msg=what)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_queries_all_outside_give_no_gradient(layout):
    """A query whose every tap lies outside every map: zero output, zero
    d(loc) and d(attn), and nothing added to d(values)."""
    values, shapes, loc, attn, dout = _inputs(4, **CASES["square_p2"])
    loc[:, 0] = 3.0
    out, dv, dloc, dattn = _port(layout, values, shapes, loc, attn, dout)
    assert not out[:, 0].any()
    assert not dloc[:, 0].any() and not dattn[:, 0].any()
    dout0 = dout.copy()
    dout0[:, 0] = 0
    _, dv0, _, _ = _port(layout, values, shapes, loc, attn, dout0)
    np.testing.assert_array_equal(dv, dv0)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_bf16_values_give_f32_out_and_bf16_gradient(layout):
    values, shapes, loc, attn, dout = _inputs(5, **CASES["dh32"])
    vb = torch.from_numpy(values).bfloat16()
    given = TD.values_to_t(vb) if layout == "values_t" else vb
    given = given.clone().requires_grad_()
    entry = TD.ms_deform_attn_t if layout == "values_t" else TD.ms_deform_attn
    out = entry(given, shapes, torch.from_numpy(loc), torch.from_numpy(attn))
    assert out.dtype == torch.float32
    out.backward(torch.from_numpy(dout))
    assert given.grad.dtype == torch.bfloat16
    ref = _xla_reference(vb.float().numpy(), shapes, loc, attn, dout)
    _close(out.detach().numpy(), ref[0], 1e-5, "out")
    dv = given.grad.float()
    dv = TD.values_from_t(dv) if layout == "values_t" else dv
    _close(dv.numpy(), ref[1], 1e-2, "d values")


def test_layout_helpers_round_trip():
    values = torch.from_numpy(_inputs(6, **CASES["nonsquare_levels"])[0])
    vt = TD.values_to_t(values)
    b, hw, heads, dh = values.shape
    assert vt.shape == (b, heads, dh, hw) and vt.is_contiguous()
    np.testing.assert_array_equal(vt.numpy(), _to_t(values.numpy()))
    assert torch.equal(TD.values_from_t(vt), values)


def test_card_entries_refuse_the_cpu_and_bad_layouts():
    values, shapes, loc, attn, dout = (
        torch.from_numpy(t) if isinstance(t, np.ndarray) else t
        for t in _inputs(7, **CASES["square_p2"]))
    with pytest.raises(ValueError, match="CUDA card"):
        TD.ms_deform_attn_sorted_forward(values, shapes, loc, attn)
    with pytest.raises(ValueError, match="CUDA card"):
        TD.ms_deform_attn_sorted_backward(values, shapes, loc, attn, dout)
    with pytest.raises(ValueError, match="do not match"):
        TD.ms_deform_attn_t(values, shapes, loc, attn)
    with pytest.raises(ValueError, match="contiguous"):
        TD.ms_deform_attn_t(values.permute(0, 2, 3, 1), shapes, loc, attn)
    with pytest.raises(ValueError, match="float32 loc"):
        TD.ms_deform_attn(values.double(), shapes, loc, attn)
