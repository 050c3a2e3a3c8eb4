"""Deformable attention at level and point counts the card's kernels do
not instantiate (more than 4 levels, or L x P > 32), on the CPU.

The reference's entry points take any L and P off the TPU
(``ms_deform_attn_slots`` calls ``ms_deform_attn_ref`` there). The port's
three entry points, ``ms_deform_attn_slots``, ``ms_deform_attn`` and
``ms_deform_attn_t``, run their plain version on CPU tensors at any L and P
too: forward and the three gradients against the reference's f32
``ms_deform_attn_ref`` and ``jax.grad`` of it (1e-5 x max|ref|: the same
f32 products, another summation order). On the card's route the same
shapes are refused before any launch (a recording stand-in for the kernel
library, CPU tensors standing in for the card's). Inputs from a numpy
seed."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
from test_torch_deform_plan import lib  # noqa: F401 (fixture)
from test_torch_front_plan import recorder  # noqa: F401 (fixture)

from robust_object_detection_tpu.ops import deform as JD
from robust_object_detection_tpu_torch.ops import deform as DF

torch.set_num_threads(1)

CASES = {
    # five levels, eight points: L 5 > 4 and L x P = 40 > 32
    "l5_p8": dict(shapes=((8, 8), (4, 4), (2, 2), (2, 1), (1, 1)), b=2,
                  heads=2, dh=8, p=8, q=5),
    # two levels of seventeen points: L x P = 34 > 32
    "l2_p17": dict(shapes=((6, 10), (3, 5)), b=1, heads=3, dh=4, p=17, q=6),
}
ENTRIES = ["slots", "values", "values_t"]
COUNTERS = (DF.ms_deform_attn_slots, DF.ms_deform_attn_backward,
            DF.ms_deform_attn_sorted_forward,
            DF.ms_deform_attn_sorted_backward)


def _inputs(seed, shapes, b, heads, dh, p, q):
    rng = np.random.default_rng(seed)
    hw = sum(h * w for h, w in shapes)
    n_l = len(shapes)
    values = rng.standard_normal((b, hw, heads, dh)).astype(np.float32)
    loc = rng.uniform(-0.1, 1.1, (b, q, heads, n_l, p, 2)).astype(np.float32)
    logits = rng.standard_normal((b, q, heads, n_l * p)).astype(np.float32)
    e = np.exp(logits - logits.max(-1, keepdims=True))
    attn = (e / e.sum(-1, keepdims=True)).reshape(b, q, heads, n_l, p)
    dout = rng.standard_normal((b, q, heads, dh)).astype(np.float32)
    return values, shapes, loc, attn.astype(np.float32), dout


def _entry(name):
    return {"slots": DF.ms_deform_attn_slots, "values": DF.ms_deform_attn,
            "values_t": DF.ms_deform_attn_t}[name]


def _given(name, values):
    if name == "values_t":
        return np.ascontiguousarray(values.transpose(0, 2, 3, 1))
    return values


def _port(name, values, shapes, loc, attn, dout):
    """(out, d values in the (B, HW, heads, dh) layout, d loc, d attn) of
    the port's entry point `name` on the CPU; launches nothing."""
    before = [f.launches for f in COUNTERS]
    leaves = [torch.from_numpy(t.copy()).requires_grad_()
              for t in (_given(name, values), loc, attn)]
    out = _entry(name)(leaves[0], shapes, leaves[1], leaves[2])
    out.backward(torch.from_numpy(dout))
    assert [f.launches for f in COUNTERS] == before
    dv = leaves[0].grad.numpy()
    if name == "values_t":
        dv = np.ascontiguousarray(dv.transpose(0, 3, 1, 2))
    return (out.detach().numpy(), dv, leaves[1].grad.numpy(),
            leaves[2].grad.numpy())


def _xla_reference(values, shapes, loc, attn, dout):
    args = (jnp.asarray(values), jnp.asarray(loc), jnp.asarray(attn))
    out = JD.ms_deform_attn_ref(args[0], shapes, args[1], args[2])
    grads = jax.grad(lambda v, l, a: jnp.sum(
        JD.ms_deform_attn_ref(v, shapes, l, a) * dout), argnums=(0, 1, 2))(
        *args)
    return [np.asarray(t) for t in (out, *grads)]


@pytest.mark.parametrize("entry", ENTRIES)
@pytest.mark.parametrize("case", list(CASES))
def test_cpu_entry_points_take_any_level_and_point_count(case, entry):
    values, shapes, loc, attn, dout = _inputs(0, **CASES[case])
    ref = _xla_reference(values, shapes, loc, attn, dout)
    got = _port(entry, values, shapes, loc, attn, dout)
    for what, g, r in zip(("out", "d values", "d loc", "d attn"), got, ref):
        assert g.shape == r.shape, what
        assert np.abs(g - r).max() <= 1e-5 * np.abs(r).max(), (
            what, np.abs(g - r).max(), np.abs(r).max())


def test_reference_slots_entry_takes_five_levels_off_the_tpu():
    """The reference's own slot entry at L 5, P 8 returns (B, Q, heads,
    dh), as the port's does: the shape is one users may configure."""
    values, shapes, loc, attn, _ = _inputs(1, **CASES["l5_p8"])
    values_t = np.ascontiguousarray(values.transpose(0, 2, 3, 1))
    out = JD.ms_deform_attn_slots(jnp.asarray(values_t), shapes,
                                  jnp.asarray(loc), jnp.asarray(attn))
    port = DF.ms_deform_attn_slots(torch.from_numpy(values), shapes,
                                   torch.from_numpy(loc),
                                   torch.from_numpy(attn))
    assert tuple(out.shape) == tuple(port.shape) == (2, 5, 2, 8)
    np.testing.assert_allclose(port.numpy(), np.asarray(out), rtol=0,
                               atol=1e-5 * np.abs(np.asarray(out)).max())


@pytest.mark.parametrize("route", ["forward", "backward", "sorted_forward",
                                   "sorted_backward"])
@pytest.mark.parametrize("case", list(CASES))
def test_card_route_refuses_before_any_launch(lib, monkeypatch, case,
                                              route):
    values, shapes, loc, attn, dout = _inputs(2, **CASES[case])
    values, loc, attn, dout = (torch.from_numpy(t)
                               for t in (values, loc, attn, dout))
    monkeypatch.setattr(DF, "_require_card", lambda *a: None)
    before = [f.launches for f in COUNTERS]
    with pytest.raises(ValueError, match="at most 4 levels and 32"):
        if route == "forward":
            DF._forward_cuda(values, shapes, loc, attn)
        elif route == "backward":
            DF.ms_deform_attn_backward(values, shapes, loc, attn, dout)
        elif route == "sorted_forward":
            DF.ms_deform_attn_sorted_forward(values, shapes, loc, attn)
        else:
            DF.ms_deform_attn_sorted_backward(values, shapes, loc, attn,
                                              dout)
    assert [f.launches for f in COUNTERS] == before
    assert lib.calls == {}
