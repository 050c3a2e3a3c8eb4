"""One level's bilinear sampling with the stamp-scatter backward (K5-g1's
module): the port's ``bilinear_sample`` on the CPU, forward and three
gradients, against the reference's ``bilinear_sample`` and ``jax.grad`` of
it (1e-5 x max|ref|: the same f32 products, another summation order), and
``stamp_scatter_ref`` against the reference's ``_stamp_scatter`` and a numpy
loop. The reference's Pallas stamp-scatter kernel has no interpret mode, so
on the CPU both sides run their plain versions (the reference's own tests
hold it the same way). Inputs from a numpy seed."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from robust_object_detection_tpu.ops import deform as JD
from robust_object_detection_tpu_torch.ops import deform as TD

torch.set_num_threads(1)

CASES = {
    "small": dict(b=2, h=6, w=5, heads=3, dh=4, q=7, p=2),
    "wide": dict(b=1, h=3, w=17, heads=2, dh=8, q=9, p=4),
    "one_cell": dict(b=1, h=1, w=1, heads=1, dh=3, q=5, p=1),
    "dh32": dict(b=2, h=9, w=8, heads=2, dh=32, q=11, p=4),
}


def _inputs(seed, b, h, w, heads, dh, q, p):
    """Samples inside the map, near its edges and outside it."""
    rng = np.random.default_rng(seed)
    v = rng.standard_normal((b, h, w, heads, dh)).astype(np.float32)
    sx = rng.uniform(-1.5, w + 1.0, (b, q, heads, p)).astype(np.float32)
    sy = rng.uniform(-1.5, h + 1.0, (b, q, heads, p)).astype(np.float32)
    cot = rng.standard_normal((b, q, heads, p, dh)).astype(np.float32)
    return v, sx, sy, cot


def _port(v, sx, sy, cot):
    before = TD.stamp_scatter.launches
    leaves = [torch.from_numpy(t.copy()).requires_grad_()
              for t in (v, sx, sy)]
    out = TD.bilinear_sample(*leaves)
    out.backward(torch.from_numpy(cot))
    assert TD.stamp_scatter.launches == before          # CPU: plain
    return [out.detach().numpy()] + [t.grad.numpy() for t in leaves]


def _close(out, ref, tol, what):
    assert out.shape == ref.shape, what
    assert np.abs(out - ref).max() <= tol * max(np.abs(ref).max(), 1e-30), (
        what, np.abs(out - ref).max(), np.abs(ref).max())


@pytest.mark.parametrize("name", list(CASES))
def test_forward_and_gradients_match_reference(name):
    v, sx, sy, cot = _inputs(0, **CASES[name])
    args = tuple(jnp.asarray(t) for t in (v, sx, sy))
    ref = [JD.bilinear_sample(*args)]
    ref += jax.grad(lambda a, x, y: jnp.sum(JD.bilinear_sample(a, x, y)
                                            * cot), argnums=(0, 1, 2))(*args)
    got = _port(v, sx, sy, cot)
    for what, g, r in zip(("out", "d v", "d sx", "d sy"), got, ref):
        _close(g, np.asarray(r), 1e-5, what)


@pytest.mark.parametrize("name", list(CASES))
def test_geometry_matches_reference(name):
    c = CASES[name]
    _, sx, sy, _ = _inputs(1, **c)
    got = TD._pixel_taps(torch.from_numpy(sx), torch.from_numpy(sy), c["h"],
                         c["w"])
    want = JD._tap_geometry(jnp.asarray(sx), jnp.asarray(sy), c["h"], c["w"])
    np.testing.assert_array_equal(got[0].numpy(),
                                  np.stack([np.asarray(t) for t in want[0]],
                                           -1))
    for what, g, w in zip(("w", "dwx", "dwy"), got[1:], want[1:]):
        np.testing.assert_allclose(
            g.numpy(), np.stack([np.asarray(t) for t in w], -1), atol=1e-6,
            err_msg=what)


STAMP_CASES = [(2, 3, 4, 11, 13), (1, 2, 32, 48, 5), (2, 1, 8, 1, 40),
               (1, 1, 3, 64, 1)]


@pytest.mark.parametrize("case", STAMP_CASES)
def test_stamp_scatter_matches_reference_and_numpy(case):
    b, heads, dh, t, hw = case
    rng = np.random.default_rng(2)
    idx = rng.integers(0, hw, (b, heads, t)).astype(np.int32)
    gw = rng.standard_normal((b, heads, dh, t)).astype(np.float32)
    before = TD.stamp_scatter.launches
    out = TD.stamp_scatter(torch.from_numpy(idx), torch.from_numpy(gw), hw)
    assert TD.stamp_scatter.launches == before
    assert out.shape == (b, heads, dh, hw) and out.dtype == torch.float32
    assert out.is_contiguous()
    expect = np.zeros((b, heads, dh, hw), np.float32)
    for bi in range(b):
        for hi in range(heads):
            for ti in range(t):
                expect[bi, hi, :, idx[bi, hi, ti]] += gw[bi, hi, :, ti]
    _close(out.numpy(), expect, 1e-5, "numpy loop")
    ref = JD._stamp_scatter(jnp.asarray(idx), jnp.asarray(gw), hw)
    _close(out.numpy(), np.asarray(ref), 1e-5, "reference")
    again = TD.stamp_scatter(torch.from_numpy(idx).long(),
                             torch.from_numpy(gw), hw)
    assert torch.equal(again, out)


@pytest.mark.parametrize("name", ["p3", "nonsquare", "outside"])
def test_per_level_composition_equals_the_merged_op(name):
    """ms_deform_attn, forward and three gradients, equals the sum over
    levels of attention-weighted bilinear_sample outputs: the model's path
    before the levels were merged into one op."""
    shapes, lo, hi = {"p3": (((8, 8), (4, 4), (2, 2)), -0.2, 1.2),
                      "nonsquare": (((6, 10), (3, 5)), 0.0, 1.0),
                      "outside": (((5, 7), (3, 3)), -0.6, 1.6)}[name]
    rng = np.random.default_rng(3)
    b, q, heads, dh, p = 2, 7, 2, 8, 3
    n_l = len(shapes)
    hw = sum(h * w for h, w in shapes)
    values = torch.from_numpy(rng.standard_normal(
        (b, hw, heads, dh)).astype(np.float32))
    loc = torch.from_numpy(rng.uniform(
        lo, hi, (b, q, heads, n_l, p, 2)).astype(np.float32))
    attn = torch.softmax(torch.from_numpy(rng.standard_normal(
        (b, q, heads, n_l * p)).astype(np.float32)), -1).reshape(
        b, q, heads, n_l, p)
    dout = torch.from_numpy(rng.standard_normal(
        (b, q, heads, dh)).astype(np.float32))

    merged = [t.clone().requires_grad_() for t in (values, loc, attn)]
    ref = TD.ms_deform_attn(merged[0], shapes, merged[1], merged[2])
    ref.backward(dout)

    leaves = [t.clone().requires_grad_() for t in (values, loc, attn)]
    out, off = 0, 0
    for l, (h, w) in enumerate(shapes):
        v = leaves[0][:, off:off + h * w].reshape(b, h, w, heads, dh)
        sampled = TD.bilinear_sample(v, leaves[1][..., l, :, 0] * w - 0.5,
                                     leaves[1][..., l, :, 1] * h - 0.5)
        out = out + (sampled * leaves[2][..., l, :, None]).sum(-2)
        off += h * w
    out.backward(dout)
    _close(out.detach().numpy(), ref.detach().numpy(), 1e-5, "out")
    for what, g, r in zip(("d values", "d loc", "d attn"), leaves, merged):
        _close(g.grad.numpy(), r.grad.numpy(), 1e-5, what)


def test_samples_all_outside_give_zero_output_and_gradients():
    v, sx, sy, cot = _inputs(4, **CASES["small"])
    sx[:] = -7.0
    out, dv, dsx, dsy = _port(v, sx, sy, cot)
    assert not out.any() and not dv.any()
    assert not dsx.any() and not dsy.any()


def test_bf16_map_gets_a_bf16_gradient():
    v, sx, sy, cot = _inputs(5, **CASES["dh32"])
    vb = torch.from_numpy(v).bfloat16().requires_grad_()
    out = TD.bilinear_sample(vb, torch.from_numpy(sx), torch.from_numpy(sy))
    assert out.dtype == torch.float32        # bf16 map x f32 weights
    out.backward(torch.from_numpy(cot))
    assert vb.grad.dtype == torch.bfloat16
    ref = _port(vb.detach().float().numpy(), sx, sy, cot)
    _close(out.detach().numpy(), ref[0], 1e-6, "out")
    _close(vb.grad.float().numpy(), ref[1], 1e-2, "d v")


def test_bad_inputs_are_refused():
    v, sx, sy, _ = (torch.from_numpy(t) for t in _inputs(6, **CASES["small"]))
    with pytest.raises(ValueError, match="takes v"):
        TD.bilinear_sample(v[0], sx, sy)
    with pytest.raises(ValueError, match="takes v"):
        TD.bilinear_sample(v, sx[:, :, :2], sy[:, :, :2])
    with pytest.raises(ValueError, match="float32 sx"):
        TD.bilinear_sample(v, sx.double(), sy.double())
    idx = torch.zeros(1, 2, 5, dtype=torch.int32)
    gw = torch.zeros(1, 2, 8, 5)
    with pytest.raises(ValueError, match="float32 gw"):
        TD.stamp_scatter(idx, gw.double(), 16)
    with pytest.raises(ValueError, match="int32 or int64 idx"):
        TD.stamp_scatter(idx.float(), gw, 16)
    with pytest.raises(ValueError, match="hw > 0"):
        TD.stamp_scatter(idx, gw, 0)
    with pytest.raises(ValueError, match="contiguous"):
        TD.stamp_scatter(idx, torch.zeros(1, 2, 8, 10)[..., ::2], 16)
    # the transpose of a contiguous (B, heads, T, dh) is read in place
    assert torch.equal(
        TD.stamp_scatter(idx, gw.transpose(2, 3).contiguous().transpose(2, 3),
                         16), TD.stamp_scatter(idx, gw, 16))
