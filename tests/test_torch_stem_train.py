"""The train-mode HGNetv2 stem (K4-f train / K4-b's module): the port's
``stem_fused`` on the CPU (its plain version, whose backward is autograd)
against the reference's ``pallas_stem.stem_fused`` in interpret mode (its
Pallas forward and its hand-written Pallas backward), at (2, 64, 256), f32,
inputs from a numpy seed.

Tolerances: both sides fold every BN into g*y + b, so they differ by f32
summation order only: y3 within 1e-4 x max|ref|, the eight batch statistics
within 1e-5 absolute / 1e-4 relative, each of the ten gradients of the loss
of tests/test_pallas_stem.py (which reaches the BN3 statistics cotangents;
a second loss reaches all eight) within 2e-3 x max|ref| (sums over 2 x 32 x
128 pixels through four batch-statistics BNs). Against the flax modules'
XLA path (another association of the BN) the bar is the reference's own:
3e-3 forward, 6e-3 gradients."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from robust_object_detection_tpu.ops import pallas_stem as PS
from robust_object_detection_tpu_torch.ops import stem as TS

torch.set_num_threads(1)

B, H, W, CM = 2, 64, 256, 32


@pytest.fixture(autouse=True)
def interpret_mode(monkeypatch):
    monkeypatch.setattr(PS, "_INTERPRET", True)


@pytest.fixture(scope="module")
def data():
    rng = np.random.RandomState(0)
    x = rng.rand(B, H, W, 3).astype(np.float32)
    params = (
        rng.randn(3, 3, 3, CM) * 0.2, rng.rand(CM) + 0.5,
        rng.randn(CM) * 0.1,
        rng.randn(2, 2, CM, CM // 2) * 0.2, rng.rand(CM // 2) + 0.5,
        rng.randn(CM // 2) * 0.1,
        rng.randn(2, 2, CM // 2, CM) * 0.2, rng.rand(CM) + 0.5,
        rng.randn(CM) * 0.1,
        rng.randn(3, 3, 2 * CM, CM) * 0.1)
    return x, tuple(p.astype(np.float32) for p in params)


def _close(out, ref, tol):
    out, ref = np.asarray(out), np.asarray(ref)
    assert out.shape == ref.shape
    assert np.abs(out - ref).max() <= tol * (np.abs(ref).max() + 1e-12), (
        np.abs(out - ref).max(), np.abs(ref).max())


def _port(x, params):
    before = (TS.stem_fused.launches, TS.stem_fused_backward.launches)
    leaves = [torch.from_numpy(p.copy()).requires_grad_() for p in params]
    out = TS.stem_fused(torch.from_numpy(x), *leaves)
    assert (TS.stem_fused.launches,
            TS.stem_fused_backward.launches) == before   # CPU: plain version
    return out, leaves


def test_forward_matches_interpreted_pallas_stem(data):
    x, params = data
    y3r, mr, vr = PS.stem_fused(jnp.asarray(x),
                                *(jnp.asarray(p) for p in params),
                                dtype=jnp.float32)
    (y3, means, variances), _ = _port(x, params)
    _close(y3.detach().numpy(), y3r, 1e-4)
    assert len(means) == len(variances) == 4
    for i in range(4):
        np.testing.assert_allclose(means[i].detach().numpy(), mr[i],
                                   atol=1e-5, rtol=1e-4)
        np.testing.assert_allclose(variances[i].detach().numpy(), vr[i],
                                   atol=1e-5, rtol=1e-4)


def _jloss(which):
    def loss(y3, m, v):
        w = jnp.arange(y3.size, dtype=jnp.float32).reshape(y3.shape) % 7 - 3
        z = (y3 - m[3]) * jax.lax.rsqrt(v[3] + PS.EPS)
        out = jnp.sum(z * w) + 0.01 * jnp.sum(y3)
        if which == "all_statistics":
            for i in range(4):
                out = out + (i + 1) * (3.0 * jnp.sum(m[i] * m[i])
                                       + 2.0 * jnp.sum(v[i] * v[i]))
        return out
    return loss


def _tloss(which):
    def loss(y3, m, v):
        w = (torch.arange(y3.numel(), dtype=torch.float32).reshape(y3.shape)
             % 7 - 3)
        z = (y3 - m[3]) * torch.rsqrt(v[3] + TS.EPS)
        out = (z * w).sum() + 0.01 * y3.sum()
        if which == "all_statistics":
            for i in range(4):
                out = out + (i + 1) * (3.0 * (m[i] * m[i]).sum()
                                       + 2.0 * (v[i] * v[i]).sum())
        return out
    return loss


@pytest.mark.parametrize("which", ["reference_test_loss", "all_statistics"])
def test_gradients_match_interpreted_pallas_backward(data, which):
    x, params = data
    jparams = tuple(jnp.asarray(p) for p in params)
    gr = jax.grad(lambda p: _jloss(which)(*PS.stem_fused(
        jnp.asarray(x), *p, dtype=jnp.float32)))(jparams)
    out, leaves = _port(x, params)
    _tloss(which)(*out).backward()
    for i, (leaf, r) in enumerate(zip(leaves, gr)):
        assert leaf.grad is not None, i
        _close(leaf.grad.numpy(), r, 2e-3)


def test_matches_the_unfused_xla_stem(data):
    """The chain written with flax's BN association, as
    tests/test_pallas_stem.py writes it."""
    x, params = data

    def conv(a, k, stride, pad):
        return jax.lax.conv_general_dilated(
            a, k, (stride, stride), pad,
            dimension_numbers=("NHWC", "HWIO", "NHWC"))

    def reference(p):
        (k1, sc1, bi1, k2a, sc2a, bi2a, k2b, sc2b, bi2b, k3) = p

        def bn_relu(y, sc, bi):
            m = y.mean((0, 1, 2))
            v = jnp.maximum(0.0, (y * y).mean((0, 1, 2)) - m * m)
            return jnp.maximum(
                (y - m) * jax.lax.rsqrt(v + PS.EPS) * sc + bi, 0.0), m, v

        xj = jnp.asarray(x)
        a1, m1, v1 = bn_relu(conv(xj, k1, 2, ((1, 1), (1, 1))), sc1, bi1)
        pz = ((0, 0), (0, 1), (0, 1), (0, 0))
        a2a, m2a, v2a = bn_relu(conv(jnp.pad(a1, pz), k2a, 1,
                                     ((0, 0), (0, 0))), sc2a, bi2a)
        a2b, m2b, v2b = bn_relu(conv(jnp.pad(a2a, pz), k2b, 1,
                                     ((0, 0), (0, 0))), sc2b, bi2b)
        hh, ww = a1.shape[1], a1.shape[2]
        ap = jnp.pad(a1, pz)
        pool = jnp.maximum(jnp.maximum(ap[:, :hh, :ww], ap[:, 1:, :ww]),
                           jnp.maximum(ap[:, :hh, 1:], ap[:, 1:, 1:]))
        y3 = conv(jnp.concatenate([pool, a2b], -1), k3, 2, ((1, 1), (1, 1)))
        m3 = y3.mean((0, 1, 2))
        v3 = jnp.maximum(0.0, (y3 * y3).mean((0, 1, 2)) - m3 * m3)
        return y3, (m1, m2a, m2b, m3), (v1, v2a, v2b, v3)

    jparams = tuple(jnp.asarray(p) for p in params)
    y3r, _, _ = reference(jparams)
    gr = jax.grad(lambda p: _jloss("reference_test_loss")(*reference(p)))(
        jparams)
    out, leaves = _port(x, params)
    _close(out[0].detach().numpy(), y3r, 3e-3)
    _tloss("reference_test_loss")(*out).backward()
    for leaf, r in zip(leaves, gr):
        _close(leaf.grad.numpy(), r, 6e-3)


def test_bf16_rounds_where_the_kernels_do(data):
    """bf16: y3 is bf16, the statistics f32 and those of the rounded
    tensors; float32 master filters are cast for the convs."""
    x, params = data
    leaves = [torch.from_numpy(p.copy()) for p in params]
    y3, means, variances = TS.stem_fused(torch.from_numpy(x).bfloat16(),
                                         *leaves)
    assert y3.dtype == torch.bfloat16
    assert all(t.dtype == torch.float32 for t in (*means, *variances))
    m3 = y3.float().mean((0, 1, 2))
    np.testing.assert_allclose(means[3].numpy(), m3.numpy(), atol=1e-6)
    ref, _, _ = TS.stem_fused(torch.from_numpy(x), *leaves)
    _close(y3.float().numpy(), ref.numpy(), 5e-2)


def test_refuses_bad_inputs(data):
    x, params = data
    leaves = [torch.from_numpy(p.copy()) for p in params]
    xt = torch.from_numpy(x)
    with pytest.raises(ValueError, match="multiples of 4"):
        TS.stem_fused(xt[:, :62], *leaves)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        TS.stem_fused(xt.double(), *leaves)
    with pytest.raises(ValueError, match="HWIO filters"):
        TS.stem_fused(xt, leaves[0][..., :16], *leaves[1:])
    with pytest.raises(ValueError, match="BN vectors"):
        TS.stem_fused(xt, leaves[0], leaves[1][:8], *leaves[2:])
    with pytest.raises(ValueError, match="CUDA card"):
        TS.stem_fused_backward(*([xt] * 13), xt, (None,) * 4, (None,) * 4)
