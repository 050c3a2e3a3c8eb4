"""The port's SSIM / PSNR / restoration loss (ops/ssim.py) against the
reference's ops/ssim.py on the same f32 inputs: values at 1e-6 (relative
for PSNR, whose mean square error is summed in another order), the 100 dB
case, a near-constant image against float64, and the loss's gradient
against jax.grad at 1e-5 x max|ref| (the reference's f32 window sums in
another order, and the variance terms cancel in the gradient too). The window is a symmetric
11 x 11 gaussian applied as shifted multiply-adds; its adjoint is checked
in float64 by torch.autograd.gradcheck."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robust_object_detection_tpu.ops import ssim as JS
from robust_object_detection_tpu_torch.ops import ssim as TS

torch.set_num_threads(1)


def _pair(seed, shape=(2, 40, 56, 3)):
    rng = np.random.RandomState(seed)
    a = rng.rand(*shape).astype(np.float32)
    b = np.clip(a + 0.1 * rng.randn(*shape), 0, 1).astype(np.float32)
    return a, b


def test_gaussian_window_matches_reference():
    np.testing.assert_array_equal(TS.gaussian_window(), JS.gaussian_window())
    np.testing.assert_array_equal(TS.gaussian_window(7, 1.0),
                                  JS.gaussian_window(7, 1.0))


@pytest.mark.parametrize("seed", [0, 1])
def test_ssim_psnr_loss_match_reference(seed):
    a, b = _pair(seed)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    assert abs(float(TS.ssim(ta, tb)) - float(JS.ssim(ja, jb))) <= 1e-6
    np.testing.assert_allclose(float(TS.psnr(ta, tb)), float(JS.psnr(ja, jb)),
                               rtol=1e-6)
    assert abs(float(TS.restoration_loss(ta, tb))
               - float(JS.restoration_loss(ja, jb))) <= 1e-6
    assert abs(float(TS.restoration_loss(ta, tb, 0.7))
               - float(JS.restoration_loss(ja, jb, 0.7))) <= 1e-6


def test_identity_and_100db():
    a, _ = _pair(2)
    t = torch.from_numpy(a)
    assert float(TS.psnr(t, t)) == 100.0 == float(JS.psnr(a, a))
    assert abs(float(TS.ssim(t, t)) - 1.0) <= 1e-6
    assert abs(float(TS.restoration_loss(t, t))) <= 1e-6


def _ssim_float64(a, b):
    """SSIM in float64 with the same f32 window, by scipy's correlate2d
    (zero padding, 'same' size)."""
    from scipy.signal import correlate2d
    w = JS.gaussian_window().astype(np.float64)
    a, b = a.astype(np.float64), b.astype(np.float64)

    def win(x):
        return np.stack([np.stack([correlate2d(x[n, :, :, c], w, mode="same")
                                   for c in range(x.shape[-1])], -1)
                         for n in range(x.shape[0])])
    mu1, mu2 = win(a), win(b)
    s1, s2 = win(a * a) - mu1 ** 2, win(b * b) - mu2 ** 2
    s12 = win(a * b) - mu1 * mu2
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    return float((((2 * mu1 * mu2 + c1) * (2 * s12 + c2))
                  / ((mu1 ** 2 + mu2 ** 2 + c1) * (s1 + s2 + c2))).mean())


@pytest.mark.parametrize("seed", [3, 4])
def test_near_constant_image_against_float64(seed):
    """An image near 0.9 with small noise: sigma^2 ~ 4e-4 against E[x^2] ~
    0.81, where the variance terms cancel (the case the window must not
    run in TF32 for). The port accumulates the window in float64, so it
    is held against a float64 SSIM at 1e-6 (the reference's f32 conv
    lands within a few 1e-7 of it, checked beside)."""
    rng = np.random.RandomState(seed)
    a = (0.9 + 0.02 * rng.randn(1, 64, 64, 3)).astype(np.float32)
    b = (a + 0.01 * rng.randn(*a.shape)).astype(np.float32)
    ref = _ssim_float64(a, b)
    got = float(TS.ssim(torch.from_numpy(a), torch.from_numpy(b)))
    assert abs(got - ref) <= 1e-6
    assert abs(float(JS.ssim(jnp.asarray(a), jnp.asarray(b))) - ref) <= 2e-6


def test_loss_gradient_matches_reference():
    a, b = _pair(4, (2, 24, 32, 3))
    ta = torch.from_numpy(a).requires_grad_(True)
    TS.restoration_loss(ta, torch.from_numpy(b)).backward()
    ref = np.asarray(jax.grad(JS.restoration_loss)(jnp.asarray(a),
                                                   jnp.asarray(b)))
    np.testing.assert_allclose(ta.grad.numpy(), ref,
                               atol=1e-5 * np.abs(ref).max(), rtol=0)


def test_window_adjoint_gradcheck():
    x = torch.rand(1, 7, 9, 2, dtype=torch.float64, requires_grad=True)
    w = TS.gaussian_window(5, 1.0).astype(np.float64)
    assert torch.autograd.gradcheck(lambda t: TS._Window.apply(t, w), (x,))
