"""Port image + corruption ops against the reference JAX ops.

Same uint8-valued f32 inputs from a seed on both sides. After quantisation
the outputs must be equal, or differ by 1 LSB on at most 0.1% of pixels:
the two frameworks may sum a filter's taps in another f32 order, and that
can move a value across an exact .5 tie of the rounding. Noise is compared
through host-drawn planes (the fused sweep's host_noise mode), since the
two PRNGs differ by design.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from robust_object_detection_tpu.core.config import CorruptionConfig as JCfg
from robust_object_detection_tpu.ops import corrupt as jc
from robust_object_detection_tpu.ops import image as ji
from robust_object_detection_tpu_torch.core.config import CorruptionConfig
from robust_object_detection_tpu_torch.ops import corrupt as tc
from robust_object_detection_tpu_torch.ops import image as ti

torch.set_num_threads(1)


def _img(seed, shape=(2, 24, 34, 3)):
    rng = np.random.RandomState(seed)
    return rng.randint(0, 256, shape).astype(np.float32)


def _assert_lsb(out, ref):
    diff = np.abs(np.asarray(out, np.float64) - np.asarray(ref, np.float64))
    assert diff.max() <= 1.0
    assert (diff > 0).mean() <= 1e-3


def test_config_matches_reference():
    assert CorruptionConfig() == CorruptionConfig(**vars(JCfg()))


@pytest.mark.parametrize("angle", [0.0, 30.0])
def test_motion_blur_kernel_equal(angle):
    np.testing.assert_array_equal(tc.motion_blur_kernel(9, angle),
                                  jc.motion_blur_kernel(9, angle))


@pytest.mark.parametrize("angle", [0.0, 45.0])
def test_motion_blur(angle):
    x = _img(0)
    ref = jc.apply_motion_blur(jnp.asarray(x), 9, angle)
    out = tc.apply_motion_blur(torch.from_numpy(x), 9, angle)
    _assert_lsb(out.numpy(), ref)
    raw = tc.apply_motion_blur(torch.from_numpy(x[0]), 9, angle,
                               quantize=False)
    raw_ref = jc.apply_motion_blur(jnp.asarray(x[0]), 9, angle,
                                   quantize=False)
    np.testing.assert_allclose(raw.numpy(), raw_ref, atol=1e-3)


def test_lowres():
    x = _img(1)
    ref = jc.apply_lowres(jnp.asarray(x))
    out = tc.apply_lowres(torch.from_numpy(x))
    _assert_lsb(out.numpy(), ref)


@pytest.mark.parametrize("hw,size", [((24, 34), 64), ((48, 30), 40)])
def test_letterbox(hw, size):
    x = _img(2, (2, *hw, 3))
    ref, rs, rhw = ji.letterbox(jnp.asarray(x), size)
    out, s, ohw = ti.letterbox(torch.from_numpy(x), size)
    assert (s, ohw) == (rs, rhw)
    # f32 on [0, 255]: XLA may contract a*(1-f) + b*f into FMAs, a few
    # ulp (~1e-5 relative) away from torch's separate multiply and add
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-3, rtol=0)
    _assert_lsb(ti.quantize_round_half_up(out).numpy(),
                ji.quantize_round_half_up(ref))


def test_pad_and_area_downsample():
    x = _img(3)
    np.testing.assert_array_equal(
        ti.pad_reflect101(torch.from_numpy(x), 3, 5).numpy(),
        ji.pad_reflect101(jnp.asarray(x), 3, 5))
    np.testing.assert_array_equal(
        ti.area_downsample_2x(torch.from_numpy(x)).numpy(),
        ji.area_downsample_2x(jnp.asarray(x)))


def test_quantisers_equal_on_ties():
    v = np.array([-3.5, -0.5, 0.5, 1.5, 2.5, 127.5, 254.5, 255.5, 300.2,
                  3.49999, 7.0], np.float32)
    for t, j in ((ti.quantize_round, ji.quantize_round),
                 (ti.quantize_round_half_up, ji.quantize_round_half_up),
                 (ti.quantize_trunc, ji.quantize_trunc)):
        np.testing.assert_array_equal(t(torch.from_numpy(v)).numpy(),
                                      j(jnp.asarray(v)))


def test_noise_through_host_planes():
    x = _img(4)
    noise = np.random.RandomState(5).normal(0, 15, x.shape).astype(np.float32)
    np.testing.assert_array_equal(
        ti.quantize_trunc(torch.from_numpy(x + noise)).numpy(),
        ji.quantize_trunc(jnp.asarray(x) + jnp.asarray(noise)))


def test_device_noise_statistics():
    """The torch.Generator stream: right sigma, clipped and truncated."""
    x = torch.full((1, 64, 64, 3), 128.0)
    g = torch.Generator().manual_seed(0)
    out = tc.apply_noise(x, g, 15.0)
    assert torch.equal(out, out.floor())
    assert abs((out - x).std().item() - 15.0) < 0.5


def test_corrupt_variant_selects_per_image():
    x = _img(6, (3, 16, 20, 3))
    g = torch.Generator().manual_seed(0)
    out = tc.corrupt_variant(torch.from_numpy(x), torch.tensor([0, 2, 3]), g)
    ref = jc.corrupt_variant(jnp.asarray(x), jnp.asarray([0, 2, 3]),
                             __import__("jax").random.key(0))
    _assert_lsb(out.numpy(), ref)


@pytest.mark.parametrize("shape,out_hw", [((2, 24, 34, 3), (12, 17)),
                                          ((37, 51, 3), (18, 25)),
                                          ((2, 30, 45, 3), (11, 7))])
def test_resize_area_matches_reference(shape, out_hw):
    """INTER_AREA at any scale (the testset builder's LowRes at odd sizes):
    f32 within 1e-3 before rounding, within 1 LSB after."""
    x = _img(7, shape)
    out = ti.resize_area(torch.from_numpy(x), *out_hw).numpy()
    ref = np.asarray(ji.resize_area(jnp.asarray(x), *out_hw))
    assert out.shape == ref.shape == shape[:-3] + out_hw + (3,)
    np.testing.assert_allclose(out, ref, atol=1e-3, rtol=0)
    _assert_lsb(ti.quantize_round_half_up(torch.from_numpy(out)).numpy(),
                ji.quantize_round_half_up(ref))


@pytest.mark.parametrize("shape", [(2, 24, 34, 3), (37, 51, 3), (5, 7, 3),
                                   (1, 32, 48, 3)])
def test_pad_to_multiple_matches_reference(shape):
    x = _img(8, shape)
    for multiple in (16, 4):
        np.testing.assert_array_equal(
            ti.pad_to_multiple(torch.from_numpy(x), multiple).numpy(),
            ji.pad_to_multiple(jnp.asarray(x), multiple))
