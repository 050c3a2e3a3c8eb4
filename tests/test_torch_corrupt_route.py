"""The trainers' corruption route (ops/corrupt.random_corruption_fast)
against the reference's ``random_corruption_fast`` and ``corrupt_variant``.

The route takes K1 (ops/fused_corrupt) where K1 computes the configuration
(blur angle 0, odd kernel, lowres 0.5x, even H, W >= 8) and the op-by-op
ops otherwise. Its blur and lowres images are held against JAX's
``corrupt_variant`` at tests/test_torch_corrupt.py's tolerance (1 LSB on
at most 0.1% of the pixels); its noise images against K1's plain version
bit for bit, since the two PRNGs differ by design and the route draws the
kernel's per-image normal for each seed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robust_object_detection_tpu.core.config import CorruptionConfig as JCfg
from robust_object_detection_tpu.ops import corrupt as jc
from robust_object_detection_tpu_torch.core.config import CorruptionConfig
from robust_object_detection_tpu_torch.ops import corrupt as tc
from robust_object_detection_tpu_torch.ops import fused_corrupt as FC

torch.set_num_threads(1)

CHOICE = torch.tensor([tc.CLEAN, tc.NOISE, tc.BLUR, tc.LOWRES],
                      dtype=torch.int32)
SEEDS = torch.tensor([101, 202, 303, 404], dtype=torch.int32)


def _img(seed, shape=(4, 24, 34, 3)):
    return np.random.RandomState(seed).randint(0, 256, shape).astype(
        np.float32)


def _assert_lsb(out, ref):
    diff = np.abs(np.asarray(out, np.float64) - np.asarray(ref, np.float64))
    assert diff.max() <= 1.0
    assert (diff > 0).mean() <= 1e-3


def _spy_k1(monkeypatch):
    calls = []
    real = FC.fused_random_corruption

    def spy(*a, **k):
        calls.append(a[0].shape)
        return real(*a, **k)
    monkeypatch.setattr(FC, "fused_random_corruption", spy)
    return calls


@pytest.mark.parametrize("k", [9, 15])
@pytest.mark.parametrize("angle", [15.0, 45.0, 90.0])
def test_op_route_matches_reference(angle, k, monkeypatch):
    calls = _spy_k1(monkeypatch)
    x = _img(int(angle) + k)
    cfg = CorruptionConfig(blur_kernel=k, blur_angle_deg=angle)
    out, choice = tc.random_corruption_fast(torch.from_numpy(x), None, cfg,
                                            CHOICE, SEEDS)
    assert calls == [] and torch.equal(choice, CHOICE)
    ref = np.asarray(jc.corrupt_variant(
        jnp.asarray(x), jnp.asarray(CHOICE.numpy()), jax.random.key(0),
        JCfg(blur_kernel=k, blur_angle_deg=angle)))
    np.testing.assert_array_equal(out[0].numpy(), x[0])
    _assert_lsb(out[2].numpy(), ref[2])
    _assert_lsb(out[3].numpy(), ref[3])
    k1 = FC.fused_corruption_reference(torch.from_numpy(x), CHOICE, SEEDS)
    assert torch.equal(out[1], k1[1])
    assert not torch.equal(out[2], k1[2])     # not K1's 0-degree blur


def test_angle_0_is_k1(monkeypatch):
    """At angle 0 the route is K1, bit for bit, through K1's entry; at 45
    the entry is not called."""
    x = torch.from_numpy(_img(1))
    want, _ = FC.fused_random_corruption(x, None, CorruptionConfig(),
                                         CHOICE, SEEDS)
    calls = _spy_k1(monkeypatch)
    out, choice = tc.random_corruption_fast(x, None, CorruptionConfig(),
                                            CHOICE, SEEDS)
    assert len(calls) == 1 and torch.equal(out, want)
    assert torch.equal(choice, CHOICE)
    tc.random_corruption_fast(x, None, CorruptionConfig(blur_angle_deg=45),
                              CHOICE, SEEDS)
    assert len(calls) == 1


@pytest.mark.parametrize("angle", [0.0, 45.0])
def test_routes_take_the_same_draws(angle):
    """Both routes draw (choice, seeds) with draw_choice from the
    generator and nothing else, so a step's stream does not depend on the
    route."""
    x = torch.from_numpy(_img(2, (6, 16, 20, 3)))
    cfg = CorruptionConfig(blur_angle_deg=angle, prob=0.9)
    g = torch.Generator().manual_seed(7)
    out, choice = tc.random_corruption_fast(x, g, cfg)
    g_ref = torch.Generator().manual_seed(7)
    want_choice, want_seeds = FC.draw_choice(6, g_ref, cfg)
    assert torch.equal(choice, want_choice)
    assert torch.equal(g.get_state(), g_ref.get_state())
    again, _ = tc.random_corruption_fast(x, None, cfg, want_choice,
                                         want_seeds)
    assert torch.equal(out, again)


def test_six_by_six_runs_as_in_jax():
    """K1 needs H, W >= 8; a 6x6 batch takes the op-by-op route, as the
    reference's does."""
    x = _img(3, (4, 6, 6, 3))
    cfg = CorruptionConfig(prob=1.0)
    jout, _ = jc.random_corruption_fast(jnp.asarray(x), jax.random.key(0),
                                        JCfg(prob=1.0))
    assert jout.shape == x.shape
    out, _ = tc.random_corruption_fast(torch.from_numpy(x), None, cfg,
                                       CHOICE, SEEDS)
    ref = np.asarray(jc.corrupt_variant(
        jnp.asarray(x), jnp.asarray(CHOICE.numpy()), jax.random.key(0),
        JCfg()))
    assert out.shape == x.shape
    _assert_lsb(out[2].numpy(), ref[2])
    _assert_lsb(out[3].numpy(), ref[3])
    np.testing.assert_array_equal(out[0].numpy(), x[0])


@pytest.mark.parametrize("cfg_kw,shape,port_error", [
    ({"downscale_factor": 0.25}, (2, 16, 20, 3), NotImplementedError),
    ({"blur_kernel": 8}, (2, 16, 20, 3), ValueError),
    ({"blur_angle_deg": 45.0}, (2, 15, 20, 3), ValueError),
])
def test_refusals_as_in_jax(cfg_kw, shape, port_error):
    """What the reference refuses, the route refuses, before any draw."""
    x = _img(4, shape)
    with pytest.raises(Exception):
        jc.random_corruption_fast(jnp.asarray(x), jax.random.key(0),
                                  JCfg(**cfg_kw))
    with pytest.raises(port_error):
        tc.random_corruption_fast(torch.from_numpy(x), None,
                                  CorruptionConfig(**cfg_kw),
                                  CHOICE[:2], SEEDS[:2])


def test_standard_normal_is_k1_noise():
    """standard_normal is the normal K1's plain version adds: its noise
    image for a seed is floor(clip(x + sigma g))."""
    x = torch.from_numpy(_img(5, (1, 8, 10, 3)))
    g = FC.standard_normal(99, (8, 10, 3))
    k1 = FC.fused_corruption_reference(x, torch.tensor([tc.NOISE]),
                                       torch.tensor([99]))
    assert torch.equal(k1[0], torch.floor(torch.clamp(x[0] + 15.0 * g,
                                                      0, 255)))
    assert abs(g.std().item() - 1.0) < 0.2
