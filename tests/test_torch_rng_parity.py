"""The port's RNG discipline (core/rng.py) and its op-by-op random
corruption (ops/corrupt.random_corruption) against the reference's.

  * ``_stable_hash`` equals the reference's bit for bit;
  * streams are deterministic, distinct by name, and resume from
    ``state()`` drawing what an uninterrupted run draws;
  * ``random_corruption``: given the same per-image choice, the clean,
    blur and lowres images equal the reference's within its own 1 LSB bar;
    the noise matches the reference's in distribution (mean and standard
    deviation of the added noise on mid-grey); the choice frequencies of
    both fall within a binomial bound of prob / 3 each and 1 - prob clean.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from robust_object_detection_tpu.core import rng as JR
from robust_object_detection_tpu.ops import corrupt as JC
from robust_object_detection_tpu_torch.core import rng as TR
from robust_object_detection_tpu_torch.core.config import CorruptionConfig
from robust_object_detection_tpu_torch.ops import corrupt as TC

torch.set_num_threads(1)


@pytest.mark.parametrize("name", ["", "a", "train", "corruption/noise",
                                  "x" * 200, "ünï", "stream-7"])
def test_stable_hash_equals_reference(name):
    assert TR._stable_hash(name) == JR._stable_hash(name)


def _draw(g):
    return torch.rand(5, generator=g)


def test_streams_are_deterministic_and_distinct():
    a, b = TR.Rng(7), TR.Rng(7)
    xs = [_draw(a.stream("data").next()) for _ in range(3)]
    ys = [_draw(b.stream("data").next()) for _ in range(3)]
    for x, y in zip(xs, ys):
        torch.testing.assert_close(x, y, rtol=0, atol=0)
    assert not torch.equal(xs[0], xs[1])
    assert not torch.equal(_draw(TR.Rng(7).stream("model").next()), xs[0])
    assert not torch.equal(_draw(TR.Rng(8).stream("data").next()), xs[0])
    torch.testing.assert_close(_draw(a.key("data")), _draw(b.key("data")))
    s = TR.Rng(7).stream("data")
    torch.testing.assert_close(_draw(s.peek(2)), xs[2])
    assert s.counter == 0
    it = TR.key_iter(3)
    torch.testing.assert_close(_draw(next(it)),
                               _draw(TR.generator(TR.fold_in(3, 0))))


def test_resume_from_state():
    r = TR.Rng(11)
    for _ in range(4):
        r.stream("a").next()
    r.stream("b").next()
    state = r.state()
    assert state == {"a": 4, "b": 1}
    expect = [_draw(r.stream("a").next()), _draw(r.stream("b").next())]
    fresh = TR.Rng(11)
    fresh.restore(state)
    assert fresh.state() == state
    got = [_draw(fresh.stream("a").next()), _draw(fresh.stream("b").next())]
    for x, y in zip(got, expect):
        torch.testing.assert_close(x, y, rtol=0, atol=0)
    # the reference's state has the same shape: name -> counter
    jr = JR.Rng(11)
    for _ in range(4):
        jr.stream("a").next()
    jr.stream("b").next()
    assert jr.state() == state


def _batch(n=8, h=32, w=48, seed=0):
    return np.random.RandomState(seed).randint(0, 256, (n, h, w, 3)).astype(
        np.float32)


def test_choice_given_equals_reference_op_by_op():
    cfg = CorruptionConfig(prob=0.9)
    img = _batch()
    g = torch.Generator().manual_seed(3)
    out, choice = TC.random_corruption(torch.from_numpy(img), g, cfg)
    choice = choice.numpy()
    assert set(choice.tolist()) >= {TC.NOISE, TC.BLUR, TC.LOWRES}
    ref = np.asarray(JC.corrupt_variant(
        jnp.asarray(img), jnp.asarray(choice), jax.random.key(0),
        JC.CorruptionConfig(prob=0.9)))
    out = out.numpy()
    assert out.dtype == np.float32 and out.shape == img.shape
    for i, c in enumerate(choice):
        if c == TC.NOISE:
            continue
        diff = np.abs(out[i] - ref[i]).max()
        assert diff <= (0 if c == TC.CLEAN else 1), (i, c, diff)
    # the same generator state draws the same batch; fast changes nothing
    g2 = torch.Generator().manual_seed(3)
    out2, choice2 = TC.random_corruption(torch.from_numpy(img), g2, cfg,
                                         fast=True)
    assert np.array_equal(choice2.numpy(), choice)
    np.testing.assert_array_equal(out2.numpy(), out)


def test_noise_matches_reference_in_distribution():
    cfg = CorruptionConfig(prob=1.0)
    img = np.full((24, 32, 32, 3), 128.0, np.float32)
    noise = TC.NOISE * np.ones(24, np.int32)
    ref = np.asarray(JC.corrupt_variant(
        jnp.asarray(img), jnp.asarray(noise), jax.random.key(1),
        JC.CorruptionConfig())) - 128.0
    out = TC.corrupt_variant(torch.from_numpy(img), torch.from_numpy(noise),
                             torch.Generator().manual_seed(1), cfg)
    out = out.numpy() - 128.0
    # f32 add, clip, truncation: mean about -0.5, std about 15
    assert abs(out.mean() - ref.mean()) < 0.15, (out.mean(), ref.mean())
    assert abs(out.std() - ref.std()) < 0.15, (out.std(), ref.std())
    assert abs(ref.std() - 15.0) < 0.3
    # random_corruption's noise branch draws from the same distribution
    g = torch.Generator().manual_seed(2)
    rc, choice = TC.random_corruption(torch.from_numpy(img), g,
                                      CorruptionConfig(prob=1.0))
    d = rc.numpy()[choice.numpy() == TC.NOISE] - 128.0
    assert d.size and abs(d.mean() - ref.mean()) < 0.3
    assert abs(d.std() - ref.std()) < 0.3


def test_choice_frequencies_within_binomial_bound():
    """4000 one-pixel-pair images: each corrupted branch prob / 3, clean
    1 - prob, for the port and the reference."""
    n, prob = 4000, 0.5
    img = np.zeros((n, 2, 2, 3), np.float32)
    _, tchoice = TC.random_corruption(torch.from_numpy(img),
                                      torch.Generator().manual_seed(5),
                                      CorruptionConfig(prob=prob))
    _, jchoice = JC.random_corruption(jnp.asarray(img), jax.random.key(5),
                                      JC.CorruptionConfig(prob=prob))
    expect = {TC.CLEAN: 1 - prob, TC.NOISE: prob / 3, TC.BLUR: prob / 3,
              TC.LOWRES: prob / 3}
    for choice in (tchoice.numpy(), np.asarray(jchoice)):
        for c, p in expect.items():
            k = int((choice == c).sum())
            bound = 4.5 * np.sqrt(n * p * (1 - p))
            assert abs(k - n * p) <= bound, (c, k, n * p, bound)


def test_draw_order():
    """apply uniforms (B,), branch (B,), then the noise (B, H, W, C)."""
    g = torch.Generator().manual_seed(9)
    choice, noise = TC.draw_random_corruption((4, 2, 2, 3), g,
                                              CorruptionConfig(prob=1.0))
    h = torch.Generator().manual_seed(9)
    torch.rand(4, generator=h)
    ref_choice = torch.randint(1, 4, (4,), generator=h)
    torch.testing.assert_close(choice, ref_choice)
    torch.testing.assert_close(noise, torch.randn((4, 2, 2, 3),
                                                  generator=h))
