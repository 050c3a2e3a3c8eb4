"""The port's on-device train augmentations
(robust_object_detection_tpu_torch/train/augment.py) against the JAX
reference (train/augment.py).

The random draws differ between jax.random and torch.Generator, so each
test feeds the port's deterministic core the draws the JAX key gives:
the three per-image HSV gains (``random_hsv``'s own key splits) and the
flip mask (``random_flip_lr``'s bernoulli). In f32 the results agree to
f32 rounding (rtol 1e-5 on [0, 255] pixels; atol 1e-4 for colour values
a hue wrap leaves near 0); in bf16, the dtype of the train step's chain,
both sides round at every op and agree within 2 bf16 steps of 255.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robust_object_detection_tpu.train import augment as JA
from robust_object_detection_tpu_torch.train import augment as TA

torch.set_num_threads(1)


def _images(seed, b=4, h=16, w=24):
    rng = np.random.RandomState(seed)
    img = rng.randint(0, 256, (b, h, w, 3)).astype(np.float32)
    img[0, 0, :4] = [[10, 10, 10], [255, 0, 0], [0, 255, 0], [0, 0, 255]]
    return img


def _jax_gains(key, b, hgain=0.015, sgain=0.7, vgain=0.4):
    """random_hsv's draws for its key, as (B,) arrays."""
    k1, k2, k3 = jax.random.split(key, 3)
    return [np.array(jax.random.uniform(k, (b, 1, 1), minval=lo,
                                          maxval=hi)).reshape(b)
            for k, lo, hi in ((k1, -hgain, hgain), (k2, 1 - sgain, 1 + sgain),
                              (k3, 1 - vgain, 1 + vgain))]


def test_rgb_hsv_round_trip_matches_reference():
    rgb = _images(0) / 255.0
    jh = np.asarray(JA.rgb_to_hsv(jnp.asarray(rgb)))
    th = TA.rgb_to_hsv(torch.from_numpy(rgb))
    np.testing.assert_allclose(th.numpy(), jh, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(TA.hsv_to_rgb(th).numpy(),
                               np.asarray(JA.hsv_to_rgb(jnp.asarray(jh))),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(TA.hsv_to_rgb(th).numpy(), rgb, atol=1e-5)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_hsv_jitter_with_reference_gains(seed):
    img = _images(seed)
    key = jax.random.key(seed)
    ref = np.asarray(JA.random_hsv(jnp.asarray(img), key))
    gains = [torch.from_numpy(g) for g in _jax_gains(key, img.shape[0])]
    out = TA.hsv_jitter(torch.from_numpy(img), *gains).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-4)


def test_hsv_jitter_bf16_chain_matches_reference():
    img = _images(3)
    key = jax.random.key(3)
    ref = np.asarray(JA.random_hsv(jnp.asarray(img, jnp.bfloat16), key)
                     .astype(jnp.float32))
    gains = [torch.from_numpy(g) for g in _jax_gains(key, img.shape[0])]
    out = TA.hsv_jitter(torch.from_numpy(img).to(torch.bfloat16), *gains)
    assert out.dtype == torch.bfloat16
    assert np.abs(out.float().numpy() - ref).max() <= 2.0


def test_flip_with_reference_mask():
    rng = np.random.RandomState(4)
    img = _images(4)
    xy = rng.uniform(0, 20, (4, 5, 2))
    boxes = np.concatenate([xy, xy + 3], -1).astype(np.float32)
    classes = rng.randint(0, 6, (4, 5)).astype(np.int32)
    classes[:, 3:] = -1
    key = jax.random.key(5)
    jimg, jboxes = JA.random_flip_lr(jnp.asarray(img), jnp.asarray(boxes),
                                     jnp.asarray(classes), key)
    flip = np.array(jax.random.bernoulli(key, 0.5, (4, 1, 1, 1))).ravel()
    assert 0 < flip.sum() < 4
    timg, tboxes = TA.flip_lr(torch.from_numpy(img), torch.from_numpy(boxes),
                              torch.from_numpy(classes),
                              torch.from_numpy(flip))
    np.testing.assert_array_equal(timg.numpy(), np.asarray(jimg))
    np.testing.assert_array_equal(tboxes.numpy(), np.asarray(jboxes))


def test_random_wrappers_draw_from_the_generator():
    """Same generator seed, same result; gains within the Ultralytics
    ranges; about half of many images flipped."""
    img = torch.from_numpy(_images(6, b=64, h=4, w=4))
    boxes = torch.zeros(64, 1, 4)
    classes = torch.zeros(64, 1, dtype=torch.int64)
    a = TA.random_hsv(img, torch.Generator().manual_seed(0))
    b = TA.random_hsv(img, torch.Generator().manual_seed(0))
    assert torch.equal(a, b) and not torch.equal(a, img)
    flipped, _ = TA.random_flip_lr(img, boxes, classes,
                                   torch.Generator().manual_seed(1))
    n = sum(not torch.equal(f, i) for f, i in zip(flipped, img))
    assert 16 < n < 48
