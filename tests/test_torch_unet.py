"""The port's restoration U-Net (models/unet.py, models/convert.py's
``unet_from_jax_variables``) against the flax RestorationUNet on the same
variables, at narrow widths (8, 16, 32, 64) and <= 64 px, f32.

Forward at atol 1e-5 (f32 sums in another order through 18 BatchNorms);
the u8 apply within 1 LSB (a 1e-7 difference of y flips a byte when
y * 255 + 0.5 sits on an integer); train-mode running statistics at 1e-6
after one forward (the batch's biased fast variance, momentum 0.99)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robust_object_detection_tpu.models import unet as JU
from robust_object_detection_tpu_torch.models import convert
from robust_object_detection_tpu_torch.models import unet as TU

from _torch_unet_vars import NARROW, jax_unet, jnp_tree

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def setup():
    jmodel, v = jax_unet()
    tmodel = TU.create(NARROW, device="cpu")
    tmodel.load_state_dict(convert.unet_from_jax_variables(
        v["params"], v["batch_stats"]))
    return jmodel, v, tmodel


def test_param_count_matches_reference():
    """Full widths (32, 64, 128, 256): built, not run; and the forward's
    122,560 multiply-adds a pixel, the count the card's bound uses."""
    jmodel = JU.create()
    v = JU.abstract_variables(jmodel, 32)
    full = TU.create(device="cpu")
    assert TU.param_count(full) == JU.param_count(v)
    assert TU.macs_per_pixel(full) == 122_560
    from torch.utils.flop_counter import FlopCounterMode
    with FlopCounterMode(display=False) as counter, torch.no_grad():
        full(torch.zeros(1, 64, 64, 3))
    # torch counts 2 FLOPs a multiply-add of each conv and transposed conv
    assert counter.get_total_flops() == 2 * 122_560 * 64 * 64


def test_forward_matches_reference(setup):
    jmodel, v, tmodel = setup
    x = np.random.RandomState(1).rand(2, 32, 48, 3).astype(np.float32)
    ref = np.asarray(jmodel.apply(jnp_tree(v), jnp.asarray(x), train=False))
    with torch.no_grad():
        out = tmodel(torch.from_numpy(x)).numpy()
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=0)


def test_restore_image_odd_size(setup):
    jmodel, v, tmodel = setup
    img = np.random.RandomState(2).rand(37, 53, 3).astype(np.float32)
    ref = np.asarray(JU.restore_image(JU.jit_apply(jmodel), jnp_tree(v),
                                      jnp.asarray(img)))
    out = TU.restore_image(tmodel, torch.from_numpy(img)).numpy()
    assert out.shape == (37, 53, 3)
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=0)


def test_apply_u8_within_one_lsb(setup):
    jmodel, v, tmodel = setup
    x = np.random.RandomState(3).randint(0, 256, (2, 48, 64, 3)).astype(
        np.uint8)
    ref = np.asarray(JU.jit_apply_u8(jmodel)(jnp_tree(v), jnp.asarray(x)))
    out = TU.apply_u8(tmodel, torch.from_numpy(x)).numpy()
    assert out.dtype == np.uint8 and out.shape == ref.shape
    diff = np.abs(out.astype(int) - ref.astype(int))
    assert diff.max() <= 1
    assert (diff > 0).mean() < 1e-3


def test_conv_transpose_flip_witness():
    """An asymmetric 2x2 kernel through flax's ConvTranspose (k 2, s 2,
    SAME) and the converted torch weight: out[2i] takes K[1], out[2i+1]
    K[0] on each axis. An unflipped weight fails this."""
    from flax import linen as nn
    rng = np.random.RandomState(4)
    k = rng.randn(2, 2, 3, 5).astype(np.float32)
    b = rng.randn(5).astype(np.float32)
    x = rng.randn(1, 3, 4, 3).astype(np.float32)
    ref = np.asarray(nn.ConvTranspose(5, (2, 2), strides=(2, 2)).apply(
        {"params": {"kernel": k, "bias": b}}, jnp.asarray(x)))
    w = convert.conv_transpose_weight(k)
    out = torch.nn.functional.conv_transpose2d(
        torch.from_numpy(x).permute(0, 3, 1, 2), w, torch.from_numpy(b),
        stride=2).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=0)
    assert not np.allclose(
        convert._t(k.transpose(2, 3, 0, 1)).numpy(), w.numpy())
    # the single-pixel case spelled out: out[0, 0] = x K[1, 1]
    np.testing.assert_allclose(ref[0, 0, 0], x[0, 0, 0] @ k[1, 1] + b,
                               atol=1e-5)


def test_train_mode_running_statistics(setup):
    jmodel, v, _ = setup
    tmodel = TU.create(NARROW, device="cpu", train=True)
    tmodel.load_state_dict(convert.unet_from_jax_variables(
        v["params"], v["batch_stats"]))
    x = np.random.RandomState(5).rand(2, 32, 32, 3).astype(np.float32)
    ref, mut = jmodel.apply(jnp_tree(v), jnp.asarray(x), train=True,
                            mutable=["batch_stats"])
    out = tmodel(torch.from_numpy(x))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               atol=1e-4, rtol=0)
    want = convert.unet_from_jax_variables(
        v["params"], jax.device_get(mut["batch_stats"]))
    got = tmodel.state_dict()
    keys = [k for k in want if "running" in k]
    assert len(keys) == 4 * 9
    for key in keys:
        np.testing.assert_allclose(got[key].numpy(), want[key].numpy(),
                                   atol=1e-6, rtol=0, err_msg=key)


def test_remat_names_and_statistics(setup):
    """A flax U-Net built with remat=True names its blocks
    CheckpointConvBlock_i: the converter reads them. The port's remat
    recomputes each block in the backward and updates the running
    statistics once, as without remat."""
    jmodel, v, _ = setup
    renamed = {k.replace("ConvBlock", "CheckpointConvBlock"): val
               for k, val in v["params"].items()}
    stats = {k.replace("ConvBlock", "CheckpointConvBlock"): val
             for k, val in v["batch_stats"].items()}
    sd = convert.unet_from_jax_variables(renamed, stats)
    x = torch.from_numpy(
        np.random.RandomState(6).rand(2, 32, 32, 3).astype(np.float32))
    models = []
    for remat in (False, True):
        m = TU.RestorationUNet(NARROW, remat=remat).train()
        m.load_state_dict(sd)
        m(x).square().mean().backward()
        models.append(m)
    a, b = (dict(m.named_parameters()) for m in models)
    for key in a:
        torch.testing.assert_close(a[key].grad, b[key].grad, atol=1e-6,
                                   rtol=1e-5)
    for key, val in models[0].state_dict().items():
        torch.testing.assert_close(val, models[1].state_dict()[key])
    with pytest.raises(KeyError, match="RestorationUNet"):
        convert.unet_from_jax_variables({"Conv_0": {}}, {})
