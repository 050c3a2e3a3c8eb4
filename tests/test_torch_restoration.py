"""The port's U-Net trainer (train/restoration.py) against the reference's
on the same weights and draws, at narrow widths (8, 16, 32, 64), batch 2,
32 x 48 patches.

The draws are made equal: the test computes the reference step's flip,
corruption id and noise arrays from its key (``fold_in(key, step)`` and
splits, as ``make_train_step`` and ``corrupt_uniform3`` take them) and
hands the port the same arrays.

What limits an f32 comparison (measured while writing this test): the
reference's f32 step-0 gradient deviates from its own float64 gradient by
up to 5.8e-3 x max|leaf| (the bottleneck's leaves), the port's f32 gradient
from that float64 gradient by at most 7.8e-6 x max|leaf|. So the gradients
are held against the reference in float64 (``jax.enable_x64`` with its
``jnp.float32`` casts and SSIM window widened, inside that test only), on
the reference step's own corrupted and clean batches: the port in float64
within 1e-6 x max|ref| of every leaf (measured 5.5e-8), the port's f32
step within 1e-4 x max|ref| (measured 7.8e-6).

Checks:
  * three f32 train steps: loss and psnr at rtol 1e-4 each step,
    grad_norm at rtol 1e-3 at step 0 and 1e-2 after (the reference's
    noisy leaves enter the norm); the state after 3 steps. AdamW's first
    update is sign-like (m_hat / sqrt(v_hat) = +-1 for every element), so
    an element whose reference gradient is within its f32 noise of 0 may
    move the other way: every parameter within 2 x (the sum of the 3
    learning rates), the median element within 1e-4 and 90% within 5e-4
    (measured 2.2e-5 and 1.1e-4), the running statistics within 1e-3
    (measured 2e-4);
  * the eval step at 1e-5; the optimizer's learning rate at every update
    against optax's schedule;
  * ``PatchDataset``'s crops byte-equal to the reference's (its draws run
    in thread order, so it runs with one thread; the port's draws do not
    depend on the thread count);
  * ``train(max_steps=2)`` writes the history and both checkpoints, and
    ``load_best`` reads the best back.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from robust_object_detection_tpu.core.config import (
    CorruptionConfig as JCfg, RestorationConfig as JRCfg)
from robust_object_detection_tpu.models import unet as JU
from robust_object_detection_tpu.ops import ssim as JS
from robust_object_detection_tpu.train import restoration as JR
from robust_object_detection_tpu_torch.core import artifacts
from robust_object_detection_tpu_torch.core.config import (
    CorruptionConfig, ExperimentConfig, RestorationConfig)
from robust_object_detection_tpu_torch.models import convert
from robust_object_detection_tpu_torch.models import unet as TU
from robust_object_detection_tpu_torch.ops import ssim as TS
from robust_object_detection_tpu_torch.train import restoration as TR

from _torch_unet_vars import NARROW, jax_unet, jnp_tree

torch.set_num_threads(1)

B, H, W, STEPS = 2, 32, 48, 3
RCFG = dict(channels=NARROW, epochs=1, lr=1e-3)


def _jax_draws(key, step, shape):
    """The reference train step's draws for `step`."""
    k_flip, k_corr = jax.random.split(jax.random.fold_in(key, step))
    flip = jax.random.bernoulli(k_flip, 0.5, (shape[0], 1, 1, 1))
    return dict(flip=flip.reshape(-1), **_jax_corruption_draws(k_corr, shape))


def _jax_corruption_draws(key, shape):
    """corrupt_uniform3's draws for `key`."""
    k_choice, k_noise = jax.random.split(key)
    variant = jax.random.randint(k_choice, (shape[0],), 1, 4)
    noise = jax.random.normal(k_noise, shape, jnp.float32)
    return {"variant": variant, "noise": noise}


def _torch_draws(d):
    return {k: torch.from_numpy(np.asarray(v).copy()).to(
        torch.bool if k == "flip" else
        (torch.int64 if k == "variant" else torch.float32))
        for k, v in d.items()}


def _grad_keeper():
    """An optax transformation whose state is the last gradient and whose
    update is zero: the reference's step then hands back its gradient."""
    return optax.GradientTransformation(
        lambda params: jax.tree.map(jnp.zeros_like, params),
        lambda g, state, params=None: (jax.tree.map(jnp.zeros_like, g), g))


@pytest.fixture(scope="module")
def setup():
    jmodel, v = jax_unet(patch=H)
    batch = np.random.RandomState(7).randint(0, 256, (B, H, W, 3)).astype(
        np.uint8)
    return jmodel, v, batch


def _port_model(v, train=True):
    m = TU.create(NARROW, device="cpu", train=train)
    m.load_state_dict(convert.unet_from_jax_variables(v["params"],
                                                      v["batch_stats"]))
    return m


def _reference_step0_loss_inputs(batch, key):
    """The reference step-0's corrupted and clean batches (its flip and
    corruption from `key`), f32 [0, 1]."""
    d = _jax_draws(key, 0, batch.shape)
    x = jnp.asarray(batch).astype(jnp.float32)
    x = jnp.where(d["flip"][:, None, None, None], x[:, :, ::-1, :], x)
    k_corr = jax.random.split(jax.random.fold_in(key, 0))[1]
    corrupted = JR.corrupt_uniform3(x, k_corr, JCfg()) / 255.0
    return np.array(corrupted), np.array(x / 255.0)


@pytest.fixture(scope="module")
def runs(setup):
    """Three steps of each trainer from the same variables and draws, the
    reference's step-0 gradient and the port's."""
    jmodel, v, batch = setup
    key = jax.random.key(3)
    jtx, _ = JR.make_optimizer(JRCfg(**RCFG), STEPS)
    jstep = jax.jit(JR.make_train_step(jmodel, jtx, JCfg(), 0.3))
    state = JR.TrainState(jnp_tree(v["params"]), jnp_tree(v["batch_stats"]),
                          jtx.init(jnp_tree(v["params"])), jnp.asarray(0))
    gstep = jax.jit(JR.make_train_step(jmodel, _grad_keeper(), JCfg(), 0.3))
    gstate = JR.TrainState(state.params, state.batch_stats,
                           _grad_keeper().init(state.params), jnp.asarray(0))
    jgrads = convert.unet_from_jax_variables(
        jax.device_get(gstep(gstate, jnp.asarray(batch), key)[0].opt_state),
        v["batch_stats"])

    model = _port_model(v)
    tx, sched = TR.make_optimizer(RestorationConfig(**RCFG), STEPS)
    tstate = TR.init_state(model, tx)
    tstep = TR.make_train_step(CorruptionConfig(), 0.3)
    metrics, tgrads = [], None
    for i in range(STEPS):
        state, jm = jstep(state, jnp.asarray(batch), key)
        tm = tstep(tstate, torch.from_numpy(batch),
                   draws=_torch_draws(_jax_draws(key, i, batch.shape)))
        metrics.append((jax.device_get(jm), tm))
        if i == 0:
            tgrads = {n: p.grad.clone() for n, p in model.named_parameters()}
    return dict(key=key, metrics=metrics, jstate=state, tstate=tstate,
                jgrads=jgrads, tgrads=tgrads,
                lr_sum=sum(sched(i) for i in range(STEPS)))


def test_three_train_steps_match_reference(runs):
    for i, (jm, tm) in enumerate(runs["metrics"]):
        for k, tol in (("loss", 1e-4), ("psnr", 1e-4),
                       ("grad_norm", 1e-3 if i == 0 else 1e-2)):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=tol,
                                       err_msg=f"{k} step {i}")
    assert runs["tstate"].step == STEPS
    state = runs["jstate"]
    after = convert.unet_from_jax_variables(
        jax.device_get(state.params), jax.device_get(state.batch_stats))
    diffs = []
    for name, val in runs["tstate"].model.state_dict().items():
        if name.endswith("num_batches_tracked"):
            continue
        d = np.abs(val.numpy() - after[name].numpy())
        if "running" in name:
            assert d.max() <= 1e-3, name
        else:
            assert d.max() <= 2 * runs["lr_sum"], name
            diffs.append(d.ravel())
    diffs = np.concatenate(diffs)
    assert np.median(diffs) <= 1e-4 and np.quantile(diffs, 0.9) <= 5e-4


def test_step0_gradients_against_float64(setup, runs):
    jmodel, v, batch = setup
    corrupted, clean = _reference_step0_loss_inputs(batch, runs["key"])
    mp = pytest.MonkeyPatch()
    try:
        with jax.enable_x64(True):
            mp.setattr(jnp, "float32", jnp.float64)
            window = JS.gaussian_window
            mp.setattr(JS, "gaussian_window",
                       lambda *a: window(*a).astype(np.float64))
            jm64 = JU.create(NARROW, dtype=jnp.float64)
            wide = jax.tree.map(
                lambda a: jnp.asarray(np.asarray(a), jnp.float64), v)

            def loss_fn(params):
                out, _ = jm64.apply(
                    {"params": params, "batch_stats": wide["batch_stats"]},
                    jnp.asarray(corrupted, jnp.float64), train=True,
                    mutable=["batch_stats"])
                return JS.restoration_loss(
                    out, jnp.asarray(clean, jnp.float64), 0.3)
            jloss, g = jax.device_get(
                jax.jit(jax.value_and_grad(loss_fn))(wide["params"]))
        mp.undo()
        assert g["Conv_0"]["kernel"].dtype == np.float64
        ref = {k: t.double() for k, t in convert.unet_from_jax_variables(
            g, v["batch_stats"]).items()}

        m64 = TU.RestorationUNet(NARROW, dtype=torch.float64).train()
        m64.load_state_dict(_port_model(v).state_dict())
        m64.double()
        mp.setattr(torch.Tensor, "float", lambda self: self.double())
        loss = TS.restoration_loss(
            m64(torch.from_numpy(corrupted).double()),
            torch.from_numpy(clean).double(), 0.3)
        loss.backward()
    finally:
        mp.undo()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-9)
    for name, p in m64.named_parameters():
        r = ref[name]
        scale = float(r.abs().max())
        assert float((p.grad - r).abs().max()) <= 1e-6 * scale, name
        got = runs["tgrads"][name].double()
        assert float((got - r).abs().max()) <= 1e-4 * scale, name


def test_eval_step_matches_reference(setup):
    jmodel, v, batch = setup
    key = jax.random.key(5)
    ref = jax.jit(JR.make_eval_step(jmodel, JCfg()))(
        JR.TrainState(jnp_tree(v["params"]), jnp_tree(v["batch_stats"]),
                      None, jnp.asarray(0)), jnp.asarray(batch), key)
    draws = _torch_draws(_jax_corruption_draws(key, batch.shape))
    out = TR.make_eval_step(CorruptionConfig())(
        _port_model(v, train=False), torch.from_numpy(batch), draws=draws)
    assert set(out) == set(ref) == {"psnr", "ssim", "psnr_in"}
    for k in out:
        np.testing.assert_allclose(float(out[k]), float(ref[k]), rtol=1e-5,
                                   atol=1e-5, err_msg=k)


def test_optimizer_learning_rate_matches_optax():
    cfg = dict(lr=2e-3, lr_min=1e-5, epochs=3)
    spe = 4
    _, jsched = JR.make_optimizer(JRCfg(**cfg), spe)
    tx, sched = TR.make_optimizer(RestorationConfig(**cfg), spe)
    opt, scheduler = tx(torch.nn.Sequential(torch.nn.Linear(1, 1)))
    assert opt.defaults["weight_decay"] == 1e-4
    for count in range(3 * spe + 3):            # past the decay's end too
        lr = opt.param_groups[0]["lr"]
        np.testing.assert_allclose(lr, float(jsched(count)), rtol=1e-6,
                                   err_msg=str(count))
        assert lr == pytest.approx(sched(count), rel=1e-12)
        opt.step()
        scheduler.step()


@pytest.fixture(scope="module")
def image_dirs(tmp_path_factory):
    """PNG images of mixed sizes, some below the 32-px patch."""
    from PIL import Image
    root = tmp_path_factory.mktemp("patches")
    rng = np.random.RandomState(11)
    sizes = [(40, 56), (32, 32), (24, 50), (64, 36), (45, 45), (33, 70)]
    for split, n in (("train", 6), ("val", 3)):
        d = root / split
        d.mkdir()
        for i in range(n):
            h, w = sizes[(i + len(split)) % len(sizes)]
            Image.fromarray(rng.randint(0, 256, (h, w, 3), dtype=np.uint8)
                            ).save(d / f"im{i}.png")
    return root


@pytest.mark.parametrize("train", [True, False])
def test_patch_dataset_matches_reference(image_dirs, train):
    split = "train" if train else "val"
    jds = JR.PatchDataset(image_dirs / split, 32, train=train, seed=4)
    tds = TR.PatchDataset(image_dirs / split, 32, train=train, seed=4)
    assert len(tds) == len(jds)
    for epoch in (0, 1):
        ref = list(jds.batches(2, epoch, num_threads=1))
        out = list(tds.batches(2, epoch, num_threads=4))
        assert len(out) == len(ref) > 0
        for o, r in zip(out, ref):
            assert o.dtype == np.uint8 and o.shape == (2, 32, 32, 3)
            np.testing.assert_array_equal(o, r)


def test_train_writes_history_and_checkpoints(image_dirs, tmp_path):
    cfg = ExperimentConfig(restoration=RestorationConfig(
        channels=NARROW, patch_size=32, epochs=2, batch_size=2,
        val_every=1))
    out = TR.train(cfg, image_dirs / "train", image_dirs / "val",
                   out_dir=tmp_path / "run", max_steps=2, device="cpu")
    assert out["param_count"] == TU.param_count(TU.create(NARROW,
                                                          device="cpu"))
    assert np.isfinite(out["best"]["psnr"]) and out["best"]["epoch"] == 1
    hist = artifacts.read_jsonl(tmp_path / "run" / "history.jsonl")
    assert len(hist) == 1 and {"train_loss", "lr", "val_psnr", "val_ssim",
                               "val_psnr_in"} <= set(hist[0])
    assert artifacts.read_json(tmp_path / "run" / "config.json")[
        "restoration"]["channels"] == list(NARROW)
    ckpt = tmp_path / "run" / "ckpt"
    assert (ckpt / "best").exists() and (ckpt / "last" / "1").exists()
    assert artifacts.read_json(ckpt / "best_meta.json")["step"] == 1
    model = TR.load_best(tmp_path / "run", NARROW, device="cpu")
    assert not model.training
    y = model(torch.zeros(1, 32, 32, 3))
    assert y.shape == (1, 32, 32, 3)
    with pytest.raises(FileNotFoundError):
        TR.load_best(tmp_path / "nothing", NARROW, device="cpu")
