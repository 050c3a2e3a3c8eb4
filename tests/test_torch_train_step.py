"""The port's whole train step (robust_object_detection_tpu_torch/train/
detector.py) against the reference's ``make_train_step``.

YOLOv8n, 64 px, batch 2, f32, ``augment=False``: the flax model is
initialised, its variables are carried onto the port by
``models/convert.from_jax_variables``, and both sides run 3 steps on the
same uint8 batch with ``make_optimizer(warmup_steps=1, total_steps=10)``
(lr 0, then lr0, then the first decay step). The reference's loss is
switched to ``precise=True`` inside this test (the port's assigner is that
configuration); nothing in the JAX package changes. At 64 px the JAX model
takes its NHWC ConvBnAct branch; the port runs the plain versions of its
kernels: the same math, with BN1/BN2 of the front folded into g*y + b.

Checks: the loss within rtol 1e-4 at every step; the step-0 gradient of
every parameter, mapped through ``pretrained.import_yolov8``, within 1e-3
x max|ref| of its leaf (f32 sums in another order, amplified through ~60
train-mode BatchNorms); the change of every parameter, running statistic
and EMA leaf over the 3 steps within 3e-3 of its size. One more test runs
the port's step with the corruption and the HSV / flip augmentation on
the CPU.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from robust_object_detection_tpu.core.config import CorruptionConfig as JCfg
from robust_object_detection_tpu.models import pretrained
from robust_object_detection_tpu.models import yolov8 as JY
from robust_object_detection_tpu.train import detection as JDL
from robust_object_detection_tpu.train import detector as JDet
from robust_object_detection_tpu_torch.core.config import CorruptionConfig
from robust_object_detection_tpu_torch.models import convert
from robust_object_detection_tpu_torch.models import yolov8 as TY
from robust_object_detection_tpu_torch.ops import conv3x3 as TC
from robust_object_detection_tpu_torch.ops import fused_corrupt as TFC
from robust_object_detection_tpu_torch.ops import yolo_front as TF
from robust_object_detection_tpu_torch.train import detector as TDet

torch.set_num_threads(1)

IMG, B, M, STEPS = 64, 2, 6, 3


def _batch(seed=0):
    rng = np.random.RandomState(seed)
    images = rng.randint(0, 256, (B, IMG, IMG, 3)).astype(np.uint8)
    xy = rng.uniform(0, IMG * 0.6, (B, M, 2))
    wh = rng.uniform(IMG * 0.15, IMG * 0.4, (B, M, 2))
    boxes = np.concatenate([xy, np.minimum(xy + wh, IMG)], -1).astype(
        np.float32)
    classes = rng.randint(0, 6, (B, M)).astype(np.int32)
    classes[1, M - 2:] = -1
    return images, boxes, classes


def _to_jax_tree(state, template):
    """A port state_dict (numpy) -> the flax {"params", "batch_stats"}."""
    back, report = pretrained.import_yolov8(state, template, variant="n")
    assert not report.skipped
    return back


@pytest.fixture(scope="module")
def runs():
    images, gb, gc = _batch()
    jmodel = JY.create(6, "n")
    tx, _ = JDet.make_optimizer(warmup_steps=1, total_steps=10)
    jstate = JDet.init_state(jmodel, jax.random.key(0), IMG, tx)
    template = jax.device_get({"params": jstate.params,
                               "batch_stats": jstate.batch_stats})

    # the port, from the same variables
    tmodel = TY.YoloV8(TY.YoloConfig(6, "n"))
    tmodel.load_state_dict(convert.from_jax_variables(
        template["params"], template["batch_stats"], "n"), strict=True)
    tstate = TDet.init_state(tmodel.train(),
                             TDet.make_optimizer(warmup_steps=1,
                                                 total_steps=10)[0])
    grads0 = {}        # the first step's gradients, as backward leaves them

    def keep_first(p, name):
        if name not in grads0:
            grads0[name] = p.grad.clone()
    for name, p in tmodel.named_parameters():
        if p.requires_grad:
            p.register_post_accumulate_grad_hook(
                lambda p, n=name: keep_first(p, n))
    tstep = TDet.make_train_step(IMG, CorruptionConfig(), augment=False)
    tlosses = [tstep(tstate, torch.from_numpy(images), torch.from_numpy(gb),
                     torch.from_numpy(gc), torch.Generator().manual_seed(0))
               for _ in range(STEPS)]

    # the reference, its loss in the precise configuration
    orig = JDL.yolo_loss
    mp = pytest.MonkeyPatch()
    mp.setattr(JDL, "yolo_loss",
               lambda *a, **k: orig(*a, **dict(k, precise=True)))
    try:
        x = jnp.asarray(images, jnp.float32) / 255.0

        def loss_fn(params):
            outs, _ = jmodel.apply({"params": params,
                                    "batch_stats": jstate.batch_stats},
                                   x, train=True, mutable=["batch_stats"])
            return JDL.yolo_loss(outs, jnp.asarray(gb), jnp.asarray(gc),
                                 IMG)[0]
        jgrads = jax.device_get(jax.grad(loss_fn)(jstate.params))
        jstep = jax.jit(JDet.make_train_step(jmodel, tx, IMG, JCfg(),
                                             augment=False))
        jlosses = []
        for _ in range(STEPS):
            jstate, metrics = jstep(jstate, jnp.asarray(images),
                                    jnp.asarray(gb), jnp.asarray(gc),
                                    jax.random.key(0))
            jlosses.append(jax.device_get(metrics))
    finally:
        mp.undo()
    return dict(template=template, jstate=jax.device_get(jstate),
                jgrads=jgrads, jlosses=jlosses, tstate=tstate,
                tlosses=tlosses, tgrads=grads0)


def _leaves(tree):
    return dict(jax.tree_util.tree_leaves_with_path(tree))


def _state_with(tmodel, values):
    """tmodel's state_dict (numpy) with the given entries replaced."""
    state = {k: v.detach().numpy().copy()
             for k, v in tmodel.state_dict().items()}
    state.update({k: v.detach().numpy() for k, v in values.items()})
    return state


def test_losses_match_reference_every_step(runs):
    """The total within rtol 1e-4 at every step; the components within
    rtol 1e-3 (the box term, a CIoU of the updated model's boxes, moves
    by ~1e-4 relative once the parameters differ by the step-0 gradients'
    f32 noise)."""
    for i, (t, j) in enumerate(zip(runs["tlosses"], runs["jlosses"])):
        np.testing.assert_allclose(t["loss"].item(), float(j["loss"]),
                                   rtol=1e-4, err_msg=f"step {i}")
        for k in ("box", "cls", "dfl"):
            np.testing.assert_allclose(t[k].item(), float(j[k]), rtol=1e-3,
                                       err_msg=f"step {i} {k}")
        assert int(t["num_fg"]) == int(j["num_fg"])
        np.testing.assert_allclose(t["grad_norm"].item(),
                                   float(j["grad_norm"]), rtol=1e-3)


def test_step0_gradients_match_reference(runs):
    tmodel = runs["tstate"].model
    mapped = _to_jax_tree(_state_with(tmodel, runs["tgrads"]),
                          runs["template"])["params"]
    ref = _leaves(runs["jgrads"])
    got = _leaves(mapped)
    assert got.keys() == ref.keys() and len(ref) > 100
    for path, r in ref.items():
        r = np.asarray(r)
        err = np.abs(np.asarray(got[path]) - r).max()
        assert err <= 1e-3 * (np.abs(r).max() + 1e-12), \
            jax.tree_util.keystr(path)


def _assert_updates_match(got, ref, init, what):
    """Each leaf's change over the 3 steps within 3e-3 x its largest
    reference change: two updates (step 0 runs at lr 0), the first of
    them learning rate x gradients within 1e-3 of the reference's, the
    second from parameters that already differ by that much; the running
    statistics follow the updated parameters."""
    got, ref, init = _leaves(got), _leaves(ref), _leaves(init)
    assert got.keys() == ref.keys()
    for path, r in ref.items():
        du_ref = np.asarray(r) - np.asarray(init[path])
        du = np.asarray(got[path]) - np.asarray(init[path])
        assert np.abs(du - du_ref).max() <= 3e-3 * np.abs(du_ref).max() \
            + 1e-7, f"{what} {jax.tree_util.keystr(path)}"


def test_params_and_running_stats_after_three_steps(runs):
    tmodel = runs["tstate"].model
    got = _to_jax_tree(_state_with(tmodel, {}), runs["template"])
    for part in ("params", "batch_stats"):
        _assert_updates_match(got[part], getattr(runs["jstate"], part),
                              runs["template"][part], part)
    assert runs["tstate"].step == int(runs["jstate"].step) == STEPS


def test_ema_after_three_steps(runs):
    tstate = runs["tstate"]
    ema = _to_jax_tree(_state_with(tstate.model, tstate.ema),
                       runs["template"])["params"]
    _assert_updates_match(ema, runs["jstate"].ema_params,
                          runs["template"]["params"], "ema")


def test_schedule_matches_reference():
    _, jsched = JDet.make_optimizer(warmup_steps=3, total_steps=10)
    _, tsched = TDet.make_optimizer(warmup_steps=3, total_steps=10)
    for count in range(12):
        np.testing.assert_allclose(tsched(count), float(jsched(count)),
                                   rtol=1e-6, atol=1e-9)


def test_weight_decay_only_on_conv_weights():
    model = TY.create(6, "n", device="cpu", train=True)
    opt, sched = TDet.make_optimizer()[0](model)
    decay, no_decay = opt.param_groups
    assert decay["weight_decay"] == 5e-4 and no_decay["weight_decay"] == 0.0
    assert all(p.dim() == 4 for p in decay["params"])
    assert all(p.dim() == 1 for p in no_decay["params"])
    assert opt.param_groups[0]["lr"] == 0.0 and opt.defaults["nesterov"]


@pytest.mark.parametrize("angle", [0.0, 45.0])
def test_augmented_step_runs_on_the_cpu(angle):
    """augment=True and base_augment=True: HSV and flip in bf16, the plain
    K1 (at 45 degrees the op-by-op route), then the step; no kernel
    launches on the CPU; finite metrics; the running statistics and the EMA
    move."""
    images, gb, gc = _batch(1)
    model = TY.create(6, "n", device="cpu", train=True,
                      generator=torch.Generator().manual_seed(0))
    state = TDet.init_state(model, TDet.make_optimizer(warmup_steps=1)[0])
    # 45 degrees: the op-by-op route (every image corrupted, so it runs)
    cfg = CorruptionConfig(blur_angle_deg=angle, prob=1.0 if angle else 0.5)
    step = TDet.make_train_step(IMG, cfg, augment=True, base_augment=True)
    counters = (TC.conv3x3, TC.conv3x3_wgrad, TF.front_fused,
                TF.front_fused_backward, TFC.fused_random_corruption)
    before = [f.launches for f in counters]
    rv = model.model[0].bn.running_var.clone()
    gen = torch.Generator().manual_seed(0)
    for _ in range(2):
        m = step(state, torch.from_numpy(images), torch.from_numpy(gb),
                 torch.from_numpy(gc), gen)
        assert all(torch.isfinite(v).all() for v in m.values())
    assert [f.launches for f in counters] == before
    assert not torch.equal(rv, model.model[0].bn.running_var)
    assert any(not torch.equal(state.ema[n], p)
               for n, p in model.named_parameters() if n in state.ema)
