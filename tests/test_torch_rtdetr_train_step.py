"""The port's whole RT-DETR train step (robust_object_detection_tpu_torch/
train/rtdetr.py) against the reference's ``make_train_step``.

RT-DETR-L's backbone and encoder at full width with a two-layer decoder,
128 px, batch 2, f32, ``augment=False``, ``denoise=True``: the flax model
is initialised, its variables are carried onto the port by
``models/convert.rtdetr_from_jax_variables``, and both sides run 3 steps on
the same uint8 batch with ``make_optimizer(warmup_steps=1)`` (lr 0, then
lr). Both sides get the SAME denoising queries: ``build_dn_queries`` is
replaced on both modules, inside this test only, by one set of arrays drawn
once with the port's function (the two frameworks' generators cannot give
the same bits). The encoder score kernel is zeroed before the variables are
carried over, so every valid anchor scores exactly its bias on both sides
and query selection picks the same anchors in the same order. Nothing in
the JAX package changes. At this size the JAX model takes its XLA branches;
the port runs the plain versions of its kernels: the same math, with the
stem's BNs folded into g*y + b.

What limits the comparison (measured while writing this test). Through the
~120 train-mode BatchNorms of a freshly initialised HGNetv2-L the f32 noise
of another summation order grows: the port's own f32 backbone differs from
its f64 run by 1e-5 (P3), 8e-5 (P4), 2e-4 (P5) of the feature's size, and
from the reference by 3e-5, 2e-4, 7e-4. Noise of 1e-3 on pre-activations
flips about that share of the ReLU masks, and a share s of flipped masks
moves a gradient by ~sqrt(s): every leaf's gradient differs from the
reference's by 5-7% in L2 at a cosine of 0.998, uniformly from the stem to
the decoder, while the loss's own gradient (the two ``rtdetr_loss`` on one
set of outputs) agrees to 2e-7 and the heads' last layers, which no ReLU
separates from the loss, to 1e-3. AdamW's first update is lr x g / |g|, so
after it the entries whose gradient is noise move either way.

That this 5-7% is noise and not a dropped term is shown by a witness without
the noise, ``test_step0_gradients_match_reference_in_float64``: the same
weights, batch and denoising queries through both sides in float64 (the
reference under ``jax.enable_x64`` with its ``jnp.float32`` casts widened,
the port with its ``.float()`` casts widened and its wrappers, which take
f32 and bf16 only, replaced by the plain versions they call on the CPU; all
inside that test only). There the loss agrees to 1e-7 relative and every
leaf's gradient to 1e-6 of its own norm (measured: 2e-9 and 6e-8).

Checks: the loss within rtol 2e-4 and its components within 1e-3 at steps 0
and 1 (step 0 runs at lr 0), the matched and capped counts equal; at step
2, after one real update, both losses lower and within 15% of each other;
the step-0 gradient of every parameter, mapped through
``pretrained.import_rtdetr``: relative L2 error <= 5e-3 for the heads' last
layers, <= 0.12 and cosine >= 0.99 for every leaf that carries more than
1e-4 of the gradient's norm, global cosine >= 0.995; the running
statistics after 3 steps (median leaf error <= 3% of its change, 90% of
the leaves <= 20%); the direction of every significant leaf's update over
the 3 steps, parameters and EMA (cosine >= 0.7, median >= 0.85).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from robust_object_detection_tpu.core.config import CorruptionConfig as JCfg
from robust_object_detection_tpu.models import layers as JL
from robust_object_detection_tpu.models import pretrained
from robust_object_detection_tpu.models import rtdetr as JR
from robust_object_detection_tpu.train import rtdetr as JT
from robust_object_detection_tpu_torch.core.config import CorruptionConfig
from robust_object_detection_tpu_torch.models import convert
from robust_object_detection_tpu_torch.models import layers as TL
from robust_object_detection_tpu_torch.models import rtdetr as TR
from robust_object_detection_tpu_torch.ops import assignment as TA
from robust_object_detection_tpu_torch.ops import conv3x3 as TC
from robust_object_detection_tpu_torch.ops import deform as TD
from robust_object_detection_tpu_torch.ops import fused_corrupt as TFC
from robust_object_detection_tpu_torch.ops import stem as TS
from robust_object_detection_tpu_torch.train import rtdetr as TT

torch.set_num_threads(1)

IMG, B, M, STEPS, LAYERS = 128, 2, 6, 3, 2


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
    back, report = pretrained.import_rtdetr(state, template)
    assert not report.skipped
    return back


@pytest.fixture(scope="module")
def runs():
    images, gb, gc = _batch()
    jcfg = JR.RtDetrConfig(num_classes=6, dec_layers=LAYERS)
    jmodel = JR.RTDETR(jcfg)
    tx, _ = JT.make_optimizer(warmup_steps=1)
    jstate = JT.init_state(jmodel, jax.random.key(0), IMG, tx)
    # a zero encoder score kernel: every valid anchor scores exactly its
    # bias on both sides, so query selection (top-k, ties to the lower
    # index) picks the same anchors in the same order whatever the f32
    # noise of the features; the kernel still gets its gradient
    params = jax.device_get(jstate.params)
    params["enc_score"]["kernel"] = np.zeros_like(
        params["enc_score"]["kernel"])
    jstate = JT.RtdetrTrainState(
        params=params, batch_stats=jstate.batch_stats,
        ema_params=jax.tree.map(np.copy, params),
        opt_state=tx.init(params), step=jstate.step)
    template = jax.device_get({"params": jstate.params,
                               "batch_stats": jstate.batch_stats})

    tmodel = TR.RTDETR(TR.RtDetrConfig(num_classes=6, dec_layers=LAYERS))
    tmodel.load_state_dict(convert.rtdetr_from_jax_variables(
        template["params"], template["batch_stats"]), strict=True)
    tstate = TT.init_state(tmodel.train(),
                           TT.make_optimizer(warmup_steps=1)[0])

    # one set of denoising queries for both sides
    gt_n = TT.to_norm_cxcywh(torch.from_numpy(gb), IMG)
    dn, dn_gt, dn_active = TT.build_dn_queries(
        gt_n, torch.from_numpy(gc), torch.Generator().manual_seed(3),
        max_gt=4)
    jdn = ({k: jnp.asarray(v.numpy()) for k, v in dn.items()},
           jnp.asarray(dn_gt.numpy()), jnp.asarray(dn_active.numpy()))

    grads0 = {}        # the first step's gradients, as backward leaves them

    def keep_first(p, name):
        if name not in grads0:
            grads0[name] = p.grad.clone()
    for name, p in tmodel.named_parameters():
        p.register_post_accumulate_grad_hook(
            lambda p, n=name: keep_first(p, n))

    mp = pytest.MonkeyPatch()
    mp.setattr(TT, "build_dn_queries", lambda *a, **k: (dn, dn_gt, dn_active))
    mp.setattr(JT, "build_dn_queries", lambda *a, **k: jdn)
    try:
        tstep = TT.make_train_step(IMG, CorruptionConfig(), augment=False)
        tlosses = [tstep(tstate, torch.from_numpy(images),
                         torch.from_numpy(gb), torch.from_numpy(gc),
                         torch.Generator().manual_seed(0))
                   for _ in range(STEPS)]

        x = jnp.asarray(images, jnp.float32) / 255.0
        jgt_n = JT.to_norm_cxcywh(jnp.asarray(gb), IMG)

        def loss_fn(params):
            outs, _ = jmodel.apply({"params": params,
                                    "batch_stats": jstate.batch_stats},
                                   x, train=True, dn=jdn[0],
                                   mutable=["batch_stats"])
            loss, _ = JT.rtdetr_loss(outs, jnp.asarray(gb), jnp.asarray(gc),
                                     IMG)
            for li in range(LAYERS):
                loss = loss + JT.dn_loss(outs["dn_logits"][li],
                                         outs["dn_boxes"][li], jdn[1],
                                         jdn[2], jgt_n, jnp.asarray(gc))
            return loss
        jloss0, jgrads = jax.device_get(
            jax.jit(jax.value_and_grad(loss_fn))(jstate.params))
        jstep = jax.jit(JT.make_train_step(jmodel, tx, IMG, JCfg(),
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
                jgrads=jgrads, jloss0=jloss0, jlosses=jlosses, tstate=tstate,
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
    for i, (t, j) in enumerate(zip(runs["tlosses"], runs["jlosses"])):
        assert set(t) == set(j)
        assert int(t["dec_n_pos"]) == int(j["dec_n_pos"])
        if i == 2:
            first = runs["jlosses"][0]["loss"]
            assert t["loss"].item() < first and float(j["loss"]) < first
            np.testing.assert_allclose(t["loss"].item(), float(j["loss"]),
                                       rtol=0.15)
            continue
        np.testing.assert_allclose(t["loss"].item(), float(j["loss"]),
                                   rtol=2e-4, err_msg=f"step {i}")
        for k in ("dec_cls", "dec_l1", "dec_giou", "enc_cls", "dn"):
            np.testing.assert_allclose(t[k].item(), float(j[k]), rtol=1e-3,
                                       err_msg=f"step {i} {k}")
        assert int(t["matcher_capped"]) == int(j["matcher_capped"])
        np.testing.assert_allclose(t["grad_norm"].item(),
                                   float(j["grad_norm"]), rtol=2e-2)
    np.testing.assert_allclose(float(runs["jloss0"]),
                               float(runs["jlosses"][0]["loss"]), rtol=1e-4)


def _l2_cos(got, ref):
    a = np.asarray(ref, np.float64).ravel()
    b = np.asarray(got, np.float64).ravel()
    na, nb = np.linalg.norm(a), np.linalg.norm(b)
    return (np.linalg.norm(a - b) / (na + 1e-30),
            float(a @ b) / (na * nb + 1e-30), na)


def _significant(runs):
    """The leaves that carry more than 1e-4 of the reference gradient's
    norm (the others, e.g. the bias of a BatchNorm that feeds another
    BatchNorm, have gradients of pure f32 noise)."""
    ref = _leaves(runs["jgrads"])
    norms = {p: np.linalg.norm(np.asarray(r, np.float64))
             for p, r in ref.items()}
    total = np.sqrt(sum(n * n for n in norms.values()))
    return {p for p, n in norms.items() if n > 1e-4 * total}


def test_step0_gradients_match_reference(runs):
    tmodel = runs["tstate"].model
    assert set(runs["tgrads"]) == {n for n, _ in tmodel.named_parameters()}
    mapped = _to_jax_tree(_state_with(tmodel, runs["tgrads"]),
                          runs["template"])["params"]
    ref = _leaves(runs["jgrads"])
    got = _leaves(mapped)
    assert got.keys() == ref.keys() and len(ref) > 300
    significant = _significant(runs)
    assert len(significant) > 250
    last = ("enc_score", "dec_score0", "dec_score1")
    for path, r in ref.items():
        name = jax.tree_util.keystr(path)
        l2, cos, _ = _l2_cos(got[path], r)
        if path[0].key in last or (path[0].key.endswith(
                ("enc_bbox", "dec_bbox0", "dec_bbox1"))
                and path[1].key == "Dense_2"):
            assert l2 <= 5e-3, (name, l2)
        if path in significant:
            assert l2 <= 0.12 and cos >= 0.99, (name, l2, cos)
    l2, cos, _ = _l2_cos(np.concatenate([np.ravel(got[p]) for p in ref]),
                         np.concatenate([np.ravel(ref[p]) for p in ref]))
    assert cos >= 0.995 and l2 <= 0.1, (l2, cos)


def test_step0_gradients_match_reference_in_float64(runs):
    """The witness without f32 noise: loss within 1e-7 relative, every
    leaf's gradient within 1e-6 of its own norm (plus 1e-9 of the whole
    gradient's, for the leaves whose true gradient is zero)."""
    images, gb, gc = _batch()
    template = runs["template"]
    f64 = torch.float64
    tmodel = TR.RTDETR(TR.RtDetrConfig(num_classes=6, dec_layers=LAYERS),
                       dtype=f64, param_dtype=f64, bn_dtype=f64)
    state = convert.rtdetr_from_jax_variables(template["params"],
                                              template["batch_stats"])
    tmodel.load_state_dict({k: v.double() if v.is_floating_point() else v
                            for k, v in state.items()}, strict=True)
    tmodel.double().train()      # the LayerNorms and biases too
    gcl = torch.from_numpy(gc)
    gt_n = TT.to_norm_cxcywh(torch.from_numpy(gb).double(), IMG)
    dn, dn_gt, dn_active = TT.build_dn_queries(
        gt_n.float(), gcl, torch.Generator().manual_seed(3), max_gt=4)
    dn = dict(dn, boxes=dn["boxes"].double())

    mp = pytest.MonkeyPatch()
    try:
        # the port: every .float() keeps float64, and the wrappers give way
        # to the plain versions they call on a CPU tensor
        mp.setattr(torch.Tensor, "float", lambda self: self.double())
        mp.setattr(TR, "stem_fused", TS.stem_train_reference)
        mp.setattr(TL, "conv3x3", TC.conv3x3_reference)
        mp.setattr(TR, "ms_deform_attn_slots", TD.ms_deform_attn_ref)
        mp.setattr(TT, "auction_assignment", TA.auction_assignment_plain)
        outs = tmodel(torch.from_numpy(images).double() / 255.0, dn)
        tloss, _ = TT.rtdetr_loss(outs, torch.from_numpy(gb).double(), gcl,
                                  IMG)
        for li in range(LAYERS):
            tloss = tloss + TT.dn_loss(outs["dn_logits"][li],
                                       outs["dn_boxes"][li], dn_gt,
                                       dn_active, gt_n, gcl)
        assert tloss.dtype == f64 and outs["logits"].dtype == f64
        tloss.backward()
        mp.undo()

        # the reference: x64 on, float64 model, BN and every jnp.float32
        # cast widened while it is traced
        with jax.enable_x64(True), JL.bn_dtype_scope(jnp.float64):
            mp.setattr(jnp, "float32", jnp.float64)
            jmodel = JR.RTDETR(JR.RtDetrConfig(num_classes=6,
                                               dec_layers=LAYERS),
                               jnp.float64)
            wide = jax.tree.map(
                lambda a: jnp.asarray(np.asarray(a), jnp.float64), template)
            jdn = {"classes": jnp.asarray(dn["classes"].numpy()),
                   "boxes": jnp.asarray(dn["boxes"].numpy()),
                   "group_ids": jnp.asarray(dn["group_ids"].numpy())}
            jdn_gt = jnp.asarray(dn_gt.numpy())
            jdn_active = jnp.asarray(dn_active.numpy())
            x = jnp.asarray(images, jnp.float64) / 255.0
            jgb, jgc = jnp.asarray(gb, jnp.float64), jnp.asarray(gc)
            jgt_n = JT.to_norm_cxcywh(jgb, IMG)

            def loss_fn(params):
                jouts, _ = jmodel.apply(
                    {"params": params, "batch_stats": wide["batch_stats"]},
                    x, train=True, dn=jdn, mutable=["batch_stats"])
                loss, _ = JT.rtdetr_loss(jouts, jgb, jgc, IMG)
                for li in range(LAYERS):
                    loss = loss + JT.dn_loss(
                        jouts["dn_logits"][li], jouts["dn_boxes"][li],
                        jdn_gt, jdn_active, jgt_n, jgc)
                return loss
            jloss, jgrads = jax.device_get(
                jax.jit(jax.value_and_grad(loss_fn))(wide["params"]))
    finally:
        mp.undo()
    assert jloss.dtype == np.float64
    np.testing.assert_allclose(tloss.item(), float(jloss), rtol=1e-7)

    grads = {n: p.grad for n, p in tmodel.named_parameters()}
    assert all(g is not None and g.dtype == f64 for g in grads.values())
    wide_np = jax.tree.map(lambda a: np.asarray(a, np.float64), template)
    got = _leaves(_to_jax_tree(_state_with(tmodel, grads),
                               wide_np)["params"])
    ref = _leaves(jgrads)
    assert got.keys() == ref.keys() and len(ref) > 300
    total = np.sqrt(sum(np.linalg.norm(np.ravel(r)) ** 2
                        for r in ref.values()))
    for path, r in ref.items():
        assert got[path].dtype == np.float64
        err = np.linalg.norm(np.ravel(got[path]) - np.ravel(r))
        assert err <= 1e-6 * np.linalg.norm(np.ravel(r)) + 1e-9 * total, \
            (jax.tree_util.keystr(path), err)


def test_running_stats_after_three_steps(runs):
    tmodel = runs["tstate"].model
    got = _leaves(_to_jax_tree(_state_with(tmodel, {}),
                               runs["template"])["batch_stats"])
    ref = _leaves(runs["jstate"].batch_stats)
    init = _leaves(runs["template"]["batch_stats"])
    assert got.keys() == ref.keys() and len(ref) > 200
    errs = []
    for path, r in ref.items():
        du_ref = np.asarray(r) - np.asarray(init[path])
        assert np.abs(du_ref).max() > 0
        errs.append(np.abs(np.asarray(got[path]) - np.asarray(r)).max()
                    / np.abs(du_ref).max())
    errs = np.sort(errs)
    assert errs[len(errs) // 2] <= 3e-2 and errs[int(len(errs) * 0.9)] <= 0.2
    assert runs["tstate"].step == int(runs["jstate"].step) == STEPS


def test_params_and_ema_after_three_steps(runs):
    tstate = runs["tstate"]
    tmodel = tstate.model
    got = _to_jax_tree(_state_with(tmodel, {}), runs["template"])["params"]
    ema = _to_jax_tree(_state_with(tmodel, tstate.ema),
                       runs["template"])["params"]
    init = _leaves(runs["template"]["params"])
    significant = _significant(runs)
    for what, mine, ref in (("params", got, runs["jstate"].params),
                            ("ema", ema, runs["jstate"].ema_params)):
        mine, ref = _leaves(mine), _leaves(ref)
        assert mine.keys() == ref.keys()
        coss = []
        for path in significant:
            du_ref = np.asarray(ref[path]) - np.asarray(init[path])
            du = np.asarray(mine[path]) - np.asarray(init[path])
            _, cos, size = _l2_cos(du, du_ref)
            assert size > 0 and cos >= 0.7, \
                (what, jax.tree_util.keystr(path), cos)
            # the same step size: two updates of about lr each
            np.testing.assert_allclose(np.abs(du).max(),
                                       np.abs(du_ref).max(), rtol=0.1)
            coss.append(cos)
        assert np.median(coss) >= 0.85, (what, np.median(coss))
    # the EMA trails the parameters by its decay
    e = _leaves(ema)
    p = _leaves(got)
    path = next(iter(significant))
    assert (np.abs(np.asarray(e[path]) - np.asarray(init[path])).max()
            < np.abs(np.asarray(p[path]) - np.asarray(init[path])).max())


def test_schedule_matches_reference():
    _, jsched = JT.make_optimizer(warmup_steps=3, total_steps=10, lrf=0.01)
    _, tsched = TT.make_optimizer(warmup_steps=3, total_steps=10, lrf=0.01)
    for count in range(12):
        np.testing.assert_allclose(tsched(count), float(jsched(count)),
                                   rtol=1e-6, atol=1e-12)


def _small_trainer_model(layers):
    model = TR.RTDETR(TR.RtDetrConfig(6, dec_layers=layers),
                      param_dtype=torch.float32)
    return TR.init_weights(model, torch.Generator().manual_seed(0)).train()


def test_adamw_decays_every_parameter_and_clip_follows_optax():
    model = _small_trainer_model(1)
    state = TT.init_state(model, TT.make_optimizer(clip=0.1)[0])
    (group,) = state.optimizer.param_groups
    assert group["weight_decay"] == 1e-4 and group["lr"] == 0.0
    assert len(group["params"]) == len(list(model.parameters()))
    assert state.clip == 0.1
    # optax.clip_by_global_norm on a toy gradient
    import optax
    g = np.array([3.0, 4.0], np.float32)
    for clip in (0.1, 10.0):
        want, _ = optax.clip_by_global_norm(clip).update(
            {"g": jnp.asarray(g)}, optax.EmptyState())
        t = torch.from_numpy(g.copy())
        norm = torch.nn.utils.get_total_norm([t])
        torch._foreach_mul_([t], clip / norm.clamp(min=clip))
        np.testing.assert_allclose(t.numpy(), np.asarray(want["g"]),
                                   rtol=1e-6)


def test_augmented_step_runs_on_the_cpu():
    """augment=True, base_augment=True and denoise=True on the CPU: no
    kernel launches, finite metrics, every parameter gets a gradient, the
    running statistics and the EMA move."""
    images, gb, gc = _batch(1)
    model = _small_trainer_model(2)
    state = TT.init_state(model, TT.make_optimizer(warmup_steps=1)[0])
    step = TT.make_train_step(IMG, CorruptionConfig(), augment=True,
                              base_augment=True, dn_max_gt=4)
    counters = (TC.conv3x3, TC.conv3x3_wgrad, TS.stem_fused,
                TS.stem_fused_backward, TD.ms_deform_attn_slots,
                TD.ms_deform_attn_backward, TA.auction_assignment,
                TFC.fused_random_corruption)
    before = [f.launches for f in counters]
    rv = model.model[0].stem1.bn.running_var.clone()
    rv_proj = model.model[28].input_proj[0][1].running_var.clone()
    gen = torch.Generator().manual_seed(0)
    for _ in range(2):
        m = step(state, torch.from_numpy(images), torch.from_numpy(gb),
                 torch.from_numpy(gc), gen)
        assert all(torch.isfinite(v).all() for v in m.values())
    assert all(p.grad is not None for p in model.parameters())
    assert [f.launches for f in counters] == before
    assert not torch.equal(rv, model.model[0].stem1.bn.running_var)
    assert not torch.equal(rv_proj,
                           model.model[28].input_proj[0][1].running_var)
    assert any(not torch.equal(state.ema[n], p)
               for n, p in model.named_parameters())
