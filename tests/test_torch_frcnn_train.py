"""The port's Faster R-CNN training half (models/frcnn.py's targets and
train mode, train/frcnn.py's losses, optimizer and step) against the
reference's, on the same weights (carried across by
``convert.frcnn_from_jax_variables``; back by ``pretrained.import_frcnn``)
and the same numpy-seeded inputs, at a small size: blocks (1, 1, 1, 1), 96
px, batch 2, 8 GT slots (5 valid), pre_nms_topk 64, 48 proposals, rpn_batch
64, roi_batch 48. The reference's BatchNorm statistics, scales and biases
are redrawn from a seed, as in tests/test_torch_frcnn.py.

Draws. The reference's step folds the step into its key and splits it
(train/frcnn.py:189-190, :80; models/frcnn.py:356); these tests draw the
same ``jax.random.uniform`` arrays from the same keys and hand them to the
port as its ``draws``, so both sides sample the same anchors and RoIs. The
matcher, the samplers given those uniforms and ``native_res_epoch_plan``
are held equal; the losses within 1e-6 relative.

What limits the f32 comparison (measured while writing this test): through
the train-mode BatchNorms (fast variance, statistics over as few as 18
values a channel at C5) f32 noise of another summation order moves every
gradient leaf by 0.5-1% in L2 on either side against its own float64 run
(the port's f32 step-0 gradients against the port's float64 ones: median
0.5%, worst 1%), so the two f32 gradients differ by ~1.3%; after one update
that noise moves a proposal or a sampled RoI, and the later steps' gradients
differ by 20-50% while the losses stay within 5e-2 (the port's own f32
run against its float64 run does the same: a RoI slot holds another box
from step 1 on). The three f32 steps are therefore held by their metrics,
by relative L2 and cosine at step 0, and by each parameter's update
(direction and size) over the three steps; the whole step is held tightly
by a float64 run of both sides (the reference under ``jax.enable_x64`` with
``jnp.float32`` widened while it is traced, its draws in float64 as x64
makes them; the port with ``Tensor.float`` widened and its BatchNorm's f32
output cast kept at the input's type, inside that fixture only): the six
metrics within 1e-9 relative and every gradient leaf, parameter and
running statistic within 1e-6 of its own norm (measured: ~3e-8). The
float64 run takes one step at roi_batch 16: XLA's float64 convolutions on
the CPU run below 1 GMAC/s (16-42 s a step here), and the box head's work
grows with the RoIs. The reference's gradients come from its optimizer
state: optax's trace is g + wd * p + momentum * trace_prev.
"""


import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from robust_object_detection_tpu.core.config import CorruptionConfig as JCfg
from robust_object_detection_tpu.models import frcnn as JF
from robust_object_detection_tpu.models import pretrained
from robust_object_detection_tpu.models import resnet as JRES
from robust_object_detection_tpu.train import frcnn as JT
from robust_object_detection_tpu_torch.core.config import CorruptionConfig
from robust_object_detection_tpu_torch.models import convert
from robust_object_detection_tpu_torch.models import frcnn as TF
from robust_object_detection_tpu_torch.models import resnet as TRES
from robust_object_detection_tpu_torch.ops import boxes as tboxes
from robust_object_detection_tpu_torch.ops import corrupt as TC
from robust_object_detection_tpu_torch.ops import fused_corrupt as TFC
from robust_object_detection_tpu_torch.train import frcnn as TT
from tests import _torch_losses as O

torch.set_num_threads(1)

IMG, B, M, N_GT, STEPS = 96, 2, 8, 5, 3
KW = dict(blocks=(1, 1, 1, 1), pre_nms_topk=64, num_proposals=48,
          rpn_batch=64, roi_batch=48)
MOMENTUM, WD = 0.9, 5e-4


def _redraw(v, rng):
    """BN statistics, scales and biases from `rng`."""
    def walk(p, s):
        for k in p:
            if isinstance(p[k], dict):
                walk(p[k], s.get(k, {}) if s is not None else None)
            elif k == "scale":
                p[k] = (rng.rand(*p[k].shape) * 0.5 + 0.75).astype(np.float32)
            elif k == "bias":
                p[k] = (rng.randn(*p[k].shape) * 0.1).astype(np.float32)
        if s is not None and "mean" in s:
            s["mean"] = (rng.randn(*s["mean"].shape) * 0.1).astype(np.float32)
            s["var"] = (rng.rand(*s["var"].shape) * 0.5 + 0.75).astype(
                np.float32)
    walk(v["params"], v["batch_stats"])
    return v


def jax_variables(cfg, seed=0):
    model = JF.FasterRCNN(cfg)
    v = jax.device_get(jax.jit(lambda k: model.init(
        k, jnp.zeros((1, 64, 64, 3), jnp.float32), train=False))(
            jax.random.key(seed)))
    return _redraw(jax.tree.map(np.array, v), np.random.RandomState(seed + 1))


def port_model(kw, v, dtype=torch.float32):
    tm = TF.FasterRCNN(TF.FrcnnConfig(**kw))
    tm.load_state_dict(convert.frcnn_from_jax_variables(
        v["params"], v["batch_stats"], tm.cfg), strict=True)
    return tm.to(dtype)


def to_port(tree, stats, kw):
    """A reference params-shaped tree (params, gradients) and batch_stats ->
    the port's state_dict layout (numpy), in the tree's own dtype (the
    converter's f32 cast is lifted inside this call)."""
    real = convert._t
    convert._t = lambda a: torch.from_numpy(np.array(a))
    try:
        sd = convert.frcnn_from_jax_variables(jax.device_get(tree),
                                              jax.device_get(stats),
                                              TF.FrcnnConfig(**kw))
    finally:
        convert._t = real
    return {k: v.numpy() for k, v in sd.items()}


@pytest.fixture(scope="module")
def variables():
    return jax_variables(JF.FrcnnConfig(**KW))


def gt_batch(seed=0, b=B, m=M, n_gt=N_GT, img=IMG):
    rng = np.random.RandomState(seed)
    images = rng.randint(0, 256, (b, img, img, 3)).astype(np.uint8)
    xy = rng.uniform(0, img * 0.6, (b, m, 2))
    wh = rng.uniform(img * 0.1, img * 0.4, (b, m, 2))
    boxes = np.concatenate([xy, np.minimum(xy + wh, img)], -1).astype(
        np.float32)
    classes = rng.randint(0, 6, (b, m)).astype(np.int32)
    boxes[:, n_gt:] = 0.0
    classes[:, n_gt:] = -1
    return images, boxes, classes


def step_uniforms(key, step, n_anchors, n_cand, b=B):
    """The uniforms the reference's step draws at `step`, from its keys:
    fold_in(key, step) -> (corr, rpn, roi); rpn -> (pos, neg); roi ->
    (match -> (pos, neg), gather)."""
    k = jax.random.fold_in(key, step)
    _, k_rpn, k_roi = jax.random.split(k, 3)
    kp, kn = jax.random.split(k_rpn)
    k_match, k_gather = jax.random.split(k_roi)
    rp, rn = jax.random.split(k_match)

    def u(kk, n, lo=0.01, hi=1.0):
        return np.array(jax.random.uniform(kk, (b, n), minval=lo, maxval=hi))
    return {"rpn_pos": u(kp, n_anchors), "rpn_neg": u(kn, n_anchors),
            "roi_pos": u(rp, n_cand), "roi_neg": u(rn, n_cand),
            "roi_gather": u(k_gather, n_cand, 0.0, 0.5)}


def port_draws(uniforms, b=B):
    d = {k: torch.from_numpy(v) for k, v in uniforms.items()}
    d["choice"] = torch.zeros(b, dtype=torch.int32)
    d["seeds"] = torch.zeros(b, dtype=torch.int32)
    return d


def rel_l2(got, ref):
    a = np.asarray(ref, np.float64).ravel()
    d = np.asarray(got, np.float64).ravel() - a
    return np.linalg.norm(d) / max(np.linalg.norm(a), 1e-30)


def cosine(got, ref):
    a = np.asarray(ref, np.float64).ravel()
    b = np.asarray(got, np.float64).ravel()
    return float(a @ b) / max(np.linalg.norm(a) * np.linalg.norm(b), 1e-30)


# ── matcher ──────────────────────────────────────────────────────────────

def _match_case(case):
    anchors = TF.anchor_boxes(IMG)
    _, gb, gc = gt_batch(seed=4)
    if case == "no_gt":
        gc[1] = -1
    elif case == "duplicate_gt":
        gb[0, 1] = gb[0, 0]          # two GTs share every anchor's IoU
        gc[0, 1] = gc[0, 0]
    return anchors, gb, gc


@pytest.mark.parametrize("case", ["plain", "no_gt", "duplicate_gt"])
def test_match_anchors_equals_reference(case):
    anchors, gb, gc = _match_case(case)
    jm, jl = JF.match_anchors(jnp.asarray(anchors), jnp.asarray(gb),
                              jnp.asarray(gc), 0.7, 0.3)
    tm, tl = TF.match_anchors(torch.from_numpy(anchors), torch.from_numpy(gb),
                              torch.from_numpy(gc), 0.7, 0.3)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    assert (tl == 1).sum() > 0 and (tl == 0).sum() > 0
    if case == "no_gt":
        assert (tl[1] == 0).all()


def test_match_anchors_against_torchvision_matcher():
    """Image by image against the torch oracle of torchvision's Matcher
    (tests/_torch_losses.tv_match_t): positives, negatives and the ignore
    band, and the matched GT of every positive."""
    anchors, gb, gc = _match_case("plain")
    tm, tl = TF.match_anchors(torch.from_numpy(anchors), torch.from_numpy(gb),
                              torch.from_numpy(gc), 0.7, 0.3)
    for b in range(B):
        valid = gc[b] >= 0
        iou = tboxes.pairwise_iou(torch.from_numpy(gb[b][valid]),
                                  torch.from_numpy(anchors))
        matches = O.tv_match_t(iou, 0.7, 0.3, True)
        np.testing.assert_array_equal(
            tl[b].numpy(), np.where(matches >= 0, 1,
                                    np.where(matches == -1, 0, -1)))
        pos = matches >= 0
        np.testing.assert_array_equal(tm[b][pos].numpy(),
                                      matches[pos].numpy())


# ── samplers ─────────────────────────────────────────────────────────────

def _labels(seed, b=3, n=500):
    rng = np.random.RandomState(seed)
    return rng.choice([-1, 0, 1], size=(b, n), p=[0.2, 0.6, 0.2]).astype(
        np.int32)


@pytest.mark.parametrize("batch,frac", [(64, 0.5), (256, 0.25), (32, 0.5)])
def test_samplers_equal_reference_given_uniforms(batch, frac):
    labels = _labels(batch)
    labels[0, :] = np.where(labels[0] == 1, 0, labels[0])   # no positive
    key = jax.random.key(batch)
    k_pos, k_neg = jax.random.split(key)
    u_pos = np.array(jax.random.uniform(k_pos, labels.shape, minval=0.01,
                                        maxval=1.0))
    u_neg = np.array(jax.random.uniform(k_neg, labels.shape, minval=0.01,
                                        maxval=1.0))
    jp, jn = JF.sample_targets(jnp.asarray(labels), batch, frac, key)
    tp, tn = TF.sample_targets(torch.from_numpy(labels), batch, frac,
                               u_pos=torch.from_numpy(u_pos),
                               u_neg=torch.from_numpy(u_neg))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))

    mask = labels == 0
    k = int(batch * frac)
    np.testing.assert_array_equal(
        TF._topk_random(torch.from_numpy(mask), k,
                        torch.from_numpy(u_pos)).numpy(),
        np.asarray(JF._topk_random(jnp.asarray(mask), k, k_pos)))
    kd = np.array([[5], [k], [400]])
    np.testing.assert_array_equal(
        TF._topk_random_dynamic(torch.from_numpy(mask), torch.from_numpy(kd),
                                torch.from_numpy(u_neg)).numpy(),
        np.asarray(JF._topk_random_dynamic(jnp.asarray(mask),
                                           jnp.asarray(kd), k_neg)))


def test_dynamic_sampler_ties_go_to_the_lower_index():
    """Equal uniforms rank by index, as the reference's stable argsort."""
    mask = np.ones((1, 12), bool)
    u = np.full((1, 12), 0.5, np.float32)
    got = TF._topk_random_dynamic(torch.from_numpy(mask),
                                  torch.tensor([[5]]), torch.from_numpy(u))
    assert got[0].nonzero().flatten().tolist() == [0, 1, 2, 3, 4]


def test_sampler_statistics_on_the_port_generator():
    """2000 draws of the port's own generator: at most batch * frac
    positives, the total `batch` when negatives suffice, and each candidate
    kept at its share within 4 sigma (positives: cap / n_pos; negatives:
    the row's negative quota / n_neg)."""
    batch, frac, draws = 32, 0.25, 2000
    labels = torch.full((2, 120), -1, dtype=torch.int32)
    labels[0, :20] = 1             # more positives than the cap of 8
    labels[0, 20:100] = 0
    labels[1, :3] = 1              # fewer positives than the cap
    labels[1, 3:60] = 0
    gen = torch.Generator().manual_seed(0)
    kept_pos = torch.zeros(2, 120)
    kept_neg = torch.zeros(2, 120)
    for _ in range(draws):
        pos, neg = TF.sample_targets(labels, batch, frac, gen)
        assert not (pos & neg).any()
        assert ((pos.sum(-1) <= 8) & ((pos | neg).sum(-1) == batch)).all()
        assert (pos <= (labels == 1)).all() and (neg <= (labels == 0)).all()
        kept_pos += pos
        kept_neg += neg
    for row, n_pos, n_neg in ((0, 20, 80), (1, 3, 57)):
        p_pos = min(8, n_pos) / n_pos
        p_neg = (batch - min(8, n_pos)) / n_neg
        for kept, sl, p in ((kept_pos, slice(0, n_pos), p_pos),
                            (kept_neg, slice(n_pos, n_pos + n_neg), p_neg)):
            share = kept[row, sl] / draws
            sigma = np.sqrt(p * (1 - p) / draws)
            assert (share - p).abs().max().item() <= 4 * sigma + 1e-12, \
                (row, p, share.min().item(), share.max().item())


# ── losses ───────────────────────────────────────────────────────────────

def test_rpn_loss_matches_reference():
    cfg = JF.FrcnnConfig(**KW)
    anchors = JF.anchor_boxes(IMG)
    _, gb, gc = gt_batch(seed=5)
    rng = np.random.RandomState(6)
    obj = rng.randn(B, len(anchors)).astype(np.float32)
    deltas = (rng.randn(B, len(anchors), 4) * 0.5).astype(np.float32)
    key = jax.random.key(3)
    ref = JT.rpn_loss(jnp.asarray(obj), jnp.asarray(deltas),
                      jnp.asarray(anchors), jnp.asarray(gb), jnp.asarray(gc),
                      cfg, key)
    kp, kn = jax.random.split(key)
    u = [torch.from_numpy(np.array(jax.random.uniform(
        k, obj.shape, minval=0.01, maxval=1.0))) for k in (kp, kn)]
    got = TT.rpn_loss(torch.from_numpy(obj), torch.from_numpy(deltas),
                      torch.from_numpy(anchors), torch.from_numpy(gb),
                      torch.from_numpy(gc), TF.FrcnnConfig(**KW),
                      u_pos=u[0], u_neg=u[1])
    for k in ("rpn_obj", "rpn_box"):
        np.testing.assert_allclose(got[k].item(), float(ref[k]), rtol=1e-6)


def _proposals(rng, n, n_invalid):
    xy = rng.uniform(0, IMG * 0.7, (B, n, 2))
    wh = rng.uniform(4, IMG * 0.5, (B, n, 2))
    props = np.concatenate([xy, np.minimum(xy + wh, IMG)], -1).astype(
        np.float32)
    valid = np.ones((B, n), bool)
    valid[:, n - n_invalid:] = False
    props[~valid] = 0.0
    return props, valid


@pytest.mark.parametrize("n_invalid", [0, 30])
def test_roi_targets_match_reference(n_invalid):
    """48 RoIs from 48 proposals and 8 GT slots; with 30 proposals invalid
    fewer candidates are sampled than R, so unsampled ones fill the slots
    in index order (the reference's lax.top_k ties); those filler rows
    include zero boxes whose delta targets are inf / nan on both sides."""
    kw = KW
    rng = np.random.RandomState(n_invalid)
    props, valid = _proposals(rng, 48, n_invalid)
    _, gb, gc = gt_batch(seed=7)
    key = jax.random.key(9)
    ref = JT.roi_targets(jnp.asarray(props), jnp.asarray(valid),
                         jnp.asarray(gb), jnp.asarray(gc),
                         JF.FrcnnConfig(**kw), key)
    k_match, k_gather = jax.random.split(key)
    kp, kn = jax.random.split(k_match)
    c = 48 + M
    u = {n: torch.from_numpy(np.array(jax.random.uniform(
        k, (B, c), minval=lo, maxval=hi)))
        for n, k, lo, hi in (("u_pos", kp, 0.01, 1.0),
                             ("u_neg", kn, 0.01, 1.0),
                             ("u_gather", k_gather, 0.0, 0.5))}
    got = TT.roi_targets(torch.from_numpy(props), torch.from_numpy(valid),
                         torch.from_numpy(gb), torch.from_numpy(gc),
                         TF.FrcnnConfig(**kw), **u)
    rois, roi_valid, cls_t, delta_t, pos = (t.numpy() for t in got)
    jr = [np.asarray(a) for a in ref]
    np.testing.assert_array_equal(rois, jr[0])
    np.testing.assert_array_equal(roi_valid, jr[1])
    np.testing.assert_array_equal(cls_t, jr[2])
    np.testing.assert_allclose(delta_t, jr[3], rtol=1e-5, atol=1e-5,
                               equal_nan=True)
    np.testing.assert_array_equal(pos, jr[4])
    if n_invalid:
        assert (~roi_valid).sum() > 0 and not np.isfinite(delta_t).all()
    else:
        assert roi_valid.all()


def test_head_loss_matches_reference():
    rng = np.random.RandomState(8)
    r, k = 40, 7
    scores = rng.randn(B, r, k).astype(np.float32) * 2
    deltas = rng.randn(B, r, k, 4).astype(np.float32)
    cls_t = rng.randint(0, k, (B, r)).astype(np.int32)
    delta_t = rng.randn(B, r, 4).astype(np.float32)
    valid = rng.rand(B, r) < 0.8
    pos = valid & (cls_t > 0)
    ref = JT.head_loss(*(jnp.asarray(a) for a in (scores, deltas, cls_t,
                                                    delta_t, valid, pos)))
    got = TT.head_loss(torch.from_numpy(scores), torch.from_numpy(deltas),
                       torch.from_numpy(cls_t).long(),
                       torch.from_numpy(delta_t), torch.from_numpy(valid),
                       torch.from_numpy(pos))
    for name in ("head_cls", "head_box"):
        np.testing.assert_allclose(got[name].item(), float(ref[name]),
                                   rtol=1e-6)


# ── train-mode modules ───────────────────────────────────────────────────

def test_train_mode_modules_and_running_statistics(variables):
    """ResNet + FPN + RPN (extract) and the box head (on pooled RoIs) in
    train mode: outputs within 1e-4 x max|ref| (measured 1.5-3e-5 on the
    pyramid: the batch statistics' fast variance, over 8-1152 values a
    channel here, sums in another order), and every running statistic
    after the update (momentum 0.99) within 1e-6 of its leaf's size."""
    jm = JF.FasterRCNN(JF.FrcnnConfig(**KW))
    tm = port_model(KW, variables)
    rng = np.random.RandomState(2)
    x = rng.rand(B, IMG, IMG, 3).astype(np.float32)
    rois = rng.randn(B, 12, 7, 7, 256).astype(np.float32)
    @jax.jit
    def forward(v, x, rois):
        out, mut = jm.apply(v, x, train=True, mutable=["batch_stats"],
                            method=jm.extract)
        head, mut2 = jm.apply({"params": v["params"],
                               "batch_stats": mut["batch_stats"]},
                              None, rois, train=True,
                              mutable=["batch_stats"],
                              method=jm.roi_forward_pooled)
        return out, head, mut2
    (pyr, obj, d), (s, bd), mut2 = jax.device_get(
        forward(variables, jnp.asarray(x), jnp.asarray(rois)))
    with torch.no_grad():
        tpyr, tobj, td = tm.extract(torch.from_numpy(x), train=True)
        ts, tbd = tm.roi_forward_pooled(None, torch.from_numpy(rois),
                                        train=True)
    pairs = [(a.permute(0, 2, 3, 1), r) for a, r in zip(tpyr, pyr)]
    pairs += [(tobj, obj), (td, d), (ts, s), (tbd, bd)]
    for got, ref in pairs:
        ref = np.asarray(ref)
        err = np.abs(got.numpy() - ref).max()
        assert err <= 1e-4 * np.abs(ref).max(), err
    ref_sd = to_port(variables["params"], mut2["batch_stats"], KW)
    before = to_port(variables["params"], variables["batch_stats"], KW)
    sd = tm.state_dict()
    n = 0
    for name, t in sd.items():
        if "running_" not in name:
            continue
        moved = np.abs(ref_sd[name] - before[name]).max()
        assert moved > 0, name
        np.testing.assert_allclose(t.numpy(), ref_sd[name], rtol=0,
                                   atol=1e-6 * np.abs(ref_sd[name]).max())
        n += 1
    assert n == 2 * sum(1 for k in sd if k.endswith("running_mean"))


# ── three whole steps ────────────────────────────────────────────────────

def _reference_grads(trace_before, trace_after, params):
    """g = trace - momentum * trace_prev - wd * p (optax's sgd trace over
    add_decayed_weights), leaf by leaf."""
    t1, t0, p = jax.device_get((trace_after, trace_before, params))
    return jax.tree.map(lambda a, b, c: a - MOMENTUM * b - WD * c, t1, t0, p)


def _run_steps(variables, kw, dtype, steps=STEPS, augment=False):
    """Both sides from `variables` for `steps` steps on one batch with the
    reference's draws. Returns (reference, port, the port's state, the
    port's state_dict before the steps); per step each side gives its
    metrics, gradients and state after the step in the port's layout, and
    the reference also its own variables."""
    images, gb, gc = gt_batch()
    f64 = dtype == torch.float64
    jdt = jnp.float64 if f64 else jnp.float32
    cfg = JF.FrcnnConfig(**kw)
    n_anchors = len(JF.anchor_boxes(IMG))
    n_cand = cfg.num_proposals + M
    key = jax.random.key(0)
    frozen = JRES.frozen_param_labels(cfg.blocks, cfg.trainable_layers)

    mp = pytest.MonkeyPatch()
    ref = []
    try:
        with jax.enable_x64(f64):
            if f64:
                mp.setattr(jnp, "float32", jnp.float64)
            jm = JF.FasterRCNN(cfg, jdt)
            tx, _ = JT.make_optimizer(steps_per_epoch=1, frozen=frozen)
            params = jax.tree.map(lambda a: jnp.asarray(a, jdt),
                                  variables["params"])
            stats = jax.tree.map(lambda a: jnp.asarray(a, jdt),
                                 variables["batch_stats"])
            state = JT.FrcnnTrainState(params, stats, tx.init(params),
                                       jnp.asarray(0))
            jstep = jax.jit(JT.make_train_step(jm, tx, IMG, JCfg(), augment))
            uniforms = [step_uniforms(key, s, n_anchors, n_cand)
                        for s in range(steps)]
            for _ in range(steps):
                trace0 = state.opt_state[1][0].trace
                p0 = state.params
                state, metrics = jstep(state, jnp.asarray(images),
                                       jnp.asarray(gb, jdt), jnp.asarray(gc),
                                       key)
                grads = _reference_grads(trace0, state.opt_state[1][0].trace,
                                         p0)
                ref.append((jax.device_get(metrics),
                            to_port(grads, variables["batch_stats"], kw),
                            to_port(state.params, state.batch_stats, kw),
                            jax.device_get({"params": state.params,
                                            "batch_stats":
                                                state.batch_stats})))
    finally:
        mp.undo()

    tm = port_model(kw, variables, dtype)
    start = {k: v.numpy().copy() for k, v in tm.state_dict().items()}
    tx, _ = TT.make_optimizer(steps_per_epoch=1, frozen=frozen)
    tstate = TT.init_state(tm, tx)
    tstep = TT.make_train_step(tm, IMG, CorruptionConfig(), augment)
    grads = {}
    for n, p in tm.named_parameters():
        p.register_post_accumulate_grad_hook(
            lambda p, n=n: grads.__setitem__(n, p.grad.detach().clone()))
    bn_train = TRES.bn_train
    mine = []
    try:
        if f64:
            mp.setattr(torch.Tensor, "float", lambda self: self.double())
            mp.setattr(TRES, "bn_train", lambda y, bn, _, m: bn_train(
                y, bn, y.dtype, m))
        for s in range(steps):
            grads.clear()
            metrics = tstep(tstate, torch.from_numpy(images),
                            torch.from_numpy(gb).to(dtype),
                            torch.from_numpy(gc), 0,
                            port_draws(uniforms[s]))
            mine.append(({k: v.item() for k, v in metrics.items()},
                         {k: v.numpy() for k, v in grads.items()},
                         {k: v.detach().numpy().copy()
                          for k, v in tm.state_dict().items()}))
    finally:
        mp.undo()
    return ref, mine, tstate, start


@pytest.fixture(scope="module")
def f64_runs(variables):
    return _run_steps(variables, dict(KW, roi_batch=16), torch.float64,
                      steps=1)


@pytest.fixture(scope="module")
def f32_runs(variables):
    return _run_steps(variables, KW, torch.float32)


METRICS = ("rpn_obj", "rpn_box", "head_cls", "head_box", "loss", "grad_norm")


def test_float64_step_matches_reference(f64_runs, variables, monkeypatch):
    """Every metric within 1e-9 relative, every gradient leaf, parameter
    and running statistic within 1e-6 of its own norm; the state compared
    both ways: the reference's converted to the port's layout, and the
    port's carried back by pretrained.import_frcnn (its ResNet-50 stage
    table narrowed to this model's blocks inside this test)."""
    ref, mine, tstate, start = f64_runs
    assert tstate.step == 1
    monkeypatch.setattr(pretrained, "RESNET50_STAGES", KW["blocks"])
    template = jax.tree.map(lambda a: np.asarray(a, np.float64), variables)
    for s, ((jmet, jg, jsd, jvars), (tmet, tg, tsd)) in enumerate(
            zip(ref, mine)):
        for k in METRICS:
            np.testing.assert_allclose(tmet[k], float(jmet[k]), rtol=1e-9,
                                       err_msg=f"step {s} {k}")
        assert set(tg) == {n for n in jsd if n in tg} and len(tg) > 60
        total = np.sqrt(sum(np.sum(np.square(jg[n], dtype=np.float64))
                            for n in tg))
        for n, g in tg.items():
            assert g.dtype == jg[n].dtype == np.float64
            # leaves whose true gradient is zero (P5's BN bias: no RoI
            # reaches P5 at 96 px) are held by the whole gradient's norm
            err = np.linalg.norm(g - jg[n])
            assert err <= 1e-6 * np.linalg.norm(jg[n]) + 1e-9 * total, \
                (s, n, err)
        for n, t in tsd.items():
            if n.endswith("num_batches_tracked"):
                continue
            assert rel_l2(t, jsd[n]) <= 1e-6, (s, n)
        back, report = pretrained.import_frcnn(tsd, template)
        assert not report.skipped
        for tree in ("params", "batch_stats"):
            got = dict(jax.tree_util.tree_leaves_with_path(back[tree]))
            want = dict(jax.tree_util.tree_leaves_with_path(jvars[tree]))
            assert got.keys() == want.keys()
            for path, w in want.items():
                assert rel_l2(got[path], w) <= 1e-6, (s, path)
    # a real update: every parameter and running statistic moved
    assert all(not np.array_equal(t, start[n]) for n, t in tsd.items()
               if not n.endswith("num_batches_tracked"))


def test_float32_steps_against_reference(f32_runs):
    """f32 (see the docstring): at step 0 the losses within 1e-4 relative
    (measured 2.5e-5), grad_norm within 1e-2 (4e-4), every gradient leaf
    within 5% relative L2 at a cosine of 0.998, the state after the step
    within 1e-3 of each leaf's norm; at steps 1 and 2 the total loss within
    1e-2, its parts within 5e-2, grad_norm within 5e-2 and the whole
    gradient at a cosine of 0.85 (measured 0.976, 0.893: the RoIs of steps
    1-2 differ); after each of them every parameter's update since the
    start points the reference's way (cosine >= 0.9, measured >= 0.986)
    with the same largest entry within 25% (measured up to 13%), every
    running statistic within 1% of its norm (measured <= 2.7e-3)."""
    ref, mine, tstate, start = f32_runs
    assert tstate.step == STEPS
    for s, ((jmet, _, _, _), (tmet, _, _)) in enumerate(zip(ref, mine)):
        for k in METRICS:
            tol = (1e-2 if k == "grad_norm" else 1e-4) if s == 0 else (
                1e-2 if k == "loss" else 5e-2)
            np.testing.assert_allclose(tmet[k], float(jmet[k]), rtol=tol,
                                       err_msg=f"step {s} {k}")
    _, jg, jsd, _ = ref[0]
    _, tg, tsd = mine[0]
    for n, g in tg.items():
        assert rel_l2(g, jg[n]) <= 5e-2 and cosine(g, jg[n]) >= 0.998, n
    for n, t in tsd.items():
        if not n.endswith("num_batches_tracked"):
            assert rel_l2(t, jsd[n]) <= 1e-3, n
    for s in range(1, STEPS):
        (_, jg, jsd, _), (_, tg, tsd) = ref[s], mine[s]
        flat = [np.concatenate([g[n].ravel() for n in tg]) for g in (tg, jg)]
        assert cosine(*flat) >= 0.85, (s, cosine(*flat))
        for n, t in tsd.items():
            if n.endswith("num_batches_tracked"):
                continue
            if "running_" in n:
                assert rel_l2(t, jsd[n]) <= 1e-2, (s, n)
            else:
                du, dj = t - start[n], jsd[n] - start[n]
                assert cosine(du, dj) >= 0.9, (s, n, cosine(du, dj))
                np.testing.assert_allclose(np.abs(du).max(),
                                           np.abs(dj).max(), rtol=0.25,
                                           err_msg=f"step {s} {n}")


def test_trainable_layers_three_freezes_the_stem_and_layer1(variables):
    """trainable_layers=3 (one f32 step): frozen parameters (stem and
    layer1) bit-identical before and after on both sides and given no
    gradient, their running statistics moved; every other leaf, and every
    running statistic, within 1e-3 of its norm of the reference's; the
    port's optimizer holds exactly the parameters the reference's decay
    mask decays (make_optimizer(frozen=...))."""
    kw = dict(KW, trainable_layers=3)
    ref, mine, tstate, start = _run_steps(variables, kw, torch.float32,
                                          steps=1)
    (jmet, _, jsd, _), (tmet, tg, tsd) = ref[0], mine[0]
    frozen = ("backbone.body.conv1.", "backbone.body.bn1.",
              "backbone.body.layer1.")
    np.testing.assert_allclose(tmet["loss"], float(jmet["loss"]), rtol=1e-4)
    n_frozen = 0
    for n, t in tsd.items():
        if n.endswith("num_batches_tracked"):
            continue
        if n.startswith(frozen) and "running_" not in n:
            np.testing.assert_array_equal(t, start[n])
            np.testing.assert_array_equal(jsd[n], start[n])
            assert n not in tg
            n_frozen += 1
        else:
            assert rel_l2(t, jsd[n]) <= 1e-3, n
            if "running_" in n:
                assert not np.array_equal(t, start[n]), n
    assert n_frozen == 3 + 3 * 3 + 3     # stem, 3 conv + bn, downsample
    in_opt = {id(p) for g in tstate.optimizer.param_groups
              for p in g["params"]}
    names = {n for n, p in tstate.model.named_parameters() if id(p) in in_opt}

    # the reference's decay mask: updates of zero gradients are -lr * wd * p
    # exactly where the mask decays
    frozen_labels = JRES.frozen_param_labels(kw["blocks"], 3)
    tx, _ = JT.make_optimizer(frozen=frozen_labels)
    params = jax.tree.map(jnp.asarray, variables["params"])
    upd, _ = tx.update(jax.tree.map(jnp.zeros_like, params),
                       tx.init(params), params)
    decayed = to_port(upd, variables["batch_stats"], kw)
    assert names == {n for n in names | set(tg) if n in decayed
                     and np.abs(decayed[n]).max() > 0}
    assert names == {n for n, _ in tstate.model.named_parameters()
                     if not n.startswith(frozen)}
    assert TRES.module_names(kw["blocks"], frozen_labels) == [
        "bn1", "conv1", "layer1.0"]


def test_step_lr_boundaries_match_reference():
    _, jsched = JT.make_optimizer(steps_per_epoch=3)
    _, tsched = TT.make_optimizer(steps_per_epoch=3)
    for count in (0, 1, 23, 24, 25, 47, 48, 49, 100):
        np.testing.assert_allclose(tsched(count), float(jsched(count)),
                                   rtol=1e-6)
    tm = TF.FasterRCNN(TF.FrcnnConfig(**KW))
    opt, sched = TT.make_optimizer(steps_per_epoch=3)[0](tm)
    lrs = []
    for _ in range(50):
        lrs.append(opt.param_groups[0]["lr"])
        opt.step()
        sched.step()
    np.testing.assert_allclose(lrs, [float(jsched(c)) for c in range(50)],
                               rtol=1e-6)
    g = opt.param_groups[0]
    assert g["momentum"] == 0.9 and g["dampening"] == 0 and \
        g["weight_decay"] == 5e-4 and not g["nesterov"]
    assert len(g["params"]) == len(list(tm.parameters()))


def test_native_res_epoch_plan_equals_reference():
    buckets = {(256, 256): list(range(0, 20)),
               (256, 320): list(range(100, 130)),
               (320, 256): list(range(200, 203)),
               (384, 256): [300]}
    for seed in (0, 7, 42):
        for bs in (1, 2, 4):
            assert TT.native_res_epoch_plan(buckets, bs, seed) == \
                JT.native_res_epoch_plan(buckets, bs, seed)


def test_augment_step_goes_through_the_fused_corruption(variables,
                                                        monkeypatch):
    """augment=True: the step hands its drawn choice and seeds to
    fused_random_corruption (on the CPU its plain version) and trains on
    its output: the same step with augment=False on the corrupted batch
    gives the same metrics."""
    images, gb, gc = gt_batch()
    calls = []
    real = TT.fused_random_corruption

    def spy(img, gen, cfg, choice=None, seeds=None):
        out = real(img, gen, cfg, choice=choice, seeds=seeds)
        calls.append((choice.clone(), out[0].clone()))
        return out
    monkeypatch.setattr(TT, "fused_random_corruption", spy)
    cfg = JF.FrcnnConfig(**KW)
    n_cand = cfg.num_proposals + M
    u = port_draws(step_uniforms(jax.random.key(0), 0,
                                 len(JF.anchor_boxes(IMG)), n_cand))
    u["choice"] = torch.tensor([TC.NOISE, TC.BLUR], dtype=torch.int32)
    u["seeds"] = torch.tensor([11, 12], dtype=torch.int32)
    runs = []
    for augment, x in ((True, torch.from_numpy(images)), (False, None)):
        tm = port_model(KW, variables)
        state = TT.init_state(tm, TT.make_optimizer()[0])
        step = TT.make_train_step(tm, IMG, CorruptionConfig(), augment)
        if x is None:
            x = calls[0][1].to(torch.uint8)
        runs.append(step(state, x, torch.from_numpy(gb),
                         torch.from_numpy(gc), 0, u))
    assert len(calls) == 1 and calls[0][0].tolist() == [TC.NOISE, TC.BLUR]
    corrupted = calls[0][1]
    np.testing.assert_array_equal(
        corrupted.numpy(), TFC.fused_corruption_reference(
            torch.from_numpy(images).float(), u["choice"], u["seeds"]).numpy())
    assert not torch.equal(corrupted, torch.from_numpy(images).float())
    for k in METRICS:
        np.testing.assert_allclose(runs[0][k].item(), runs[1][k].item(),
                                   rtol=1e-6)


def test_augment_step_at_45_degrees_takes_the_op_route(variables,
                                                       monkeypatch):
    """blur_angle_deg=45, which K1 does not compute: the step corrupts its
    drawn choice and seeds op by op (random_corruption_fast) without
    calling K1's entry, and trains on that output: the same step with
    augment=False on the route's batch gives the same metrics. The noise
    image is K1's for the seed, the blur image is not K1's 0-degree one."""
    images, gb, gc = gt_batch()
    calls = []
    real = TT.fused_random_corruption

    def spy(*a, **k):
        calls.append(a[0].shape)
        return real(*a, **k)
    monkeypatch.setattr(TT, "fused_random_corruption", spy)
    cfg = JF.FrcnnConfig(**KW)
    u = port_draws(step_uniforms(jax.random.key(0), 0,
                                 len(JF.anchor_boxes(IMG)),
                                 cfg.num_proposals + M))
    u["choice"] = torch.tensor([TC.NOISE, TC.BLUR], dtype=torch.int32)
    u["seeds"] = torch.tensor([11, 12], dtype=torch.int32)
    corruption = CorruptionConfig(blur_angle_deg=45.0)
    x = torch.from_numpy(images)
    runs = []
    for augment in (True, False):
        tm = port_model(KW, variables)
        state = TT.init_state(tm, TT.make_optimizer()[0])
        step = TT.make_train_step(tm, IMG, corruption, augment)
        runs.append(step(state, x, torch.from_numpy(gb),
                         torch.from_numpy(gc), 0, u))
        if augment:
            assert calls == []
            corrupted, _ = TC.random_corruption_fast(
                x.float(), None, corruption, u["choice"], u["seeds"])
            x = corrupted.to(torch.uint8)
    k1, _ = real(torch.from_numpy(images).float(), None, CorruptionConfig(),
                 u["choice"], u["seeds"])
    assert torch.equal(corrupted[0], k1[0])
    assert not torch.equal(corrupted[1], k1[1])
    for k in METRICS:
        assert np.isfinite(runs[0][k].item())
        np.testing.assert_allclose(runs[0][k].item(), runs[1][k].item(),
                                   rtol=1e-6)


def test_step_draws_depend_on_seed_and_step_alone():
    """draw_train from step_generator(seed, step): the same draws for the
    same (seed, step), others for another step or seed; shapes and
    ranges."""
    def draws(seed, step):
        return TT.draw_train(2, 30, 12, TT.step_generator(seed, step, "cpu"))
    a, b = draws(0, 3), draws(0, 3)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["rpn_pos"], draws(0, 4)["rpn_pos"])
    assert not torch.equal(a["rpn_pos"], draws(1, 3)["rpn_pos"])
    assert a["rpn_pos"].shape == (2, 30) and a["roi_gather"].shape == (2, 12)
    assert a["choice"].shape == a["seeds"].shape == (2,)
    for k in ("rpn_pos", "rpn_neg", "roi_pos", "roi_neg"):
        assert a[k].min() >= 0.01 and a[k].max() < 1.0
    assert a["roi_gather"].min() >= 0.0 and a["roi_gather"].max() < 0.5
