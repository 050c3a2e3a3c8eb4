"""Faster R-CNN's bf16 mode (models/{resnet, fpn, frcnn}.py ``dtype``,
train/frcnn.py ``train(dtype=...)``) against the reference's
``FasterRCNN(dtype=jnp.bfloat16)`` on the same weights (carried across by
``convert.frcnn_from_jax_variables``), at tests/test_torch_frcnn_train.py's
sizes: blocks (1, 1, 1, 1), 96 px, batch 2, 8 GT slots, both FPN layouts.

Every bf16 comparison is held against the reference's own bf16-vs-f32
spread, measured in the test on the same inputs: ``spread_ratio`` =
||port_bf16 - ref_bf16|| / ||ref_bf16 - ref_f32|| (L2 over the tensor;
an f32 port scores 1.0 by construction). The reference is compiled
without XLA's excess precision, which on the CPU keeps some bf16 results
in f32. Both sides then round the same operands at the same places and
part only where another f32 summation order flips a bf16 rounding, which
the BatchNorms amplify. Bars (measured while writing this test):

  * the whole extract and roi_forward chain: 0.85 (measured 0.41-0.78;
    ResNet's and the FPN's BatchNorms left in bf16: 0.93-1.12);
  * the RPN head on the reference's bf16 pyramid: 0.2 (0.025-0.033; its
    1x1 convs computed in bf16 where flax promotes them to f32:
    0.63-0.71);
  * the box head on the same pyramid and proposals: 0.5 (0.41-0.47; the
    predictor in bf16: 0.55-0.69);
  * one train step (sampler identity: both sides take the reference's
    draws and its bf16 proposals, replayed into both steps): the vector
    of the five losses 0.6 (0.39), grad_norm 1.0 (0.83), all gradients
    together 0.8 (0.64) and each leaf 1.25 (0.40-1.02): bf16 gradients
    of a network this small, with BatchNorm over 18-1152 values a
    channel, sit 20-46% (relative L2) from their f32 counterparts on
    the reference's own side.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch
import torch.nn.functional as TFn

import jax
import jax.numpy as jnp

from robust_object_detection_tpu.core.config import CorruptionConfig as JCfg
from robust_object_detection_tpu.models import frcnn as JF
from robust_object_detection_tpu.models import resnet as JRES
from robust_object_detection_tpu.train import frcnn as JT
from robust_object_detection_tpu_torch.core.config import (CorruptionConfig,
                                                           ExperimentConfig)
from robust_object_detection_tpu_torch.models import convert
from robust_object_detection_tpu_torch.models import frcnn as TF
from robust_object_detection_tpu_torch.train import detector as TD
from robust_object_detection_tpu_torch.train import frcnn as TT

from test_torch_frcnn_train import (B, IMG, KW, M, _reference_grads,
                                    gt_batch, jax_variables, port_draws,
                                    rel_l2, step_uniforms, to_port)

torch.set_num_threads(1)

BF16 = torch.bfloat16
# bars on spread_ratio, from the measurements in the docstring
CHAIN, RPN_HEAD, BOX_HEAD = 0.85, 0.2, 0.5
STEP_LOSSES, STEP_NORM, STEP_GRADS, STEP_LEAF = 0.6, 1.0, 0.8, 1.25


def port_model(kw, v, dtype):
    tm = TF.FasterRCNN(TF.FrcnnConfig(**kw), dtype)
    tm.load_state_dict(convert.frcnn_from_jax_variables(
        v["params"], v["batch_stats"], tm.cfg), strict=True)
    return tm


@pytest.fixture(scope="module", params=[True, False],
                ids=["fpn_norm", "bias_fpn"])
def norm_vars(request):
    kw = dict(KW, fpn_norm=request.param)
    return kw, jax_variables(JF.FrcnnConfig(**kw))


def spread_ratio(got, ref_bf16, ref_f32) -> float:
    """||port - ref_bf16|| / ||ref_bf16 - ref_f32|| (L2 over the tensor:
    single rounding flips average out where a max would pick one)."""
    rb = np.asarray(ref_bf16, np.float64)
    spread = np.linalg.norm(rb - np.asarray(ref_f32, np.float64))
    assert spread > 0
    return float(np.linalg.norm(np.asarray(got, np.float64) - rb) / spread)


# ── forward pieces ───────────────────────────────────────────────────────

def run_exact(fn, *args):
    """fn jitted without XLA's excess precision, which on the CPU would
    keep some bf16 results in f32: the reference then rounds where its
    flax dtypes say, as the port does."""
    return jax.device_get(jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_allow_excess_precision": False})(*args))


def _reference_pieces(kw, v, dtype, x, proposals, pyramid=None):
    """(pyramid, obj, deltas, scores, box_deltas): the whole extract and
    roi_forward, or with `pyramid` given, the RPN head and the RoI heads
    on it."""
    jm = JF.FasterRCNN(JF.FrcnnConfig(**kw), dtype)

    def run(v, x, p, pyr):
        if pyr is None:
            pyr, obj, d = jm.apply(v, x, method=jm.extract)
        else:
            obj, d = jm.apply(v, pyr, method=lambda m, f: m.rpn_head(f))
        s, bd = jm.apply(v, pyr, p, method=jm.roi_forward)
        return pyr, obj, d, s, bd
    return run_exact(run, v, x, proposals, pyramid)


def _port_pieces(tm, x, proposals, pyramid=None):
    with torch.no_grad():
        if pyramid is None:
            pyr, obj, d = tm.extract(torch.from_numpy(x))
        else:
            pyr = [torch.from_numpy(np.asarray(p, np.float32)).to(
                torch.float32 if np.asarray(p).dtype == np.float32
                else tm.dtype).permute(0, 3, 1, 2) for p in pyramid]
            obj, d = tm.rpn["head"](pyr)
        s, bd = tm.roi_forward(pyr, torch.from_numpy(proposals))
    return ([p.permute(0, 2, 3, 1).float().numpy() for p in pyr],
            obj.numpy(), d.numpy(), s.numpy(), bd.numpy())


def _inputs():
    rng = np.random.RandomState(3)
    x = rng.rand(B, IMG, IMG, 3).astype(np.float32)
    xy = rng.uniform(0, IMG * 0.7, (B, 24, 2))
    wh = rng.uniform(4, IMG * 0.5, (B, 24, 2))
    props = np.concatenate([xy, np.minimum(xy + wh, IMG)], -1).astype(
        np.float32)
    return x, props


_REFERENCE = {}      # the reference's pieces, once per FPN layout


def _pieces(kw, v, pyramid=None, tm=None):
    """(port, reference bf16, reference f32) pieces: the whole chain, or
    with `pyramid` (the reference's bf16 pyramid) the heads on it."""
    x, props = _inputs()
    key = (kw["fpn_norm"], pyramid is None)
    if key not in _REFERENCE:
        args = (jnp.asarray(x), jnp.asarray(props), pyramid)
        _REFERENCE[key] = tuple(_reference_pieces(kw, v, dt, *args)
                                for dt in (jnp.bfloat16, jnp.float32))
    rb, rf = _REFERENCE[key]
    got = _port_pieces(tm or port_model(kw, v, BF16), x, props, pyramid)
    return got, rb, rf


PIECES = ("obj", "rpn_deltas", "scores", "box_deltas")


def test_forward_pieces_match_reference_bf16(norm_vars):
    """The pyramid P2..P6, RPN objectness and deltas and the box head on
    the same proposals, the whole chain from the image; then the RPN head
    and the box head on the reference's bf16 pyramid. The pyramid is f32
    with the v2 FPN and bf16 with the bias FPN, the RPN and box-head
    outputs always f32."""
    kw, v = norm_vars
    got, rb, rf = _pieces(kw, v)
    want = np.float32 if kw["fpn_norm"] else jnp.bfloat16
    assert all(np.asarray(p).dtype == want for p in rb[0])
    tm = port_model(kw, v, BF16)
    with torch.no_grad():
        pyr = tm.extract(torch.from_numpy(_inputs()[0]))[0]
    assert all(p.dtype == (torch.float32 if kw["fpn_norm"] else BF16)
               for p in pyr)
    for lvl, (g, b, f) in enumerate(zip(got[0], rb[0], rf[0])):
        assert spread_ratio(g, b, f) <= CHAIN, f"P{lvl + 2}"
    for name, g, b, f in zip(PIECES, got[1:], rb[1:], rf[1:]):
        assert g.dtype == np.float32, name
        assert spread_ratio(g, b, f) <= CHAIN, name
    got, rb, rf = _pieces(kw, v, rb[0], tm)
    for name, g, b, f in zip(PIECES, got[1:], rb[1:], rf[1:]):
        bar = RPN_HEAD if name in ("obj", "rpn_deltas") else BOX_HEAD
        assert spread_ratio(g, b, f) <= bar, name


def _bf16_module_calls(mp):
    """nn.Linear / nn.Conv2d calls (the RPN's 1x1s and the box predictor,
    the layers flax promotes to f32) computed in bf16."""
    def linear(self, x):
        return TFn.linear(x.to(BF16), self.weight.to(BF16),
                          self.bias.to(BF16)).float()

    def conv(self, x):
        return TFn.conv2d(x.to(BF16), self.weight.to(BF16),
                          self.bias.to(BF16)).float()
    mp.setattr(torch.nn.Linear, "forward", linear)
    mp.setattr(torch.nn.Conv2d, "forward", conv)


def test_wrong_dtypes_leave_the_bar(norm_vars, monkeypatch):
    """The bars see the dtype faults the f32 tests cannot: the RPN's 1x1s
    and the box predictor in bf16, the BatchNorms' outputs left in bf16,
    and the f32 model (1.0 by construction)."""
    from robust_object_detection_tpu_torch.models import fpn as TFPN
    from robust_object_detection_tpu_torch.models import resnet as TRES
    kw, v = norm_vars
    _, rb, _ = _pieces(kw, v)
    got, rbh, rfh = _pieces(kw, v, rb[0], port_model(kw, v, torch.float32))
    assert min(spread_ratio(g, b, f) for g, b, f in
               zip(got[1:], rbh[1:], rfh[1:])) > BOX_HEAD
    with monkeypatch.context() as mp:
        _bf16_module_calls(mp)
        got, rbh, rfh = _pieces(kw, v, rb[0])
    assert all(spread_ratio(g, b, f) > bar for g, b, f, bar in zip(
        got[1:], rbh[1:], rfh[1:], (RPN_HEAD, RPN_HEAD, BOX_HEAD, BOX_HEAD)))
    bn = TRES.batch_norm
    with monkeypatch.context() as mp:
        for mod in (TRES, TFPN):
            mp.setattr(mod, "batch_norm", lambda *a: bn(*a).to(BF16))
        got, rb, rf = _pieces(kw, v)
    assert max(spread_ratio(g, b, f) for g, b, f in
               zip(got[0], rb[0], rf[0])) > CHAIN


# ── one train step ───────────────────────────────────────────────────────

def _reference_step(kw, v, dtype, images, gb, gc, proposals):
    """The reference's train step in `dtype` with `proposals` replayed:
    (metrics, gradients in the port's layout)."""
    cfg = JF.FrcnnConfig(**kw)
    frozen = JRES.frozen_param_labels(cfg.blocks, cfg.trainable_layers)
    jm = JF.FasterRCNN(cfg, dtype)
    tx, _ = JT.make_optimizer(steps_per_epoch=1, frozen=frozen)
    state = JT.FrcnnTrainState(v["params"], v["batch_stats"],
                               tx.init(v["params"]), jnp.asarray(0))
    mp = pytest.MonkeyPatch()
    mp.setattr(JF, "generate_proposals",
               lambda *a, **k: (jnp.asarray(proposals[0]),
                                jnp.asarray(proposals[1])))
    try:
        trace0 = state.opt_state[1][0].trace
        new, metrics = run_exact(
            JT.make_train_step(jm, tx, IMG, JCfg(), False), state,
            jnp.asarray(images), jnp.asarray(gb), jnp.asarray(gc),
            jax.random.key(0))
    finally:
        mp.undo()
    grads = _reference_grads(trace0, new.opt_state[1][0].trace,
                             v["params"])
    return (jax.device_get(metrics), to_port(grads, v["batch_stats"], kw))


def _port_step(tm, images, gb, gc, draws, proposals):
    tx, _ = TT.make_optimizer(steps_per_epoch=1)
    state = TT.init_state(tm, tx)
    grads = {}
    for n, p in tm.named_parameters():
        p.register_post_accumulate_grad_hook(
            lambda p, n=n: grads.__setitem__(n, p.grad.detach().clone()))
    mp = pytest.MonkeyPatch()
    mp.setattr(TF, "generate_proposals",
               lambda *a, **k: tuple(torch.from_numpy(np.asarray(t))
                                     for t in proposals))
    try:
        m = TT.make_train_step(tm, IMG, CorruptionConfig(), False)(
            state, torch.from_numpy(images), torch.from_numpy(gb),
            torch.from_numpy(gc), 0, draws)
    finally:
        mp.undo()
    return ({k: t.item() for k, t in m.items()},
            {k: t.numpy() for k, t in grads.items()}, state)


@pytest.fixture(scope="module")
def step_runs():
    kw = KW
    v = jax_variables(JF.FrcnnConfig(**kw))
    images, gb, gc = gt_batch()
    cfg = JF.FrcnnConfig(**kw)
    jm = JF.FasterRCNN(cfg, jnp.bfloat16)
    x = jnp.asarray(images, jnp.float32) / 255.0
    _, obj, d = jm.apply(v, x, train=True, mutable=["batch_stats"],
                         method=jm.extract)[0]
    proposals = jax.device_get(JF.generate_proposals(obj, d, IMG, cfg))
    uniforms = step_uniforms(jax.random.key(0), 0, len(JF.anchor_boxes(IMG)),
                             cfg.num_proposals + M)
    ref_b = _reference_step(kw, v, jnp.bfloat16, images, gb, gc, proposals)
    ref_f = _reference_step(kw, v, jnp.float32, images, gb, gc, proposals)
    tm = port_model(kw, v, BF16)
    mine = _port_step(tm, images, gb, gc, port_draws(uniforms), proposals)
    return ref_b, ref_f, mine


LOSSES = ("rpn_obj", "rpn_box", "head_cls", "head_box", "loss")


def test_bf16_step_matches_reference_bf16_step(step_runs):
    """The five losses (as one vector), grad_norm, all gradients together
    and each gradient leaf against the reference's bf16 step, each bar a
    share of the reference's bf16-vs-f32 spread. Parameters, running
    statistics and the optimizer's state stay f32."""
    (jmb, jgb), (jmf, jgf), (tm, tg, state) = step_runs
    vec = [[m[k] for k in LOSSES] for m in (tm, jmb, jmf)]
    assert spread_ratio(*vec) <= STEP_LOSSES
    assert spread_ratio(tm["grad_norm"], jmb["grad_norm"],
                        jmf["grad_norm"]) <= STEP_NORM
    assert tg.keys() <= jgb.keys() and len(tg) > 50
    flat = [np.concatenate([g[n].ravel() for n in tg]) for g in
            (tg, jgb, jgf)]
    assert spread_ratio(*flat) <= STEP_GRADS
    for n in tg:
        assert spread_ratio(tg[n], jgb[n], jgf[n]) <= STEP_LEAF, n
    assert all(p.dtype == torch.float32 for p in state.model.parameters())
    assert all(b.dtype == torch.float32 for n, b in
               state.model.named_buffers() if "running_" in n)
    for s in state.optimizer.state.values():
        assert s["momentum_buffer"].dtype == torch.float32


# ── dtype resolution, the trainer and the CLI ────────────────────────────

def test_dtype_none_resolves_like_the_other_trainers():
    assert TT.compute_dtype(None, torch.device("cpu")) == torch.float32
    assert TT.compute_dtype(None, torch.device("cuda")) == BF16
    assert TT.compute_dtype("bfloat16", torch.device("cpu")) == BF16
    assert TD.compute_dtype is TT.compute_dtype
    with pytest.raises(ValueError):
        TT.compute_dtype("float16", torch.device("cpu"))


@pytest.fixture(scope="module")
def coco_root(tmp_path_factory):
    from robust_object_detection_tpu.data import convert as jconvert
    from robust_object_detection_tpu.data import synthetic
    root = tmp_path_factory.mktemp("frcnn_bf16_data")
    for split, n, seed in (("train", 4, 0), ("val", 2, 1)):
        det = synthetic.make_det_split(root / f"det_{split}", n_images=n,
                                       seed=seed,
                                       size_range=((40, 80), (40, 80)))
        jconvert.convert_det_to_coco(det, root / "coco", split)
    return root / "coco"


SMALL = dict(blocks=(1, 1, 1, 1), pre_nms_topk=64, num_proposals=32,
             roi_batch=32, rpn_batch=32)


def test_train_bf16_validates_and_loads_back_f32(coco_root, tmp_path):
    """train(dtype="bfloat16"): the step and the validation run the bf16
    model, config.json records bfloat16, the checkpoint holds f32 tensors
    and load_checkpoint builds an f32 model from it."""
    seen = []
    real = TF.create

    def create(*a, **k):
        model = real(*a, **k)
        seen.append(model.dtype)
        return model
    mp = pytest.MonkeyPatch()
    mp.setattr(TF, "create", create)
    try:
        out = TT.train(ExperimentConfig(), coco_root, tmp_path / "run",
                       epochs=1, img_size=64, batch_size=2, max_boxes=16,
                       model_kwargs=SMALL, dtype="bfloat16", augment=True,
                       device=torch.device("cpu"))
    finally:
        mp.undo()
    assert seen == [BF16]
    assert out["steps"] == 2 and np.isfinite(out["final_loss"])
    stamp = json.loads((tmp_path / "run" / "config.json").read_text())
    assert stamp["dtype"] == "bfloat16"
    hist = [json.loads(x) for x in
            (tmp_path / "run" / "history.jsonl").read_text().splitlines()]
    assert "mAP50" in hist[-1]
    best = torch.load(tmp_path / "run" / "ckpt" / "best", weights_only=True)
    assert all(t.dtype in (torch.float32, torch.int64)
               for t in best["state"].values())
    model = TT.load_checkpoint(tmp_path / "run", device=torch.device("cpu"))
    assert model.dtype == torch.float32
    assert all(p.dtype == torch.float32 for p in model.parameters())
    assert dataclasses.asdict(model.cfg)["blocks"] == (1, 1, 1, 1)


def test_cli_trains_frcnn_in_bf16(coco_root, tmp_path, capsys):
    from robust_object_detection_tpu_torch import cli
    cli.main(["train-detector", "--model", "frcnn", "--data-root",
              str(coco_root), "--out", str(tmp_path / "o"), "--epochs", "1",
              "--max-steps", "1", "--img-size", "64", "--batch-size", "2",
              "--dtype", "bfloat16", "--device", "cpu"])
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed["steps"] == 1 and np.isfinite(printed["final_loss"])
    stamp = json.loads((tmp_path / "o" / "config.json").read_text())
    assert stamp["dtype"] == "bfloat16"
