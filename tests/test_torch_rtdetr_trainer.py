"""The port's RT-DETR matchers and training loop (robust_object_detection_
tpu_torch/train/rtdetr.{_solve_assignment, hungarian_match(method=),
ASSIGNMENT, train, load_checkpoint}) against the JAX package on the CPU.

Matchers: the greedy ``_solve_assignment`` gives the reference's (rows,
cols) on random and on tied costs with padded columns; the Hungarian
reaches scipy's optimal total cost, with scipy's assignment where the
optimum is unique (random continuous costs); ``hungarian_match`` gives the
reference's gt_for_query, IoUs and capped flags for all three methods.

The whole loop: ``train`` of both packages from one seeded ``pretrained=``
state_dict at the port's small RT-DETR test config (that of
test_torch_rtdetr_train_step: RT-DETR-L's backbone and encoder at full
width, two decoder layers, 128 px, batch 2, f32, the encoder score kernel
zeroed so that both sides select queries in one order; 2 epochs of 2
steps, a val split), with augmentation, mosaic and the denoising queries
off (``make_train_step(denoise=False)`` on both sides, inside this test
only: the two frameworks' generators cannot draw the same queries). The
history: lr within 1e-5 (optax evaluates the schedule in f32, the port
in float64), matcher_capped equal, mAP50 / mAP50_95 within
1e-3; train_loss within 1e-3 relative in epoch 1, whose two steps both run
from the pretrained weights (step 0 at lr 0; measured 5e-4), and within
5e-2 in epoch 2 (measured 2.5e-2): AdamW's first updates move every
parameter by about lr x sign(g), also those whose gradient is f32 noise
through ~120 train-mode BatchNorms (test_torch_rtdetr_train_step holds the
third step's loss at 15% for that reason). The other cases run at 64 px:
the port's epoch-level resume (``last`` keyed by epoch) is bit-identical
to an uninterrupted run, ``load_checkpoint`` carries the EMA, a greedy run
launches no auction, and tensor parallelism is refused.
"""

import json
import shutil

import numpy as np
import pytest
import torch
from scipy.optimize import linear_sum_assignment

import jax.numpy as jnp

from robust_object_detection_tpu.core import config as jcfg
from robust_object_detection_tpu.data import convert as jconvert
from robust_object_detection_tpu.data import synthetic
from robust_object_detection_tpu.train import rtdetr as JT
from robust_object_detection_tpu_torch.core import artifacts
from robust_object_detection_tpu_torch.core.config import (ExperimentConfig,
                                                           MeshConfig,
                                                           TrainConfig)
from robust_object_detection_tpu_torch.models import rtdetr as TR
from robust_object_detection_tpu_torch.train import rtdetr as TT

torch.set_num_threads(1)

IMG = 64
CPU = torch.device("cpu")
SMALL = dict(dec_layers=2)
BIG = 1e6


# ── matchers ─────────────────────────────────────────────────────────────

def _costs(seed, b, q, m, tied=False, padded=0.3):
    rng = np.random.RandomState(seed)
    c = rng.rand(b, q, m).astype(np.float32) * 10
    if tied:
        c = np.round(c) / 4          # many exactly equal costs
    c[:, :, rng.rand(m) < padded] = BIG
    return c


@pytest.mark.parametrize("tied", [False, True])
def test_greedy_matches_reference(tied):
    for seed, (b, q, m) in enumerate([(3, 20, 7), (2, 9, 15), (4, 30, 30),
                                      (1, 5, 1)]):
        c = _costs(seed, b, q, m, tied)
        jr, jc = JT._solve_assignment(jnp.asarray(c))
        tr, tc = TT._solve_assignment(torch.from_numpy(c))
        np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
        assert tr.dtype == tc.dtype == torch.int32


def test_hungarian_reaches_scipy_optimum():
    """Random costs, square and rectangular either way: the total cost of
    the port's pairs equals scipy's optimum (float64, 1e-9), and so do the
    pairs; with padded columns (BIG) those GTs are matched by no one and
    the rest is the optimum of the unpadded columns."""
    for seed, (q, m) in enumerate([(12, 12), (30, 8), (6, 20), (1, 4),
                                   (300, 40)]):
        c = _costs(seed, 2, q, m, padded=0.0)
        rows, cols = TT._solve_assignment(torch.from_numpy(c), exact=True)
        for b in range(2):
            r, cc = linear_sum_assignment(c[b].astype(np.float64))
            k = min(q, m)
            got = c[b].astype(np.float64)[rows[b, :k].numpy(),
                                          cols[b, :k].numpy()].sum()
            want = c[b].astype(np.float64)[r, cc].sum()
            assert abs(got - want) <= 1e-9 * want
            assert sorted(zip(rows[b, :k].tolist(), cols[b, :k].tolist())) \
                == sorted(zip(r.tolist(), cc.tolist()))
    c = _costs(7, 2, 25, 10, padded=0.4)
    rows, cols = TT._solve_assignment(torch.from_numpy(c), exact=True)
    for b in range(2):
        keep = np.flatnonzero(c[b].min(0) < BIG / 2)
        r, cc = linear_sum_assignment(c[b][:, keep].astype(np.float64))
        got = {(int(x), int(y)) for x, y in zip(rows[b], cols[b]) if y < 10}
        assert got == {(int(x), int(keep[y])) for x, y in zip(r, cc)}


def _match_inputs(seed, b=2, q=40, m=12, nc=6):
    rng = np.random.RandomState(seed)
    logits = rng.randn(b, q, nc).astype(np.float32) * 2
    boxes = np.concatenate([rng.uniform(0.2, 0.8, (b, q, 2)),
                            rng.uniform(0.05, 0.3, (b, q, 2))], -1)
    gt = np.concatenate([rng.uniform(0.2, 0.8, (b, m, 2)),
                         rng.uniform(0.05, 0.3, (b, m, 2))], -1)
    cls = rng.randint(0, nc, (b, m)).astype(np.int32)
    cls[1, m // 2:] = -1
    return [a.astype(np.float32) if a.dtype.kind == "f" else a
            for a in (logits, boxes, gt, cls)]


@pytest.mark.parametrize("method", ["auction", "greedy", "hungarian"])
def test_hungarian_match_methods_match_reference(method, monkeypatch):
    """gt_for_query, the matched IoUs and the capped flags of both
    packages' hungarian_match on one set of random outputs; the module's
    ASSIGNMENT knob picks the same method when method is None."""
    for seed in range(3):
        args = _match_inputs(seed)
        jg, jiou, jaux = JT.hungarian_match(*map(jnp.asarray, args),
                                            method=method)
        monkeypatch.setattr(TT, "ASSIGNMENT", method)
        tg, tiou, taux = TT.hungarian_match(*map(torch.from_numpy, args))
        np.testing.assert_array_equal(tg.numpy(), np.asarray(jg))
        np.testing.assert_allclose(tiou.numpy(), np.asarray(jiou),
                                   atol=1e-6)
        np.testing.assert_array_equal(taux["capped"].numpy(),
                                      np.asarray(jaux["capped"]))
        np.testing.assert_allclose(taux["cost"].numpy(),
                                   np.asarray(jaux["cost"]), rtol=1e-5)
        assert (tg.numpy() >= 0).sum() == (args[3] >= 0).sum()
    with pytest.raises(ValueError, match="method"):
        TT.hungarian_match(*map(torch.from_numpy, _match_inputs(0)),
                           method="sinkhorn")


# ── the whole loop ───────────────────────────────────────────────────────

@pytest.fixture(scope="module")
def coco_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("rtdetr_trainer")
    for name, n, seed in (("train", 4, 0), ("val", 2, 1)):
        det = synthetic.make_det_split(root / f"det_{name}", n_images=n,
                                       seed=seed,
                                       size_range=((48, 80), (48, 80)))
        jconvert.convert_det_to_coco(det, root / "coco", name)
    return root / "coco"


def _pretrained_state(seed=3):
    model = TR.create(6, device=CPU,
                      generator=torch.Generator().manual_seed(seed), **SMALL)
    sd = model.state_dict()
    sd["model.28.enc_score_head.weight"].zero_()
    return sd


def _cfg(model=1):
    return ExperimentConfig(train=TrainConfig(seed=0),
                            mesh=MeshConfig(data=1, model=model))


RUN = dict(augment=False, epochs=2, img_size=IMG, batch_size=2, max_boxes=16,
           mosaic=False, base_augment=False, dtype="float32",
           model_kwargs=SMALL)


def _no_denoise(mp, module):
    orig = module.make_train_step
    mp.setattr(module, "make_train_step",
               lambda *a, **k: orig(*a, **dict(k, denoise=False)))


def _listing(run):
    """What test_train_history_matches_reference reads of a run directory:
    the history, best_meta.json and the names under ckpt/last. The
    directories are removed once read (a run's checkpoints take ~1 GB)."""
    return {"history": artifacts.read_jsonl(run / "history.jsonl"),
            "best_meta": json.loads((run / "ckpt" / "best_meta.json")
                                    .read_text()),
            "last": sorted(p.name for p in (run / "ckpt" / "last").iterdir())}


@pytest.fixture(scope="module")
def runs(coco_root, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("rtdetr_runs")
    path = tmp / "rtdetr_small_seeded.pt"
    torch.save(_pretrained_state(), path)
    mp = pytest.MonkeyPatch()
    try:
        _no_denoise(mp, TT)
        _no_denoise(mp, JT)
        run = dict(RUN, img_size=128)
        TT.train(_cfg(), coco_root, tmp / "port", pretrained=str(path),
                 device=CPU, **run)
        JT.train(jcfg.ExperimentConfig(
            train=jcfg.TrainConfig(seed=0),
            mesh=jcfg.MeshConfig(data=1, model=1)), coco_root, tmp / "ref",
            pretrained=str(path), **run)
        return _listing(tmp / "port"), _listing(tmp / "ref")
    finally:
        mp.undo()
        shutil.rmtree(tmp, ignore_errors=True)


def test_train_history_matches_reference(runs):
    port, ref_run = runs
    got, ref = port["history"], ref_run["history"]
    assert [h["epoch"] for h in got] == [h["epoch"] for h in ref] == [1, 2]
    for g, r, tol in zip(got, ref, (1e-3, 5e-2)):
        assert set(r) <= set(g)
        np.testing.assert_allclose(g["train_loss"], r["train_loss"],
                                   rtol=tol)
        np.testing.assert_allclose(g["lr"], r["lr"], rtol=1e-5)
        assert g["matcher_capped"] == r["matcher_capped"]
        for k in ("mAP50", "mAP50_95"):
            assert abs(g[k] - r[k]) <= 1e-3, (k, g[k], r[k])
    # `last` keyed by epoch, as the reference's
    assert port["last"] == ["1", "2"]
    assert port["best_meta"]["metric"] == max(h["mAP50"] for h in got)


def test_epoch_resume_is_bit_identical_and_loads_ema(coco_root, tmp_path,
                                                     monkeypatch):
    """One epoch (max_steps stops the run after it), then a second call
    that resumes at epoch 2: the same weights, running statistics, EMA,
    AdamW moments and schedule as one uninterrupted two-epoch run, bit
    for bit. load_checkpoint gives an eval-mode module with the EMA;
    without ``best`` it falls back to ``last``."""
    _no_denoise(monkeypatch, TT)
    sd = _pretrained_state()
    kw = dict(RUN, pretrained=sd, device=CPU)
    TT.train(_cfg(), coco_root, tmp_path / "whole", **kw)
    a = torch.load(tmp_path / "whole" / "ckpt" / "last" / "2",
                   weights_only=True)["state"]
    shutil.rmtree(tmp_path / "whole")
    split = tmp_path / "split"
    first = TT.train(_cfg(), coco_root, split, max_steps=2, **kw)
    assert first["steps"] == 2
    assert [h["epoch"] for h in artifacts.read_jsonl(
        split / "history.jsonl")] == [1]
    out = TT.train(_cfg(), coco_root, split, **kw)
    assert out["steps"] == 4
    assert [h["epoch"] for h in artifacts.read_jsonl(
        split / "history.jsonl")] == [1, 2]
    b = torch.load(split / "ckpt" / "last" / "2", weights_only=True)["state"]
    assert a["step"] == b["step"] == 4
    for part in ("model", "ema"):
        for k, t in a[part].items():
            assert torch.equal(t, b[part][k]), (part, k)
    for k, t in a["optimizer"]["state"].items():
        for name in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(t[name], b["optimizer"]["state"][k][name])
    assert a["scheduler"] == b["scheduler"]

    best = torch.load(split / "ckpt" / "best", weights_only=True)["state"]
    model = TT.load_checkpoint(split, device=CPU, model_kwargs=SMALL)
    assert not model.training and model.cfg.dec_layers == 2
    for n, p in model.named_parameters():
        assert torch.equal(p, best["ema"].get(n, best["model"][n]))
    (split / "ckpt" / "best").unlink()
    model = TT.load_checkpoint(split, device=CPU, model_kwargs=SMALL)
    for n, p in model.named_parameters():
        assert torch.equal(p, b["ema"].get(n, b["model"][n]))
    shutil.rmtree(split)


def test_greedy_run_launches_no_auction(coco_root, tmp_path, monkeypatch):
    """ASSIGNMENT = "greedy": the loop trains (finite losses, matcher_capped
    0) and never calls the auction; a mesh with a model axis of 2 needs
    two processes (tests/test_torch_multiprocess.py runs one), so one
    process refuses it as the mesh's factoring."""
    _no_denoise(monkeypatch, TT)
    monkeypatch.setattr(TT, "ASSIGNMENT", "greedy")
    calls = []
    real = TT.auction_assignment
    monkeypatch.setattr(TT, "auction_assignment",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    kw = dict(RUN, pretrained=_pretrained_state(), device=CPU, epochs=1)
    TT.train(_cfg(), coco_root, tmp_path / "greedy", **kw)
    hist = artifacts.read_jsonl(tmp_path / "greedy" / "history.jsonl")
    assert np.isfinite(hist[0]["train_loss"])
    assert hist[0]["matcher_capped"] == 0.0 and not calls
    shutil.rmtree(tmp_path / "greedy")
    with pytest.raises(ValueError, match="factor the device count"):
        TT.train(_cfg(model=2), coco_root, tmp_path / "tp", **kw)


def test_pretrained_heads_and_dn_table():
    """A COCO-80 rtdetr-l-layout state_dict onto the 6-class model: the
    score heads keep their fresh init, an 80-row denoising table is
    skipped, a 6-row table (Ultralytics' nc rows) fills the first rows of
    the port's nc + 1; a mismatch elsewhere raises."""
    coco = TR.RTDETR(TR.RtDetrConfig(num_classes=80, **SMALL)).state_dict()
    model = TR.create(6, device=CPU, train=True, **SMALL)
    fresh = {k: t.clone() for k, t in model.state_dict().items()}
    report = TT.load_pretrained(model, coco, TT.RTDETR_HEADS,
                                (TT.DN_TABLE,))
    own = model.state_dict()
    assert any(s.startswith(TT.DN_TABLE) for s in report["skipped"])
    for k, t in own.items():
        if k.startswith(TT.RTDETR_HEADS) or k == TT.DN_TABLE:
            assert torch.equal(t, fresh[k]), k
        elif not k.endswith("num_batches_tracked"):
            assert torch.equal(t, coco[k]), k
    six = dict(coco)
    six[TT.DN_TABLE] = torch.randn(6, coco[TT.DN_TABLE].shape[1])
    TT.load_pretrained(model, six, TT.RTDETR_HEADS, (TT.DN_TABLE,))
    table = model.state_dict()[TT.DN_TABLE]
    assert torch.equal(table[:6], six[TT.DN_TABLE])
    assert torch.equal(table[6:], fresh[TT.DN_TABLE][6:])
    bad = dict(coco)
    bad["model.10.conv.weight"] = bad["model.10.conv.weight"][:1]
    with pytest.raises(ValueError, match="model.10.conv.weight"):
        TT.load_pretrained(model, bad, TT.RTDETR_HEADS, (TT.DN_TABLE,))
