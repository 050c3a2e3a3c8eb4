"""The port's YOLO training loop (robust_object_detection_tpu_torch/train/
detector.{train, load_checkpoint, load_pretrained, make_predict_step
(use_ema=True)}) and the host half of train/augment.py, against the JAX
package on the CPU.

Host augmentation: ``mosaic4``, ``affine_matrix``, ``random_affine_host``
and ``mosaic_batches`` from one ``np.random.RandomState`` seed give the
reference's images byte for byte and its boxes and classes exactly (the
port's warp is a numpy copy of PIL's bilinear affine); ``random_erasing``
given the reference's draws erases the same pixels.

EMA prediction: YOLOv8n (64 px, f32, class logits spread as in
test_torch_fused_sweep) with an EMA that differs from the parameters; the
port's predict step with ``use_ema=True`` gives the reference's default
(EMA) predict step's detections, the raw one the reference's
``use_ema=False``, and the module is left as it was.

The whole loop: ``train`` of both packages from one seeded ``pretrained=``
state_dict (YOLOv8n, 64 px, f32, no augmentation, no mosaic, 2 epochs of 2
steps, a val split; the reference's loss in its ``precise=True``
configuration, which is the port's assigner, inside this test only). The
per-epoch train_loss within 1e-3 relative (four SGD steps of f32 noise
through ~60 train-mode BatchNorms; test_torch_train_step holds single
steps at 1e-4), lr within 1e-6, mAP50 / mAP50_95 within 1e-3. A run
killed mid-epoch (the reference's tests/test_resume.py scenario, here with
mosaic + affine, HSV / flip and the corruption on, layout="yolo" and no val
split) resumes to weights, running statistics, EMA and optimizer state
bit-identical to an uninterrupted run; its final = best save and
``load_checkpoint``'s fallback to ``last`` are held too.
"""

import json
import shutil

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from robust_object_detection_tpu.core import config as jcfg
from robust_object_detection_tpu.data import convert as jconvert
from robust_object_detection_tpu.data import pipeline as jpipe
from robust_object_detection_tpu.data import synthetic
from robust_object_detection_tpu.models import pretrained as jpretrained
from robust_object_detection_tpu.models import yolov8 as jy
from robust_object_detection_tpu.train import augment as JA
from robust_object_detection_tpu.train import detection as JDL
from robust_object_detection_tpu.train import detector as JDet
from robust_object_detection_tpu_torch.core import artifacts
from robust_object_detection_tpu_torch.core.config import (ExperimentConfig,
                                                           MeshConfig,
                                                           TrainConfig)
from robust_object_detection_tpu_torch.data import pipeline as tpipe
from robust_object_detection_tpu_torch.models import convert
from robust_object_detection_tpu_torch.models import yolov8 as ty
from robust_object_detection_tpu_torch.train import augment as TA
from robust_object_detection_tpu_torch.train import detector as TD

torch.set_num_threads(1)

IMG = 64
CPU = torch.device("cpu")
KW = dict(num_candidates=64, max_det=32)


# ── host augmentation ────────────────────────────────────────────────────

def _sample_arrays(rng, size, slots=12, n=5):
    img = rng.randint(0, 256, (size, size, 3)).astype(np.uint8)
    boxes = np.zeros((slots, 4), np.float32)
    classes = np.full((slots,), -1, np.int32)
    xy = rng.uniform(0, size * 0.7, (n, 2))
    wh = rng.uniform(2, size * 0.35, (n, 2))
    boxes[:n] = np.concatenate([xy, xy + wh], 1)
    classes[:n] = rng.randint(0, 6, n)
    return img, boxes, classes


def _assert_same_sample(out, ref):
    np.testing.assert_array_equal(out[0], ref[0])
    np.testing.assert_array_equal(out[1], ref[1])
    np.testing.assert_array_equal(out[2], ref[2])
    assert out[1].dtype == ref[1].dtype and out[2].dtype == ref[2].dtype


@pytest.mark.parametrize("knobs", [
    {}, dict(degrees=10.0, shear=5.0),
    dict(degrees=45.0, shear=10.0, scale=0.9, translate=0.3)])
def test_affine_matches_reference(knobs):
    """affine_matrix and random_affine_host on one RandomState seed: the
    same matrix, scale and draws consumed; the warped image byte for byte
    (PIL's bilinear affine against the port's numpy copy), the boxes and
    classes equal. Sizes 64 and 96, twelve seeds each."""
    for size in (64, 96):
        for seed in range(12):
            m_ref, s_ref = JA.affine_matrix(np.random.RandomState(seed),
                                            size, **knobs)
            m_out, s_out = TA.affine_matrix(np.random.RandomState(seed),
                                            size, **knobs)
            np.testing.assert_array_equal(m_out, m_ref)
            assert s_out == s_ref
            sample = _sample_arrays(np.random.RandomState(100 + seed), size)
            r_ref, r_out = (np.random.RandomState(seed) for _ in range(2))
            ref = JA.random_affine_host(*sample, r_ref, max_boxes=8,
                                        **knobs)
            out = TA.random_affine_host(*sample, r_out, max_boxes=8,
                                        **knobs)
            _assert_same_sample(out, ref)
            assert r_out.randint(1 << 30) == r_ref.randint(1 << 30)


def test_mosaic4_matches_reference():
    for seed in range(8):
        rng = np.random.RandomState(seed)
        loaded = [_sample_arrays(rng, IMG, n=4) for _ in range(4)]
        ref = JA.mosaic4(loaded, IMG, np.random.RandomState(seed), 10)
        out = TA.mosaic4(loaded, IMG, np.random.RandomState(seed), 10)
        _assert_same_sample(out, ref)
        assert (out[2] >= 0).any()


@pytest.fixture(scope="module")
def split(tmp_path_factory):
    """A COCO root (4 train, 2 val images) and a YOLO-layout root (8
    train images), written by the reference's data/synthetic and
    data/convert."""
    root = tmp_path_factory.mktemp("yolo_trainer")
    for name, n, seed in (("train", 4, 0), ("val", 2, 1)):
        det = synthetic.make_det_split(root / f"det_{name}", n_images=n,
                                       seed=seed,
                                       size_range=((48, 80), (48, 80)))
        jconvert.convert_det_to_coco(det, root / "coco", name)
    det = synthetic.make_det_split(root / "det_yolo", n_images=8, seed=2,
                                   size_range=((48, 80), (48, 80)))
    jconvert.convert_det_to_yolo(det, root / "yolo", "train")
    return root


def test_mosaic_batches_match_reference(split, monkeypatch):
    """One epoch of mosaic + affine batches (batch 2, 64 px) over the
    train split, with one in-memory decoder on both sides (the reference
    reads it through its pipeline's load_image_rgb): images byte for byte,
    boxes and classes equal, the Batch fields of make_batches."""
    samples = tpipe.index_coco(split / "coco", "train")

    def load(sample):
        r = np.random.RandomState(sample.image_id)
        return r.randint(0, 256, (sample.height, sample.width, 3)).astype(
            np.uint8)
    monkeypatch.setattr(jpipe, "load_image_rgb", load)
    ref = list(JA.mosaic_batches(jpipe.index_coco(split / "coco", "train"),
                                 2, IMG, max_boxes=16, seed=3))
    out = list(TA.mosaic_batches(samples, 2, IMG, max_boxes=16, seed=3,
                                 load_image=load))
    assert len(out) == len(ref) == 2
    for o, r in zip(out, ref):
        for field in ("images", "boxes", "classes", "image_ids", "scales"):
            a, b = getattr(o, field), getattr(r, field)
            assert a.dtype == b.dtype, field
            np.testing.assert_array_equal(a, b, err_msg=field)
        assert o.num_valid == r.num_valid == 2
    assert sum((b.classes >= 0).sum() for b in out) > 0


def test_random_erasing_matches_reference():
    """The erased rectangle from the reference's five draws (area share,
    log aspect, corner, apply) equals the reference's, for draws that
    apply and one that does not."""
    img = np.random.RandomState(0).rand(40, 56, 3).astype(np.float32) * 255
    applied = 0
    for seed in range(12):
        key = jax.random.key(seed)
        ref = np.asarray(JA.random_erasing(jnp.asarray(img), key, p=0.7))
        k1, k2, k3, k4, k5 = jax.random.split(key, 5)
        area = jax.random.uniform(k1, (), minval=0.02, maxval=0.33)
        log_r = jax.random.uniform(k2, (), minval=np.log(0.3),
                                   maxval=np.log(3.3))
        draws = [torch.tensor(float(v)) for v in
                 (area, log_r, jax.random.uniform(k3, ()),
                  jax.random.uniform(k4, ()))]
        apply = torch.tensor(float(jax.random.uniform(k5, ())) < 0.7)
        out = TA.erase(torch.from_numpy(img), *draws, apply).numpy()
        np.testing.assert_array_equal(out, ref)
        applied += int((out == 114.0).all(-1).any())
    assert 0 < applied < 12
    # the generator wrapper draws its own and keeps the image's shape
    got = TA.random_erasing(torch.from_numpy(img),
                            torch.Generator().manual_seed(0), p=1.0)
    assert got.shape == img.shape and (got == 114.0).all(-1).any()


# ── EMA prediction ───────────────────────────────────────────────────────

def test_ema_predict_matches_reference():
    """The reference predicts with ``ema_params`` and the raw model's
    ``batch_stats``. Parameters converted to the port, an EMA 5% away from
    them: use_ema=True gives the reference's default predict step's
    detections (valid and classes equal, scores within 1e-4, boxes within
    1e-2 px), use_ema=False the reference's use_ema=False, and the two
    differ; the module's parameters, buffers, grad flags and train mode
    are untouched."""
    jmodel = jy.create(6, "n")
    v = jax.device_get(jy.init_variables(jmodel, jax.random.key(0), IMG))
    rng = np.random.RandomState(0)
    params = jax.tree.map(np.array, v["params"])
    stats = jax.tree.map(
        lambda a: np.asarray(rng.rand(*a.shape) * 0.5 + 0.75, a.dtype),
        v["batch_stats"])
    for i in range(3):
        out = params["Head_0"][f"cls{i}_out"]
        out["kernel"] = out["kernel"] * 4.0
        out["bias"] = rng.randn(*out["bias"].shape).astype(np.float32)
    ema = jax.tree.map(
        lambda a: (a + 0.05 * (np.abs(a).max() + 1e-3)
                   * rng.randn(*a.shape)).astype(a.dtype), params)
    jstate = JDet.DetTrainState(params, stats, ema, None, jnp.asarray(0))
    images = rng.randint(0, 256, (2, IMG, IMG, 3)).astype(np.uint8)

    model = ty.YoloV8(ty.YoloConfig(6, "n")).train()
    model.load_state_dict(convert.from_jax_variables(params, stats, "n"))
    ema_sd = convert.from_jax_variables(ema, stats, "n")
    state = TD.TrainState(model, {n: ema_sd[n].clone() for n, p in
                                  model.named_parameters()
                                  if p.requires_grad}, None, None)
    before = {k: t.clone() for k, t in model.state_dict().items()}
    got = {}
    for use_ema in (True, False):
        ref = jax.device_get(JDet.make_predict_step(
            jmodel, IMG, use_ema=use_ema, **KW)(jstate, jnp.asarray(images)))
        step = TD.make_predict_step(IMG, use_ema=use_ema, **KW)
        arg = state if use_ema else model.eval()
        out = [t.numpy() for t in step(arg, torch.from_numpy(images))]
        model.train()
        np.testing.assert_array_equal(out[3], ref[3])
        assert out[3].sum() > 0
        np.testing.assert_array_equal(out[2], ref[2])
        np.testing.assert_allclose(out[1], ref[1], atol=1e-4, rtol=0)
        np.testing.assert_allclose(out[0], ref[0], atol=1e-2, rtol=0)
        got[use_ema] = out
    assert np.abs(got[True][1] - got[False][1]).max() > 1e-2
    assert model.training
    after = model.state_dict()
    assert all(torch.equal(before[k], after[k]) for k in before)
    assert all(p.requires_grad for n, p in model.named_parameters()
               if n in state.ema)


# ── pretrained weights ───────────────────────────────────────────────────

def _pretrained_state(nc=6, seed=3):
    """A seeded Ultralytics-layout YOLOv8n state_dict with its running
    statistics redrawn."""
    model = ty.create(nc, "n", device=CPU,
                      generator=torch.Generator().manual_seed(seed))
    sd = model.state_dict()
    g = torch.Generator().manual_seed(seed + 1)
    for k, t in sd.items():
        if k.endswith("running_mean"):
            t.copy_(torch.randn(t.shape, generator=g) * 0.1)
        elif k.endswith("running_var"):
            t.copy_(torch.rand(t.shape, generator=g) * 0.5 + 0.75)
    return sd


def test_load_pretrained_keeps_head_skips_as_reference():
    """A COCO-80 checkpoint onto the 6-class model: the class branch the
    reference's import_yolov8(strict_head=False) skips keeps its fresh
    init (the same blocks skipped), everything else is loaded; a mismatch
    outside the head raises, and so does a missing tensor."""
    coco = _pretrained_state(nc=80)
    model = ty.create(6, "n", device=CPU, train=True)
    fresh = {k: t.clone() for k, t in model.state_dict().items()}
    report = TD.load_pretrained(model, coco)
    own = model.state_dict()
    assert report["skipped"] and all(
        s.startswith("model.22.cv3.") for s in report["skipped"])
    for k, t in own.items():
        if k.endswith("num_batches_tracked"):
            continue
        if k.startswith("model.22.cv3.") and coco[k].shape != t.shape:
            assert torch.equal(t, fresh[k]), k
        else:
            assert torch.equal(t, coco[k].to(t.dtype)), k
    template = jax.device_get(jy.init_variables(jy.create(6, "n"),
                                                jax.random.key(0), IMG))
    _, jreport = jpretrained.import_yolov8(
        {k: v.numpy() for k, v in coco.items()}, template, variant="n",
        strict_head=False)
    skipped_blocks = {".".join(s.split()[0].split(".")[1:5])
                      for s in report["skipped"]}
    ref_blocks = {s.split()[0].removesuffix(".conv")
                  for s in jreport.skipped}
    assert skipped_blocks == ref_blocks
    bad = dict(coco)
    bad["model.0.conv.weight"] = bad["model.0.conv.weight"][:, :2]
    with pytest.raises(ValueError, match="model.0.conv.weight"):
        TD.load_pretrained(model, bad)
    del bad["model.0.conv.weight"]
    with pytest.raises(ValueError, match="has no model.0.conv.weight"):
        TD.load_pretrained(model, bad)


# ── the whole loop against the reference ─────────────────────────────────

def _cfg():
    return ExperimentConfig(train=TrainConfig(seed=0),
                            mesh=MeshConfig(data=1, model=1))


E2E = dict(augment=False, variant="n", epochs=2, img_size=IMG, batch_size=2,
           max_boxes=16, mosaic=False, base_augment=False, dtype="float32")


@pytest.fixture(scope="module")
def runs(split, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("yolo_runs")
    path = tmp / "yolov8n_seeded.pt"
    torch.save(_pretrained_state(), path)
    port_out = tmp / "port"
    TD.train(_cfg(), split / "coco", port_out, pretrained=str(path),
             device=CPU, **E2E)
    orig = JDL.yolo_loss
    mp = pytest.MonkeyPatch()
    mp.setattr(JDL, "yolo_loss",
               lambda *a, **k: orig(*a, **dict(k, precise=True)))
    ref_out = tmp / "ref"
    try:
        JDet.train(jcfg.ExperimentConfig(
            train=jcfg.TrainConfig(seed=0),
            mesh=jcfg.MeshConfig(data=1, model=1)), split / "coco", ref_out,
            pretrained=str(path), **E2E)
    finally:
        mp.undo()
    yield port_out, ref_out
    shutil.rmtree(tmp, ignore_errors=True)


def test_train_history_matches_reference(runs):
    """Epoch 1's two steps both run from the pretrained weights (step 0 at
    lr 0): its train_loss within 1e-3 relative (measured 1.6e-4). Epoch 2
    follows two SGD updates at lr 0.01 from random weights, which multiply
    the f32 noise ~10x each (step 2: 1.2e-3) until one of the TAL
    assignments of step 3 flips (num_fg 14 vs 15, 6% on that step's
    loss): its train_loss within 5e-2 (measured 2.6e-2);
    test_train_updates_match_reference holds where those updates go."""
    port_out, ref_out = runs
    got = artifacts.read_jsonl(port_out / "history.jsonl")
    ref = artifacts.read_jsonl(ref_out / "history.jsonl")
    assert [h["epoch"] for h in got] == [h["epoch"] for h in ref] == [1, 2]
    for g, r, tol in zip(got, ref, (1e-3, 5e-2)):
        assert set(r) <= set(g)
        np.testing.assert_allclose(g["train_loss"], r["train_loss"],
                                   rtol=tol)
        np.testing.assert_allclose(g["lr"], r["lr"], rtol=1e-6)
        for k in ("mAP50", "mAP50_95"):
            assert abs(g[k] - r[k]) <= 1e-3, (k, g[k], r[k])
    stamp = json.loads((port_out / "config.json").read_text())
    assert stamp == json.loads((ref_out / "config.json").read_text())
    meta = json.loads((port_out / "ckpt" / "best_meta.json").read_text())
    assert meta["metric"] == max(h["mAP50"] for h in got)


def _cosine(a, b):
    return float((a * b).sum() / (np.linalg.norm(a) * np.linalg.norm(b)
                                  + 1e-30))


def test_train_updates_match_reference(runs):
    """The change of every parameter, EMA leaf and running statistic over
    the run (from the pretrained weights to ``last``), the port's mapped
    through ``import_yolov8``, against the reference's ``last``: cosine of
    the whole update >= 0.99 and of each leaf's, median >= 0.99 (what the
    chaotic f32 noise of the history test leaves of the update's
    direction)."""
    port_out, ref_out = runs
    ref_copy = ref_out.parent / "ref_last"
    shutil.copytree(ref_out, ref_copy)
    shutil.rmtree(ref_copy / "ckpt" / "best")
    (ref_copy / "ckpt" / "best_meta.json").unlink()
    _, jstate = JDet.load_checkpoint(ref_copy, variant="n", img_size=IMG)
    jstate = jax.device_get(jstate)
    template = {"params": jstate.params, "batch_stats": jstate.batch_stats}

    def tree(sd):
        return jpretrained.import_yolov8(
            {k: v.numpy() for k, v in sd.items()}, template, variant="n")[0]
    last = torch.load(port_out / "ckpt" / "last" / "4",
                      weights_only=True)["state"]
    init = tree(_pretrained_state())
    got = tree(last["model"])
    got_ema = tree(dict(last["model"], **last["ema"]))
    for what, g, r, i in (
            ("params", got["params"], jstate.params, init["params"]),
            ("ema", got_ema["params"], jstate.ema_params, init["params"]),
            ("stats", got["batch_stats"], jstate.batch_stats,
             init["batch_stats"])):
        g, r, i = (dict(jax.tree_util.tree_leaves_with_path(t))
                   for t in (g, r, i))
        assert g.keys() == r.keys()
        du = {p: np.asarray(g[p], np.float64) - np.asarray(i[p])
              for p in r}
        du_ref = {p: np.asarray(r[p], np.float64) - np.asarray(i[p])
                  for p in r}
        whole = _cosine(np.concatenate([du[p].ravel() for p in r]),
                        np.concatenate([du_ref[p].ravel() for p in r]))
        leaves = [_cosine(du[p], du_ref[p]) for p in r
                  if np.abs(du_ref[p]).max() > 0]
        print(what, whole, np.median(leaves), min(leaves))
        assert whole >= 0.99 and np.median(leaves) >= 0.99, what


def test_load_checkpoint_carries_the_ema(runs):
    """load_checkpoint: an eval-mode module whose parameters are the
    ``best`` payload's EMA and whose running statistics are the raw
    model's; its detections are those of the EMA predict step on a state
    holding the trained module."""
    port_out, _ = runs
    payload = torch.load(port_out / "ckpt" / "best",
                         weights_only=True)["state"]
    model = TD.load_checkpoint(port_out, variant="n", device=CPU)
    assert not model.training
    for n, p in model.named_parameters():
        assert torch.equal(p, payload["ema"].get(n, payload["model"][n]))
    for n, b in model.named_buffers():
        assert torch.equal(b, payload["model"][n])
    raw = ty.create(6, "n", device=CPU, train=True)
    raw.load_state_dict(payload["model"])
    state = TD.TrainState(raw, payload["ema"], None, None)
    images = torch.from_numpy(np.random.RandomState(5).randint(
        0, 256, (2, IMG, IMG, 3)).astype(np.uint8))
    a = TD.make_predict_step(IMG, use_ema=True, **KW)(state, images)
    b = TD.make_predict_step(IMG, **KW)(model, images)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


RESUME = dict(augment=True, variant="n", epochs=2, img_size=IMG,
              batch_size=2, max_boxes=16, layout="yolo", mosaic=True,
              close_mosaic=1, base_augment=True, save_every_steps=1,
              dtype="float32", device=CPU)


def test_midepoch_resume_is_bit_identical(split, tmp_path, monkeypatch):
    """Killed while fetching the 4th batch of epoch 1 (4 an epoch, a
    checkpoint every step), the run resumes at that batch: after 8 steps
    its weights, running statistics, EMA, optimizer and schedule equal an
    uninterrupted run's bit for bit. Epoch 1 is mosaic + affine, epoch 2
    plain (close_mosaic 1); HSV / flip and the corruption draw from the
    step's generator. No val split: final = best, and load_checkpoint
    falls back to ``last`` once ``best`` is gone."""
    root = split / "yolo"
    sd = _pretrained_state()
    whole = TD.train(_cfg(), root, tmp_path / "whole", pretrained=sd,
                     **RESUME)
    assert whole["steps"] == 8

    orig_prefetch = tpipe.prefetch

    def bombing_prefetch(it, *a, **kw):
        def gen():
            for i, b in enumerate(orig_prefetch(it, *a, **kw)):
                if i == 3:
                    raise KeyboardInterrupt("preempted")
                yield b
        return gen()
    monkeypatch.setattr(tpipe, "prefetch", bombing_prefetch)
    with pytest.raises(KeyboardInterrupt):
        TD.train(_cfg(), root, tmp_path / "split", pretrained=sd, **RESUME)
    monkeypatch.setattr(tpipe, "prefetch", orig_prefetch)
    split_dir = tmp_path / "split"
    assert artifacts.read_jsonl(split_dir / "history.jsonl") == []
    assert sorted(p.name for p in (split_dir / "ckpt" / "last").iterdir()) \
        == ["2", "3"]
    out = TD.train(_cfg(), root, split_dir, pretrained=sd, **RESUME)
    assert out["steps"] == 8
    assert [h["epoch"] for h in artifacts.read_jsonl(
        split_dir / "history.jsonl")] == [1, 2]

    a = torch.load(tmp_path / "whole" / "ckpt" / "last" / "8",
                   weights_only=True)
    b = torch.load(split_dir / "ckpt" / "last" / "8", weights_only=True)
    assert a["extra"] == b["extra"] == {"epoch": 2, "batch_in_epoch": 4,
                                        "epoch_done": True}
    assert a["state"]["step"] == b["state"]["step"] == 8
    for part in ("model", "ema"):
        assert a["state"][part].keys() == b["state"][part].keys()
        for k, t in a["state"][part].items():
            assert torch.equal(t, b["state"][part][k]), (part, k)
    for k, t in a["state"]["optimizer"]["state"].items():
        assert torch.equal(t["momentum_buffer"],
                           b["state"]["optimizer"]["state"][k]
                           ["momentum_buffer"])
    assert a["state"]["scheduler"] == b["state"]["scheduler"]
    assert any(not torch.equal(a["state"]["ema"][k], t)
               for k, t in a["state"]["model"].items()
               if k in a["state"]["ema"])

    meta = json.loads((split_dir / "ckpt" / "best_meta.json").read_text())
    assert meta == {"step": 2, "metric": 0.0}
    (split_dir / "ckpt" / "best").unlink()
    (split_dir / "ckpt" / "best_meta.json").unlink()
    model = TD.load_checkpoint(split_dir, variant="n", device=CPU)
    for n, p in model.named_parameters():
        assert torch.equal(p, b["state"]["ema"].get(
            n, b["state"]["model"][n]))
    (split_dir / "ckpt" / "last" / "7").unlink()
    (split_dir / "ckpt" / "last" / "8").unlink()
    with pytest.raises(FileNotFoundError):
        TD.load_checkpoint(split_dir, variant="n", device=CPU)
    shutil.rmtree(tmp_path / "whole")
    shutil.rmtree(split_dir)
