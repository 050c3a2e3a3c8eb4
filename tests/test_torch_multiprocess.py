"""The port's data and tensor parallelism (parallel/mesh.py and the four
trainers) in two gloo processes on the CPU, against one process and
against the reference.

Each launch starts two ranks of tests/_torch_mp_worker.py (one thread
each) that run the port's data-parallel steps on their rows of one
global batch; the test runs the same runners in its own process without
a group for the one-process side. Checks:

  * YOLOv8n at 64 px, global batch 4, two steps (lr 0, then lr0): the
    two-rank step against the reference's ``make_train_step`` jitted over
    a 2-device CPU data mesh (its loss ``precise=True``, as
    tests/test_torch_train_step.py runs it) and against the port's
    one-process step, with the augmentation on (K1, HSV, flip drawn for
    the global batch) against one process;
  * one Faster R-CNN step and one U-Net step against one process;
  * each with the train-mode BatchNorm running statistics; a rank that
    skips the gradient all-reduce or the BatchNorm statistics' all-reduce
    leaves the bars (ROD_TEST_MUTATE);
  * ``detector.train`` on two processes: 8 images, global batch 4, two
    steps; history.jsonl written once, config.json present, the
    checkpoint loads in one process;
  * RT-DETR with ``mesh.model=2`` (the decoder split over both ranks)
    against ``model=1``, queries 24 and 2 decoder layers at 64 px for 3
    steps: final_loss within rtol 1e-3 (the reference's bar,
    tests/test_rtdetr_tp.py), and the divisibility guard;
  * under that split, one replicated state, as the reference's one array
    of each replicated leaf: after each of 2 steps the two model ranks'
    replicated leaves, the gradients the clip reads, the EMA, the AdamW
    moments, every buffer, the 3 matchings and the metrics bit-equal,
    also when model index 1 perturbs a replicated leaf's gradient
    (ROD_TEST_MUTATE=tp_grad) or swaps two queries of its matchings
    (tp_match), which the broadcasts from model index 0 undo;
  * sharded eval: mAP equal to the unsharded pass within 1e-9.

Bars against one process (measured while writing this test): two ranks
sum the BatchNorm moments, the loss normalisers and the gradients in
another order than one process does, so f32 values part at the 1e-7
relative level, and the train-mode BatchNorms amplify that in the
gradients (tests/test_torch_train_step.py holds the one-process port
against the reference at 1e-3 of a gradient leaf for the same reason).
Metrics are held at rtol 1e-3 (measured: up to 8.6e-6 on YOLO and Faster
R-CNN, 1.4e-4 on the U-Net's grad_norm) and each state leaf's distance
to the one-process leaf within 2e-2 of its change plus 4 f32 ulps of its
size, in L2 (measured: up to 2.4e-4 on YOLO, 4.9e-3 on Faster R-CNN). The
U-Net's first AdamW update is about lr x sign(g), which flips on small
noisy gradients, so its gradients are held instead, at 0.1 relative L2
(measured: up to 5.3e-2, on ``mid.conv0``: the U-Net's f32 gradient
noise that tests/test_torch_restoration.py describes), and the same step
in float64 agrees to 1e-9 (measured 4e-15). The two ranks end bit-identical.
A dropped gradient or statistics all-reduce moves the metrics or the
state by far more than these bars (test_dropped_all_reduce_leaves_the_bars).
"""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from robust_object_detection_tpu.core.config import CorruptionConfig as JCfg
from robust_object_detection_tpu.core.config import MeshConfig as JMesh
from robust_object_detection_tpu.models import yolov8 as JY
from robust_object_detection_tpu.parallel import mesh as jmesh
from robust_object_detection_tpu.train import detection as JDL
from robust_object_detection_tpu.train import detector as JDet
from robust_object_detection_tpu_torch.core.config import (ExperimentConfig,
                                                           MeshConfig,
                                                           TrainConfig)
from robust_object_detection_tpu_torch.models import convert
from robust_object_detection_tpu_torch.models import unet as TU
from robust_object_detection_tpu_torch.train import detector as TDet
from robust_object_detection_tpu_torch.train import frcnn as TT
from robust_object_detection_tpu_torch.train import restoration as TR
from robust_object_detection_tpu_torch.train import rtdetr as TRT

import _torch_mp_worker as W
from test_torch_train_step import (_assert_updates_match, _to_jax_tree)

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
WORKER = Path(__file__).resolve().parent / "_torch_mp_worker.py"
IMG, B, M = 64, 4, 6
METRIC_RTOL, STATE_TOL, ULPS, GRAD_TOL = 1e-3, 2e-2, 4, 0.1


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def launch(names, work: Path, mutate: str = "", timeout: int = 240):
    """Both ranks of the worker over `names`; returns {name: [rank0,
    rank1]}."""
    port = _free_port()
    procs = []
    for rank in range(2):
        env = dict(os.environ, PYTHONPATH=f"{ROOT}:{ROOT / 'tests'}",
                   ROD_COORDINATOR=f"localhost:{port}",
                   ROD_NUM_PROCESSES="2", ROD_PROCESS_ID=str(rank),
                   ROD_TEST_MUTATE=mutate, OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen(
            [sys.executable, str(WORKER), ",".join(names), str(work)],
            cwd=ROOT, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True))
    try:
        errs = [p.communicate(timeout=timeout)[1] for p in procs]
        assert all(p.returncode == 0 for p in procs), "\n".join(
            f"rank {r}: {e[-3000:]}" for r, e in enumerate(errs))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    return {n: [torch.load(work / f"{n}.rank{r}.pt", weights_only=False)
                for r in range(2)] for n in names}


def yolo_batch(seed=0):
    rng = np.random.RandomState(seed)
    images = rng.randint(0, 256, (B, IMG, IMG, 3)).astype(np.uint8)
    xy = rng.uniform(0, IMG * 0.6, (B, M, 2))
    wh = rng.uniform(IMG * 0.15, IMG * 0.4, (B, M, 2))
    boxes = np.concatenate([xy, np.minimum(xy + wh, IMG)], -1).astype(
        np.float32)
    classes = rng.randint(0, 6, (B, M)).astype(np.int32)
    classes[1, M - 2:] = -1
    classes[3, M - 3:] = -1
    return images, boxes, classes


def assert_same_run(got, ref, what, metric_rtol=METRIC_RTOL,
                    state_tol=STATE_TOL, start=None, skip=None):
    """got (a rank's result) against ref (one process's): every metric at
    metric_rtol; every state leaf (weights and running statistics) within
    state_tol of its change from `start` (or of its size), both in L2."""
    for i, (g, r) in enumerate(zip(got["metrics"], ref["metrics"])):
        for k in r:
            if os.environ.get("MP_MEASURE"):
                print("MEASURE metric", what, k,
                      abs(g[k] - r[k]) / max(abs(r[k]), 1e-30))
            np.testing.assert_allclose(g[k], r[k], rtol=metric_rtol,
                                       atol=1e-12,
                                       err_msg=f"{what} step {i} {k}")
    for k, r in ref["state"].items():
        if not r.is_floating_point() or (skip and skip(k)):
            continue
        r64, g64 = r.double(), got["state"][k].double()
        base = r64 - start[k].double() if start is not None else r64
        scale = base.norm().item()
        err = (g64 - r64).norm().item()
        # + a few f32 ulps of the leaf: a change far below its values
        ulps = ULPS * np.finfo(np.float32).eps * r64.norm().item()
        if os.environ.get("MP_MEASURE"):
            print("MEASURE", what, k, err / max(scale, 1e-30),
                  err / max(ulps / ULPS, 1e-30))
        assert err <= state_tol * scale + ulps, (what, k, err, scale)


@pytest.fixture(scope="module")
def work(tmp_path_factory):
    return tmp_path_factory.mktemp("mp")


@pytest.fixture(scope="module")
def yolo_inputs(work):
    """YOLOv8n from the reference's init (variables carried across), the
    global batch; written for the worker, plain and augmented."""
    jmodel = JY.create(6, "n")
    tx, _ = JDet.make_optimizer(warmup_steps=1, total_steps=10)
    jstate = JDet.init_state(jmodel, jax.random.key(0), IMG, tx)
    template = jax.device_get({"params": jstate.params,
                               "batch_stats": jstate.batch_stats})
    state = convert.from_jax_variables(template["params"],
                                       template["batch_stats"], "n")
    images, boxes, classes = yolo_batch()
    base = dict(state=state, img=IMG, steps=2,
                images=torch.from_numpy(images),
                boxes=torch.from_numpy(boxes),
                classes=torch.from_numpy(classes))
    for name, aug in (("yolo", False), ("yolo-aug", True)):
        torch.save(dict(base, augment=aug), work / f"{name}.in.pt")
    return dict(base, jmodel=jmodel, jstate=jstate, tx=tx,
                template=template)


@pytest.fixture(scope="module")
def frcnn_unet_inputs(work):
    from robust_object_detection_tpu_torch.models import frcnn as TF
    fm = TF.create(TF.FrcnnConfig(**W.FRCNN_SMALL), torch.device("cpu"),
                   torch.Generator().manual_seed(1))
    images, boxes, classes = yolo_batch(1)
    n_anchors = len(TF.anchor_boxes(IMG))
    draws = TT.draw_train(B, n_anchors, W.FRCNN_SMALL["num_proposals"] + M,
                          torch.Generator().manual_seed(5))
    draws["choice"] = torch.tensor([1, 0, 3, 2], dtype=torch.int32)
    torch.save(dict(state=fm.state_dict(), img=IMG,
                    images=torch.from_numpy(images),
                    boxes=torch.from_numpy(boxes),
                    classes=torch.from_numpy(classes), draws=draws),
               work / "frcnn.in.pt")
    channels = (8, 16)
    um = TU.create(channels, device=torch.device("cpu"),
                   generator=torch.Generator().manual_seed(2), train=True)
    uimg = torch.from_numpy(np.random.RandomState(3).randint(
        0, 256, (B, 32, 32, 3)).astype(np.uint8))
    udraws = TR.draw_train(uimg.shape, torch.Generator().manual_seed(4))
    torch.save(dict(state=um.state_dict(), channels=channels, images=uimg,
                    draws=udraws), work / "unet.in.pt")
    torch.save(dict(state=um.state_dict(), channels=channels, images=uimg,
                    draws=dict(udraws, noise=udraws["noise"].double()),
                    f64=True), work / "unet-f64.in.pt")


@pytest.fixture(scope="module")
def coco_roots(tmp_path_factory):
    from robust_object_detection_tpu.data import convert as jconvert
    from robust_object_detection_tpu.data import synthetic
    tmp = tmp_path_factory.mktemp("mp_data")
    for split, n, seed in (("train", 8, 0), ("val", 8, 1)):
        det = synthetic.make_det_split(tmp / f"det_{split}", n_images=n,
                                       seed=seed,
                                       size_range=((48, 49), (48, 49)))
        jconvert.convert_det_to_coco(det, tmp / "coco", split)
    det = synthetic.make_det_split(tmp / "det_tp", n_images=8,
                                   size_range=((48, 49), (48, 49)))
    jconvert.convert_det_to_coco(det, tmp / "coco_tp", "train")
    return tmp / "coco", tmp / "coco_tp"


@pytest.fixture(scope="module")
def dp_runs(work, yolo_inputs, frcnn_unet_inputs, coco_roots):
    """One launch of every data-parallel scenario."""
    torch.save(dict(root=coco_roots[0], img=IMG), work / "eval.in.pt")
    return launch(["yolo", "yolo-aug", "frcnn", "unet", "unet-f64", "eval"],
                  work)


def _one_process(work, name):
    d = torch.load(work / f"{name}.in.pt", weights_only=False)
    return W.RUNNERS[name.split("-")[0]](d, None)


def test_yolo_dp_step_matches_reference_two_device_mesh(dp_runs,
                                                        yolo_inputs):
    """The reference's train step jitted over a 2-device data mesh on the
    same global batch: loss, components and num_fg every step (rtol 1e-4,
    tests/test_torch_train_step.py's bars), every parameter and running
    statistic's change over the two steps within 3e-3 of its size."""
    d = yolo_inputs
    ctx = jmesh.MeshContext(jmesh.make_mesh(JMesh(data=2, model=1)))
    orig = JDL.yolo_loss
    mp = pytest.MonkeyPatch()
    mp.setattr(JDL, "yolo_loss",
               lambda *a, **k: orig(*a, **dict(k, precise=True)))
    try:
        step = jax.jit(
            JDet.make_train_step(d["jmodel"], d["tx"], IMG, JCfg(),
                                 augment=False),
            in_shardings=(ctx.replicated, ctx.data, ctx.data, ctx.data,
                          None),
            out_shardings=(ctx.replicated, ctx.replicated))
        jstate = jmesh.replicate_tree(ctx, d["jstate"])
        jmetrics = []
        for _ in range(2):
            jstate, m = step(jstate, jnp.asarray(d["images"].numpy()),
                             jnp.asarray(d["boxes"].numpy()),
                             jnp.asarray(d["classes"].numpy()),
                             jax.random.key(0))
            jmetrics.append(jax.device_get(m))
    finally:
        mp.undo()
    jstate = jax.device_get(jstate)
    for rank in dp_runs["yolo"]:
        for t, j in zip(rank["metrics"], jmetrics):
            np.testing.assert_allclose(t["loss"], float(j["loss"]),
                                       rtol=1e-4)
            for k in ("box", "cls", "dfl"):
                np.testing.assert_allclose(t[k], float(j[k]), rtol=1e-3)
            assert int(t["num_fg"]) == int(j["num_fg"])
        got = _to_jax_tree({k: v.numpy() for k, v in rank["state"].items()},
                           d["template"])
        for part in ("params", "batch_stats"):
            _assert_updates_match(got[part], getattr(jstate, part),
                                  d["template"][part], part)


@pytest.mark.parametrize("name", ["yolo", "yolo-aug", "frcnn", "unet"])
def test_dp_step_matches_one_process(dp_runs, work, name):
    """Both ranks hold the one-process step's metrics, weights, running
    statistics (and, for YOLO, EMA), bit for bit between the ranks."""
    ref = _one_process(work, name)
    start = torch.load(work / f"{name}.in.pt", weights_only=False)["state"]
    r0, r1 = dp_runs[name]
    for k in r0["state"]:
        assert torch.equal(r0["state"][k], r1["state"][k]), k
    adam = "grads" in ref        # the U-Net: its gradients, not AdamW's
    assert_same_run(r0, ref, name, start=start,
                    skip=(lambda k: "running_" not in k) if adam else None)
    if adam:
        for k, g in ref["grads"].items():
            err = (r0["grads"][k] - g).double().norm().item()
            if os.environ.get("MP_MEASURE"):
                print("MEASURE grad", k, err / g.double().norm().item())
            assert err <= GRAD_TOL * g.double().norm().item(), k
    if "ema" in ref:
        for k, v in ref["ema"].items():
            base = (v.double() - start[k].double()).abs().max().item()
            err = (r0["ema"][k].double() - v.double()).abs().max().item()
            assert err <= STATE_TOL * base + 1e-12, k


def test_dp_step_in_float64_equals_one_process(dp_runs, work):
    """The U-Net step in float64 on both sides: two ranks give the
    one-process metrics and gradients to 1e-9 (measured 4e-15), so the f32
    differences above are summation order, not semantics."""
    ref = _one_process(work, "unet-f64")
    for rank in dp_runs["unet-f64"]:
        for k, v in ref["metrics"][0].items():
            assert rank["metrics"][0][k] == pytest.approx(v, rel=1e-9), k
        for k, g in ref["grads"].items():
            assert g.dtype == torch.float64
            err = (rank["grads"][k] - g).norm() / g.norm()
            assert err <= 1e-9, k
        for k, v in ref["state"].items():
            if "running_" in k:
                torch.testing.assert_close(rank["state"][k], v, rtol=1e-9,
                                           atol=1e-12)


@pytest.mark.parametrize("mutate", ["grad", "bn"])
def test_dropped_all_reduce_leaves_the_bars(work, yolo_inputs, dp_runs,
                                            mutate):
    """A rank that skips the gradient all-reduce (or takes its BatchNorm
    statistics over its own rows) no longer holds the one-process step."""
    ref = _one_process(work, "yolo")
    start = yolo_inputs["state"]
    out = work / f"mut_{mutate}"
    out.mkdir(exist_ok=True)
    torch.save(torch.load(work / "yolo.in.pt", weights_only=False),
               out / "yolo.in.pt")
    got = launch(["yolo"], out, mutate)["yolo"][0]
    with pytest.raises(AssertionError):
        assert_same_run(got, ref, f"mutate {mutate}", start=start)


def test_sharded_eval_matches_unsharded(dp_runs, work):
    ref = _one_process(work, "eval")["summary"]
    assert ref["images"] == 8 and 0.05 < ref["mAP50"] < 0.999
    for rank in dp_runs["eval"]:
        s = rank["summary"]
        assert s["images"] == 8
        assert s["mAP50"] == pytest.approx(ref["mAP50"], abs=1e-9)
        assert s["mAP50_95"] == pytest.approx(ref["mAP50_95"], abs=1e-9)


@pytest.fixture(scope="module")
def train_runs(work, coco_roots):
    root, tp_root = coco_roots
    torch.save(dict(root=root, out=work / "det_run"),
               work / "detector_train.in.pt")
    torch.save(dict(root=tp_root, out=work / "tp_run",
                    mesh=dict(data=1, model=2)),
               work / "rtdetr_train.in.pt")
    images, boxes, classes = yolo_batch(2)
    for name in TP_RUNS:
        torch.save(dict(img=IMG, steps=2,
                        images=torch.from_numpy(images[:2]),
                        boxes=torch.from_numpy(boxes[:2]),
                        classes=torch.from_numpy(classes[:2])),
                   work / f"{name}.in.pt")
    runs = launch(["detector_train", "rtdetr_train", TP_RUNS[0]], work)
    runs.update(launch(TP_RUNS[1:], work, "tp_grad,tp_match"))
    return runs


def test_detector_train_on_two_processes(train_runs, work):
    """Two steps on 8 images at global batch 4; the artifacts written
    once by the primary; the checkpoint loads in one process."""
    r0, r1 = (r["result"] for r in train_runs["detector_train"])
    assert r0["steps"] == r1["steps"] == 2
    assert r0["final_loss"] == r1["final_loss"]
    run = work / "det_run"
    hist = (run / "history.jsonl").read_text().splitlines()
    assert len(hist) == 1, hist
    rec = json.loads(hist[0])
    assert rec["epoch"] == 1 and "mAP50" in rec
    assert (run / "config.json").exists()
    assert len(list((run / "ckpt" / "last").iterdir())) == 1
    model = TDet.load_checkpoint(run, "n", device=torch.device("cpu"))
    with torch.no_grad():
        out = model(torch.rand(1, IMG, IMG, 3))
    assert all(torch.isfinite(t).all() for o in out for t in o)


def test_rtdetr_tp2_matches_tp1(train_runs, work, coco_roots):
    """mesh.model=2 against a one-process run: the plan applied, final
    loss within rtol 1e-3; the checkpoint in the TP=1 layout."""
    tp = train_runs["rtdetr_train"]
    assert [r["tp_plans"] for r in tp] == [1, 1]
    ref = W.run_rtdetr_train(dict(root=coco_roots[1], out=work / "tp1_run",
                                  mesh=dict(data=1, model=1)), None)
    assert ref["tp_plans"] == 0
    for r in tp:
        assert r["result"]["steps"] == ref["result"]["steps"] == 3
        np.testing.assert_allclose(r["result"]["final_loss"],
                                   ref["result"]["final_loss"], rtol=1e-3)
    a = TRT.load_checkpoint(work / "tp_run", device=torch.device("cpu"),
                            model_kwargs=dict(queries=24, dec_layers=2))
    b = TRT.load_checkpoint(work / "tp1_run", device=torch.device("cpu"),
                            model_kwargs=dict(queries=24, dec_layers=2))
    sa, sb = a.state_dict(), b.state_dict()
    assert sa.keys() == sb.keys()
    assert all(sa[k].shape == sb[k].shape for k in sa)


# the decoder split as it is, and with model index 1 perturbed
TP_RUNS = ("rtdetr_tp", "rtdetr_tp-tp_grad", "rtdetr_tp-tp_match")
TP_PARTS = ("params", "grad", "ema", "moments", "buffers", "match",
            "metrics")


@pytest.mark.parametrize("name", TP_RUNS)
def test_rtdetr_tp_ranks_hold_one_replicated_state(train_runs, name):
    """After every step both model ranks hold the same replicated state
    (digests of every replicated leaf, the gradient the global norm and
    the clip read, its EMA and AdamW moments, every buffer), the same 3
    matchings and the same metrics, bit for bit. Under a mutation, model
    index 1's own gradient or matching differs (the mutation is live) and
    the broadcasts from model index 0 make them one again."""
    r0, r1 = train_runs[name]
    assert (r0["model_index"], r1["model_index"]) == (0, 1)
    assert len(r0["steps"]) == len(r1["steps"]) == 2
    live = {"grad_reduced": False, "matcher": False}
    for i, (a, b) in enumerate(zip(r0["steps"], r1["steps"])):
        assert len(a["match"]) == 3
        assert len(a["params"]) == len(a["grad"]) > 0
        for part in TP_PARTS:
            if isinstance(a[part], dict):
                apart = [k for k in a[part] if a[part][k] != b[part].get(k)]
                assert a[part].keys() == b[part].keys() and not apart, (
                    name, i, part, apart[:3])
            else:
                assert a[part] == b[part], (name, i, part)
        for part in live:
            live[part] |= a[part] != b[part]
    mutation = name.partition("-")[2]
    assert live["grad_reduced"] == (mutation == "tp_grad")
    assert live["matcher"] == (mutation == "tp_match")


def test_rtdetr_tp_divisibility_guard(tmp_path, coco_roots):
    with pytest.raises(ValueError, match="divisible"):
        TRT.train(ExperimentConfig(train=TrainConfig(seed=0),
                                   mesh=MeshConfig(data=1, model=2)),
                  coco_roots[1], tmp_path / "bad", epochs=1, img_size=64,
                  batch_size=2, max_steps=1,
                  model_kwargs=dict(queries=24, dec_layers=2, heads=5),
                  device=torch.device("cpu"))
