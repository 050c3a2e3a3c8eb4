"""The port's CLI (robust_object_detection_tpu_torch/cli.py) against the
reference's, and the port's env-driven process group
(parallel/distributed.py).

  * the parser: the same 16 subcommands with the same flags, plus
    ``--device`` on each;
  * both CLIs on one tiny PNG split: ``convert-det-coco``,
    ``convert-det-yolo`` and ``build-testsets`` give equal artifacts
    (Clean and Noise byte-equal, Blur and LowRes within 1 LSB, the
    reference's own bar), ``validate`` prints the same lines for each
    kind;
  * ``eval`` and ``eval-restored`` on a reference YOLOv8m checkpoint
    carried across by models/convert.py: mAPs within 1e-3 of the
    reference CLI's (tests/test_torch_detector_eval.py's tolerance), with
    ground truth made of the reference's own detections, so the mAPs sit
    near 1 and a wrong box lowers them;
  * ``train-detector`` (all three models) and ``train-restoration`` write
    the reference's checkpoint layout and print its result keys;
  * the refusal of a computing command without a card and without
    ``--device cpu``; Faster R-CNN in bfloat16 and ``--allow-pickle``
    reach their trainer;
  * ``python -m robust_object_detection_tpu_torch.cli`` runs;
  * ``shard_samples`` and ``local_batch_size`` equal the reference's,
    ``maybe_initialize`` is False without the environment and joins a
    two-process gloo group with it.
"""

import argparse
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

from robust_object_detection_tpu import cli as jcli
from robust_object_detection_tpu.core.checkpoint import \
    CheckpointManager as JCheckpointManager
from robust_object_detection_tpu.data import pipeline as jpipe
from robust_object_detection_tpu.data import synthetic
from robust_object_detection_tpu.eval import detector_eval as jde
from robust_object_detection_tpu.models import yolov8 as jy
from robust_object_detection_tpu.parallel import distributed as jdist
from robust_object_detection_tpu.train import detector as jdet
from robust_object_detection_tpu_torch import cli as tcli
from robust_object_detection_tpu_torch.core.checkpoint import \
    CheckpointManager
from robust_object_detection_tpu_torch.models import convert
from robust_object_detection_tpu_torch.models import yolov8 as ty
from robust_object_detection_tpu_torch.parallel import distributed as tdist

from test_torch_yolov8 import _randomise_bn

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
IMG = 64
VARIANTS = ("Test_Clean", "Test_Noise", "Test_Blur", "Test_LowRes")


def _port(*argv):
    return tcli.main(list(argv) + ["--device", "cpu"])


# ── The parser ───────────────────────────────────────────────────────────

def _subcommands(parser):
    sub = next(a for a in parser._actions
               if isinstance(a, argparse._SubParsersAction))
    return {name: sorted(s for a in sp._actions for s in a.option_strings)
            for name, sp in sub.choices.items()}


def _reference_parser(monkeypatch):
    """The parser the reference's main() builds, caught at parse_args."""
    caught = []

    class Caught(Exception):
        pass

    def parse(self, *a, **k):
        caught.append(self)
        raise Caught

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", parse)
    with pytest.raises(Caught):
        jcli.main(["validate", "--root", "x"])
    monkeypatch.undo()
    return caught[0]


def test_parser_has_the_reference_commands_and_flags(monkeypatch):
    ref = _subcommands(_reference_parser(monkeypatch))
    ours = _subcommands(tcli.build_parser())
    assert len(ref) == 16 and ours.keys() == ref.keys()
    for name in ref:
        assert sorted(set(ours[name]) - {"--device"}) == ref[name], name
        assert "--device" in ours[name]


# ── Both CLIs on one split ───────────────────────────────────────────────

@pytest.fixture(scope="module")
def prepared(tmp_path_factory):
    """Raw train / val PNG splits and each CLI's processed roots and
    testsets: {"raw": ..., "ref": root, "port": root}."""
    root = tmp_path_factory.mktemp("cli")
    raw = {s: synthetic.make_det_split(root / f"raw_{s}", n_images=3,
                                       seed=i, ext="png",
                                       size_range=((40, 57), (48, 81)))
           for i, s in enumerate(("train", "val"))}
    return _prepare(root, raw)


def _prepare(root, raw):
    def run(side, *argv):
        if side == "ref":
            jcli.main(list(argv))
        else:
            _port(*argv)

    for side in ("ref", "port"):
        proc = root / side / "processed"
        for s in ("train", "val"):
            run(side, "convert-det-coco", "--src", str(raw[s]), "--out",
                str(proc / "visdrone_coco6"), "--split", s)
            run(side, "convert-det-yolo", "--src", str(raw[s]), "--out",
                str(proc / "visdrone_yolo6"), "--split", s)
        run(side, "build-testsets", "--processed-root", str(proc), "--out",
            str(root / side / "testsets"))
    return {"raw": raw, "ref": root / "ref", "port": root / "port"}


def _files(root: Path):
    return sorted(str(p.relative_to(root)) for p in root.rglob("*")
                  if p.is_file())


def _read(path):
    from PIL import Image
    return np.asarray(Image.open(path).convert("RGB")).astype(int)


def test_converters_give_equal_artifacts(prepared):
    ref, ours = prepared["ref"] / "processed", prepared["port"] / "processed"
    names = _files(ref)
    assert len(names) > 20 and _files(ours) == names
    for n in names:
        a, b = (ours / n).read_bytes(), (ref / n).read_bytes()
        if n.endswith("data.yaml"):
            b = b.replace(str(ref.resolve()).encode(),
                          str(ours.resolve()).encode())
        assert a == b, n


def test_build_testsets_gives_equal_artifacts(prepared):
    ref, ours = prepared["ref"] / "testsets", prepared["port"] / "testsets"
    names = _files(ref)
    assert _files(ours) == names
    n_images = 0
    for n in names:
        a, b = ours / n, ref / n
        if "/images/" not in n:
            tb, rb = a.read_text(), b.read_text()
            if n.endswith("data.yaml"):
                rb = rb.replace(str(b.parent.resolve()),
                                str(a.parent.resolve()))
            assert tb == rb, n
        elif "Test_Clean" in n or "Test_Noise" in n:
            assert a.read_bytes() == b.read_bytes(), n
            n_images += 1
        else:
            assert np.abs(_read(a) - _read(b)).max() <= 1, n
            n_images += 1
    assert n_images == 2 * 4 * 3


@pytest.fixture(scope="module")
def jpeg_roots(tmp_path_factory):
    """A JPEG split converted by each CLI (the reference's validate counts
    .jpg files only)."""
    root = tmp_path_factory.mktemp("cli_jpg")
    raw = synthetic.make_det_split(root / "raw", n_images=3, seed=4,
                                   size_range=((40, 57), (48, 81)))
    for side in ("ref", "port"):
        for cmd, layout in (("convert-det-coco", "coco"),
                            ("convert-det-yolo", "yolo")):
            argv = [cmd, "--src", str(raw), "--out", str(root / side / layout)]
            jcli.main(argv) if side == "ref" else _port(*argv)
    return raw, root


@pytest.mark.parametrize("kind", ["visdrone-det", "coco", "yolo"])
def test_validate_prints_the_reference_lines(jpeg_roots, kind, capsys):
    raw, root = jpeg_roots
    roots = ((raw, raw) if kind == "visdrone-det" else
             (root / "ref" / kind, root / "port" / kind))
    jcli.main(["validate", "--root", str(roots[0]), "--kind", kind])
    ref = capsys.readouterr().out
    _port("validate", "--root", str(roots[1]), "--kind", kind)
    assert capsys.readouterr().out == ref
    assert ref.endswith("[validate] OK\n")


def test_validate_counts_png_and_bmp_images(prepared, capsys):
    """Where the reference counts .jpg files only, the port counts every
    suffix data/imageio.py reads (a BMP split validates)."""
    _port("validate", "--root", str(prepared["raw"]["val"]), "--kind",
          "visdrone-det")
    _port("validate", "--root",
          str(prepared["port"] / "processed" / "visdrone_yolo6"), "--kind",
          "yolo")
    assert capsys.readouterr().out.splitlines() == [
        "[validate] images=3 annotations=3", "[validate] OK",
        "[validate] images=3 labels=3", "[validate] OK"]


def test_validate_fails_on_a_missing_layout(tmp_path):
    with pytest.raises(SystemExit, match="FAILED"):
        _port("validate", "--root", str(tmp_path), "--kind", "yolo")


def test_cli_module_runs_in_a_subprocess(prepared):
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run(
        [sys.executable, "-m", "robust_object_detection_tpu_torch.cli",
         "validate", "--root",
         str(prepared["port"] / "processed" / "visdrone_coco6"),
         "--kind", "coco", "--split", "train", "--device", "cpu"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.splitlines()[-1] == "[validate] OK"


# ── eval / eval-restored on one YOLOv8m checkpoint ───────────────────────

@pytest.fixture(scope="module")
def yolo_checkpoints(tmp_path_factory):
    """A reference YOLOv8m checkpoint (orbax, EMA = params; every BN
    redrawn, the class outputs' kernels x100 so the scores spread) and the
    same weights carried across into the port's (torch.save)."""
    root = tmp_path_factory.mktemp("yolo_ckpt")
    model = jy.create(6, "m")
    v = _randomise_bn(jax.device_get(
        jy.init_variables(model, jax.random.key(0), IMG)), 1)
    v = jax.tree.map(np.array, v)
    for i in range(3):
        # spread the class logits, so that the detections' scores spread
        out = v["params"]["Head_0"][f"cls{i}_out"]
        out["kernel"] *= 100.0
        out["bias"][:] = -3.0
    ref = root / "ref"
    ckpt = JCheckpointManager(ref)
    ckpt.save_best(1, {"params": v["params"],
                       "batch_stats": v["batch_stats"],
                       "ema_params": v["params"]}, 0.0)
    ckpt.close()
    port = ty.YoloV8(ty.YoloConfig(6, "m"))
    port.load_state_dict(convert.from_jax_variables(
        v["params"], v["batch_stats"], "m"), strict=True)
    ckpt = CheckpointManager(root / "port")
    ckpt.save_best(1, {"model": port.state_dict(),
                       "ema": {n: p.detach() for n, p in
                               port.named_parameters()}}, 0.0)
    ckpt.close()
    return model, v, ref, root / "port"


def _pseudo_gt_testsets(prepared, model, v, root):
    """The clean val split under every variant name of coco6 and
    coco6_restored, its ground truth replaced by the reference's own
    detections (score >= 0.3, at most 8 an image)."""
    src = prepared["port"] / "processed" / "visdrone_coco6"
    samples = jpipe.index_coco(src, "val")
    state = jdet.DetTrainState(v["params"], v["batch_stats"], v["params"],
                               None, 0)
    predict = jax.jit(jdet.make_predict_step(model, IMG))
    dets, _, _ = jde._collect_detections(predict, state, samples, IMG, 2,
                                         None, 600)
    coco = json.loads((src / "annotations" / "instances_val.json")
                      .read_text())
    anns = []
    for s in samples:
        d = dets[s.image_id]
        order = np.argsort(-d.scores, kind="stable")[:8]
        for i in order:
            if d.scores[i] < 0.3:
                continue
            x, y, w, h = (float(t) for t in d.boxes[i])
            anns.append({"id": len(anns) + 1, "image_id": s.image_id,
                         "category_id": int(d.classes[i]),
                         "bbox": [x, y, w, h], "area": w * h,
                         "iscrowd": 0})
    assert len(anns) >= 6
    coco["annotations"] = anns
    for layout in ("coco6", "coco6_restored"):
        for variant in VARIANTS:
            dst = root / layout / variant
            shutil.copytree(src, dst)
            (dst / "annotations" / "instances_val.json").write_text(
                json.dumps(coco))
            shutil.rmtree(dst / "images" / "train")
    return root


def test_eval_and_eval_restored_match_the_reference_cli(
        prepared, yolo_checkpoints, tmp_path):
    model, v, ref_ckpt, port_ckpt = yolo_checkpoints
    testsets = _pseudo_gt_testsets(prepared, model, v, tmp_path / "ts")
    common = ["--testset-root", str(testsets), "--img-size", str(IMG),
              "--batch-size", "2"]
    for cmd, name in (("eval", "eval_results"),
                      ("eval-restored", "eval_restored_results")):
        jcli.main([cmd, "--model", f"yolo_baseline=yolo:{ref_ckpt}",
                   *common, "--out", str(tmp_path / "ref")])
        out = _port(cmd, "--model", f"yolo_baseline=yolo:{port_ckpt}",
                    *common, "--out", str(tmp_path / "port"))
        ref = json.loads((tmp_path / "ref" / f"{name}.json").read_text())
        ours = json.loads((tmp_path / "port" / f"{name}.json").read_text())
        assert ours.keys() == ref.keys() == out.keys() == {"yolo_baseline"}
        for variant in VARIANTS:
            r, o = ref["yolo_baseline"][variant], ours["yolo_baseline"][
                variant]
            assert r["mAP50"] > 0.5, (cmd, variant, r["mAP50"])
            for k in ("mAP50", "mAP50_95"):
                assert abs(o[k] - r[k]) <= 1e-3, (cmd, variant, k, o[k],
                                                  r[k])
        assert (tmp_path / "port" / f"{name}.csv").read_text().splitlines(
        )[0] == (tmp_path / "ref" / f"{name}.csv").read_text().splitlines(
        )[0]


# ── Trainers through the CLI ─────────────────────────────────────────────

def _layout(out_dir: Path):
    return sorted(str(p.relative_to(out_dir)) for p in out_dir.rglob("*")
                  if p.parent == out_dir or p.parent.parent == out_dir)


def _reference_ckpt_layout(tmp_path):
    """What the reference's CheckpointManager writes for one best and one
    last save: ckpt/best, ckpt/best_meta.json, ckpt/last/<step>."""
    ckpt = JCheckpointManager(tmp_path / "refckpt")
    ckpt.save_best(1, {"w": np.zeros(2, np.float32)}, 0.5)
    ckpt.save_last(3, {"w": np.zeros(2, np.float32)})
    ckpt.close()
    names = {str(p.relative_to(tmp_path / "refckpt"))
             for p in (tmp_path / "refckpt").rglob("*")
             if len(p.relative_to(tmp_path / "refckpt").parts) <= 3}
    return {n for n in names if n.split("/")[-1] in
            ("ckpt", "best", "best_meta.json", "last")
            or n.startswith("ckpt/last/")}


@pytest.mark.parametrize("model", ["yolo", "rtdetr", "frcnn"])
def test_train_detector_writes_the_reference_layout(prepared, model,
                                                    tmp_path, capsys):
    out = tmp_path / model
    # at 64 px Faster R-CNN's RoI batch is filled up with zero-size
    # padding boxes (fewer valid proposals than RoI slots): the loss must
    # stay finite, as the reference's does
    _port("train-detector", "--model", model, "--data-root",
          str(prepared["port"] / "processed" / "visdrone_coco6"),
          "--out", str(out), "--epochs", "1", "--max-steps", "1",
          "--img-size", str(IMG), "--batch-size", "2", "--augment")
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    # the reference's train() returns {out_dir, steps, final_loss}
    # (train/detector.py:406, train/rtdetr.py:698, train/frcnn.py:536)
    assert printed.keys() == {"out_dir", "steps", "final_loss"}
    assert printed["steps"] == 1 and np.isfinite(printed["final_loss"])
    for name in ("history.jsonl", "ckpt/best_meta.json", "ckpt/best"):
        assert (out / name).exists(), name
    # the reference's YOLO and Faster R-CNN trainers stamp config.json,
    # its RT-DETR trainer does not
    assert (out / "config.json").exists() == (model != "rtdetr")
    assert len(list((out / "ckpt" / "last").iterdir())) == 1
    ref = _reference_ckpt_layout(tmp_path)
    ours = {n for n in _layout(out / "ckpt")}
    assert {"best", "best_meta.json", "last"} <= ours
    assert {n.split("/", 1)[1] for n in ref if n.count("/") == 1} == {
        "best", "best_meta.json", "last"}
    hist = [json.loads(x) for x in
            (out / "history.jsonl").read_text().splitlines()]
    assert "mAP50" in hist[-1] and "train_loss" in hist[-1]
    shutil.rmtree(out)


def test_frcnn_head_loss_on_padding_rois_equals_reference():
    """RoI slots filled with zero-size padding boxes carry non-finite
    delta targets; the reference's multiply by a bool mask selects, so
    they add 0. The port's head loss equals the reference's on the
    reference's own targets, and its gradient is finite."""
    import jax.numpy as jnp
    from robust_object_detection_tpu.models import frcnn as JF
    from robust_object_detection_tpu.train import frcnn as JT
    from robust_object_detection_tpu_torch.train import frcnn as TT
    rng = np.random.RandomState(0)
    b, p, m, r = 2, 40, 5, 32
    xy = rng.uniform(0, 40, (b, p, 2))
    proposals = np.concatenate([xy, xy + rng.uniform(4, 20, (b, p, 2))], -1)
    prop_valid = np.arange(p)[None].repeat(b, 0) < np.asarray([[18], [11]])
    proposals[~prop_valid] = 0.0
    gxy = rng.uniform(0, 40, (b, m, 2))
    gt = np.concatenate([gxy, gxy + rng.uniform(6, 20, (b, m, 2))], -1)
    gc = np.asarray([[0, 3, 5, -1, -1], [2, -1, -1, -1, -1]])
    gt[gc < 0] = 0.0
    cfg = JF.FrcnnConfig(roi_batch=r)
    rois, rv, ct, dt, pos = JT.roi_targets(
        jnp.asarray(proposals, jnp.float32), jnp.asarray(prop_valid),
        jnp.asarray(gt, jnp.float32), jnp.asarray(gc), cfg,
        jax.random.key(0))
    assert not bool(jnp.isfinite(dt).all()) and int(pos.sum()) > 0
    scores = rng.randn(b, r, 7).astype(np.float32)
    deltas = rng.randn(b, r, 7, 4).astype(np.float32)
    ref = JT.head_loss(jnp.asarray(scores), jnp.asarray(deltas), ct, dt,
                       rv, pos)
    d = torch.tensor(deltas, requires_grad=True)
    out = TT.head_loss(torch.from_numpy(scores), d,
                       torch.from_numpy(np.asarray(ct)).long(),
                       torch.from_numpy(np.asarray(dt)),
                       torch.from_numpy(np.asarray(rv)),
                       torch.from_numpy(np.asarray(pos)))
    for k in ("head_cls", "head_box"):
        assert float(out[k]) == pytest.approx(float(ref[k]), rel=1e-6), k
    (out["head_cls"] + out["head_box"]).backward()
    assert torch.isfinite(d.grad).all()


def test_train_restoration_and_restore_testsets(prepared, tmp_path, capsys):
    cfg = tmp_path / "cfg.json"
    from robust_object_detection_tpu_torch.core import config as cl
    c = cl.ExperimentConfig()
    cl.save(cl.override(c, restoration=cl.override(
        c.restoration, patch_size=32, batch_size=2)), cfg)
    imgs = prepared["port"] / "processed" / "visdrone_coco6" / "images"
    _port("train-restoration", "--train-dir", str(imgs / "train"),
          "--val-dir", str(imgs / "val"), "--out", str(tmp_path / "unet"),
          "--max-steps", "1", "--config", str(cfg))
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    # the reference's train() returns {best, out_dir, param_count}
    # (train/restoration.py:274)
    assert printed.keys() == {"best", "out_dir", "param_count"}
    for name in ("config.json", "history.jsonl", "ckpt/best_meta.json",
                 "ckpt/best"):
        assert (tmp_path / "unet" / name).exists(), name
    ts = tmp_path / "ts"
    shutil.copytree(prepared["port"] / "testsets", ts)
    counts = _port("restore-testsets", "--testset-root", str(ts),
                   "--unet-dir", str(tmp_path / "unet"), "--batch-size", "2")
    assert counts == {f"{f}/{v}": 3 for f in ("coco6", "yolo6")
                      for v in VARIANTS}
    for f in ("coco6", "yolo6"):
        src = ts / f / "Test_Clean" / "images" / "val"
        dst = ts / f"{f}_restored" / "Test_Clean" / "images" / "val"
        for p in src.iterdir():
            assert (dst / p.name).read_bytes() == p.read_bytes()


# ── Refusals ─────────────────────────────────────────────────────────────

def test_frcnn_bfloat16_and_allow_pickle_are_refused(tmp_path,
                                                     monkeypatch):
    """Faster R-CNN's bfloat16 mode and --allow-pickle are ported: the CLI
    refuses neither and hands --dtype and allow_pickle to the trainer
    (tests/test_torch_frcnn_bf16.py trains through the first,
    tests/test_torch_pretrained_pickle.py loads through the second)."""
    from robust_object_detection_tpu_torch.train import detector as tdet
    from robust_object_detection_tpu_torch.train import frcnn as tfr
    common = ["train-detector", "--data-root", str(tmp_path), "--out",
              str(tmp_path / "o")]
    seen = {}
    monkeypatch.setattr(tfr, "train", lambda *a, **k: seen.update(k) or {})
    monkeypatch.setattr(tdet, "train", lambda *a, **k: seen.update(k) or {})
    _port(*common, "--model", "frcnn", "--dtype", "bfloat16")
    assert seen["dtype"] == "bfloat16" and seen["allow_pickle"] is False
    _port(*common, "--model", "yolo", "--allow-pickle")
    assert seen["allow_pickle"] is True


def test_a_computing_command_needs_the_card_or_cpu(prepared, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this check is for a machine without a card")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        tcli.main(["build-testsets", "--processed-root",
                   str(prepared["port"] / "processed"), "--out",
                   str(tmp_path / "t")])
    assert not (tmp_path / "t").exists()


# ── parallel/distributed ─────────────────────────────────────────────────

@pytest.mark.parametrize("n, count", [(10, 1), (10, 3), (7, 4), (2, 4)])
def test_shard_samples_equals_reference(n, count):
    samples = list(range(n))
    for i in range(count):
        assert tdist.shard_samples(samples, i, count) == \
            jdist.shard_samples(samples, i, count)


def test_single_process_helpers_equal_reference(monkeypatch):
    for k in ("ROD_COORDINATOR", "ROD_NUM_PROCESSES", "ROD_PROCESS_ID",
              "ROD_AUTO_DISTRIBUTED", "MASTER_ADDR", "MASTER_PORT",
              "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(k, raising=False)
    assert tdist.maybe_initialize("cpu") is False
    assert tdist.is_primary() and jdist.is_primary()
    assert tdist.local_batch_size(8) == jdist.local_batch_size(8) == 8
    assert tdist.shard_samples(list(range(5))) == jdist.shard_samples(
        list(range(5)))


_GROUP = r"""
import json, sys
from robust_object_detection_tpu_torch.parallel import distributed as d
import torch.distributed as dist
assert d.maybe_initialize("cpu")
assert d.maybe_initialize("cpu")        # idempotent
t = __import__("torch").tensor([float(dist.get_rank() + 1)])
dist.all_reduce(t)
print(json.dumps({"primary": d.is_primary(), "local": d.local_batch_size(8),
                  "shard": d.shard_samples(list(range(7))),
                  "sum": t.item()}))
dist.destroy_process_group()
"""


def test_maybe_initialize_joins_a_gloo_group(tmp_path):
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    procs = []
    for rank in range(2):
        env = dict(os.environ, PYTHONPATH=str(ROOT),
                   ROD_COORDINATOR=f"localhost:{port}",
                   ROD_NUM_PROCESSES="2", ROD_PROCESS_ID=str(rank))
        procs.append(subprocess.Popen(
            [sys.executable, "-c", _GROUP], cwd=ROOT, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=120)
        assert p.returncode == 0, err
        outs.append(json.loads(out.strip().splitlines()[-1]))
    assert [o["primary"] for o in outs] == [True, False]
    assert [o["local"] for o in outs] == [4, 4]
    assert [o["shard"] for o in outs] == [[0, 2, 4], [1, 3, 5]]
    assert [o["sum"] for o in outs] == [3.0, 3.0]


@pytest.mark.slow
def test_full_pipeline_example_runs(tmp_path):
    """examples/full_pipeline_synthetic_torch.py end to end on the CPU."""
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run(
        [sys.executable, str(ROOT / "examples" /
                             "full_pipeline_synthetic_torch.py"),
         "--work", str(tmp_path), "--device", "cpu", "--img-size", "64"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=1800)
    assert res.returncode == 0, res.stderr[-4000:]
    assert "[example] done" in res.stdout
