"""The port's host substrate (core/config.py, core/artifacts.py,
core/checkpoint.py, core/profiling.py) against the reference's: config
JSON written by either package loads in the other; override; the
artifact formats; checkpoints (rolling, best, an interrupted write);
the trace with the program's spans."""

import dataclasses
import json

import pytest
import torch

from robust_object_detection_tpu.core import artifacts as JA
from robust_object_detection_tpu.core import config as JC
from robust_object_detection_tpu_torch.core import artifacts as TA
from robust_object_detection_tpu_torch.core import checkpoint as TK
from robust_object_detection_tpu_torch.core import config as TC
from robust_object_detection_tpu_torch.core import profiling as TP

torch.set_num_threads(1)


def _custom(C):
    return C.override(C.ExperimentConfig(), name="exp7",
                      train={"lr": 3e-4, "remat": True},
                      restoration={"channels": (16, 32), "lr_min": 1e-7},
                      mesh={"data": 2}, corruption={"noise_sigma": 20.0})


def test_config_defaults_and_fields_match_reference():
    assert TC.to_dict(TC.ExperimentConfig()) == JC.to_dict(
        JC.ExperimentConfig())
    for name in ("CorruptionConfig", "DataConfig", "TrainConfig",
                 "RestorationConfig", "MeshConfig", "EvalConfig",
                 "ExperimentConfig"):
        t = [(f.name, f.default) for f in dataclasses.fields(getattr(TC, name))]
        j = [(f.name, f.default) for f in dataclasses.fields(getattr(JC, name))]
        assert t == j, name


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_config_json_round_trips_both_ways(tmp_path, writer):
    src, dst = (JC, TC) if writer == "jax" else (TC, JC)
    cfg = _custom(src)
    src.save(cfg, tmp_path / "cfg.json")
    back = dst.load(tmp_path / "cfg.json")
    assert dst.to_dict(back) == src.to_dict(cfg)
    assert back.restoration.channels == (16, 32)
    assert back.out_dir == cfg.out_dir
    # and through the other package's writer again, unchanged
    dst.save(back, tmp_path / "again.json")
    assert json.loads((tmp_path / "again.json").read_text()) == json.loads(
        (tmp_path / "cfg.json").read_text())


def test_override_and_from_dict():
    cfg = _custom(TC)
    assert cfg.name == "exp7" and cfg.train.lr == 3e-4 and cfg.train.remat
    assert cfg.train.epochs == TC.TrainConfig().epochs     # untouched
    assert cfg.mesh == TC.MeshConfig(data=2, model=1)
    partial = TC.from_dict({"restoration": {"batch_size": 4}, "unknown": 1})
    assert partial.restoration.batch_size == 4
    assert partial.restoration.channels == (32, 64, 128, 256)
    with pytest.raises(dataclasses.FrozenInstanceError):
        cfg.name = "x"


def test_artifacts_match_reference(tmp_path):
    rows = [{"variant": "Test_Clean", "mAP50": 0.5, "n": 3},
            {"variant": "Test_Noise", "mAP50": 0.25}]
    for mod, d in ((TA, tmp_path / "t"), (JA, tmp_path / "j")):
        for r in rows:
            mod.append_jsonl(d / "h.jsonl", r)
        mod.write_json(d / "r.json", {"rows": rows})
        mod.write_csv(d / "r.csv", rows)
        mod.write_csv(d / "empty.csv", [])
    for name in ("h.jsonl", "r.json", "r.csv", "empty.csv"):
        assert (tmp_path / "t" / name).read_bytes() == (
            tmp_path / "j" / name).read_bytes(), name
    assert TA.read_jsonl(tmp_path / "t" / "h.jsonl") == rows
    assert TA.read_jsonl(tmp_path / "t" / "missing.jsonl") == []
    assert TA.read_json(tmp_path / "t" / "r.json") == {"rows": rows}
    assert not list((tmp_path / "t").glob("*.tmp"))
    table = [["yolov8m", 0.41234, 7], ["rtdetr", 0.5, 12]]
    assert TA.format_table(["model", "mAP", "n"], table) == JA.format_table(
        ["model", "mAP", "n"], table)


def test_history_logger(tmp_path):
    log = TA.HistoryLogger(tmp_path / "run")
    rec = log.log(epoch=1, loss=0.5)
    log.log(epoch=2, loss=0.25, elapsed_sec=99)
    hist = TA.read_jsonl(tmp_path / "run" / "history.jsonl")
    assert hist[0] == rec and rec["elapsed_sec"] >= 0 and rec["epoch"] == 1
    assert hist[1]["elapsed_sec"] == 99


def _state(seed):
    g = torch.Generator().manual_seed(seed)
    return {"model": {"w": torch.randn(3, 4, generator=g),
                      "n": torch.tensor(seed)},
            "optimizer": {"state": {0: {"step": torch.tensor(2.0)}},
                          "param_groups": [{"lr": 1e-3, "betas": (0.9, 0.999),
                                            "params": [0]}]}}


def _equal(a, b):
    if isinstance(a, torch.Tensor):
        return torch.equal(a, b)
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_equal(x, y) for x, y in zip(a, b))
    return a == b


def test_checkpoint_last_and_best(tmp_path):
    ckpt = TK.CheckpointManager(tmp_path, max_to_keep=2)
    assert ckpt.latest_step() is None and ckpt.restore_last() is None
    assert ckpt.restore_best() is None and ckpt.best_metric() is None
    for step in (1, 2, 3, 3):          # a step saved twice is replaced
        ckpt.save_last(step, _state(step), extra={"epoch": step})
    assert sorted(p.name for p in (tmp_path / "ckpt" / "last").iterdir()) \
        == ["2", "3"]
    last = ckpt.restore_last(map_location="cpu")
    assert last["step"] == 3 and last["extra"] == {"epoch": 3}
    assert _equal(last["state"], _state(3))
    assert ckpt.save_best(1, _state(1), 30.0)
    assert not ckpt.save_best(2, _state(2), 29.0)
    assert ckpt.save_best(3, _state(3), 31.5)
    assert not ckpt.save_best(4, _state(4), 40.0, mode="min")
    assert ckpt.best_metric() == 31.5
    assert json.loads((tmp_path / "ckpt" / "best_meta.json").read_text()) \
        == {"step": 3, "metric": 31.5}
    assert _equal(TK.CheckpointManager(tmp_path).restore_best(), _state(3))
    ckpt.close()


def test_interrupted_write_keeps_the_previous_checkpoint(tmp_path,
                                                         monkeypatch):
    ckpt = TK.CheckpointManager(tmp_path)
    ckpt.save_last(5, _state(5))
    ckpt.save_best(5, _state(5), 1.0)
    real_save = torch.save

    def cut_short(obj, f):
        real_save(obj, f)
        with open(f, "r+b") as fh:          # a kill mid-write
            fh.truncate(64)
        raise KeyboardInterrupt
    monkeypatch.setattr(torch, "save", cut_short)
    with pytest.raises(KeyboardInterrupt):
        ckpt.save_last(5, _state(6))
    with pytest.raises(KeyboardInterrupt):
        ckpt.save_best(6, _state(6), 2.0)
    monkeypatch.undo()
    assert not list(tmp_path.rglob("*.tmp"))
    assert _equal(ckpt.restore_last()["state"], _state(5))
    assert _equal(ckpt.restore_best(), _state(5))
    assert ckpt.best_metric() == 1.0


def test_stage_timer_and_trace(tmp_path):
    """The stage timer's successor: trace() records the program's spans
    while it profiles and writes them into its Chrome trace beside the
    profiler's events, on the profiler's timeline."""
    with TP.trace(tmp_path / "tr"):
        with TP.span("stage.outer", step=2):
            with TP.span("stage.inner"):
                torch.ones(4).sum()
    trace = json.loads((tmp_path / "tr" / "trace.json").read_text())
    spans = {e["name"]: e for e in trace["traceEvents"]
             if e.get("cat") == "program_span"}
    assert set(spans) == {"stage.outer", "stage.inner"}
    outer, inner = spans["stage.outer"], spans["stage.inner"]
    assert outer["ph"] == "X" and outer["args"] == {"step": 2}
    assert outer["ts"] <= inner["ts"]
    assert inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"]
    ops = [e for e in trace["traceEvents"] if e.get("name") == "aten::sum"]
    assert ops and all(inner["ts"] <= e["ts"] and e["ts"] + e["dur"]
                       <= inner["ts"] + inner["dur"] for e in ops)
    with TP.trace(tmp_path / "off", enabled=False):
        with TP.span("unrecorded"):
            pass
    assert not (tmp_path / "off").exists()
