"""The reduction of the program's stage spans against a device trace
(harness/spans.py): the attribution rules on synthetic spans, launches,
operations and gaps, and the span readers on whole tiny runs on the CPU,
their profiled segment recorded as ``spans.span_profile`` records it.

    python -m pytest benchmark/tests -q
"""

import contextlib
import time
from types import SimpleNamespace as S

import pytest
import torch

from benchmark import run
from benchmark.harness import manifest, spans, trace

from test_bench_harness import tiny

TRAIN_READERS = ["augment_ms_per_step.train", "forward_ms_per_step.train",
                 "loss_ms_per_step.train", "backward_ms_per_step.train",
                 "optimizer_ms_per_step.train"]
SWEEP_HOST = ["nms_host_ms_per_pass.eval", "fetch_wait_ms_per_pass.eval",
              "score_host_ms_per_pass.eval"]


def _spans():
    # step (0-100) > forward (10-40) > inner (20-30); step > loss (40-90)
    return [S(name="train.step", start=0, end=100, parent=None),
            S(name="train.forward", start=10, end=40, parent=0),
            S(name="inner", start=20, end=30, parent=1),
            S(name="train.loss", start=40, end=90, parent=0)]


def test_the_innermost_open_span_takes_each_launch_and_its_time():
    calls = [(25, 1, True),     # inside inner, forward and step
             (15, 2, True),     # forward
             (40, 3, True),     # forward's end and loss's start: loss
             (30, 4, True),     # inner's end: inner
             (95, 5, True),     # step only
             (120, 6, True),    # outside every span
             (50, 7, False)]    # a copy's call: no launch
    ops = [(200, 210, 1), (210, 230, 2), (230, 260, 3), (260, 270, 4),
           (270, 275, 5), (275, 276, 6), (300, 340, 7)]
    out = spans.attribute(_spans(), calls, ops, gaps=[])
    rows = out["by_span"]
    assert rows["inner"]["launches"] == 2
    assert rows["inner"]["device_ms"] == pytest.approx(20e-6)
    assert rows["train.forward"]["launches"] == 1
    assert rows["train.forward"]["device_ms"] == pytest.approx(20e-6)
    assert rows["train.forward"]["device_ms_total"] == pytest.approx(40e-6)
    assert rows["train.forward"]["launches_total"] == 3
    assert rows["train.loss"]["launches"] == 1
    assert rows["train.loss"]["device_ms"] == pytest.approx(70e-6)
    assert rows["train.step"]["device_ms"] == pytest.approx(5e-6)
    assert rows["train.step"]["device_ms_total"] == pytest.approx(115e-6)
    assert rows["train.step"]["launches_total"] == 5
    assert rows[spans.OUTSIDE]["launches"] == 1
    assert rows[spans.OUTSIDE]["device_ms"] == pytest.approx(1e-6)
    assert out["launches"] == 6 and out["device_ops"] == 7
    assert out["device_ms"] == pytest.approx(116e-6)
    assert out["unmatched"] == 0


def test_host_self_time_and_counts():
    rows = spans.attribute(_spans(), [], [], [])["by_span"]
    assert rows["train.step"]["host_ms"] == pytest.approx(100e-6)
    assert rows["train.step"]["host_self_ms"] == pytest.approx(20e-6)
    assert rows["train.forward"]["host_self_ms"] == pytest.approx(20e-6)
    assert rows["inner"]["host_self_ms"] == pytest.approx(10e-6)
    assert all(r["count"] == 1 for r in rows.values())
    unclosed = _spans() + [S(name="open", start=95, end=None, parent=0)]
    assert "open" not in spans.attribute(unclosed, [], [], [])["by_span"]


def test_gaps_go_to_the_span_open_at_their_middle_or_outside():
    ops = [(0, 5, 1), (15, 22, 2), (60, 70, 3), (150, 160, 4)]
    gaps = spans.busy_gaps(ops)
    assert gaps == [(5, 15), (22, 60), (70, 150)]
    out = spans.attribute(_spans(), [], ops, gaps)
    rows = out["by_span"]
    assert rows["train.forward"]["idle_s"] == pytest.approx(10e-9)   # 10
    assert rows["train.loss"]["idle_s"] == pytest.approx(38e-9)      # 41
    assert rows[spans.OUTSIDE]["idle_s"] == pytest.approx(80e-9)     # 110
    assert out["idle_spans"][0] == [spans.OUTSIDE, pytest.approx(80e-9)]
    # no host call: each operation charged at its own start
    assert out["unmatched"] == 4
    assert rows["train.step"]["device_ms"] == pytest.approx(5e-6)
    assert rows["train.forward"]["device_ms"] == pytest.approx(7e-6)
    assert rows["train.loss"]["device_ms"] == pytest.approx(10e-6)
    assert rows[spans.OUTSIDE]["device_ms"] == pytest.approx(10e-6)


def test_readers_read_nothing_without_spans():
    for name in TRAIN_READERS + SWEEP_HOST + ["restore_ms_per_pass.eval"]:
        reader = manifest.load_plugin("metrics", name)
        assert reader.read({}) is None
        assert reader.read({"kind": "train", "profile": {}}) is None
        assert reader.read({"kind": "sweep", "profile": {}}) is None


def test_readers_divide_by_steps_and_passes():
    rows = {"train.step": {"count": 2, "device_ms_total": 10.0},
            "train.optimizer": {"count": 2, "device_ms_total": 3.0},
            "train.ema": {"count": 2, "device_ms_total": 1.0}}
    rec = {"kind": "train", "spans": {"by_span": rows, "device_ops": 9}}
    read = manifest.load_plugin("metrics", "optimizer_ms_per_step.train").read
    assert read(rec) == 2.0
    rec["spans"]["device_ops"] = 0          # no card: no device time
    assert read(rec) is None
    rows = {"sweep.pass": {"count": 8, "host_ms": 80.0},
            "sweep.collect": {"count": 1, "host_ms": 8.0},
            "sweep.score": {"count": 1, "host_ms": 24.0}}
    rec = {"kind": "sweep", "spans": {"by_span": rows, "device_ops": 0}}
    read = manifest.load_plugin("metrics", "score_host_ms_per_pass.eval").read
    assert read(rec) == 4.0


def _run_with_spans(monkeypatch, cell: manifest.Cell) -> dict:
    """A tiny --trace 1 run whose profiled segment records the program's
    spans; the record carries their reduction under "spans"."""
    driver = manifest.load_plugin("drivers", cell.traffic["driver"])
    held = {}

    @contextlib.contextmanager
    def profiled(device):
        with spans.span_profile(device) as (prof, rec):
            held["record"] = rec
            yield prof

    def reduced(prof, wall_s, rtdetr=False):
        held["spans"] = spans.reduce(prof, held["record"])
        return trace.reduce_profile(prof, wall_s, rtdetr)
    monkeypatch.setattr(driver, "device_profile", profiled)
    monkeypatch.setattr(driver, "reduce_profile", reduced)
    torch.manual_seed(0)
    ctx = run.RunContext(cell, 2 ** 31 + 77, 0.5, True, torch.device("cpu"),
                         manifest.load_plugin("families",
                                              cell.config["family"]),
                         time.perf_counter())
    out = driver.run(ctx)
    out["record"]["spans"] = held["spans"]
    return out


@pytest.mark.parametrize("cell", ["yolov8m.train_aug.b16",
                                  "yolov8m.sweep8.b32"])
def test_a_tiny_run_records_the_stage_spans(monkeypatch, cell):
    out = _run_with_spans(monkeypatch, tiny(cell))
    record = out["record"]
    rows = record["spans"]["by_span"]
    if record["kind"] == "train":
        assert rows["train.step"]["count"] == out["profile"]["steps"] == 1
        for name in ("train.augment", "train.forward", "train.loss",
                     "train.assign", "train.backward", "train.optimizer",
                     "train.ema"):
            assert rows[name]["count"] == 1, name
        readers = TRAIN_READERS
    else:
        assert rows["sweep.call"]["count"] == 1
        assert rows["sweep.pass"]["count"] == out["profile"]["forwards"] == 8
        assert rows["sweep.restore"]["count"] == 3
        readers = SWEEP_HOST + ["restore_ms_per_pass.eval"]
        for name in SWEEP_HOST:
            value = manifest.load_plugin("metrics", name).read(record)
            assert value is not None and value > 0, name
    # no card: nothing charged as device time
    assert record["spans"]["device_ops"] == 0
    for name in readers:
        if name not in SWEEP_HOST:
            assert manifest.load_plugin("metrics", name).read(record) is None
    assert spans.table(record["spans"]).splitlines()[0].startswith("span")
