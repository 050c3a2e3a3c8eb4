"""The harness on the CPU: the manifest and the plug-ins it names, the
arithmetic of the end-to-end metrics, the FLOP counts, the guard against
JAX, and whole runs of the cells at tiny sizes through the program's plain
paths (the look for a card skipped), sound and with the timed path broken.

    python -m pytest benchmark/tests -q
"""

import ast
import copy
import dataclasses
import hashlib
import json
import os
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from benchmark import run
from benchmark.harness import guard, manifest, timing

ROOT = manifest.ROOT
BENCH = manifest.BENCH_DIR
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}


def test_manifest_has_the_contract_keys_and_paths():
    m = manifest.load_manifest()
    assert set(m) == KEYS
    assert m["paths"] == ["benchmark"]
    assert m["command"][:2] == ["python3", "benchmark/run.py"]
    assert 1 <= m["run_seconds"] <= 51
    names = [e["name"] for e in m["end_to_end"]]
    assert "setup_s" in names
    for e in m["end_to_end"]:
        assert 0 < e["bound"] <= 0.25 and e["source"] in ("host_clock",
                                                           "device_trace")
    cells = {w["name"] for w in m["workloads"]}
    for p in m["per_layer"]:
        assert p["moves"] in names
        for cell in p.get("workloads", cells):
            assert cell in cells
            moved = next(e for e in m["end_to_end"] if e["name"] == p["moves"])
            assert cell in moved.get("workloads", cells)


@pytest.mark.parametrize("cell", [w["name"] for w in
                                  manifest.load_manifest()["workloads"]])
def test_every_cell_names_files_and_plugins_that_exist(cell):
    c = manifest.find_cell(cell)
    manifest.load_plugin("families", c.config["family"])
    driver = manifest.load_plugin("drivers", c.traffic["driver"])
    assert callable(driver.run) and callable(driver.control)
    for metric in c.per_layer:
        assert callable(manifest.load_plugin("metrics", metric["name"]).read)
    limits = run.limits_of(cell)
    assert limits and all(v >= 0 for v in limits.values())
    assert c.end_to_end and c.per_layer


@pytest.mark.parametrize("kind", ["configs", "traffic", "limits"])
def test_every_data_file_parses(kind):
    files = sorted((BENCH / kind).glob("*.json"))
    assert files
    for f in files:
        assert isinstance(json.loads(f.read_text()), dict), f


def test_config_files_state_their_source_and_precision():
    for c in manifest.load_manifest()["configs"]:
        data = json.loads((ROOT / c["file"]).read_text())
        assert data["source"] == c["source"]
        assert "precision" in data and "assumed" in data
        assert c["reduced"] == []


def chunked_median(values, chunk: int) -> float:
    """What a benchmark that times chunks of steps and keeps their median
    reports."""
    means = [statistics.fmean(values[i:i + chunk])
             for i in range(0, len(values) - chunk + 1, chunk)]
    return statistics.median(means)


def test_a_stall_moves_the_rate_and_the_tail_and_not_a_chunked_median():
    steady = [100.0] * 120
    stalled = list(steady)
    for start in (20, 60, 100):          # three bursts of 5 stalled steps
        stalled[start:start + 5] = [160.0] * 5
    assert timing.rate(len(steady), sum(steady) / 1e3) == pytest.approx(10.0)
    assert timing.rate(len(stalled), sum(stalled) / 1e3) < 9.5
    assert timing.percentile(steady, 90) == 100.0
    assert timing.percentile(stalled, 90) > 150.0
    assert chunked_median(stalled, 5) == 100.0


def test_step_times_are_the_gaps_between_stamps():
    assert timing.gaps_ms([0.0, 10.0, 25.0, 27.5]) == [10.0, 15.0, 2.5]
    with pytest.raises(ValueError):
        timing.rate(10, 0.0)


def test_yolov8m_flops_at_640_are_the_published_78_9_gflops():
    fam = manifest.load_plugin("families", "yolov8")
    cfg = manifest.find_cell("yolov8m.train_aug.b16").config
    published = fam.flops(dict(cfg, imgsz=640, nc=80), 1, train=False)
    assert published / 1e9 == pytest.approx(78.9, abs=0.1)
    nc6 = fam.flops(dict(cfg, imgsz=640), 1, train=False)
    assert 78.0e9 < nc6 < published     # the nc 6 head is a little smaller


def test_unet_is_the_references_3_70m_parameters():
    from benchmark.reference.unet import RestorationUNet
    with torch.device("meta"):
        m = RestorationUNet([32, 64, 128, 256])
    assert sum(p.numel() for p in m.parameters()) / 1e6 == pytest.approx(
        3.70, abs=0.005)


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_module_of_the_benchmark_imports_jax_or_the_jax_package():
    files = sorted(BENCH.rglob("*.py"))
    assert len(files) > 20
    for f in files:
        found = guard.forbidden_loaded(list(_imports(f)))
        assert not found, (f, found)


def test_reference_imports_nothing_of_the_program():
    for f in sorted((BENCH / "reference").glob("*.py")):
        tops = {m.split(".")[0] for m in _imports(f)}
        assert "robust_object_detection_tpu_torch" not in tops, f


def test_the_guard_compares_whole_top_level_names():
    assert guard.forbidden_loaded(["robust_object_detection_tpu_torch.ops",
                                   "numpy", "jaxtyping"]) == []
    assert guard.forbidden_loaded(["jax.numpy", "robust_object_detection_tpu"
                                   ".ops", "flax"]) == [
        "flax", "jax", "robust_object_detection_tpu"]


def test_without_a_card_the_run_prints_no_result(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run.main(["--workload", "yolov8m.train_aug.b16", "--seed",
                   "2147483901", "--seconds", "1", "--trace", "0"])
    assert rc != 0
    assert capsys.readouterr().out == ""


# ── whole runs at tiny sizes ────────────────────────────────────────────────

TINY = {"yolov8m.train_aug.b16": ({"imgsz": 64},
                                  {"batch": 2, "pool": 4, "trace_steps": 1}),
        "yolov8m.sweep8.b32": ({"imgsz": 128},
                               {"batch": 2, "images": 4,
                                "native_hw": [48, 64], "trace_images": 2,
                                "check_images": 2, "gt_per_image": [2, 5],
                                "box_px": [4, 20]})}


def tiny(cell: str, precision: str = "float32") -> manifest.Cell:
    """The cell at a size the CPU runs in seconds; float32 by default, so
    that a sound run lands far inside the cell's limits."""
    c = manifest.find_cell(cell)
    cfg, tr = TINY[cell]
    config = dict(c.config, **cfg)
    config["precision"] = dict(config["precision"], detector=precision)
    return dataclasses.replace(c, config=config,
                               traffic=dict(c.traffic, **tr))


def tiny_run(cell: manifest.Cell, trace: bool = False, seed: int = 2 ** 31
             + 77) -> dict:
    torch.manual_seed(0)
    return run.run_cell(cell, seed, 0.5, trace, torch.device("cpu"),
                        run.limits_of(cell.name), time.perf_counter())


@pytest.mark.parametrize("cell", list(TINY))
@pytest.mark.parametrize("trace", [False, True])
def test_a_tiny_run_prints_the_result_keys_and_is_correct(cell, trace):
    res = tiny_run(tiny(cell), trace)
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]
    assert list(res)[-1] == "checks"
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    c = manifest.find_cell(cell)
    want = c.per_layer if trace else c.end_to_end
    if not trace:
        assert set(res["metrics"]) == {m["name"] for m in want}
    for name, m in res["metrics"].items():
        assert m["unit"] == next(w["unit"] for w in want
                                 if w["name"] == name)
    assert res["device"]["platform"] == "cpu"
    json.dumps(res, allow_nan=False)


def _fault(monkeypatch, family: str, name: str, wrap):
    fam = manifest.load_plugin("families", family)
    inner = getattr(fam, name)
    monkeypatch.setattr(fam, name, lambda *a, **k: wrap(inner(*a, **k)))


def _unchanged_state(made):
    state, step = made

    def broken(st, *args):
        saved = copy.deepcopy((st.model.state_dict(),
                               st.optimizer.state_dict(), st.ema))
        out = step(st, *args)
        st.model.load_state_dict(saved[0])
        st.optimizer.load_state_dict(saved[1])
        st.ema.update(saved[2])
        return out
    return state, broken


def _half_batch(made):
    state, step = made

    def broken(st, images, boxes, classes, gen):
        h = images.shape[0] // 2
        return step(st, images[:h], boxes[:h], classes[:h], gen)
    return state, broken


def _altered_answer(predict):
    def broken(model, canvas):      # each image's first detection
        boxes, scores, classes, valid = predict(model, canvas)
        scores = scores.clone()
        scores[:, 0] += 0.25
        return boxes, scores, classes, valid
    return broken


def _half_batch_predict(predict):
    def broken(model, canvas):
        boxes, scores, classes, valid = predict(model, canvas)
        valid = valid.clone()
        valid[valid.shape[0] // 2:] = False
        return boxes, scores, classes, valid
    return broken


FAULTS = [("yolov8m.train_aug.b16", "program_train", _unchanged_state),
          ("yolov8m.train_aug.b16", "program_train", _half_batch),
          ("yolov8m.sweep8.b32", "program_predict", _altered_answer),
          ("yolov8m.sweep8.b32", "program_predict", _half_batch_predict)]


@pytest.mark.parametrize("cell,entry,fault", FAULTS,
                         ids=[f[2].__name__.strip("_") for f in FAULTS])
def test_a_broken_timed_path_is_not_correct(monkeypatch, cell, entry, fault):
    c = tiny(cell)
    _fault(monkeypatch, c.config["family"], entry, fault)
    res = tiny_run(c)
    assert not res["correct"], res["checks"]


def test_a_new_cell_is_only_new_files(tmp_path):
    """A copy of the benchmark with one more traffic mix, one more limits
    file and one more manifest entry runs the new cell; no file under
    benchmark/ that was there changed."""
    root = tmp_path / "checkout"
    shutil.copytree(BENCH, root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", root / "BENCHMARK.json")

    def digests():
        return {p: hashlib.sha256(p.read_bytes()).hexdigest()
                for p in (root / "benchmark").rglob("*") if p.is_file()
                and "__pycache__" not in p.parts}
    before = digests()
    base = json.loads((BENCH / "traffic" / "train_aug.b16.json").read_text())
    new = dict(base, **dict(TINY["yolov8m.train_aug.b16"][1], batch=4))
    (root / "benchmark" / "traffic" / "train_aug.b4.json").write_text(
        json.dumps(new))
    (root / "benchmark" / "limits" / "yolov8m.train_aug.b4.json").write_text(
        (BENCH / "limits" / "yolov8m.train_aug.b16.json").read_text())
    m = json.loads((root / "BENCHMARK.json").read_text())
    m["workloads"].append({"name": "yolov8m.train_aug.b4",
                           "config": "yolov8m", "traffic": "train_aug.b4",
                           "chips": 1, "why": "a test's added cell"})
    (root / "BENCHMARK.json").write_text(json.dumps(m))
    script = (
        "import sys, time, json, dataclasses, torch\n"
        f"sys.path[:0] = [{str(root)!r}, {str(ROOT)!r}]\n"
        "from benchmark import run\n"
        "from benchmark.harness import manifest\n"
        "c = manifest.find_cell('yolov8m.train_aug.b4')\n"
        "cfg = dict(c.config, imgsz=64, precision=dict(c.config['precision'],"
        " detector='float32'))\n"
        "c = dataclasses.replace(c, config=cfg)\n"
        "r = run.run_cell(c, 5, 1.5, False, torch.device('cpu'),"
        " run.limits_of(c.name), time.perf_counter())\n"
        "print(json.dumps({'correct': r['correct'], 'file': "
        "manifest.__file__}))\n")
    out = subprocess.run([sys.executable, "-c", script], capture_output=True,
                         text=True, timeout=600,
                         env=dict(os.environ, OMP_NUM_THREADS="2"))
    assert out.returncode == 0, out.stderr[-3000:]
    last = json.loads(out.stdout.strip().splitlines()[-1])
    assert last["correct"]
    assert last["file"].startswith(str(root))
    after = digests()
    assert {p: d for p, d in after.items() if p in before} == before
