"""The manifest (``BENCHMARK.json`` at the checkout's root) and the plug-ins
it names.

Everything that belongs to one configuration, one traffic mix or one
per-layer metric is a file of its own, found by name:

  * a configuration: the JSON file its manifest entry names (``file``),
    whose ``family`` names an adapter ``benchmark/families/<family>.py``;
  * a traffic mix: ``benchmark/traffic/<traffic>.json``, whose ``driver``
    names ``benchmark/drivers/<driver>.py``;
  * a per-layer metric: ``benchmark/metrics/<name>.py`` (a ``read(record)``
    that returns a number or None);
  * a hand kernel's work: ``benchmark/work/<family>.py``.

A later change adds a cell, a configuration or a metric by adding files and
manifest entries; no file that is there needs an edit.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import re
from pathlib import Path
from types import ModuleType
from typing import Dict, List, Optional

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent
MANIFEST = ROOT / "BENCHMARK.json"

_NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")


def check_name(name: str) -> str:
    if not isinstance(name, str) or not _NAME.match(name):
        raise ValueError(f"not a benchmark name: {name!r}")
    return name


def load_manifest(path: Path = MANIFEST) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    """One workload of the manifest with everything it names, loaded."""
    name: str
    chips: int
    config: dict             # the configuration's file, with "name"
    traffic: dict            # the traffic mix's file, with "name"
    end_to_end: List[dict]   # the end-to-end metrics this cell reports
    per_layer: List[dict]    # the per-layer metrics this cell reports


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def find_cell(name: str, manifest: Optional[dict] = None) -> Cell:
    """The cell `name` of the manifest; raises KeyError if there is none."""
    m = load_manifest() if manifest is None else manifest
    work = {w["name"]: w for w in m["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in {MANIFEST.name}; have "
                       f"{sorted(work)}")
    w = work[name]
    cfg_entry = {c["name"]: c for c in m["configs"]}[w["config"]]
    config = dict(load_json(ROOT / cfg_entry["file"]), name=w["config"])
    traffic = dict(load_json(BENCH_DIR / "traffic"
                             / f"{check_name(w['traffic'])}.json"),
                   name=w["traffic"])
    return Cell(name=name, chips=int(w["chips"]), config=config,
                traffic=traffic,
                end_to_end=[e for e in m["end_to_end"] if _applies(e, name)],
                per_layer=[p for p in m["per_layer"] if _applies(p, name)])


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


_MODULES: Dict[Path, ModuleType] = {}


def load_plugin(kind: str, name: str) -> ModuleType:
    """benchmark/<kind>/<name>.py, loaded by its path (names may hold dots,
    so they are no package paths). Loaded once a process."""
    path = BENCH_DIR / kind / f"{check_name(name)}.py"
    if path not in _MODULES:
        if not path.is_file():
            raise FileNotFoundError(f"no {kind} plug-in {name!r} ({path})")
        mod_name = "benchmark_" + kind + "_" + re.sub(r"\W", "_", name)
        spec = importlib.util.spec_from_file_location(mod_name, path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _MODULES[path] = mod
    return _MODULES[path]
