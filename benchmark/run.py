#!/usr/bin/env python3
"""Run one cell of the benchmark once, on the card this process is given.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s>
                             --trace <0|1>

The cell (``BENCHMARK.json``'s workloads) names a configuration and a
traffic mix; the traffic mix names its driver (benchmark/drivers/). The
run makes its inputs and weights from --seed, sets up and warms the
program, measures for --seconds, checks what the timed path produced
against the plain reference, and prints as the last line of its standard
output one JSON object: ``correct``, ``attempted``, ``failed``, ``metrics``
(the cell's end-to-end metrics, or with --trace 1 its per-layer metrics),
``device``, with --trace 1 ``breakdown``, and last ``checks``: each number
compared, with its limit (also the last lines of standard error).

Exits 2 without a result where there is no CUDA card or fewer cards than
the cell asks for, and 1 where the process has loaded JAX or the JAX
package.
"""

from __future__ import annotations

import os
import time

T_IMPORT = time.perf_counter()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CACHE = ROOT / ".bench_cache"

# the program's libraries load no JAX; build caches live in the checkout
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"
os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(CACHE / "torch_extensions"))
os.environ.setdefault("TRITON_CACHE_DIR", str(CACHE / "triton"))
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark.harness import checks, guard, manifest  # noqa: E402


def process_start() -> float:
    """The process's start on the ``time.perf_counter`` clock (from its
    start time in /proc, else this module's import)."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        age = (time.clock_gettime(time.CLOCK_BOOTTIME)
               - ticks / os.sysconf("SC_CLK_TCK"))
        return time.perf_counter() - age
    except (OSError, ValueError, IndexError, AttributeError):
        return T_IMPORT


@dataclasses.dataclass
class RunContext:
    cell: manifest.Cell
    seed: int
    seconds: float
    trace: bool
    device: "object"
    family: "object"
    t_process: float

    @staticmethod
    def log(msg: str) -> None:
        print(msg, file=sys.stderr, flush=True)


def limits_of(cell: str) -> dict:
    return manifest.load_json(manifest.BENCH_DIR / "limits" / f"{cell}.json")


def run_cell(cell: manifest.Cell, seed: int, seconds: float, trace: bool,
             device, limits: dict, t_process: float) -> dict:
    """One run of `cell` on `device`: the result object (without the
    check for JAX, which is the caller's, once the run is over)."""
    family = manifest.load_plugin("families", cell.config["family"])
    driver = manifest.load_plugin("drivers", cell.traffic["driver"])
    ctx = RunContext(cell, seed, seconds, trace, device, family, t_process)
    out = driver.run(ctx)
    if trace:
        metrics = {}
        for m in cell.per_layer:
            value = manifest.load_plugin("metrics", m["name"]).read(
                out["record"])
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": out["end_to_end"][m["name"]],
                               "unit": m["unit"]} for m in cell.end_to_end}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": _device_kind(device), "count": cell.chips,
           "memory_peak_bytes": out["peak_bytes"]}
    result = {"correct": False, "attempted": out["attempted"],
              "failed": out["failed"], "metrics": metrics, "device": dev}
    if trace and out["profile"] is not None:
        prof = out["profile"]
        dev["busy_s"] = prof["busy_s"]
        dev["window_s"] = prof["wall_s"]
        result["breakdown"] = {"device_ops": prof["device_ops"],
                               "idle_gaps": prof["idle_gaps"]}
    result["checks"] = checks.result_checks(out["numbers"], limits)
    result["correct"] = checks.passed(result["checks"])
    return result


def _device_kind(device) -> str:
    if device.type == "cuda":
        import torch
        return torch.cuda.get_device_name(device)
    return device.type


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    t_process = process_start()
    cell = manifest.find_cell(args.workload)
    limits = limits_of(cell.name)
    # a traffic mix may fix the host's thread pools (OpenMP's, torch's
    # intra-op pool): on a shared host their spinning spreads the runs; set
    # before torch or numpy is loaded
    if cell.traffic.get("host_threads") is not None:
        os.environ["OMP_NUM_THREADS"] = str(cell.traffic["host_threads"])

    import torch
    if not torch.cuda.is_available():
        print("no CUDA card: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"{cell.name} needs {cell.chips} cards, this process sees "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 2
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                      torch.device("cuda", 0), limits, t_process)
    loaded = guard.forbidden_loaded()
    if loaded:
        print(f"the run loaded {loaded}: no result", file=sys.stderr)
        return 1
    for name, c in result["checks"].items():
        ok = "ok" if c["value"] <= c["limit"] else "FAIL"
        print(f"check {name} {c['value']!r} limit {c['limit']!r} {ok}",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
