"""What the per-layer metrics' readers share: each reader file
(benchmark/metrics/<name>.py) is one call of these on the run's record,
and returns None where the record has nothing for it to read."""

from __future__ import annotations

import statistics
from typing import Optional

from . import manifest, peaks
from .trace import ELEMENTWISE_GROUPS, is_hand_kernel


def _profile(record: dict, kind: str) -> Optional[dict]:
    if record.get("kind") != kind:
        return None
    return record.get("profile")


def units(record: dict) -> int:
    """Train: the profiled steps; sweep: the profiled forwards."""
    p = record["profile"]
    return p["steps"] if record["kind"] == "train" else p["forwards"]


def host_ms(record: dict, kind: str) -> Optional[float]:
    if record.get("kind") != kind or not record.get("host_ms"):
        return None
    return statistics.median(record["host_ms"])


def step_ms_median(record: dict, kind: str) -> Optional[float]:
    if record.get("kind") != kind or not record.get("step_ms"):
        return None
    return statistics.median(record["step_ms"])


def launches(record: dict, kind: str) -> Optional[float]:
    p = _profile(record, kind)
    if p is None or not p["launches"]:
        return None
    return p["launches"] / units(record)


def elementwise_ms(record: dict, kind: str) -> Optional[float]:
    p = _profile(record, kind)
    if p is None:
        return None
    ms = sum(p["by_group"].get(g, [0.0])[0] for g in ELEMENTWISE_GROUPS)
    return ms / units(record) if ms > 0 else None


def idle_share(record: dict, kind: str) -> Optional[float]:
    p = _profile(record, kind)
    if p is None or p["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - p["busy_s"] / p["wall_s"])


def kernel_roofline(record: dict, kind: str) -> Optional[float]:
    """100 x the hand kernels' least time (their work at the shapes of the
    calls the family lists, from benchmark/work/) over their device time,
    both over the profiled segment and over the kernel groups it ran."""
    p = _profile(record, kind)
    if p is None:
        return None
    fam = record["family"]
    bounds: dict = {}
    for name, call in fam.kernel_calls(record["config"], record["batch"],
                                       kind == "train"):
        mod = manifest.load_plugin("work", name)
        g = mod.group(call)
        bounds[g] = bounds.get(g, 0.0) + mod.bound_ms(call) * units(record)
    ran = {g: v[0] for g, v in p["by_group"].items() if is_hand_kernel(g)}
    num = sum(b for g, b in bounds.items() if g in ran)
    den = sum(ran.values())
    if num <= 0 or den <= 0:
        return None
    return 100.0 * num / den


def mfu(record: dict, kind: str) -> Optional[float]:
    """100 x the least time of the window's work at the peaks of the
    precisions the configuration states, over the window."""
    if record.get("kind") != kind or "flops" not in record:
        return None
    least_s = sum(flops / peaks.PRECISION_PEAK[prec]
                  for prec, flops in record["flops"].items())
    return 100.0 * least_s / record["window_s"]
