"""Profiling and tracing (counterpart of
robust_object_detection_tpu/core/profiling.py):

  * :func:`trace` — ``torch.profiler`` around a block, written as a Chrome
    trace (``<out_dir>/trace.json``; the card's kernels too when there is
    one),
  * :func:`annotate` — a named range in that trace
    (``torch.profiler.record_function``),
  * :class:`StageTimer` — wall-clock per named stage; a stage given a
    ``fence`` synchronizes the card that holds it before reading the
    clock, so the stage is charged with its device work.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from pathlib import Path
from typing import Dict, Iterator

import torch


@contextlib.contextmanager
def trace(out_dir: str | Path, enabled: bool = True) -> Iterator[None]:
    """torch.profiler trace around a code block, exported as a Chrome
    trace to ``<out_dir>/trace.json``."""
    if not enabled:
        yield
        return
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(str(out_dir / "trace.json"))


def annotate(name: str):
    """Named region for the profiler timeline."""
    return torch.profiler.record_function(name)


def _first_tensor(tree):
    if isinstance(tree, torch.Tensor):
        return tree
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        for x in tree:
            t = _first_tensor(x)
            if t is not None:
                return t
    return None


class StageTimer:
    """Accumulates wall-clock per named stage. ``fence`` (a tensor, or a
    dict / list / tuple holding one) makes the stage wait for the card
    that holds its first tensor before the clock is read."""

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str, fence=None) -> Iterator[None]:
        t0 = time.time()
        try:
            yield
        finally:
            t = _first_tensor(fence) if fence is not None else None
            if t is not None and t.is_cuda:
                torch.cuda.synchronize(t.device)
            self.totals[name] += time.time() - t0
            self.counts[name] += 1

    def summary(self) -> Dict[str, Dict[str, float]]:
        return {k: {"total_s": round(v, 4),
                    "count": self.counts[k],
                    "mean_ms": round(1e3 * v / max(self.counts[k], 1), 3)}
                for k, v in self.totals.items()}

    def report(self) -> str:
        lines = [f"{k:30s} {v['count']:6d}x  {v['mean_ms']:9.2f} ms  "
                 f"{v['total_s']:9.2f} s"
                 for k, v in sorted(self.summary().items())]
        return "\n".join(lines)
