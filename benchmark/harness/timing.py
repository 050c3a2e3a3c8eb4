"""The arithmetic of the end-to-end metrics, and the clocks they are read
from.

A train window dispatches its steps ahead with no synchronisation between
them, records a CUDA event after each step and ends in one synchronise:
the rate is all images of all steps over the whole wall time, and a
step's time is the gap between the events of consecutive steps, read
after the window. A sweep window runs whole calls back to back: the rate
is every image-pass of every completed call over the time from the first
call's start to the last call's end.
"""

from __future__ import annotations

import statistics
import time
from typing import List, Sequence


def rate(items: float, seconds: float) -> float:
    """Work completed per second over a whole window."""
    if seconds <= 0:
        raise ValueError(f"a window of {seconds} s")
    return items / seconds


def percentile(values: Sequence[float], q: int) -> float:
    """The q-th percentile (1 <= q <= 99) of all values, by
    ``statistics.quantiles(..., n=100, method="inclusive")``."""
    if len(values) < 2:
        raise ValueError(f"a percentile of {len(values)} values")
    return statistics.quantiles(values, n=100, method="inclusive")[q - 1]


def gaps_ms(stamps_ms: Sequence[float]) -> List[float]:
    """Step times from the stamps taken after each step (the first stamp
    is taken before the first step)."""
    return [b - a for a, b in zip(stamps_ms, stamps_ms[1:])]


class StepClock:
    """Stamps taken after each step of a window: CUDA events on a card
    (read after the window, so they cost no synchronisation), the host's
    clock on the CPU, where every op is synchronous."""

    def __init__(self, device):
        self.cuda = getattr(device, "type", str(device)) == "cuda"
        self._marks: list = []

    def mark(self) -> None:
        if self.cuda:
            import torch
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self._marks.append(ev)
        else:
            self._marks.append(time.perf_counter())

    def stamps_ms(self) -> List[float]:
        """Milliseconds of each mark after the first; call after a
        synchronise."""
        if not self._marks:
            return []
        first = self._marks[0]
        if self.cuda:
            return [first.elapsed_time(ev) for ev in self._marks]
        return [(t - first) * 1e3 for t in self._marks]


def synchronize(device) -> None:
    if getattr(device, "type", str(device)) == "cuda":
        import torch
        torch.cuda.synchronize(device)
