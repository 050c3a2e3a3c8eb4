"""The program's stage spans (``core/profiling.recording`` in the port)
reduced against a device trace of the same segment: the numbers the
span metrics read (``benchmark/metrics/*_per_step.train``,
``*_per_pass.eval``).

The spans are stamped on ``time.time_ns()``, the clock of the profiler's
events, so both compare directly. The rules (:func:`attribute`):

  * each kernel or copy on the card is charged to the innermost span open
    at the host call that launched it (matched by correlation id), and
    each launch is counted there; a span is open from its start to its end,
    both included, and the innermost open span is the one opened last;
  * each idle gap of the card (between its busy intervals, as
    ``trace.idle_gaps`` finds them) is charged to the innermost span open
    at the gap's middle, or to :data:`OUTSIDE`;
  * a span's host time is its duration, its self time that less its
    children's.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from .trace import LAUNCH_APIS, device_profile

OUTSIDE = "outside the program's spans"
UNIT = {"train": "train.step", "sweep": "sweep.pass"}


@contextlib.contextmanager
def span_profile(device):
    """``trace.device_profile(device)`` with the program's spans recorded;
    yields (profiler, record)."""
    from robust_object_detection_tpu_torch.core import profiling

    with profiling.recording() as rec, device_profile(device) as prof:
        yield prof, rec


def profile_events(prof) -> Tuple[list, list]:
    """(runtime calls [(start ns, correlation id, is a launch)], device
    operations [(start ns, end ns, correlation id)]) of a finished
    ``torch.profiler`` run: the kernels and copies on the card, and the
    host's calls that enqueued them."""
    from torch.autograd import DeviceType

    calls, ops = [], []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            if not e.is_user_annotation():
                ops.append((e.start_ns(), e.end_ns(), e.correlation_id()))
        else:
            calls.append((e.start_ns(), e.correlation_id(),
                          e.name() in LAUNCH_APIS))
    return calls, ops


def busy_gaps(ops: Iterable[Tuple[int, int, int]]) -> List[Tuple[int, int]]:
    """The card's idle gaps between its first and last operation."""
    gaps, end = [], -math.inf
    for s, t in sorted((s, t) for s, t, _ in ops):
        if end > -math.inf and s > end:
            gaps.append((end, s))
        end = max(end, t)
    return gaps


def _innermost(spans: Sequence, times: Sequence[int]) -> List[Optional[int]]:
    """The index of the innermost span open at each time (None where none
    is): a sweep over the spans' edges, edges included."""
    closed = [(i, s) for i, s in enumerate(spans) if s.end is not None]
    edges = [(s.start, 0, i) for i, s in closed]
    edges += [(s.end, 2, i) for i, s in closed]
    edges += [(t, 1, q) for q, t in enumerate(times)]
    edges.sort()
    out: List[Optional[int]] = [None] * len(times)
    open_: List[int] = []
    for _, kind, i in edges:
        if kind == 0:
            open_.append(i)
        elif kind == 2:
            open_.remove(i)
        else:
            out[i] = open_[-1] if open_ else None
    return out


def attribute(spans: Sequence, calls: Sequence[Tuple[int, int, bool]],
              ops: Sequence[Tuple[int, int, int]],
              gaps: Sequence[Tuple[int, int]], top: int = 10) -> dict:
    """Charges device time, launches and idle gaps to spans (objects with
    ``name``, ``start``, ``end`` (None: never closed, left out),
    ``parent``: a parent's index; ns).

    Returns {"by_span": {name: {"count", "host_ms", "host_self_ms",
    "device_ms" (charged to the name as the innermost span),
    "device_ms_total" (to it or a span inside it), "launches",
    "launches_total" (likewise), "idle_s"}}
    (with an :data:`OUTSIDE` row), "device_ms" (every operation),
    "device_ops", "launches", "unmatched" (operations with no host call,
    charged at their own start), "idle_spans": the `top` [name, s] by idle
    seconds}."""
    rows: Dict[str, dict] = {}

    def row(name: str) -> dict:
        return rows.setdefault(name, {
            "count": 0, "host_ms": 0.0, "host_self_ms": 0.0,
            "device_ms": 0.0, "device_ms_total": 0.0, "launches": 0,
            "launches_total": 0, "idle_s": 0.0})

    child_ns = [0] * len(spans)
    for s in spans:
        if s.parent is not None and s.end is not None:
            child_ns[s.parent] += s.end - s.start
    for i, s in enumerate(spans):
        if s.end is not None:
            r = row(s.name)
            r["count"] += 1
            r["host_ms"] += (s.end - s.start) / 1e6
            r["host_self_ms"] += (s.end - s.start - child_ns[i]) / 1e6

    launch_at = {corr: t for t, corr, _ in calls}
    times = [t for t, _, _ in calls]
    unmatched = [k for k, (_, _, corr) in enumerate(ops)
                 if corr not in launch_at]
    times += [ops[k][0] for k in unmatched]
    times += [(a + b) // 2 for a, b in gaps]
    where = _innermost(spans, times)
    n_calls, n_un = len(calls), len(unmatched)
    span_of_call = dict(zip((corr for _, corr, _ in calls), where[:n_calls]))
    span_of_op = dict(zip(unmatched, where[n_calls:n_calls + n_un]))

    chains: Dict[Optional[int], List[str]] = {}

    def chain(i: Optional[int]) -> List[str]:
        """The names of span i and the spans around it, innermost first."""
        if i not in chains:
            names, j = [], i
            while j is not None:
                if spans[j].name not in names:
                    names.append(spans[j].name)
                j = spans[j].parent
            chains[i] = names or [OUTSIDE]
        return chains[i]

    launches = 0
    for (_, corr, is_launch), i in zip(calls, where[:n_calls]):
        if is_launch:
            launches += 1
            names = chain(i)
            row(names[0])["launches"] += 1
            for name in names:
                row(name)["launches_total"] += 1
    device_ms = 0.0
    for k, (s, t, corr) in enumerate(ops):
        i = span_of_call[corr] if corr in launch_at else span_of_op[k]
        ms = (t - s) / 1e6
        device_ms += ms
        names = chain(i)
        row(names[0])["device_ms"] += ms
        for name in names:
            row(name)["device_ms_total"] += ms
    for (a, b), i in zip(gaps, where[n_calls + n_un:]):
        row(spans[i].name if i is not None else OUTSIDE)["idle_s"] += \
            (b - a) / 1e9
    idle = sorted(((n, r["idle_s"]) for n, r in rows.items()
                   if r["idle_s"] > 0), key=lambda kv: -kv[1])
    return {"by_span": rows, "device_ms": device_ms, "device_ops": len(ops),
            "launches": launches, "unmatched": n_un,
            "idle_spans": [[n, s] for n, s in idle[:top]]}


def reduce(prof, record, top: int = 10) -> dict:
    """:func:`attribute` of a finished profiler run and the span record
    taken over the same segment."""
    calls, ops = profile_events(prof)
    return attribute(record.spans, calls, ops, busy_gaps(ops), top)


def table(reduced: dict) -> str:
    """The reduction by span, one line each: device ms (self and with the
    spans inside), launches, host self ms, idle s."""
    lines = [f"{'span':32s} {'count':>6s} {'device ms':>11s} "
             f"{'incl. ms':>11s} {'launches':>9s} {'host self ms':>13s} "
             f"{'idle s':>9s}"]
    for name, r in sorted(reduced["by_span"].items(),
                          key=lambda kv: -kv[1]["device_ms_total"]):
        lines.append(f"{name:32s} {r['count']:6d} {r['device_ms']:11.3f} "
                     f"{r['device_ms_total']:11.3f} {r['launches']:9d} "
                     f"{r['host_self_ms']:13.3f} {r['idle_s']:9.4f}")
    return "\n".join(lines)


def per_unit(record: dict, kind: str, names: Sequence[str],
             field: str) -> Optional[float]:
    """The sum of `field` over the spans `names`, a train step (kind
    "train") or a batch x pass ("sweep"); None where the record has no
    spans, or for device time where the trace holds no operation on the
    card."""
    red = record.get("spans") if record.get("kind") == kind else None
    if not red:
        return None
    rows = red["by_span"]
    n = rows.get(UNIT[kind], {}).get("count", 0)
    if n == 0 or (field.startswith("device") and red["device_ops"] == 0):
        return None
    return sum(rows[name][field] for name in names if name in rows) / n
