"""Stage spans and tracing (counterpart of
robust_object_detection_tpu/core/profiling.py):

  * :func:`span` — a named stage of the program (``train.forward``,
    ``sweep.restore``, ...), with ids that tie the spans of one step or one
    call together (``step=``, ``call=``, ``batch=``, ``pass_=``),
  * :func:`recording` — turns recording on for a block and yields the
    :class:`Record` of the spans opened in it,
  * :func:`trace` — ``torch.profiler`` around a block with the spans
    recorded, written as one Chrome trace (``<out_dir>/trace.json``): the
    card's kernels (the host's ops where there is no card) and the spans
    above them.

Recording is off by default: :func:`span` then returns one shared object
that does nothing. A span reads the host's clock at its edges and never
waits for the card (no ``synchronize``, ``.item()`` or ``.cpu()``): the
card's time comes from a device trace. The clock is ``time.time_ns()``,
the one ``torch.profiler``'s events are stamped on, so a span and the
kernels launched inside it compare directly.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from collections import Counter
from pathlib import Path
from typing import Dict, Iterator, List, Optional

import torch

_record: Optional["Record"] = None       # the record while recording is on
_local = threading.local()               # each thread's stack of open spans


class Span:
    """One stage: its name, start and end (``time.time_ns()``), the index
    of its parent in the record (None for a root), the thread that opened
    it (its native id, the profiler's ``tid``) and the ids it was given."""

    __slots__ = ("name", "start", "end", "parent", "thread", "ids")

    def __init__(self, name: str, start: int, parent: Optional[int],
                 thread: int, ids: dict):
        self.name = name
        self.start = start
        self.end: Optional[int] = None
        self.parent = parent
        self.thread = thread
        self.ids = ids


class Record:
    """The spans opened while recording was on, in the order they opened."""

    def __init__(self):
        self.spans: List[Span] = []

    def counts(self) -> Dict[str, int]:
        return dict(Counter(s.name for s in self.spans))


class _Off:
    """What :func:`span` returns while recording is off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Open:
    __slots__ = ("record", "index", "stack")

    def __init__(self, record: Record, name: str, ids: dict):
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        self.record, self.stack = record, stack
        self.index = len(record.spans)
        record.spans.append(Span(name, time.time_ns(),
                                 stack[-1] if stack else None,
                                 threading.get_native_id(), ids))
        stack.append(self.index)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.record.spans[self.index].end = time.time_ns()
        self.stack.pop()
        return False


def span(name: str, **ids):
    """A stage of the program, as a context manager; recorded only inside
    :func:`recording`."""
    if _record is None:
        return _OFF
    return _Open(_record, name, ids)


@contextlib.contextmanager
def recording() -> Iterator[Record]:
    """Record the spans opened in this block (on every thread); yields the
    record, complete when the block ends."""
    global _record
    if _record is not None:
        raise RuntimeError("spans are already being recorded")
    _record = rec = Record()
    try:
        yield rec
    finally:
        _record = None


def _chrome_events(record: Record, base_ns: int = 0) -> List[dict]:
    """The record's closed spans as Chrome-trace complete ("X") events,
    on a timeline that starts at `base_ns` (the profiler's
    ``baseTimeNanoseconds``)."""
    pid = os.getpid()
    return [{"ph": "X", "cat": "program_span", "name": s.name,
             "pid": pid, "tid": s.thread,
             "ts": (s.start - base_ns) / 1e3,
             "dur": (s.end - s.start) / 1e3, "args": dict(s.ids)}
            for s in record.spans if s.end is not None]


@contextlib.contextmanager
def trace(out_dir: str | Path, enabled: bool = True) -> Iterator[None]:
    """torch.profiler around a code block (the card's activity where there
    is a card, else the host's ops) with the program's spans recorded;
    both exported as one Chrome trace to ``<out_dir>/trace.json``."""
    if not enabled:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    activity = (ProfilerActivity.CUDA if torch.cuda.is_available()
                else ProfilerActivity.CPU)
    with recording() as rec, profile(activities=[activity]) as prof:
        yield
    path = out_dir / "trace.json"
    prof.export_chrome_trace(str(path))
    data = json.loads(path.read_text())
    data["traceEvents"] += _chrome_events(
        rec, int(data.get("baseTimeNanoseconds", 0)))
    path.write_text(json.dumps(data))
