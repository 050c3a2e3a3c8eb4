"""Artifact IO (counterpart of robust_object_detection_tpu/core/artifacts.py):
append-only jsonl history and JSON / CSV result tables, in the reference's
formats so the same downstream tooling reads both packages' runs.
"""

from __future__ import annotations

import csv
import json
import os
import time
from pathlib import Path
from typing import Any, Dict, Iterable, List, Mapping, Sequence


def append_jsonl(path: str | Path, record: Mapping[str, Any]) -> None:
    p = Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    with p.open("a", encoding="utf-8") as f:
        f.write(json.dumps(dict(record), ensure_ascii=False) + "\n")


def read_jsonl(path: str | Path) -> List[Dict[str, Any]]:
    p = Path(path)
    if not p.exists():
        return []
    return [json.loads(line) for line in p.read_text().splitlines()
            if line.strip()]


def write_json(path: str | Path, obj: Any) -> None:
    """Atomic JSON write (temp file + os.replace): a reader after a kill
    sees the old file or the new one, never a truncated one."""
    p = Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    tmp = p.with_name(p.name + ".tmp")
    tmp.write_text(json.dumps(obj, indent=2, ensure_ascii=False),
                   encoding="utf-8")
    os.replace(tmp, p)


def read_json(path: str | Path) -> Any:
    return json.loads(Path(path).read_text(encoding="utf-8"))


def write_csv(path: str | Path, rows: Sequence[Mapping[str, Any]],
              fieldnames: Sequence[str] | None = None) -> None:
    p = Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    if not rows:
        p.write_text("")
        return
    if fieldnames is None:
        fieldnames = list(rows[0].keys())
    with p.open("w", newline="", encoding="utf-8") as f:
        w = csv.DictWriter(f, fieldnames=fieldnames)
        w.writeheader()
        for r in rows:
            w.writerow({k: r.get(k, "") for k in fieldnames})


class HistoryLogger:
    """Per-run history: one jsonl record per call, with the whole seconds
    since the logger was made as ``elapsed_sec`` unless the record has
    one."""

    def __init__(self, out_dir: str | Path, filename: str = "history.jsonl"):
        self.path = Path(out_dir) / filename
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._t0 = time.time()

    def log(self, **record: Any) -> Dict[str, Any]:
        record.setdefault("elapsed_sec", int(time.time() - self._t0))
        append_jsonl(self.path, record)
        return record


def format_table(headers: Sequence[str], rows: Iterable[Sequence[Any]],
                 floatfmt: str = "{:.4f}") -> str:
    """Plain-text aligned table for stdout summaries."""
    srows = [[floatfmt.format(v) if isinstance(v, float) else str(v)
              for v in row] for row in rows]
    widths = [max(len(h), *(len(r[i]) for r in srows)) if srows else len(h)
              for i, h in enumerate(headers)]

    def fmt(cells):
        return "  ".join(c.ljust(w) for c, w in zip(cells, widths))
    lines = [fmt(headers), fmt(["-" * w for w in widths])]
    lines += [fmt(r) for r in srows]
    return "\n".join(lines)
