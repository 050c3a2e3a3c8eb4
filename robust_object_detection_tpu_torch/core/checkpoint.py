"""Checkpoints with restore-and-continue (counterpart of
robust_object_detection_tpu/core/checkpoint.py).

The reference keeps its checkpoints with orbax; the port keeps the same
layout under ``<out_dir>/ckpt`` with ``torch.save``:

  * ``last/<step>`` — the rolling checkpoints, the newest ``max_to_keep``,
  * ``best`` and ``best_meta.json`` (``{"step", "metric"}``) — the best
    checkpoint by a metric.

A state is anything ``torch.load(weights_only=True)`` reads back: nested
dicts and lists of tensors and numbers (a ``state_dict``, an optimizer's
``state_dict``). Every file is written to a temporary name and moved into
place with ``os.replace``, so a write cut short leaves the previous
checkpoint readable. Orbax checkpoints are not read: JAX weights come
across through ``models/convert.py``.

:func:`load_weights` reads a pretrained weights file (the counterpart of
the reference's ``models/pretrained.load_checkpoint_state``): a plain
``state_dict``, one under ``"ema"`` / ``"model"``, or, with
``allow_pickle=True`` only, a pickled ``nn.Module`` (an Ultralytics
``.pt``).
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Any, Dict, Mapping, Optional

import torch

from . import artifacts


def _atomic_save(obj: Any, path: Path) -> None:
    """torch.save to `path` through a temporary file and os.replace."""
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(path.name + ".tmp")
    try:
        torch.save(obj, tmp)
        os.replace(tmp, path)
    finally:
        tmp.unlink(missing_ok=True)


def _load(path: Path, map_location) -> Any:
    return torch.load(path, map_location=map_location, weights_only=True)


def load_weights(path: str | Path, allow_pickle: bool = False
                 ) -> Mapping[str, torch.Tensor]:
    """A pretrained weights file -> its state_dict, on the CPU.

    The file is read with ``weights_only=True``. One that cannot be read so
    (an Ultralytics ``.pt`` pickles the whole ``nn.Module``) raises a
    ValueError naming ``allow_pickle``, unless `allow_pickle` is True: then
    it is read again with ``weights_only=False``, which runs the pickle's
    code, so set it only for files you trust. The payload under ``"ema"``,
    else ``"model"``, is taken where there is one, and an ``nn.Module`` is
    turned into its ``.float().state_dict()``."""
    try:
        obj = torch.load(path, map_location="cpu", weights_only=True)
    except Exception as e:
        if not allow_pickle:
            raise ValueError(
                f"{path} is not a plain-tensor checkpoint (Ultralytics .pt "
                f"files pickle the whole nn.Module). Re-load with "
                f"allow_pickle=True if the file is trusted, or export its "
                f"state_dict first.") from e
        obj = torch.load(path, map_location="cpu", weights_only=False)
    for key in ("ema", "model"):
        if isinstance(obj, Mapping) and obj.get(key) is not None:
            obj = obj[key]
            break
    if isinstance(obj, torch.nn.Module):
        obj = obj.float().state_dict()
    return obj


class CheckpointManager:
    """Keeps ``last`` (rolling) and ``best`` (by metric)."""

    def __init__(self, out_dir: str | Path, max_to_keep: int = 2):
        self.root = Path(out_dir).absolute() / "ckpt"
        self.root.mkdir(parents=True, exist_ok=True)
        self._last_dir = self.root / "last"
        self._best = self.root / "best"
        self._best_meta = self.root / "best_meta.json"
        self.max_to_keep = max_to_keep

    # ── rolling `last` ──────────────────────────────────────────────
    def _steps(self):
        if not self._last_dir.exists():
            return []
        return sorted(int(p.name) for p in self._last_dir.iterdir()
                      if p.name.isdigit())

    def save_last(self, step: int, state: Any,
                  extra: Optional[Dict[str, Any]] = None) -> None:
        """Write ``last/<step>`` (replacing one of the same step), then
        drop the oldest beyond ``max_to_keep``."""
        payload = {"state": state}
        if extra:
            payload["extra"] = extra
        _atomic_save(payload, self._last_dir / str(step))
        steps = self._steps()
        for old in steps[:max(0, len(steps) - self.max_to_keep)]:
            (self._last_dir / str(old)).unlink(missing_ok=True)

    def latest_step(self) -> Optional[int]:
        steps = self._steps()
        return steps[-1] if steps else None

    def restore_last(self, map_location=None) -> Optional[Dict[str, Any]]:
        """{"state", "step"[, "extra"]} of the newest rolling checkpoint,
        or None when there is none."""
        step = self.latest_step()
        if step is None:
            return None
        restored = _load(self._last_dir / str(step), map_location)
        restored["step"] = step
        return restored

    # ── `best` by metric ────────────────────────────────────────────
    def save_best(self, step: int, state: Any, metric: float,
                  mode: str = "max") -> bool:
        """Write ``best`` if `metric` beats the recorded one (`mode` "max"
        or "min"); returns whether it did."""
        prev = self.best_metric()
        improved = (prev is None or
                    (metric > prev if mode == "max" else metric < prev))
        if not improved:
            return False
        _atomic_save({"state": state}, self._best)
        artifacts.write_json(self._best_meta,
                             {"step": step, "metric": metric})
        return True

    def best_metric(self) -> Optional[float]:
        if not self._best_meta.exists():
            return None
        return artifacts.read_json(self._best_meta)["metric"]

    def restore_best(self, map_location=None) -> Optional[Any]:
        if not self._best.exists():
            return None
        return _load(self._best, map_location)["state"]

    def close(self) -> None:
        """Nothing is held open; kept for the reference's interface."""
