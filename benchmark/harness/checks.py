"""The numbers that decide ``correct``: each one a gap between what the
timed path produced and what the plain reference computes from the same
inputs, held against a limit of its own (``benchmark/limits/<cell>.json``).
"""

from __future__ import annotations

import math
import statistics
from typing import Dict, Sequence


def loss_gap(prog: Sequence[float], ref: Sequence[float]) -> float:
    """The largest relative gap of a step's loss."""
    return max(abs(p - r) / max(abs(r), 1e-12) for p, r in zip(prog, ref))


def leaf_norms(tensors: Dict[str, "torch.Tensor"]) -> Dict[str, float]:
    return {n: float(t.double().norm()) for n, t in tensors.items()}


def leaf_gaps(prog: Dict[str, float], ref: Dict[str, float]):
    """[(leaf, gap)] of every leaf, the largest first: |norm of the
    program's leaf - norm of the reference's| over the larger of the
    reference's norm of that leaf and of the median leaf (a leaf the
    program lacks reads 1)."""
    median = statistics.median(ref.values())
    gaps = [(n, abs(prog.get(n, 0.0) - r) / max(r, median, 1e-30))
            for n, r in ref.items()]
    return sorted(gaps, key=lambda g: -g[1])


def bn_stat_gaps(prog: Dict[str, "torch.Tensor"],
                 ref: Dict[str, "torch.Tensor"]):
    """[(gap, layer)] of every BatchNorm layer whose batch statistics both
    hold (``<layer>.running_mean`` / ``running_var`` keys): the larger of
    the norms of the means' and of the standard deviations' differences,
    over the norm of the reference's standard deviation."""
    out = []
    for key in ref:
        if not key.endswith(".running_var"):
            continue
        layer = key[:-len(".running_var")]
        rm, rv, pm, pv = (d[f"{layer}.running_{k}"].double().cpu()
                          for d in (ref, prog) for k in ("mean", "var"))
        rs, ps = rv.clamp(min=0).sqrt(), pv.clamp(min=0).sqrt()
        gap = max(float((pm - rm).norm()), float((ps - rs).norm()))
        out.append((gap / max(float(rs.norm()), 1e-30), layer))
    return out


def moved_leaves(ref_grad: Dict[str, float], share: float = 1e-3):
    """The leaves whose reference gradient is above `share` of the median
    leaf's; the others move by round-off alone and are left out of the
    change."""
    median = statistics.median(ref_grad.values())
    return [n for n, g in ref_grad.items() if g > share * median]


def selection_gap(ref, prog, canvas: int) -> float:
    """The largest gap between two sets of fixed-capacity detections
    (boxes (B, K, 4), scores, classes, valid), slot by slot: max(score gap,
    largest corner gap / canvas), 1 for a slot whose class or validity
    differs."""
    import torch

    rb, rs, rc, rv = ref
    pb, ps, pc, pv = prog
    if (rv != pv).any() or (rc[rv] != pc[pv].to(rc.dtype)).any():
        return 1.0
    if not rv.any():
        return 0.0
    return float(torch.maximum((rs[rv] - ps[pv]).abs(),
                               (rb[rv] - pb[pv]).abs().amax(-1) / canvas
                               ).max())


def result_checks(values: Dict[str, float], limits: Dict[str, float]
                  ) -> Dict[str, dict]:
    """{name: {"value", "limit"}} for every number with a limit (a value
    that is not finite reads 1e300, above any limit, and stays valid
    JSON); a number without one is an error of the benchmark."""
    missing = [k for k in values if k not in limits]
    if missing:
        raise KeyError(f"no limit for {missing}")
    return {k: {"value": v if math.isfinite(v) else 1e300,
                "limit": limits[k]} for k, v in values.items()}


def passed(checks: Dict[str, dict]) -> bool:
    return all(c["value"] <= c["limit"] for c in checks.values())
