"""The card's published peaks and the bound of a piece of work.

Frozen copies of ``chip_smoke.py``'s ``HBM_BYTES_PER_S``, ``PEAK_FLOPS``,
``PEAK_TF32``, ``work`` and ``bound`` (commit bdbb134). NVIDIA H100 SXM data
sheet, dense rates without sparsity, at the full power limit of 700 W.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_TF32 = 495e12  # dense TF32 on the tensor cores

# the rate of a product in each precision a configuration may state
PRECISION_PEAK = {"bfloat16": PEAK_FLOPS["bfloat16"], "tf32": PEAK_TF32,
                  "float32": PEAK_FLOPS["float32"]}


def work(dtype: str, nbytes: float, flops: float) -> dict:
    """The bound's inputs for one kernel run: the bytes it must move, its
    operations, and the peak of the type it computes in."""
    return dict(bytes=nbytes, flops=flops, peak=PEAK_FLOPS[dtype])


def bound_ms(w: dict) -> float:
    """The least time of a :func:`work` record: the larger of its bytes
    at the HBM rate and its operations at its peak."""
    return max(w["bytes"] / HBM_BYTES_PER_S, w["flops"] / w["peak"]) * 1e3
