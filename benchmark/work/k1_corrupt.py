"""K1, the Augmented step's corruption (csrc/corrupt.cu), as a function: an
f32 (B, H, W, C) batch in [0, 255] read once, written once; its
arithmetic (a k-tap blur, a 2-axis FIR, a hash and Box-Muller) is far
below the bytes' time. Frozen from chip_smoke.py's K1 row (commit
bdbb134): the bytes bound."""

from benchmark.harness.peaks import bound_ms as _bound, work


def group(call: dict) -> str:
    return "K1 corrupt"


def bound_ms(call: dict) -> float:
    b, h, w, c = call["batch"], call["h"], call["w"], call["c"]
    return _bound(work("float32", 2 * b * h * w * c * 4, 0.0))
