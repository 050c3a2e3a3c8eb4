"""K3 (csrc/conv3x3.cu, conv3x3_wgrad.cu), a dense 3x3 stride-1 conv of C
channels to C at (B, H, W) in NHWC, as a function. Forward or dX: reads
the input and the filter, writes the output; wgrad: reads x and dy,
writes the filter gradient. 2 x 9 x C x C operations a pixel. As
chip_smoke.py's K3 rows (commit bdbb134)."""

from benchmark.harness.peaks import bound_ms as _bound, work


def group(call: dict) -> str:
    return "K3-b conv3x3_wgrad" if call["wgrad"] else "K3-f conv3x3"


def bound_ms(call: dict) -> float:
    b, h, w, c, elt = (call[k] for k in ("batch", "h", "w", "c", "elt"))
    act = b * h * w * c * elt
    flops = 2 * 9 * c * c * b * h * w
    if call["wgrad"]:
        return _bound(work(call["dtype"], 2 * act + 9 * c * c * 4, flops))
    return _bound(work(call["dtype"], 2 * act + 9 * c * c * elt, flops))
