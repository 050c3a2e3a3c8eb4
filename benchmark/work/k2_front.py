"""K2, the YOLOv8 P1/P2 front (csrc/yolo_front.cu, yolo_front_bwd.cu), as
a function: (B, S, S, 3) -> 3x3 s2 conv to C1, BN, SiLU -> 3x3 s2 conv to
C2. Forward: reads x and the filters, writes y2 (y1 / a1 stay inside);
backward: reads x, y1, y2 and dy2, dX of the second conv and both filter
gradients. A frozen copy of chip_smoke.py's ``front_work`` (commit
bdbb134) with the widths as arguments."""

from benchmark.harness.peaks import bound_ms as _bound, work


def group(call: dict) -> str:
    return "K2-b yolo_front_bwd" if call["backward"] else "K2-f yolo_front"


def bound_ms(call: dict) -> float:
    b, s, c1, c2, elt = (call[k] for k in ("batch", "size", "c1", "c2",
                                           "elt"))
    px1 = b * (s // 2) ** 2
    px2 = b * (s // 4) ** 2
    f1, f2 = 2 * 27 * c1 * px1, 2 * 9 * c1 * c2 * px2
    x_b, y1_b, y2_b = b * s * s * 3 * elt, px1 * c1 * elt, px2 * c2 * elt
    if call["backward"]:
        return _bound(work(call["dtype"], x_b + y1_b + 2 * y2_b,
                           2 * f2 + f1))
    return _bound(work(call["dtype"], x_b + y2_b + (27 * c1 + 9 * c1 * c2)
                       * elt, f1 + f2))
