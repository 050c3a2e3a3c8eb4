"""VisDrone class tables (the port's own copy of the tables of
robust_object_detection_tpu/data/visdrone.py that the scorer reads).

Only classes [1, 4, 5, 6, 9, 10] of the raw VisDrone ids are kept —
pedestrian, car, van, truck, bus, motor — remapped to contiguous ids (COCO
uses 1..6, YOLO 0..5). Annotation parsing is not ported yet.
"""

from __future__ import annotations

from typing import Tuple

# VisDrone raw category ids kept, in order (reference USED_CLASSES).
USED_CLASSES: Tuple[int, ...] = (1, 4, 5, 6, 9, 10)
CLASS_NAMES: Tuple[str, ...] = ("pedestrian", "car", "van", "truck", "bus",
                                "motor")
NUM_CLASSES = len(USED_CLASSES)
