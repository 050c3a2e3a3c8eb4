"""What the process that prints a result may not have loaded: JAX, its
libraries and the JAX package, compared by whole top-level module names
(the program's package name begins with the JAX package's)."""

from __future__ import annotations

import sys
from typing import List

FORBIDDEN = ("jax", "jaxlib", "flax", "robust_object_detection_tpu")


def forbidden_loaded(modules=None) -> List[str]:
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))
