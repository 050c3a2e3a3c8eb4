"""Corruption parameters (counterpart of robust_object_detection_tpu.core.config).

The reference's ``core`` package imports jax on import, so the port keeps
its own copy of the one dataclass the eval path needs. Fields and defaults
must stay identical to the reference's ``CorruptionConfig``: training-time
corruption and testset generation share these values byte for byte.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class CorruptionConfig:
    noise_sigma: float = 15.0
    blur_kernel: int = 9
    blur_angle_deg: float = 0.0
    downscale_factor: float = 0.5
    # Probability that a training sample is corrupted at all.
    prob: float = 0.5
