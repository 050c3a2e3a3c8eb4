#!/usr/bin/env python3
"""Run named phases of chip_smoke.py on the card, in order, after building
the kernels; nothing is caught, so a failed check exits 1.

    python3 tools/smoke_phases.py phase_cli [phase_unet_training ...]

Used to run one phase alone, and by tools/smoke_mutants.sh to run the
phase that holds a mutation.
"""

import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

import chip_smoke  # noqa: E402
from robust_object_detection_tpu_torch import kernels  # noqa: E402


def main(names) -> int:
    if not torch.cuda.is_available():
        print("FAIL: no CUDA card", file=sys.stderr)
        return 1
    kernels.build()
    kernels.load()
    dev = torch.device("cuda", 0)
    for name in names:
        t0 = time.perf_counter()
        getattr(chip_smoke, name)(dev)
        print(f"[{name}] passed in {time.perf_counter() - t0} s",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
