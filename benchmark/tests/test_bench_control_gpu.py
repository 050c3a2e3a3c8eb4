"""The controls, on a card at each cell's own size: the plain reference,
computed in the precision below the one its configuration states (float8
e4m3 for bf16, bf16 for TF32), put in the program's place, must come out
not correct, on three seeds. Prints every reading (run with -s):

    python -m pytest -m gpu -s benchmark/tests/test_bench_control_gpu.py
"""

import time

import pytest
import torch

from benchmark import run
from benchmark.harness import manifest

SEEDS = (2147483901, 3221225473, 4294967291)


def cells():
    return [w["name"] for w in manifest.load_manifest()["workloads"]]


@pytest.mark.gpu
@pytest.mark.parametrize("cell", cells())
def test_control_fails_a_limit(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    c = manifest.find_cell(cell)
    limits = run.limits_of(cell)
    driver = manifest.load_plugin("drivers", c.traffic["driver"])
    family = manifest.load_plugin("families", c.config["family"])
    readings = []
    for seed in SEEDS:
        ctx = run.RunContext(c, seed, 0.0, False, torch.device("cuda", 0),
                             family, time.perf_counter())
        numbers = driver.control(ctx)
        print(f"[control] {cell} seed {seed}: {numbers} limits {limits}",
              flush=True)
        readings.append(numbers)
    for numbers in readings:
        assert any(v > limits[k] for k, v in numbers.items()), numbers
