#!/usr/bin/env python3
"""Where two RT-DETR-L model ranks part in the forward, on one card.

    python3 tools/tp_determinism.py [--launches N] [--variants a,b,...]

Starts N pairs of processes (gloo on the one card, ``mesh.model=2``, as
chip_smoke.py phase 29 does) for each variant; each rank runs phase 29's
first bf16 RT-DETR-L train step (chip_smoke.parallel_steps, 512 px, the
same seeded weights and batch) with a forward hook on every top-level
module of the model, and keeps a SHA-256 of each module's output. Prints,
for every pair, the first module whose output differs between the two
ranks, and the distinct outcomes of each module over all ranks of the
variant. Variants: "default", the port as it is (its attention on
models/rtdetr.SDPA_BACKENDS: flash, memory-efficient, math); "cudnn":
cuDNN's scaled_dot_product_attention allowed too, PyTorch's own default;
"cublas": "cudnn" with the worker started with
CUBLAS_WORKSPACE_CONFIG=:4096:8.
"""

import argparse
import os
import socket
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

WORKER = r"""
import sys
import torch
import torch.distributed as dist
root, rank, port, work, variant, tag = sys.argv[1:7]
sys.path.insert(0, root)
import chip_smoke as C
from robust_object_detection_tpu_torch import kernels
from robust_object_detection_tpu_torch.core.config import MeshConfig
from robust_object_detection_tpu_torch.parallel import mesh as M
kernels.load()
dev = torch.device("cuda", 0)
torch.cuda.set_device(dev)
if variant in ("cudnn", "cublas"):
    from torch.nn.attention import SDPBackend
    from robust_object_detection_tpu_torch.models import rtdetr as R
    R.SDPA_BACKENDS = [SDPBackend.CUDNN_ATTENTION] + R.SDPA_BACKENDS
dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                        world_size=2, rank=int(rank))
d = torch.load(f"{work}/in.pt", weights_only=False)
mesh = M.make_mesh(MeshConfig(data=1, model=2))
record = []


def first_tensor(o):
    while not torch.is_tensor(o):
        o = next(iter(o.values())) if isinstance(o, dict) else o[0]
    return o


real = C.parallel_model


def hooked(*a, **k):
    model, opt, lib = real(*a, **k)
    for name, mod in model.model.named_children():
        mod.register_forward_hook(
            lambda m, i, o, name=name: record.append(
                (name, C.digest(first_tensor(o)))))
    return model, opt, lib


C.parallel_model = hooked
C.PAR_TIMED = 0
C.parallel_steps("rtdetr", dev, d["init"], d["batch"], mesh, "bfloat16",
                 steps=1)
torch.save({"record": record}, f"{work}/{tag}.rank{rank}.pt")
dist.destroy_process_group()
"""


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--launches", type=int, default=6)
    ap.add_argument("--variants", default="default,cudnn")
    args = ap.parse_args()
    import numpy as np
    import torch

    import chip_smoke as C
    from robust_object_detection_tpu_torch import kernels
    if not torch.cuda.is_available():
        print("FAIL: no CUDA card", file=sys.stderr)
        return 1
    kernels.build()
    dev = torch.device("cuda", 0)
    b, size = C.PAR_SHAPES["rtdetr"]
    images, gb, gc = C.detection_batch(np.random.RandomState(C.SEED + 62),
                                       b, size, 40, 64)
    init = {n: v.detach().cpu().clone() for n, v in
            C.parallel_model("rtdetr", dev)[0].state_dict().items()}
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as work:
        torch.save({"init": init, "batch": tuple(
            torch.from_numpy(a) for a in (images, gb, gc))},
            f"{work}/in.pt")
        for variant in args.variants.split(","):
            env = dict(os.environ, OMP_NUM_THREADS="1")
            if variant == "cublas":
                env["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
            outcomes = {}
            parted = 0
            for n in range(args.launches):
                tag = f"{variant}{n}"
                port = free_port()
                procs = [subprocess.Popen(
                    [sys.executable, "-c", WORKER, str(ROOT), str(r),
                     str(port), work, variant, tag], env=env,
                    stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                    text=True) for r in range(2)]
                errs = [p.communicate(timeout=600)[1] for p in procs]
                if any(p.returncode for p in procs):
                    print(f"FAIL: {variant} launch {n}: "
                          + " | ".join(e[-1500:] for e in errs))
                    return 1
                recs = [torch.load(f"{work}/{tag}.rank{r}.pt")["record"]
                        for r in range(2)]
                first = next((a[0] for a, b_ in zip(*recs) if a != b_),
                             None)
                parted += first is not None
                for rec in recs:
                    for name, h in rec:
                        outcomes.setdefault(name, set()).add(h)
                print(f"[tp-determinism] {variant} launch {n}: "
                      f"{len(recs[0])} module outputs a rank; first that "
                      f"differs between the ranks: {first}", flush=True)
            many = {k: len(v) for k, v in outcomes.items() if len(v) > 1}
            print(f"[tp-determinism] {variant}: {parted} of "
                  f"{args.launches} pairs part; modules with more than one "
                  f"output over the {2 * args.launches} ranks: {many}",
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
