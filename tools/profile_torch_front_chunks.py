#!/usr/bin/env python3
"""K2-b's f32 error against the length of its tensor-core accumulation
chains, on one CUDA card.

    python3 tools/profile_torch_front_chunks.py [--per-sm 1 2 4 8 16]

At the train path's shape, (16, 1024, 1024, 3) -> 48 -> 96, with seeded
inputs and cotangents drawn as chip_smoke.py's phase_train_kernels draws
the front's (the same distributions, not the same values): K2-b's
f32 gradients (dk1, dsc1, dbi1, dk2) against the plain version's
(autograd of front_fused_reference, cuDNN's TF32 off), as max abs error
over max|ref|, and the device ms of each K2-b kernel, with the blocks an
SM of dk2's and dk1's pixel chunks (kernels.FRONT_ROUTES['float32']
['per_sm']) set to each value in turn. A block sums its chunk's pixels in
one accumulation chain on the tensor cores; the chunks are added in a
fixed order by plain f32 adds.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as S  # noqa: E402  (SEED, device_ms_by_kernel)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--per-sm", type=int, nargs="+", default=[1, 2, 4, 8,
                                                                16])
    args = ap.parse_args()

    import torch

    from robust_object_detection_tpu_torch import kernels
    from robust_object_detection_tpu_torch.ops import yolo_front as TF

    if not torch.cuda.is_available():
        print("FAIL: needs a CUDA card", file=sys.stderr)
        return 1
    print(S.run_cmd(["nvidia-smi", "--query-gpu=name,power.limit",
                     "--format=csv,noheader"]))
    kernels.build()
    kernels.load()
    dev = torch.device("cuda", 0)
    g = torch.Generator(dev).manual_seed(S.SEED + 1)
    b, size = S.TRAIN_BATCH, S.IMG_SIZE
    x = torch.rand(b, size, size, 3, device=dev, generator=g)
    params = (torch.randn(3, 3, 3, 48, device=dev, generator=g) * 0.2,
              torch.rand(48, device=dev, generator=g) + 0.5,
              torch.randn(48, device=dev, generator=g) * 0.1,
              torch.randn(3, 3, 48, 96, device=dev, generator=g) * 0.1)
    cots = (torch.randn(b, size // 4, size // 4, 96, device=dev,
                        generator=g),
            *(torch.randn(c, device=dev, generator=g) * 0.1
              for c in (48, 48, 96, 96)))
    rparams = [t.clone().requires_grad_() for t in params]
    with torch.backends.cudnn.flags(allow_tf32=False):
        ref = torch.autograd.grad(TF.front_fused_reference(x, *rparams),
                                  rparams, cots)
    kparams = [t.clone().requires_grad_() for t in params]
    out = TF.front_fused(x, *kparams)       # keeps the saved tensors alive
    saved = out[0].grad_fn.saved_tensors
    per_sm = kernels.FRONT_ROUTES["float32"]["per_sm"]
    default = dict(per_sm)
    for n in args.per_sm:
        per_sm["dk2"] = per_sm["dk1"] = n
        grads = TF.front_fused_backward(*saved, *cots)
        errs = {k: (o - r).abs().max().item() / r.abs().max().item()
                for k, o, r in zip(("dk1", "dsc1", "dbi1", "dk2"), grads,
                                   ref)}
        rows = S.device_ms_by_kernel(
            lambda: TF.front_fused_backward(*saved, *cots))
        ms = {S.short_kernel_name(k): m for m, _, k in rows
              if "ftf::" in k or "sum_chunks" in k}
        print(f"[chunks] dk2 / dk1 blocks an SM {n}: error / max|ref| "
              f"{errs}; device ms {ms}", flush=True)
    per_sm.update(default)
    return 0


if __name__ == "__main__":
    sys.exit(main())
