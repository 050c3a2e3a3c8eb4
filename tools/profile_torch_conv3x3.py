#!/usr/bin/env python3
"""Times of K3 (the 3x3 conv kernels) on one CUDA card, with what the
compiler made of them.

    python3 tools/profile_torch_conv3x3.py [--root DIR]

At the model paths' shapes (seeded random inputs as in chip_smoke.py):

  1. CUDA-event medians (10 calls after 3 warm-ups) of K3-f
     (``conv3x3``) at (8, 256, 256, 48) -> 48 and of K3-b
     (``conv3x3_wgrad``) at (16, 256, 256, 48) and (8, 256, 256, 48), bf16
     and f32, with the one library call beside each (``F.conv2d``,
     ``torch.nn.grad.conv2d_weight``, PyTorch's default flags, and for f32
     also with cuDNN's TF32 off: the default runs f32 convs in one-pass
     TF32), and the host's time to enqueue one call (100 calls, no
     synchronize);
  2. under torch.profiler, the device time by kernel of 10 calls of each
     (K3-b's main kernel and its ordered chunk sum apart);
  3. ptxas's registers and spills (when this process built the library) and
     an opcode count of the SASS (cuobjdump -sass) of every kernel whose
     name holds ``conv3x3`` or ``wgrad``: tensor-core (HMMA, and of them
     TF32), shared loads (LDS, LDSM), global loads (LDG) and async copies
     (LDGSTS), FFMA, and the split's FADD / LOP3 / SEL.

--root names another checkout whose port package is measured instead of
this one's (its kernels are built there), so that two trees can be timed
in one call on one card. Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as S  # noqa: E402  (time_ms, device_ms_by_kernel, ...)

OPS = ("HMMA", "HMMA.1688.F32.TF32", "HGMMA", "LDSM", "LDS", "LDG",
       "LDGSTS", "STS", "FFMA", "FADD", "LOP3", "SEL", "BAR")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", type=Path, default=ROOT,
                    help="checkout whose port package is measured")
    args = ap.parse_args()
    sys.path.insert(0, str(args.root.resolve()))

    import torch
    import torch.nn.functional as F

    from robust_object_detection_tpu_torch import kernels
    from robust_object_detection_tpu_torch.ops import conv3x3 as C

    if not torch.cuda.is_available():
        print("FAIL: needs a CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    print(S.run_cmd(["nvidia-smi", "--query-gpu=name,power.limit",
                     "--format=csv,noheader"]))
    print(f"[conv3x3] package {Path(C.__file__).resolve().parents[1]}")
    so = kernels.build()
    kernels.load()

    def host_us(fn, calls=100):
        """Host microseconds to enqueue one call (the wrapper's own cost
        while the card keeps up)."""
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        return (t1 - t0) / calls * 1e6

    def tf32_off(fn, dtype):
        """For f32, the library call's events ms with cuDNN's TF32 off
        (cudnn.flags(allow_tf32=False) alone would switch cuDNN off)."""
        if dtype != torch.float32:
            return ""
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
            return f" (default flags: cuDNN's TF32 on), {S.time_ms(fn)} ms " \
                f"with cuDNN's TF32 off"

    g = torch.Generator(dev).manual_seed(S.SEED)
    k = torch.randn(3, 3, 48, 48, device=dev, generator=g) * 0.1
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).split(".")[-1]
        x = torch.randn(S.BATCH, 256, 256, 48, device=dev,
                        generator=g).to(dtype)
        kd = k.to(dtype)
        xv, kv = x.permute(0, 3, 1, 2), kd.permute(3, 2, 0, 1)
        ms = S.time_ms(lambda: C.conv3x3(x, kd))
        lib = S.time_ms(lambda: F.conv2d(xv, kv, padding=1))
        off = tf32_off(lambda: F.conv2d(xv, kv, padding=1), dtype)
        print(f"[conv3x3] K3-f {name} (8, 256, 256, 48) -> 48: kernel {ms} "
              f"ms; F.conv2d {lib} ms{off}; enqueue "
              f"{host_us(lambda: C.conv3x3(x, kd))} us a call")
        for kms, n, key in S.device_ms_by_kernel(lambda: C.conv3x3(x, kd)):
            print(f"    {kms:9.4f}  x{n}  {key[:110]}")
        for batch in (S.TRAIN_BATCH, S.RTDETR_TRAIN_BATCH):
            xb = torch.randn(batch, 256, 256, 48, device=dev,
                             generator=g).to(dtype)
            dy = torch.randn(batch, 256, 256, 48, device=dev,
                             generator=g).to(dtype)
            xv, dyv = xb.permute(0, 3, 1, 2), dy.permute(0, 3, 1, 2)
            ms = S.time_ms(lambda: C.conv3x3_wgrad(xb, dy))
            lib = S.time_ms(lambda: torch.nn.grad.conv2d_weight(
                xv, (48, 48, 3, 3), dyv, padding=1))
            off = tf32_off(lambda: torch.nn.grad.conv2d_weight(
                xv, (48, 48, 3, 3), dyv, padding=1), dtype)
            print(f"[conv3x3] K3-b {name} ({batch}, 256, 256, 48) -> 48: "
                  f"kernel {ms} ms; conv2d_weight {lib} ms{off}; enqueue "
                  f"{host_us(lambda: C.conv3x3_wgrad(xb, dy))} us a call")
            if dtype == torch.float32 or batch == S.TRAIN_BATCH:
                for kms, n, key in S.device_ms_by_kernel(
                        lambda: C.conv3x3_wgrad(xb, dy)):
                    print(f"    {kms:9.4f}  x{n}  {key[:110]}")
            del xb, dy
        del x

    def k3(fn):
        return "conv3x3" in fn or "wgrad" in fn

    log = kernels.build_log()
    if not log:
        print("[conv3x3] library built by an earlier process: no ptxas "
              "output")
    for fn, line in S.ptxas_report(log):
        if k3(fn):
            print(f"[ptxas] {fn}: {line}")
    sass = S.sass_opcodes(so, ("conv3x3", "wgrad"))
    for fn, ops in sorted(sass.items()):
        counts = " ".join(f"{op} {ops.get(op, 0)}" for op in OPS)
        print(f"[sass] {fn}: {sum(ops.values())} instructions; {counts}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
