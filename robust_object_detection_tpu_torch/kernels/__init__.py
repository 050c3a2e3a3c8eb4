"""Build and load the hand-written CUDA kernels of ``csrc/``.

Every ``csrc/*.cu`` file is compiled by ``nvcc`` for ``sm_90a`` (one
process per file, all started together) and linked into ONE shared
library with a plain C interface, loaded with ``ctypes``. The build
happens at first use, from the sources in this checkout only, into
``_build/`` (listed in ``.gitignore``), keyed by a hash of the sources so a
fresh checkout or an edited kernel rebuilds and an unchanged one does not.

Nothing here touches CUDA or runs ``nvcc`` when the module is imported: the
CPU tests import every module of the package.

Each C entry point returns the ``cudaError_t`` of its launches (0 = ok);
:func:`check` turns a non-zero code into an exception.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List, Optional

PKG_ROOT = Path(__file__).resolve().parent.parent
CSRC = PKG_ROOT / "csrc"
BUILD_DIR = PKG_ROOT / "_build"

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v"]

# dtype codes and the conv output tile side, shared with csrc/conv_tile.cuh
DTYPE_F32, DTYPE_BF16 = 0, 1
TILE = 16

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# argument lists of the C entry points (pointers and the stream as void*,
# or ctypes would pass them as 32-bit ints)
SIGNATURES: Dict[str, List] = {
    # x, w, y, B, H, W, Cin, Cout, dtype, stream
    "conv3x3_nhwc": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    # x, dy, part (scratch), dk, B, H, W, Cin, Cout, n_chunks, dtype, stream
    "conv3x3_wgrad_nhwc": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    # x, k1, g1, b1, k2, a1 (scratch), y2, B, H, W, C1, C2, dtype, stream
    "yolo_front_nhwc": [_P, _P, _P, _P, _P, _P, _P,
                        _I, _I, _I, _I, _I, _I, _P],
    # x, k1, sc1, bi1, k2, y1, y2, stats1, stats2 (scratch), mean1, var1,
    # g1, b1, mean2, var2, B, H, W, C1, C2, dtype, stream
    "yolo_front_train_nhwc": [_P] * 15 + [_I] * 6 + [_P],
    # x, k2, y1, y2, dy2, sc1, mean1, var1, g1, b1, mean2, dmean1, dvar1,
    # dmean2, dvar2, dy1, gpart, wpart, vecs (scratch), dk1, dk2, dsc1,
    # dbi1, B, H, W, C1, C2, chunks1, chunks2, dtype, stream
    "yolo_front_bwd_nhwc": [_P] * 23 + [_I] * 8 + [_P],
    # x, y, choice, seeds, B, H, W, C, sigma, blur_k, inv_k, stream
    "corrupt_nhwc": [_P, _P, _P, _P, _I, _I, _I, _I, _F, _I, _F, _P],
    # x, k1, g1, b1, k2a, g2a, b2a, k2b, g2b, b2b, k3, a1, a2a, cat
    # (scratch), y3, B, H, W, dtype, stream
    "hgstem_nhwc": [_P] * 15 + [_I] * 4 + [_P],
    # x, k1, sc1, bi1, k2a, sc2a, bi2a, k2b, sc2b, bi2b, k3, y1, y2a, y2b,
    # cat, y3, stats (scratch), vecs (14 x 32 f32 out), B, H, W, dtype, stream
    "hgstem_train_nhwc": [_P] * 18 + [_I] * 4 + [_P],
    # x, y1, y2a, y2b, cat, y3, k2a, k2b, k3, sc1, sc2a, sc2b, fvecs, dy3,
    # dstat, dcat, da1p, dy2b, dy2a, dy1, gpart, wpart, work (scratch), dk1,
    # dk2a9, dk2b9, dk3, dvec, B, H, W, chunks x 4, dtype, stream
    "hgstem_bwd_nhwc": [_P] * 28 + [_I] * 8 + [_P],
    # values, loc, attn, out, levels (host int[3 L]: H, W, start), B, HW, Q,
    # NH, DH, L, P, dtype, stream
    "ms_deform_attn_fwd": [_P] * 5 + [_I] * 8 + [_P],
    # values, loc, attn, dout, dv (f32, zeroed), dloc, dattn, levels, B, HW,
    # Q, NH, DH, L, P, dtype, stream
    "ms_deform_attn_bwd": [_P] * 8 + [_I] * 8 + [_P],
    # value (B, M, Q), valid, owner, capped, B, Q, M, eps, max_rounds,
    # complete_greedy, stream
    "auction_assign": [_P] * 4 + [_I] * 3 + [_F, _I, _I, _P],
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_log = ""


def sources() -> List[Path]:
    return sorted(list(CSRC.glob("*.cu")) + list(CSRC.glob("*.cuh")))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def nvcc_path() -> str:
    cands = [Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin"
             / "nvcc"]
    found = shutil.which("nvcc")
    if found:
        cands.append(Path(found))
    for c in cands:
        if c.is_file():
            return str(c)
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the CUDA kernels are built from csrc/ at first use")


def build() -> Path:
    """Compile csrc/*.cu into _build/libkernels_<hash>.so unless present:
    one nvcc per source, all started together, then one link."""
    global _build_log
    so = BUILD_DIR / f"libkernels_{source_hash()}.so"
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    tag = f"{so.stem}.{os.getpid()}"
    compile_flags = [f for f in NVCC_FLAGS if f != "-shared"]
    jobs = []
    for cu in (p for p in sources() if p.suffix == ".cu"):
        obj = BUILD_DIR / f"{cu.stem}.{tag}.o"
        cmd = [nvcc, *compile_flags, "-c", "-I", str(CSRC), "-o", str(obj),
               str(cu)]
        jobs.append((obj, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                           stderr=subprocess.STDOUT,
                                           text=True)))
    logs, failed = [], False
    for obj, proc in jobs:
        try:
            out, _ = proc.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            proc.kill()
            out, _ = proc.communicate()
        logs.append(out)
        failed |= proc.returncode != 0
    tmp = so.with_name(so.name + f".{os.getpid()}.tmp")
    if not failed:
        res = subprocess.run([nvcc, *NVCC_FLAGS, "-o", str(tmp),
                              *(str(o) for o, _ in jobs)],
                             capture_output=True, text=True, timeout=600)
        logs.append(res.stdout + res.stderr)
        failed = res.returncode != 0
    for obj, _ in jobs:
        obj.unlink(missing_ok=True)
    _build_log = "".join(logs)
    if failed:
        raise RuntimeError(f"nvcc failed:\n{_build_log}")
    os.replace(tmp, so)
    return so


def build_log() -> str:
    """nvcc's output (including -Xptxas=-v register/smem lines) of the
    build this process ran; empty when the library was already built."""
    return _build_log


def load() -> ctypes.CDLL:
    """The kernel library, built on first call. Raises if it cannot be."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, args in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = args
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib


def check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {err}")


def dtype_code(dtype) -> int:
    import torch
    codes = {torch.float32: DTYPE_F32, torch.bfloat16: DTYPE_BF16}
    if dtype not in codes:
        raise ValueError(f"kernels take float32 or bfloat16, got {dtype}")
    return codes[dtype]


def stream_ptr(device) -> int:
    import torch
    return torch.cuda.current_stream(device).cuda_stream


def tile_count(h: int, w: int) -> int:
    """TILE x TILE output tiles of an h x w conv output (conv_tile.cuh)."""
    return -(-h // TILE) * -(-w // TILE)


def wgrad_chunks(cin: int, cout: int) -> int:
    """Pixel chunks of a weight-gradient launch (conv_wgrad.cuh): enough
    blocks (chunks x 16-wide channel tiles) to fill the card's SMs a few
    times. Fixed for a shape, so a repeated run sums in the same order."""
    return max(1, -(-512 // (-(-cin // 16) * -(-cout // 16))))
