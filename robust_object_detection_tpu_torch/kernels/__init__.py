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
import functools
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
    # x, w, y (f32), B, H, W, Cin, Cout, dtype, stream
    "conv3x3_nhwc": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    # x, w, y (bf16), B, H, W, Cin, Cout, nt, vec, blocks, stream (the plan
    # of conv3x3_tc_plan)
    "conv3x3_tc_nhwc": [_P, _P, _P] + [_I] * 8 + [_P],
    # x, dy, part (scratch), dk, B, H, W, Cin, Cout, n_chunks, dtype, stream
    "conv3x3_wgrad_nhwc": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    # x, dy (bf16), part (scratch), dk, B, H, W, Cin, Cout, mt, nt, vec,
    # n_chunks, stream (the plan of wgrad_tc_plan)
    "conv3x3_wgrad_tc_nhwc": [_P] * 4 + [_I] * 9 + [_P],
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
    # the bf16 front (csrc/front_tc.cuh) with the plan of front_plan: the
    # arguments of yolo_front_nhwc without dtype, + blocks1, blocks2, vec1,
    # vec2
    "yolo_front_tc_nhwc": [_P] * 7 + [_I] * 9 + [_P],
    # yolo_front_train_nhwc's, without dtype, + blocks1, blocks2, vec1, vec2
    "yolo_front_train_tc_nhwc": [_P] * 15 + [_I] * 9 + [_P],
    # yolo_front_bwd_nhwc's pointers with e2 (scratch) after dy1, B, H, W,
    # C1, C2, da_blocks, dk2_chunks, dk1_chunks, vec, vec_x (front_bwd_plan)
    "yolo_front_bwd_tc_nhwc": [_P] * 24 + [_I] * 10 + [_P],
    # x, y, choice, seeds, B, H, W, C, sigma, blur_k, inv_k, stream
    "corrupt_nhwc": [_P, _P, _P, _P, _I, _I, _I, _I, _F, _I, _F, _P],
    # x, k1, g1, b1, k2a, g2a, b2a, k2b, g2b, b2b, k3, a1, a2a, cat
    # (scratch), y3, B, H, W, dtype (f32 only), stream
    "hgstem_nhwc": [_P] * 15 + [_I] * 4 + [_P],
    # x, k1, sc1, bi1, k2a, sc2a, bi2a, k2b, sc2b, bi2b, k3, y1, y2a, y2b,
    # cat, y3, stats (scratch), vecs (14 x 32 f32 out), B, H, W, dtype (f32
    # only), stream
    "hgstem_train_nhwc": [_P] * 18 + [_I] * 4 + [_P],
    # x, y1, y2a, y2b, cat, y3, k2a, k2b, k3, sc1, sc2a, sc2b, fvecs, dy3,
    # dstat, dcat, da1p, dy2b, dy2a, dy1, gpart, wpart, work (scratch), dk1,
    # dk2a9, dk2b9, dk3, dvec, B, H, W, chunks x 4, dtype (f32 only), stream
    "hgstem_bwd_nhwc": [_P] * 28 + [_I] * 8 + [_P],
    # the bf16 stem (csrc/front_tc.cuh, csrc/stem_tc.cuh) with the plan of
    # stem_plan: hgstem_nhwc's pointers, B, H, W, then blocks and vec of
    # stem1, stem2a, stem2b, stem3
    "hgstem_tc_nhwc": [_P] * 15 + [_I] * 11 + [_P],
    # hgstem_train_nhwc's pointers, B, H, W, then the plan as above
    "hgstem_train_tc_nhwc": [_P] * 18 + [_I] * 11 + [_P],
    # hgstem_bwd_nhwc's pointers with e3 (scratch) after dy1 and dk2a, dk2b
    # (2, 2, ., .) in place of dk2a9, dk2b9; B, H, W, then the plan of
    # stem_bwd_plan: da_blocks, dk3_chunks, asm_blocks, wg2b_chunks,
    # dx2b_blocks, wg2a_chunks, dx2a_blocks, dk1_chunks, vec, vec_x
    "hgstem_bwd_tc_nhwc": [_P] * 29 + [_I] * 13 + [_P],
    # values, loc, attn, out, levels (host int[3 L]: H, W, start), B, HW, Q,
    # NH, DH, L, P, dtype, stream
    "ms_deform_attn_fwd": [_P] * 5 + [_I] * 8 + [_P],
    # values, loc, attn, dout, dv (f32, zeroed), dloc, dattn, levels, B, HW,
    # Q, NH, DH, L, P, dtype, stream
    "ms_deform_attn_bwd": [_P] * 8 + [_I] * 8 + [_P],
    # value (B, M, Q), valid, owner, capped, B, Q, M, eps, max_rounds,
    # complete_greedy, stream
    "auction_assign": [_P] * 4 + [_I] * 3 + [_F, _I, _I, _P],
    # keys (sorted), gw, dv, rows, T, HW, DH, sb, key_bytes, stream
    "stamp_scatter_sorted": [_P] * 3 + [_I] * 6 + [_P],
    # values, loc, attn, out (f32), levels, B, HW, Q, NH, DH, L, P, dtype,
    # transposed, stream
    "ms_deform_attn_sorted_fwd": [_P] * 5 + [_I] * 9 + [_P],
    # values, loc, attn, dout, dloc, dattn, keys, coef, levels, B, HW, Q, NH,
    # DH, L, P, dtype, transposed, sb, key_bytes, stream
    "ms_deform_attn_sorted_taps": [_P] * 9 + [_I] * 11 + [_P],
    # keys (sorted), coef, dout, dv, B, HW, Q, NH, DH, taps_per_q, dtype,
    # transposed, sb, key_bytes, stream
    "ms_deform_attn_sorted_dvalues": [_P] * 4 + [_I] * 10 + [_P],
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


# ---- K3's bf16 tensor-core kernels (csrc/conv3x3_tc.cuh) ----------------
# Output pixel tiles are TC_TH x TC_TW; a launch's plan is computed here so
# that the CPU tests can hold it.
TC_TH, TC_TW = 8, 16
TC_BLOCKS_PER_SM = 2        # both kernels fit two blocks an SM
_INT_MAX = 2 ** 31 - 1


def tc_tiles(b: int, h: int, w: int) -> int:
    """Pixel tiles of a (b, h, w) tensor in the tensor-core kernels."""
    return b * -(-h // TC_TH) * -(-w // TC_TW)


def _tc_shape_ok(name: str, b: int, h: int, w: int, cin: int,
                 cout: int) -> None:
    if min(b, h, w, cin, cout) <= 0:
        raise ValueError(f"{name} takes non-empty tensors, got B {b}, H {h}, "
                         f"W {w}, Cin {cin}, Cout {cout}")
    if tc_tiles(b, h, w) > _INT_MAX or 9 * cin * cout > _INT_MAX:
        raise ValueError(f"{name}: B {b} x H {h} x W {w} with {cin} -> "
                         f"{cout} channels is beyond the kernel's int32 "
                         f"counts")


def _vec(cin: int, cout: int, ptrs) -> int:
    """1 if every staged row is whole 16-byte pieces: channel counts that
    are multiples of 8 and 16-byte aligned base pointers."""
    return int(cin % 8 == 0 and cout % 8 == 0
               and all(p % 16 == 0 for p in ptrs))


def conv3x3_tc_plan(b: int, h: int, w: int, cin: int, cout: int, ptrs,
                    n_sm: int) -> Dict[str, int]:
    """Launch plan of K3-f's bf16 kernel on (b, h, w, cin) -> cout, with
    base pointers `ptrs` (x, w) and `n_sm` SMs: nt n8 tiles a block (an
    8 nt output-channel slice, blockIdx.y; the kernel takes 48 input
    channels a pass), vec (16-byte staging), blocks (persistent, about two
    an SM; block i takes the tiles of :func:`chunk_tiles`)."""
    _tc_shape_ok("conv3x3", b, h, w, cin, cout)
    nt = 2 if cout <= 16 else 6
    co_chunks = -(-cout // (8 * nt))
    if co_chunks > 65535:
        raise ValueError(f"conv3x3: {cout} output channels are too many")
    tiles = tc_tiles(b, h, w)
    return dict(nt=nt, vec=_vec(cin, cout, ptrs), co_chunks=co_chunks,
                tiles=tiles,
                blocks=max(1, min(tiles, TC_BLOCKS_PER_SM * n_sm
                                  // co_chunks)))


def wgrad_tc_plan(b: int, h: int, w: int, cin: int, cout: int, ptrs,
                  n_sm: int) -> Dict[str, int]:
    """Launch plan of K3-b's bf16 kernel on x (b, h, w, cin), dy (b, h, w,
    cout) with base pointers `ptrs` (x, dy) and `n_sm` SMs: mt m16 tiles
    (16 mt input channels, blockIdx.y) and nt n8 tiles (8 nt output
    channels, blockIdx.z) a block, vec, and n_chunks pixel chunks (chunk c
    owns the tiles of :func:`chunk_tiles`): enough blocks for about two an
    SM, fixed for a shape and a card, so a repeated run sums in the same
    order."""
    _tc_shape_ok("conv3x3_wgrad", b, h, w, cin, cout)
    mt = 1 if cin <= 16 else 3
    nt = 2 if cout <= 16 else 6
    slices = -(-cin // (16 * mt)) * -(-cout // (8 * nt))
    if max(-(-cin // (16 * mt)), -(-cout // (8 * nt))) > 65535:
        raise ValueError(f"conv3x3_wgrad: {cin} -> {cout} channels are too "
                         f"many")
    tiles = tc_tiles(b, h, w)
    return dict(mt=mt, nt=nt, vec=_vec(cin, cout, ptrs), tiles=tiles,
                n_chunks=max(1, min(tiles, TC_BLOCKS_PER_SM * n_sm
                                    // slices)))


# ---- K2's bf16 tensor-core kernels (csrc/front_tc.cuh) ------------------
# P1, P2 and dk1 cut their output (or y1) pixels into FRONT_TH x FRONT_TW
# tiles, dA1 its y1 pixels into DA_TH x DA_TW tiles (8 x 16 pixels of each
# row / column parity class), dk2 its y2 pixels into DK2_TH x FRONT_TW.
# Blocks an SM by each kernel's shared memory and registers: P1 34 KB, P2
# 214 KB, dA1 164 KB, dk2 81 KB (288 threads), dk1 73 KB.
FRONT_TH, FRONT_TW = 8, 16
DA_TH, DA_TW = 16, 32
DK2_TH = 4
P1_PER_SM, P2_PER_SM, DA_PER_SM, DK2_PER_SM, DK1_PER_SM = 4, 1, 1, 2, 2
P1_CH, P2_CH, DA_CH, DK_CH = 48, 96, 48, 48   # channels a block, each way


def _tiles(b: int, h: int, w: int, th: int, tw: int) -> int:
    return b * -(-h // th) * -(-w // tw)


def _spread(tiles: int, per_sm: int, n_sm: int, slices: int) -> int:
    """Persistent blocks (or pixel chunks) of a launch whose grid has
    `slices` channel slices: about `per_sm` blocks an SM in all, at least
    one, at most one a tile. Fixed for a shape and a card."""
    return max(1, min(tiles, per_sm * n_sm // slices))


def _front_shape_ok(name: str, b: int, h: int, w: int, c1: int,
                    c2: int) -> None:
    if min(b, c1, c2) <= 0 or h < 2 or w < 2:
        raise ValueError(f"{name} takes B >= 1, H, W >= 2 and C1, C2 >= 1, "
                         f"got B {b}, H {h}, W {w}, C1 {c1}, C2 {c2}")
    if (b * (h // 2) * (w // 2) > _INT_MAX or 9 * c1 * c2 > _INT_MAX
            or max(-(-c1 // 48), -(-c2 // 48)) > 65535):
        raise ValueError(f"{name}: B {b} x H {h} x W {w} with C1 {c1}, C2 "
                         f"{c2} is beyond the kernels' int32 counts")


def front_plan(b: int, h: int, w: int, c1: int, c2: int, ptrs,
               n_sm: int) -> Dict[str, Dict[str, int]]:
    """Launch plan of K2-f's bf16 kernels on x (b, h, w, 3) -> 48 -> 96
    (or c1 -> c2), with base pointers `ptrs` (x, k1, k2) and `n_sm` SMs.
    ``p1`` / ``p2``: tiles, co_chunks (output-channel slices, blockIdx.y),
    blocks (persistent; block i takes the tiles of :func:`chunk_tiles`, and
    in train mode writes row i of the statistics partials, so the wrapper
    allocates 2 x blocks x C of them) and vec (16-byte staging: P1 needs W
    and C1 multiples of 8 and x, k1 aligned; P2 C1, C2 multiples of 8 and k2
    aligned, its input being the wrapper's own y1 / a1)."""
    _front_shape_ok("yolo_front", b, h, w, c1, c2)
    x, k1, k2 = ptrs
    h2, w2 = h // 2, w // 2
    h4, w4 = -(-h2 // 2), -(-w2 // 2)
    plan = {}
    for name, (th, hh, ww, ch, cout, per_sm, vec) in dict(
            p1=(FRONT_TH, h2, w2, P1_CH, c1, P1_PER_SM,
                w % 8 == 0 and c1 % 8 == 0
                and x % 16 == 0 and k1 % 16 == 0),
            p2=(FRONT_TH, h4, w4, P2_CH, c2, P2_PER_SM,
                _vec(c1, c2, (k2,)))).items():
        tiles = _tiles(b, hh, ww, th, FRONT_TW)
        co_chunks = -(-cout // ch)
        plan[name] = dict(tiles=tiles, co_chunks=co_chunks, vec=int(vec),
                          blocks=_spread(tiles, per_sm, n_sm, co_chunks))
    return plan


def front_bwd_plan(b: int, h: int, w: int, c1: int, c2: int, ptrs,
                   n_sm: int) -> Dict[str, int]:
    """Launch plan of K2-b's bf16 kernels for x (b, h, w, 3), y1 (b, h/2,
    w/2, c1), y2 (b, h/4, w/4, c2), with base pointers `ptrs` (x, k2, y1, y2,
    dy2) and `n_sm` SMs: da_blocks (dA1's persistent blocks, each writing
    one row of the BN1 partials: gpart holds 2 x da_blocks x c1),
    dk2_chunks and dk1_chunks (the filter gradients' pixel chunks: wpart
    holds max(dk2_chunks x 9 c1 c2, dk1_chunks x 27 c1)), vec (16-byte
    staging of everything but x: c1, c2 multiples of 8, pointers aligned)
    and vec_x (vec, W a multiple of 8 and x aligned), with each kernel's
    tile count. Fixed for a shape and a card."""
    _front_shape_ok("yolo_front_bwd", b, h, w, c1, c2)
    x, *rest = ptrs
    h2, w2 = h // 2, w // 2
    h4, w4 = -(-h2 // 2), -(-w2 // 2)
    vec = _vec(c1, c2, rest)
    da_tiles = _tiles(b, h2, w2, DA_TH, DA_TW)
    dk2_tiles = _tiles(b, h4, w4, DK2_TH, FRONT_TW)
    dk1_tiles = _tiles(b, h2, w2, FRONT_TH, FRONT_TW)
    c1s, c2s = -(-c1 // DK_CH), -(-c2 // DK_CH)
    return dict(vec=int(vec), vec_x=int(vec and w % 8 == 0 and x % 16 == 0),
                da_tiles=da_tiles, da_co_chunks=-(-c1 // DA_CH),
                da_blocks=_spread(da_tiles, DA_PER_SM, n_sm, -(-c1 // DA_CH)),
                dk2_tiles=dk2_tiles,
                dk2_chunks=_spread(dk2_tiles, DK2_PER_SM, n_sm, c1s * c2s),
                dk1_tiles=dk1_tiles,
                dk1_chunks=_spread(dk1_tiles, DK1_PER_SM, n_sm, c1s))


# ---- K4's bf16 tensor-core kernels (csrc/front_tc.cuh, csrc/stem_tc.cuh) --
# stem1 and stem3 run K2's P1 and P2 kernels (FRONT_TH x FRONT_TW output
# tiles), d(cat) its dA1 (DA_TH x DA_TW tiles of the concat, two 32-channel
# slices), dk3 its dk2 (DK2_TH x FRONT_TW tiles of y3, one 64 x 32 slice),
# dk1 its dk1 at 32 channels; the 2x2 convs, their input and filter
# gradients take STEM_TH x STEM_TW tiles of the stem2 maps; the concat's
# backward is persistent over (pixel, 8 channels) items. Blocks an SM by
# each kernel's shared memory and registers: P1 30 KB, P2 208 KB, the
# 2x2 forward 30-37 KB, its dX 42-62 KB, its filter gradient 35-37 KB, dA1
# 57 KB, dk2 98 KB (288 threads), dk1 57 KB.
STEM_CM = 32                  # the kernels' width (HGNetv2-L)
STEM_TH, STEM_TW = 8, 16
STEM_P1_PER_SM, STEM_C2_PER_SM, STEM_P3_PER_SM = 4, 4, 1
STEM_DA_PER_SM, STEM_DK3_PER_SM, STEM_ASM_PER_SM = 2, 2, 4
STEM_WG_PER_SM, STEM_DX_PER_SM, STEM_DK1_PER_SM = 4, 3, 2


def _stem_shape_ok(name: str, b: int, h: int, w: int) -> None:
    if b <= 0 or h <= 0 or w <= 0 or h % 4 or w % 4:
        raise ValueError(f"{name} takes B >= 1 and H, W positive multiples "
                         f"of 4, got B {b}, H {h}, W {w}")
    if b * (h // 2) * (w // 2) > _INT_MAX:
        raise ValueError(f"{name}: B {b} x H {h} x W {w} is beyond the "
                         f"kernels' int32 counts")


def stem_plan(b: int, h: int, w: int, ptrs,
              n_sm: int) -> Dict[str, Dict[str, int]]:
    """Launch plan of K4-f's bf16 kernels on x (b, h, w, 3), with base
    pointers `ptrs` (x, k1, k2a, k2b, k3) and `n_sm` SMs. ``p1`` (stem1),
    ``c2a``, ``c2b`` (the 2x2 convs), ``p3`` (stem3): tiles, blocks
    (persistent; block i takes the tiles of :func:`chunk_tiles`, and in
    train mode writes row i of that conv's statistics partials) and vec
    (16-byte staging: stem1 needs W a multiple of 8 and x, k1 aligned, the
    others their filter aligned, their inputs being the wrapper's own
    buffers). ``stats``: the floats of the train mode's partials buffer,
    2 x the largest blocks x channels of the four convs."""
    _stem_shape_ok("stem", b, h, w)
    x, k1, k2a, k2b, k3 = ptrs
    h2, w2, h4, w4 = h // 2, w // 2, h // 4, w // 4
    plan = {}
    for name, (hh, ww, per_sm, vec) in dict(
            p1=(h2, w2, STEM_P1_PER_SM,
                w % 8 == 0 and x % 16 == 0 and k1 % 16 == 0),
            c2a=(h2, w2, STEM_C2_PER_SM, k2a % 16 == 0),
            c2b=(h2, w2, STEM_C2_PER_SM, k2b % 16 == 0),
            p3=(h4, w4, STEM_P3_PER_SM, k3 % 16 == 0)).items():
        tiles = _tiles(b, hh, ww, STEM_TH, STEM_TW)
        plan[name] = dict(tiles=tiles, vec=int(vec),
                          blocks=_spread(tiles, per_sm, n_sm, 1))
    widths = dict(p1=STEM_CM, c2a=STEM_CM // 2, c2b=STEM_CM, p3=STEM_CM)
    plan["stats"] = 2 * max(plan[k]["blocks"] * c for k, c in widths.items())
    return plan


def stem_bwd_plan(b: int, h: int, w: int, ptrs, n_sm: int) -> Dict[str, int]:
    """Launch plan of K4-b's bf16 kernels for x (b, h, w, 3) and the stem's
    saved tensors, with base pointers `ptrs` (x, k2a, k2b, k3, dy3) and
    `n_sm` SMs: da_blocks (d(cat)'s persistent blocks, two channel slices),
    dk3_chunks, wg2b_chunks, wg2a_chunks and dk1_chunks (the filter
    gradients' pixel chunks), asm_blocks, dx2b_blocks and dx2a_blocks (the
    concat's backward and the two 2x2 input gradients, each block one row
    of dgamma / dbeta partials), each with its tile (or item) count; vec
    (16-byte staging of the filters and dy3: pointers aligned) and vec_x
    (vec, W a multiple of 8 and x aligned); ``gpart`` and ``wpart``, the
    floats of the partials buffers. Fixed for a shape and a card."""
    _stem_shape_ok("stem_bwd", b, h, w)
    x, *rest = ptrs
    cm = STEM_CM
    h2, w2, h4, w4 = h // 2, w // 2, h // 4, w // 4
    vec = int(all(p % 16 == 0 for p in rest))
    t2 = _tiles(b, h2, w2, STEM_TH, STEM_TW)
    plan = dict(vec=vec, vec_x=int(vec and w % 8 == 0 and x % 16 == 0),
                da_tiles=_tiles(b, h2, w2, DA_TH, DA_TW),
                dk3_tiles=_tiles(b, h4, w4, DK2_TH, FRONT_TW),
                asm_items=b * h2 * w2 * (cm // 8),
                wg2b_tiles=t2, dx2b_tiles=t2, wg2a_tiles=t2, dx2a_tiles=t2,
                dk1_tiles=_tiles(b, h2, w2, FRONT_TH, FRONT_TW))
    plan["da_blocks"] = _spread(plan["da_tiles"], STEM_DA_PER_SM, n_sm, 2)
    plan["dk3_chunks"] = _spread(plan["dk3_tiles"], STEM_DK3_PER_SM, n_sm, 1)
    plan["asm_blocks"] = _spread(-(-plan["asm_items"] // 256),
                                 STEM_ASM_PER_SM, n_sm, 1)
    for k in ("wg2b", "wg2a"):
        plan[f"{k}_chunks"] = _spread(t2, STEM_WG_PER_SM, n_sm, 1)
    for k in ("dx2b", "dx2a"):
        plan[f"{k}_blocks"] = _spread(t2, STEM_DX_PER_SM, n_sm, 1)
    plan["dk1_chunks"] = _spread(plan["dk1_tiles"], STEM_DK1_PER_SM, n_sm, 1)
    plan["gpart"] = 2 * max(plan["asm_blocks"] * cm,
                            plan["dx2b_blocks"] * (cm // 2),
                            plan["dx2a_blocks"] * cm)
    plan["wpart"] = max(plan["dk3_chunks"] * 9 * 2 * cm * cm,
                        plan["wg2b_chunks"] * 4 * (cm // 2) * cm,
                        plan["wg2a_chunks"] * 4 * cm * (cm // 2),
                        plan["dk1_chunks"] * 27 * cm)
    return plan


def chunk_tiles(tiles: int, n_chunks: int, chunk: int) -> range:
    """The pixel tiles chunk `chunk` of a K3-b launch walks (and the tiles
    a persistent K3-f block walks, with n_chunks = blocks), in order."""
    return range(chunk, tiles, n_chunks)


def sm_count(device) -> int:
    """The SM count of a CUDA device (the plans ask on every launch)."""
    import torch
    index = torch.device(device).index
    return _sm_count(torch.cuda.current_device() if index is None else index)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    import torch
    return torch.cuda.get_device_properties(index).multi_processor_count
