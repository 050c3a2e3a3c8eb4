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

# dtype codes, shared with csrc/conv_tile.cuh
DTYPE_F32, DTYPE_BF16 = 0, 1

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# argument lists of the C entry points (pointers and the stream as void*,
# or ctypes would pass them as 32-bit ints)
SIGNATURES: Dict[str, List] = {
    # x, w, y (bf16), B, H, W, Cin, Cout, nt, vec, blocks, stream (the plan
    # of conv3x3_tc_plan); the same in f32
    "conv3x3_tc_nhwc": [_P, _P, _P] + [_I] * 8 + [_P],
    "conv3x3_tf32_nhwc": [_P, _P, _P] + [_I] * 8 + [_P],
    # x, dy (bf16), part (scratch), dk, B, H, W, Cin, Cout, mt, nt, vec,
    # n_chunks, stream (the plan of wgrad_tc_plan); the same in f32
    "conv3x3_wgrad_tc_nhwc": [_P] * 4 + [_I] * 9 + [_P],
    "conv3x3_wgrad_tf32_nhwc": [_P] * 4 + [_I] * 9 + [_P],
    # K2 (csrc/yolo_front.cu, yolo_front_bwd.cu) with the plan of
    # front_plan / front_bwd_plan; bf16 (front_tc.cuh) and f32
    # (front_tf32.cuh) take the same arguments. Eval: x, k1, g1, b1 (the
    # BN1 fold), k2, a1 (scratch), y2, B, H, W, C1, C2, blocks1, blocks2,
    # vec1, vec2, stream
    "yolo_front_tc_nhwc": [_P] * 7 + [_I] * 9 + [_P],
    "yolo_front_tf32_nhwc": [_P] * 7 + [_I] * 9 + [_P],
    # train: x, k1, sc1, bi1, k2, y1, y2, stats1, stats2 (scratch), mean1,
    # var1, g1, b1, mean2, var2, B, H, W, C1, C2, blocks1, blocks2, vec1,
    # vec2, sync (a SyncFn or null: parallel/mesh.kernel_sync), sync_buf
    # (scratch), stream
    "yolo_front_train_tc_nhwc": [_P] * 15 + [_I] * 9 + [_P] * 3,
    "yolo_front_train_tf32_nhwc": [_P] * 15 + [_I] * 9 + [_P] * 3,
    # backward: x, k2, y1, y2, dy2, sc1, mean1, var1, g1, b1, mean2, dmean1,
    # dvar1, dmean2, dvar2, dy1, e2, gpart, wpart, vecs (scratch), dk1, dk2,
    # dsc1, dbi1, B, H, W, C1, C2, da_blocks, dk2_chunks, dk1_chunks, vec,
    # vec_x, sync, stream
    "yolo_front_bwd_tc_nhwc": [_P] * 24 + [_I] * 10 + [_P] * 2,
    "yolo_front_bwd_tf32_nhwc": [_P] * 24 + [_I] * 10 + [_P] * 2,
    # x, y, choice, seeds, B, H, W, C, sigma, blur_k, inv_k, smem, vec (the
    # plan of corrupt_plan), stream
    "corrupt_nhwc": [_P] * 4 + [_I] * 4 + [_F, _I, _F, _I, _I, _P],
    # K4 (csrc/hgstem.cu, hgstem_bwd.cu) with the plan of stem_plan /
    # stem_bwd_plan; bf16 (front_tc.cuh, stem_tc.cuh) and f32 (split TF32:
    # front_tf32.cuh, stem_tf32.cuh) take the same arguments. Eval: x, k1,
    # g1, b1, k2a, g2a, b2a, k2b, g2b, b2b, k3, a1, a2a, cat (scratch), y3,
    # B, H, W, then blocks and vec of stem1, stem2a, stem2b, stem3, stream
    "hgstem_tc_nhwc": [_P] * 15 + [_I] * 11 + [_P],
    "hgstem_tf32_nhwc": [_P] * 15 + [_I] * 11 + [_P],
    # train: x, k1, sc1, bi1, k2a, sc2a, bi2a, k2b, sc2b, bi2b, k3, y1, y2a,
    # y2b, cat, y3, stats (scratch), vecs (14 x 32 f32 out), B, H, W, the
    # plan as above, sync, sync_buf (scratch), stream
    "hgstem_train_tc_nhwc": [_P] * 18 + [_I] * 11 + [_P] * 3,
    "hgstem_train_tf32_nhwc": [_P] * 18 + [_I] * 11 + [_P] * 3,
    # backward: x, y1, y2a, y2b, cat, y3, k2a, k2b, k3, sc1, sc2a, sc2b,
    # fvecs, dy3, dstat, dcat, da1p, dy2b, dy2a, dy1, e3, gpart, wpart,
    # work (scratch), dk1, dk2a, dk2b, dk3, dvec, B, H, W, then da_blocks,
    # dk3_chunks, asm_blocks, wg2b_chunks, dx2b_blocks, wg2a_chunks,
    # dx2a_blocks, dk1_chunks, vec, vec_x, sync, stream
    "hgstem_bwd_tc_nhwc": [_P] * 29 + [_I] * 13 + [_P] * 2,
    "hgstem_bwd_tf32_nhwc": [_P] * 29 + [_I] * 13 + [_P] * 2,
    # values, loc, attn, out, levels (host int[3 L]: H, W, start), B, HW, Q,
    # NH, DH, L, P, dtype, vec, row_lanes, fixed (deform_fwd_plan), stream
    "ms_deform_attn_fwd": [_P] * 5 + [_I] * 11 + [_P],
    # values, loc, attn, dout, dloc, dattn, cell, coef (scratch), dv, levels,
    # tiles (host int[L]), B, HW, Q, NH, DH, L, P, dtype, dout_dtype,
    # transposed, vec, row_lanes, fixed, ivec, svec (deform_bwd_plan), stream
    "ms_deform_attn_bwd": [_P] * 11 + [_I] * 15 + [_P],
    # cost (B, Q, M), valid, owner, capped (bool), stats (or null), B, Q,
    # M, qs, cap, smem (the plan of auction_plan), eps, max_rounds,
    # complete_greedy, stream
    "auction_assign": [_P] * 5 + [_I] * 6 + [_F, _I, _I, _P],
    # idx, gw, dv, rows, T, HW, DH, cs, ts (gw's channel and tap strides),
    # idx_bytes, tile, ivec, pairs (the plan of stamp_plan), stream
    "stamp_scatter": [_P] * 3 + [_I] * 10 + [_P],
    # values (or values_t), loc, attn, out (f32), ws (values_t's relayout,
    # or null), levels, B, HW, Q, NH, DH, L, P, dtype, transposed, vec,
    # row_lanes, fixed (deform_fwd_plan of the rows the gather reads),
    # ld_vec, st_vec (deform_relayout_plan; 0 for values), stream
    "ms_deform_attn_sorted_fwd": [_P] * 6 + [_I] * 14 + [_P],
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


_entries: Dict[str, tuple] = {}


def launch(device, name: str, *args) -> int:
    """Calls the kernel library's entry point `name` with `args` and the
    current stream of `device`; returns its error code. The function is
    looked up once per loaded library (:func:`load` is called only until
    then), and `device` is made current only when it is not already."""
    import torch
    hit = _entries.get(name)
    if hit is None or _lib is None or hit[0] is not _lib:
        lib = load()
        hit = _entries[name] = (lib, getattr(lib, name))
    if device.index == torch.cuda.current_device():
        return hit[1](*args, stream_ptr(device))
    with torch.cuda.device(device):
        return hit[1](*args, stream_ptr(device))


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


# ---- K3's tensor-core kernels -------------------------------------------
# bf16: csrc/conv3x3_tc.cuh (m16n8k16); f32: csrc/conv3x3_tf32.cuh (split
# TF32 on m16n8k8, three MMAs a product). A launch's plan is computed here
# so that the CPU tests can hold it. K3-f walks th x TC_TW output tiles,
# K3-b TC_TH x TC_TW pixel tiles. By dtype: K3-f's tile height th; blocks
# an SM (per_sm, both kernels); the channels of a 16-byte piece; how many
# of K3-f's operands are staged by 16-byte cp.async (x, then the filter);
# the entry points. bf16 fits two blocks an SM (K3-f 4 warps, K3-b 9).
# f32's halo stages and filter fill an SM's shared memory, one block an
# SM: K3-f 8 warps of two tile rows each, K3-b 18 warps (9 taps x 2 halves
# of the n8 tiles); K3-f f32 stages its filter transposed, element by
# element, so only x's layout decides its 16-byte staging.
TC_TH, TC_TW = 8, 16
K3_ROUTES = {
    "bfloat16": dict(th=TC_TH, per_sm=2, piece=8, staged=2,
                     fwd="conv3x3_tc_nhwc", wgrad="conv3x3_wgrad_tc_nhwc"),
    "float32": dict(th=16, per_sm=1, piece=4, staged=1,
                    fwd="conv3x3_tf32_nhwc",
                    wgrad="conv3x3_wgrad_tf32_nhwc")}
_INT_MAX = 2 ** 31 - 1


def tc_tiles(b: int, h: int, w: int) -> int:
    """K3-b's pixel tiles of a (b, h, w) tensor (K3-f's at bf16)."""
    return _tiles(b, h, w, TC_TH, TC_TW)


def _tc_shape_ok(name: str, b: int, h: int, w: int, cin: int,
                 cout: int, th: int = TC_TH) -> None:
    if min(b, h, w, cin, cout) <= 0:
        raise ValueError(f"{name} takes non-empty tensors, got B {b}, H {h}, "
                         f"W {w}, Cin {cin}, Cout {cout}")
    if (_tiles(b, h, w, th, TC_TW) > _INT_MAX
            or 9 * cin * cout > _INT_MAX):
        raise ValueError(f"{name}: B {b} x H {h} x W {w} with {cin} -> "
                         f"{cout} channels is beyond the kernel's int32 "
                         f"counts")


def _vec(chans, ptrs, piece: int = 8) -> int:
    """1 if every staged row is whole 16-byte pieces: channel counts that
    are multiples of `piece` (the channels of 16 bytes: 8 bf16, 4 f32) and
    16-byte aligned base pointers."""
    return int(all(c % piece == 0 for c in chans)
               and all(p % 16 == 0 for p in ptrs))


def conv3x3_tc_plan(dtype: str, b: int, h: int, w: int, cin: int,
                    cout: int, ptrs, n_sm: int) -> Dict[str, int]:
    """Launch plan of K3-f's `dtype` kernel ("bfloat16" or "float32") on
    (b, h, w, cin) -> cout, with base pointers `ptrs` (x, w) and `n_sm`
    SMs: nt n8 tiles a block (an 8 nt output-channel slice, blockIdx.y;
    the kernel takes 48 input channels a pass), vec (16-byte staging),
    tiles (th x TC_TW), blocks (persistent, per_sm an SM in all; block i
    takes the tiles of :func:`chunk_tiles`)."""
    route = K3_ROUTES[dtype]
    _tc_shape_ok("conv3x3", b, h, w, cin, cout, route["th"])
    nt = 2 if cout <= 16 else 6
    co_chunks = -(-cout // (8 * nt))
    if co_chunks > 65535:
        raise ValueError(f"conv3x3: {cout} output channels are too many")
    tiles = _tiles(b, h, w, route["th"], TC_TW)
    n = route["staged"]
    return dict(nt=nt, vec=_vec((cin, cout)[:n], ptrs[:n], route["piece"]),
                co_chunks=co_chunks, tiles=tiles,
                blocks=_spread(tiles, route["per_sm"], n_sm, co_chunks))


def wgrad_tc_plan(dtype: str, b: int, h: int, w: int, cin: int, cout: int,
                  ptrs, n_sm: int) -> Dict[str, int]:
    """Launch plan of K3-b's `dtype` kernel on x (b, h, w, cin), dy (b, h,
    w, cout) with base pointers `ptrs` (x, dy) and `n_sm` SMs: mt m16
    tiles (16 mt input channels, blockIdx.y) and nt n8 tiles (8 nt output
    channels, blockIdx.z) a block, vec, and n_chunks pixel chunks (chunk c
    owns the tiles of :func:`chunk_tiles`): per_sm blocks an SM in all,
    fixed for a shape and a card, so a repeated run sums in the same
    order."""
    route = K3_ROUTES[dtype]
    _tc_shape_ok("conv3x3_wgrad", b, h, w, cin, cout)
    mt = 1 if cin <= 16 else 3
    nt = 2 if cout <= 16 else 6
    if max(-(-cin // (16 * mt)), -(-cout // (8 * nt))) > 65535:
        raise ValueError(f"conv3x3_wgrad: {cin} -> {cout} channels are too "
                         f"many")
    slices = -(-cin // (16 * mt)) * -(-cout // (8 * nt))
    tiles = tc_tiles(b, h, w)
    return dict(mt=mt, nt=nt, vec=_vec((cin, cout), ptrs, route["piece"]),
                tiles=tiles,
                n_chunks=_spread(tiles, route["per_sm"], n_sm, slices))


# ---- K2's tensor-core kernels ---------------------------------------------
# bf16: csrc/front_tc.cuh (m16n8k16); f32: csrc/front_tf32.cuh (split TF32
# on m16n8k8, three MMAs a product). P1, P2 and dk1 cut their output (or
# y1) pixels into FRONT_TH x FRONT_TW tiles, dA1 its y1 pixels into DA_TH x
# DA_TW tiles (8 x 16 pixels of each row / column parity class), dk2 its y2
# pixels into DK2_TH x FRONT_TW, in both routes. By dtype (FRONT_ROUTES):
# blocks an SM of each kernel, by its shared memory and registers (bf16:
# P1 34 KB, P2 214 KB, dA1 164 KB, dk2 81 KB (288 threads), dk1 73 KB;
# f32: P1 64 KB, P2 224 KB, dA1 212 KB, dk2 225 KB (576 threads), dk1 202
# KB); the channels of a 16-byte piece; whether the forward's filters are
# staged by 16-byte cp.async (bf16) or element by element, transposed and
# split (f32: then only x's layout decides P1's staging and only C1 P2's);
# the entry points. f32's filter gradients (dk2, dk1) take four chunks'
# worth of blocks an SM: the tensor cores' f32 accumulation loses more than
# an IEEE sum along a long chain (at batch 16 dk2's error against the plain
# f32 version halves with each doubling of the chunks: 1.2e-4 of max|ref|
# at one an SM, 2.9e-5 at four; PERF.md), and the chunks are summed in
# order by plain f32 adds (the partials: 44 MB at batch 16).
FRONT_TH, FRONT_TW = 8, 16
DA_TH, DA_TW = 16, 32
DK2_TH = 4
P1_CH, P2_CH, DA_CH, DK_CH = 48, 96, 48, 48   # channels a block, each way
FRONT_ROUTES = {
    "bfloat16": dict(per_sm=dict(p1=4, p2=1, da=1, dk2=2, dk1=2), piece=8,
                     filters_staged=True, eval="yolo_front_tc_nhwc",
                     train="yolo_front_train_tc_nhwc",
                     bwd="yolo_front_bwd_tc_nhwc"),
    "float32": dict(per_sm=dict(p1=3, p2=1, da=1, dk2=4, dk1=4), piece=4,
                    filters_staged=False, eval="yolo_front_tf32_nhwc",
                    train="yolo_front_train_tf32_nhwc",
                    bwd="yolo_front_bwd_tf32_nhwc")}


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


def front_plan(dtype: str, b: int, h: int, w: int, c1: int, c2: int, ptrs,
               n_sm: int) -> Dict[str, Dict[str, int]]:
    """Launch plan of K2-f's `dtype` kernels ("bfloat16" or "float32") on x
    (b, h, w, 3) -> 48 -> 96 (or c1 -> c2), with base pointers `ptrs` (x,
    k1, k2) and `n_sm` SMs. ``p1`` / ``p2``: tiles, co_chunks
    (output-channel slices, blockIdx.y), blocks (persistent; block i takes
    the tiles of :func:`chunk_tiles`, and in train mode writes row i of the
    statistics partials, so the wrapper allocates 2 x blocks x C of them)
    and vec (16-byte staging: P1 needs W a multiple of a piece and x
    aligned, and where the filter is staged by cp.async (bf16) C1 a
    multiple of a piece and k1 aligned; P2 C1 a multiple of a piece, and
    bf16 also C2 and k2, its input being the wrapper's own y1 / a1)."""
    route = FRONT_ROUTES[dtype]
    _front_shape_ok("yolo_front", b, h, w, c1, c2)
    x, k1, k2 = ptrs
    piece, staged = route["piece"], route["filters_staged"]
    h2, w2 = h // 2, w // 2
    h4, w4 = -(-h2 // 2), -(-w2 // 2)
    vec1 = w % piece == 0 and x % 16 == 0 and (
        not staged or _vec((c1,), (k1,), piece))
    vec2 = _vec((c1, c2), (k2,), piece) if staged else _vec((c1,), (), piece)
    plan = {}
    for name, (hh, ww, ch, cout, vec) in dict(
            p1=(h2, w2, P1_CH, c1, vec1),
            p2=(h4, w4, P2_CH, c2, vec2)).items():
        tiles = _tiles(b, hh, ww, FRONT_TH, FRONT_TW)
        co_chunks = -(-cout // ch)
        plan[name] = dict(tiles=tiles, co_chunks=co_chunks, vec=int(vec),
                          blocks=_spread(tiles, route["per_sm"][name], n_sm,
                                         co_chunks))
    return plan


def front_bwd_plan(dtype: str, b: int, h: int, w: int, c1: int, c2: int,
                   ptrs, n_sm: int) -> Dict[str, int]:
    """Launch plan of K2-b's `dtype` kernels for x (b, h, w, 3), y1 (b,
    h/2, w/2, c1), y2 (b, h/4, w/4, c2), with base pointers `ptrs` (x, k2,
    y1, y2, dy2) and `n_sm` SMs: da_blocks (dA1's persistent blocks, each
    writing one row of the BN1 partials: gpart holds 2 x da_blocks x c1),
    dk2_chunks and dk1_chunks (the filter gradients' pixel chunks: wpart
    holds max(dk2_chunks x 9 c1 c2, dk1_chunks x 27 c1)), vec (16-byte
    staging of everything but x: c1, c2 multiples of a piece, pointers
    aligned) and vec_x (vec, W a multiple of a piece and x aligned), with
    each kernel's tile count. Fixed for a shape and a card."""
    route = FRONT_ROUTES[dtype]
    _front_shape_ok("yolo_front_bwd", b, h, w, c1, c2)
    x, *rest = ptrs
    per_sm, piece = route["per_sm"], route["piece"]
    h2, w2 = h // 2, w // 2
    h4, w4 = -(-h2 // 2), -(-w2 // 2)
    vec = _vec((c1, c2), rest, piece)
    da_tiles = _tiles(b, h2, w2, DA_TH, DA_TW)
    dk2_tiles = _tiles(b, h4, w4, DK2_TH, FRONT_TW)
    dk1_tiles = _tiles(b, h2, w2, FRONT_TH, FRONT_TW)
    c1s, c2s = -(-c1 // DK_CH), -(-c2 // DK_CH)
    return dict(vec=int(vec),
                vec_x=int(vec and w % piece == 0 and x % 16 == 0),
                da_tiles=da_tiles, da_co_chunks=-(-c1 // DA_CH),
                da_blocks=_spread(da_tiles, per_sm["da"], n_sm,
                                  -(-c1 // DA_CH)),
                dk2_tiles=dk2_tiles,
                dk2_chunks=_spread(dk2_tiles, per_sm["dk2"], n_sm, c1s * c2s),
                dk1_tiles=dk1_tiles,
                dk1_chunks=_spread(dk1_tiles, per_sm["dk1"], n_sm, c1s))


# ---- K4's tensor-core kernels --------------------------------------------
# bf16: csrc/front_tc.cuh, csrc/stem_tc.cuh (m16n8k16); f32: csrc/
# front_tf32.cuh, csrc/stem_tf32.cuh (split TF32 on m16n8k8, three MMAs a
# product). stem1 and stem3 run K2's P1 and P2 kernels (FRONT_TH x FRONT_TW
# output tiles), d(cat) its dA1 (DA_TH x DA_TW tiles of the concat, two
# 32-channel slices), dk3 its dk2 (DK2_TH x FRONT_TW tiles of y3; one 64 x
# 32 slice in bf16, two 32 x 32 in f32), dk1 its dk1 at 32 channels; the
# 2x2 convs, their input and filter gradients take STEM_TH x STEM_TW tiles
# of the stem2 maps; the concat's backward is persistent over (pixel,
# piece) items. By dtype (STEM_ROUTES): blocks (or pixel chunks) an SM of
# each kernel, by its shared memory and registers (bf16: P1 30 KB, P2 208
# KB, the 2x2 forward 30-37 KB, its dX 42-62 KB, its filter gradient 35-37
# KB, dA1 57 KB, dk2 98 KB (288 threads), dk1 57 KB; f32: P1 60 KB, P2
# 166 KB, the 2x2 forward 106 KB (stem2a) and 69 KB (stem2b), its dX 107
# and 69 KB, its filter gradient 111-120 KB (256 threads), dA1 81 KB, dk2
# 154 KB (576 threads), dk1 154 KB); the channel slices of d(cat) and dk3;
# the channels of a 16-byte piece; whether the filters are staged by
# 16-byte cp.async (bf16) or element by element, transposed and split
# (f32: then only x's layout decides stem1's staging, and k3's and dy3's
# the backward's); the partials each filter-gradient chunk writes (f32's
# 2x2 filter gradient: one a row half of its 8 warps); the entry points.
# f32's filter gradients take four chunks an SM, as K2's: the tensor
# cores' f32 accumulation loses more than an IEEE sum along a long chain,
# and the chunks are summed in order by plain f32 adds.
STEM_CM = 32                  # the kernels' width (HGNetv2-L)
STEM_TH, STEM_TW = 8, 16
STEM_ROUTES = {
    "bfloat16": dict(
        per_sm=dict(p1=4, c2a=4, c2b=4, p3=1, da=2, dk3=2, asm=4, wg2b=4,
                    wg2a=4, dx2b=3, dx2a=3, dk1=2),
        slices=dict(da=2, dk3=1), piece=8, filters_staged=True, wg_parts=1,
        eval="hgstem_tc_nhwc", train="hgstem_train_tc_nhwc",
        bwd="hgstem_bwd_tc_nhwc"),
    "float32": dict(
        per_sm=dict(p1=3, c2a=2, c2b=3, p3=1, da=2, dk3=4, asm=4, wg2b=4,
                    wg2a=4, dx2b=2, dx2a=3, dk1=4),
        slices=dict(da=2, dk3=2), piece=4, filters_staged=False, wg_parts=2,
        eval="hgstem_tf32_nhwc", train="hgstem_train_tf32_nhwc",
        bwd="hgstem_bwd_tf32_nhwc")}


def _stem_shape_ok(name: str, b: int, h: int, w: int) -> None:
    if b <= 0 or h <= 0 or w <= 0 or h % 4 or w % 4:
        raise ValueError(f"{name} takes B >= 1 and H, W positive multiples "
                         f"of 4, got B {b}, H {h}, W {w}")
    if b * (h // 2) * (w // 2) > _INT_MAX:
        raise ValueError(f"{name}: B {b} x H {h} x W {w} is beyond the "
                         f"kernels' int32 counts")


def stem_plan(dtype: str, b: int, h: int, w: int, ptrs,
              n_sm: int) -> Dict[str, Dict[str, int]]:
    """Launch plan of K4-f's `dtype` kernels ("bfloat16" or "float32") on x
    (b, h, w, 3), with base pointers `ptrs` (x, k1, k2a, k2b, k3) and
    `n_sm` SMs. ``p1`` (stem1), ``c2a``, ``c2b`` (the 2x2 convs), ``p3``
    (stem3): tiles, blocks (persistent; block i takes the tiles of
    :func:`chunk_tiles`, and in train mode writes row i of that conv's
    statistics partials) and vec (16-byte staging: stem1 needs W a
    multiple of a piece and x aligned, and where the filters are staged by
    cp.async (bf16) k1 aligned; the others, whose inputs are the wrapper's
    own buffers, their filter aligned where it is staged so, else always).
    ``stats``: the floats of the train mode's partials buffer, 2 x the
    largest blocks x channels of the four convs."""
    route = STEM_ROUTES[dtype]
    _stem_shape_ok("stem", b, h, w)
    x, k1, k2a, k2b, k3 = ptrs
    per_sm, piece = route["per_sm"], route["piece"]
    staged = route["filters_staged"]

    def aligned(k):
        return not staged or k % 16 == 0
    h2, w2, h4, w4 = h // 2, w // 2, h // 4, w // 4
    plan = {}
    for name, (hh, ww, vec) in dict(
            p1=(h2, w2, w % piece == 0 and x % 16 == 0 and aligned(k1)),
            c2a=(h2, w2, aligned(k2a)), c2b=(h2, w2, aligned(k2b)),
            p3=(h4, w4, aligned(k3))).items():
        tiles = _tiles(b, hh, ww, STEM_TH, STEM_TW)
        plan[name] = dict(tiles=tiles, vec=int(vec),
                          blocks=_spread(tiles, per_sm[name], n_sm, 1))
    widths = dict(p1=STEM_CM, c2a=STEM_CM // 2, c2b=STEM_CM, p3=STEM_CM)
    plan["stats"] = 2 * max(plan[k]["blocks"] * c for k, c in widths.items())
    return plan


def stem_bwd_plan(dtype: str, b: int, h: int, w: int, ptrs,
                  n_sm: int) -> Dict[str, int]:
    """Launch plan of K4-b's `dtype` kernels for x (b, h, w, 3) and the
    stem's saved tensors, with base pointers `ptrs` (x, k2a, k2b, k3, dy3)
    and `n_sm` SMs: da_blocks (d(cat)'s persistent blocks, two channel
    slices), dk3_chunks, wg2b_chunks, wg2a_chunks and dk1_chunks (the
    filter gradients' pixel chunks), asm_blocks, dx2b_blocks and
    dx2a_blocks (the concat's backward and the two 2x2 input gradients,
    each block one row of dgamma / dbeta partials), each with its tile (or
    item) count; vec (16-byte staging of dy3 and of the filters staged by
    cp.async: bf16 all three, f32 k3; pointers aligned) and vec_x (vec, W a
    multiple of a piece and x aligned); ``gpart`` and ``wpart``, the floats
    of the partials buffers. Fixed for a shape and a card."""
    route = STEM_ROUTES[dtype]
    _stem_shape_ok("stem_bwd", b, h, w)
    x, k2a, k2b, k3, dy3 = ptrs
    per_sm, slices, piece = route["per_sm"], route["slices"], route["piece"]
    cm = STEM_CM
    h2, w2, h4, w4 = h // 2, w // 2, h // 4, w // 4
    staged = (k2a, k2b, k3) if route["filters_staged"] else (k3,)
    vec = int(all(p % 16 == 0 for p in (*staged, dy3)))
    t2 = _tiles(b, h2, w2, STEM_TH, STEM_TW)
    plan = dict(vec=vec, vec_x=int(vec and w % piece == 0 and x % 16 == 0),
                da_tiles=_tiles(b, h2, w2, DA_TH, DA_TW),
                dk3_tiles=_tiles(b, h4, w4, DK2_TH, FRONT_TW),
                asm_items=b * h2 * w2 * (cm // piece),
                wg2b_tiles=t2, dx2b_tiles=t2, wg2a_tiles=t2, dx2a_tiles=t2,
                dk1_tiles=_tiles(b, h2, w2, FRONT_TH, FRONT_TW))
    plan["da_blocks"] = _spread(plan["da_tiles"], per_sm["da"], n_sm,
                                slices["da"])
    plan["dk3_chunks"] = _spread(plan["dk3_tiles"], per_sm["dk3"], n_sm,
                                 slices["dk3"])
    plan["asm_blocks"] = _spread(-(-plan["asm_items"] // 256),
                                 per_sm["asm"], n_sm, 1)
    for k in ("wg2b", "wg2a"):
        plan[f"{k}_chunks"] = _spread(t2, per_sm[k], n_sm, 1)
    for k in ("dx2b", "dx2a"):
        plan[f"{k}_blocks"] = _spread(t2, per_sm[k], n_sm, 1)
    plan["dk1_chunks"] = _spread(plan["dk1_tiles"], per_sm["dk1"], n_sm, 1)
    plan["gpart"] = 2 * max(plan["asm_blocks"] * cm,
                            plan["dx2b_blocks"] * (cm // 2),
                            plan["dx2a_blocks"] * cm)
    parts = route["wg_parts"]
    plan["wpart"] = max(plan["dk3_chunks"] * 9 * 2 * cm * cm,
                        plan["wg2b_chunks"] * parts * 4 * (cm // 2) * cm,
                        plan["wg2a_chunks"] * parts * 4 * cm * (cm // 2),
                        plan["dk1_chunks"] * 27 * cm)
    return plan


# ---- K5 forward and K5-g2 forward's gather (csrc/deform_fwd.cuh) ---------
def _lanes(n_l: int, n_p: int, dh: int, vec: int) -> Dict[str, int]:
    row_lanes = min(32, 1 << (-(-dh // vec) - 1).bit_length())
    slots = 32 // row_lanes
    return dict(vec=vec, row_lanes=row_lanes, slots=slots,
                passes=-(-dh // (row_lanes * vec)),
                rounds=-(-4 * n_l * n_p // slots),
                fixed=int(vec > 1 and (n_l, n_p, dh) == (3, 4, 32)))


def deform_fwd_plan(n_l: int, n_p: int, dh: int, esize: int,
                    values_ptr: int) -> Dict[str, int]:
    """Lane plan of K5 forward for L = n_l levels x P = n_p points, dh
    channels of `esize` bytes at `values_ptr`: vec (channels a load: 16
    bytes where dh * esize is a multiple of 16 and values is aligned, else
    1), row_lanes (lanes a value row: a power of two, at most 32), slots
    (taps a load instruction, 32 / row_lanes), passes (of row_lanes * vec
    channels), rounds (4 L P taps over the slots) and fixed (1 for the
    model's (3, 4) x 32 channels with 16-byte loads: the kernel instantiated
    for it). Lane i of a warp reads, in round r of pass c, tap k = r *
    slots + i // row_lanes (corner k % 4 of point k // 4 = (level, point))
    and channels c * row_lanes * vec + (i % row_lanes) * vec + [0, vec)."""
    vec = 16 // esize if (dh * esize) % 16 == 0 and values_ptr % 16 == 0 \
        else 1
    return _lanes(n_l, n_p, dh, vec)


# ---- K5-g2 forward's relayout of values_t (csrc/ms_deform_attn_sorted.cu) --
# values_t_to_rows_kernel: one block of RELAYOUT_THREADS per (cell tile,
# channel tile, batch) copies a RELAYOUT_TILE_C x RELAYOUT_TILE_P tile of a
# batch's (NH * DH) x HW matrix through shared memory into the rows (B, HW,
# NH, DH) that K5's gather reads.
RELAYOUT_TILE_C = 64
RELAYOUT_TILE_P = 64
RELAYOUT_THREADS = 256


def deform_relayout_plan(b: int, n_h: int, dh: int, hw: int, esize: int,
                         values_t_ptr: int) -> Dict[str, int]:
    """Launch plan of K5-g2 forward's relayout of values_t (b, n_h, dh, hw)
    with elements of `esize` bytes at `values_t_ptr`: channels c = n_h *
    dh, the tiles (tile_c channels x tile_p cells), pitch (elements a
    staged row: an odd number of 4-byte words), the grid (cell tiles,
    channel tiles, b), threads, piece (elements in 16 bytes), ld_vec
    (16-byte loads along HW: hw a multiple of the piece and values_t
    aligned) and st_vec (16-byte stores along the channels: c a multiple of
    the piece; the workspace is a fresh, aligned allocation). A tile that
    crosses an edge of the matrix uses element accesses in both phases,
    whatever the flags. In a full tile, thread t of a vector phase moves
    piece i = t + k * threads: loads channel i // (tile_p / piece), cells
    (i % (tile_p / piece)) * piece + [0, piece); stores cell i // (tile_c /
    piece), channels (i % (tile_c / piece)) * piece + [0, piece). An
    element phase moves element e = t + k * threads: loads (channel e //
    tile_p, cell e % tile_p), stores (cell e // tile_c, channel e %
    tile_c)."""
    c = n_h * dh
    if min(b, n_h, dh, hw) <= 0:
        raise ValueError(f"ms_deform_attn_t takes non-empty tensors, got B "
                         f"{b}, heads {n_h}, dh {dh}, HW {hw}")
    grid = (-(-hw // RELAYOUT_TILE_P), -(-c // RELAYOUT_TILE_C), b)
    if c > _INT_MAX or hw > _INT_MAX or max(grid[1:]) > 65535:
        raise ValueError(f"ms_deform_attn_t: B {b} x {c} channels x HW {hw} "
                         f"is beyond the relayout's grid")
    piece = 16 // esize
    return dict(c=c, tile_c=RELAYOUT_TILE_C, tile_p=RELAYOUT_TILE_P,
                pitch=RELAYOUT_TILE_P + (2 if esize == 2 else 1),
                threads=RELAYOUT_THREADS, grid=grid, piece=piece,
                ld_vec=int(hw % piece == 0 and values_t_ptr % 16 == 0),
                st_vec=int(c % piece == 0))


# ---- K5-g1 (csrc/stamp_scatter.cu, csrc/owner_scatter.cuh) ---------------
# A block of STAMP_WARPS warps owns one row (b, h) and `tile` consecutive
# cells, each warp the cells c (tile-local) with stamp_owner(c) == its
# index. Tiles are powers of two from 8 cells, STAMP_TILE where that gives
# at least one block an SM (STAMP_MIN_BLOCKS), halved until it does or
# reaches 8 (the kernel takes up to STAMP_MAX_TILE). Timed on an H100 at
# the RT-DETR-L levels against 128 and 512, 256 cells were best or within
# 8% of the best tile in both gw layouts: larger tiles leave fewer blocks
# an SM (shared memory), smaller ones make more blocks scan idx.
STAMP_WARPS = 8
STAMP_MAX_TILE = 512
STAMP_TILE = 256
STAMP_MIN_BLOCKS = 132
STAMP_CHUNK = 2048           # taps a block scans a pass
STAMP_LIST = 2 * STAMP_CHUNK  # taps a block lists before it adds them
STAMP_RING = 64              # a warp's queue of taps


def stamp_owner(c: int) -> int:
    """The warp of a K5-g1 block that owns tile-local cell c (c < 512), as
    csrc/stamp_scatter.cu hashes it: the taps piled on one map row or
    column (clamped samples outside the map) spread over the warps, and
    four neighbour cells share one."""
    c >>= 2
    return (c ^ (c >> 3) ^ (c >> 6)) & (STAMP_WARPS - 1)


@functools.lru_cache(maxsize=None)
def _stamp_tile(rows: int, hw: int) -> int:
    tile = STAMP_TILE
    while tile > STAMP_WARPS and tile // 2 >= hw:
        tile //= 2
    while tile > STAMP_WARPS and rows * -(-hw // tile) < STAMP_MIN_BLOCKS:
        tile //= 2
    return tile


def stamp_plan(rows: int, hw: int, t: int, dh: int, ptrs,
               tap_stride: int) -> Dict[str, int]:
    """Launch plan of K5-g1 on `rows` rows of `t` taps into `hw` cells of
    `dh` channels, with base pointers `ptrs` (idx, gw) and gw's taps
    `tap_stride` elements apart (1 in the reference's layout, dh in the
    row layout): tile (cells a block: block i owns row i // tiles, cells
    from (i % tiles) * tile; its warps own them by :func:`stamp_owner`),
    tiles (a row), blocks, smem (bytes of shared memory a block), ivec
    (16-byte loads of idx: t a multiple of 8, idx aligned) and pairs (one
    8-byte load for two neighbour taps: tap stride 1, t even, gw 8-byte
    aligned). The tile, and so the cells each warp owns, depend on (rows,
    hw) alone, never on the data, the pointers or gw's layout."""
    if min(rows, hw, t, dh) <= 0:
        raise ValueError(f"stamp_scatter takes non-empty tensors, got rows "
                         f"{rows}, hw {hw}, T {t}, dh {dh}")
    tile = _stamp_tile(rows, hw)
    tiles = -(-hw // tile)
    if rows * tiles > _INT_MAX or t > _INT_MAX - 2 * STAMP_CHUNK:
        raise ValueError(f"stamp_scatter: {rows} rows of {t} taps into "
                         f"{hw} cells are beyond the kernel's int32 counts")
    return dict(tile=tile, tiles=tiles, blocks=rows * tiles,
                smem=4 * (32 * (tile + 1) + STAMP_LIST + 2 * STAMP_WARPS
                          + STAMP_WARPS * STAMP_RING),
                ivec=int(t % 8 == 0 and ptrs[0] % 16 == 0),
                pairs=int(tap_stride == 1 and t % 2 == 0
                          and ptrs[1] % 8 == 0))


# ---- K5 and K5-g2 backward (csrc/deform_bwd.cu) --------------------------
# The taps kernel runs K5 forward's lanes (one warp per (batch, query,
# head)); the scatter is K5-g1's owner scatter (csrc/owner_scatter.cuh).
# The taps of a (batch, head) row are written level-major, (level, query,
# point, corner): tap k = (l P + p) 4 + corner of query q at
# :func:`deform_bwd_tap_index`. Each level is tiled on its own, so that a
# scatter block scans one level's taps, its warps owning the cells of
# :func:`stamp_owner`; block i owns row i // tiles. Timed on an H100 at the
# RT-DETR-L train shapes (tools/profile_torch_deform_cuts.py), tiles of 256
# cells at every level beat smaller tiles for the coarse levels (256 / 64 /
# 16 cells: 1.5x slower; 256 / 128 / 64: 1.1x): every block scans its whole
# level, so more blocks cost more than longer walks.
def deform_bwd_tap_index(q: int, k: int, n_q: int, n_p: int) -> int:
    """Where the taps kernel writes tap k (corner k % 4 of point k // 4 =
    (level, point)) of query q in its (batch, head) row of cell and coef:
    level-major, so that a level's taps are one range and, within it, in
    the order (query, point, corner)."""
    tpq = 4 * n_p
    return k // tpq * n_q * tpq + q * tpq + k % tpq


def deform_bwd_tile(plan, shapes, t: int):
    """(level, first cell, cells) of tile t of a row of the scatter: the
    (t - first)-th tile of the level whose tiles hold t."""
    start = 0
    for l, (h, w) in enumerate(shapes):
        n = -(-h * w // plan["level_tiles"][l])
        if t < n:
            tile = plan["level_tiles"][l]
            return l, start + t * tile, min(tile, h * w - t * tile)
        t -= n
        start += h * w
    raise IndexError("no such tile")


def deform_bwd_scan(plan, shapes, t: int):
    """(ta, tb): the taps of its row that the scatter block of tile t scans,
    those of the tile's level."""
    level = deform_bwd_tile(plan, shapes, t)[0]
    return level * plan["taps_per_level"], (level + 1) * plan["taps_per_level"]


def deform_bwd_plan(rows: int, shapes, n_q: int, n_p: int, dh: int,
                    esize: int, values_ptr: int,
                    transposed: bool) -> Dict[str, int]:
    """Launch plan of the deformable-attention backward (K5 and K5-g2) on
    `rows` (batch, head) rows of value maps of `shapes` ((H_l, W_l), ...)
    with dh channels of `esize` bytes at `values_ptr`, n_q queries and n_p
    points a level; transposed: values_t (B, heads, dh, HW). The taps
    kernel's lanes as :func:`deform_fwd_plan` gives them (vec, row_lanes,
    slots, passes, rounds, fixed), vec 16 bytes of channels where `values`
    rows are whole aligned 16-byte pieces or, for values_t (element loads
    HW apart), where dh is a multiple of that many channels. The scatter's:
    level_tiles (cells a tile of each level: :func:`stamp_plan`'s tile for
    the row's cells, halved while a level needs no more than half of it),
    tiles (a row), blocks, smem (bytes a block), taps (a row, L x
    taps_per_level, taps_per_level = n_q x taps_per_query = n_q x 4 n_p),
    ivec (16-byte loads of the cell buffer: taps_per_level a multiple of 8)
    and svec (channels a store of d(values) in the `values` layout: 16
    bytes where dh allows; 0 for values_t, stored with lanes along cells).
    The tiles, and so the cells each warp owns, depend on (rows, shapes)
    alone."""
    cells = [h * w for h, w in shapes]
    hw, n_l = sum(cells), len(cells)
    if min(rows, n_q, n_l, n_p, dh, *cells) <= 0:
        raise ValueError(f"ms_deform_attn backward takes non-empty tensors, "
                         f"got rows {rows}, shapes {tuple(shapes)}, Q {n_q}, "
                         f"P {n_p}, dh {dh}")
    v16 = 16 // esize
    if transposed:
        vec = v16 if dh % v16 == 0 else 1
    else:
        vec = v16 if (dh * esize) % 16 == 0 and values_ptr % 16 == 0 else 1
    plan = _lanes(n_l, n_p, dh, vec)
    tile = _stamp_tile(rows, hw)
    level_tiles = []
    for c in cells:
        t = tile
        while t > STAMP_WARPS and t // 2 >= c:
            t //= 2
        level_tiles.append(t)
    tiles = sum(-(-c // t) for c, t in zip(cells, level_tiles))
    tpq = 4 * n_p
    tpl = n_q * tpq
    if rows * tiles > _INT_MAX or n_l * tpl > _INT_MAX - 2 * STAMP_CHUNK:
        raise ValueError(f"ms_deform_attn backward: {rows} rows of "
                         f"{n_l * tpl} taps into {hw} cells are beyond the "
                         f"kernels' int32 counts")
    plan.update(level_tiles=tuple(level_tiles), tiles=tiles,
                blocks=rows * tiles,
                smem=4 * (32 * (max(level_tiles) + 1) + STAMP_LIST
                          + 2 * STAMP_WARPS + STAMP_WARPS * STAMP_RING),
                taps_per_query=tpq, taps_per_level=tpl, taps=n_l * tpl,
                ivec=int(tpl % 8 == 0),
                svec=0 if transposed else (v16 if (dh * esize) % 16 == 0
                                           else 1))
    return plan


# ---- K1, the training corruption (csrc/corrupt.cu) -----------------------
# A 2-D grid of tiles per image, CORRUPT_TW pixels x CORRUPT_TH rows; blur
# and lowres stage the tile and its halo (+-k/2 pixels; +-2 rows and +-2
# pixels) in shared memory, each staged row a whole number of 16-byte
# chunks from a 16-byte aligned start, positions outside the image holding
# the pixel reflect-101 maps them to.
CORRUPT_TW, CORRUPT_TH = 64, 16
CORRUPT_SMEM_LIMIT = 232448


def _ceil4(n: int) -> int:
    return -(-n // 4) * 4


def corrupt_stage_width(hx: int, c: int) -> int:
    """Floats of a staged row for a halo of hx pixels (csrc/corrupt.cu's
    stage_width)."""
    return _ceil4((CORRUPT_TW + 2 * hx) * c) + 4


def corrupt_plan(b: int, h: int, w: int, c: int, blur_k: int,
                 ptrs) -> Dict:
    """K1's launch plan for (b, h, w, c) f32 images: the grid of tiles, the
    blur halo, the dynamic shared bytes (the larger of blur's staged rows
    and lowres' staged rows plus its horizontal-FIR buffer) and vec, 1 when
    every row is 16-byte aligned (w * c a multiple of 4 and every pointer
    of `ptrs`, x and y, 16-byte aligned): 16-byte loads, stores and
    cp.async, else element ones."""
    if not 0 < b <= 65535 or c <= 0 or h < 8 or w < 8 or h % 2 or w % 2:
        raise ValueError(f"K1 takes 1 to 65535 images of even H, W >= 8 and "
                         f"C >= 1, got {(b, h, w, c)}")
    if blur_k <= 0 or blur_k % 2 == 0 or blur_k // 2 >= w:
        raise ValueError(f"K1 takes an odd blur kernel narrower than 2 W - "
                         f"1 (reflect-101 stays in the image), got {blur_k} "
                         f"at W {w}")
    if h * w * c >= 2 ** 31:
        raise ValueError(f"K1 indexes an image with 32 bits, got "
                         f"{(h, w, c)}")
    r = blur_k // 2
    blur = CORRUPT_TH * corrupt_stage_width(r, c) * 4
    lowres = (CORRUPT_TH + 4) * (corrupt_stage_width(2, c)
                                 + CORRUPT_TW * c) * 4
    smem = max(blur, lowres)
    if smem > CORRUPT_SMEM_LIMIT:
        raise ValueError(f"K1's tile of {c} channels needs {smem} bytes of "
                         f"shared memory, more than {CORRUPT_SMEM_LIMIT}")
    return dict(grid=(-(-w // CORRUPT_TW), -(-h // CORRUPT_TH), b), h=h, w=w,
                c=c, halo=r, smem=smem,
                vec=int((w * c) % 4 == 0 and all(p % 16 == 0 for p in ptrs)))


def _reflect_clamp(i, n: int):
    import numpy as np
    i = np.abs(i)
    i = np.where(i >= n, 2 * n - 2 - i, i)
    return np.clip(i, 0, n - 1)


def corrupt_window(plan: Dict, bx: int, by: int, hx: int, hy: int):
    """What tile (bx, by) stages for a halo of hx pixels and hy rows: (the
    image rows of its staged rows, the row floats x * C + c of its staged
    columns, a, the row float of staged column 0), in shared-memory order,
    reflect-101 then clamped into the image (csrc/corrupt.cu's stage)."""
    import numpy as np
    h, w, c = plan["h"], plan["w"], plan["c"]
    x0, y0 = bx * CORRUPT_TW, by * CORRUPT_TH
    a = ((x0 - hx) * c) // 4 * 4
    g = a + np.arange(corrupt_stage_width(hx, c))
    px = g // c
    rows = _reflect_clamp(y0 - hy + np.arange(CORRUPT_TH + 2 * hy), h)
    return rows, _reflect_clamp(px, w) * c + (g - px * c), a


def corrupt_tile_floats(plan: Dict, bx: int, by: int, vec: bool):
    """The flat indices (y * W + x) * C + c of one image that tile (bx, by)
    writes, in the order of its threads' loop (16-byte units when vec)."""
    import numpy as np
    w, c = plan["w"], plan["c"]
    twc = CORRUPT_TW * c
    x0, y0 = bx * CORRUPT_TW, by * CORRUPT_TH
    fn = min(CORRUPT_TW, w - x0) * c
    rows = min(CORRUPT_TH, plan["h"] - y0)
    unit = 4 if vec else 1
    e = np.arange(CORRUPT_TH * twc // unit)
    r, f = e // (twc // unit), unit * (e % (twc // unit))
    keep = (r < rows) & (f < fn)
    start = (y0 + r[keep]) * (w * c) + x0 * c + f[keep]
    return (start[:, None] + np.arange(unit)).ravel()


# ---- K6, the auction matcher (csrc/auction.cu) ---------------------------
# One block an image; -cost staged transposed in shared memory, a GT's row
# of qs values (Q rounded up to 4) contiguous, as many rows as fit beside
# the per-query and per-column state. The sections of the layout, each
# rounded up to 16 bytes, mirror auction.cu's `layout`.
AUCTION_SMEM_LIMIT = 232448 - 1024


def _round16(n: int) -> int:
    return -(-n // 16) * 16


def auction_plan(q: int, m: int) -> Dict[str, int]:
    """K6's launch plan for cost (B, q, m): qs, the staged row's length;
    state, the shared bytes of everything but the staged rows (a query's
    price, best bid, owner and best free column in the greedy; a column's
    list entry, best free query in the greedy and flag; the free-query
    flags); cap, the rows that fit beside it (at most m); smem, the dynamic
    shared bytes. A launch stages min(valid GTs, cap) rows, the first valid
    columns in index order (the greedy completion stages further columns
    up to cap); any others are read from cost where they lie."""
    if q <= 0 or m <= 0:
        raise ValueError(f"auction_assignment takes Q, M > 0, got {q}, {m}")
    qs = -(-q // 4) * 4
    state = (_round16(qs * 4) + _round16(q * 8) + 2 * _round16(q * 4)
             + 2 * _round16(m * 4) + _round16(m) + _round16(qs))
    if state > AUCTION_SMEM_LIMIT:
        raise ValueError(f"auction_assignment: Q {q}, M {m} need {state} "
                         f"bytes of per-query and per-column state in shared "
                         f"memory, more than {AUCTION_SMEM_LIMIT}")
    cap = min(m, (AUCTION_SMEM_LIMIT - state) // (qs * 4))
    return dict(qs=qs, state=state, cap=cap, smem=state + cap * qs * 4)


def auction_rows_staged(plan: Dict[str, int], n_valid: int) -> int:
    """The rows an image with `n_valid` valid GTs stages."""
    return min(n_valid, plan["cap"])


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
