"""Native (C++) tier of the port's host code: lazy g++ builds + ctypes
bindings.

Each shared library is compiled on first use with g++ -O3 into a
per-source-hash cache of the port's own (``_build/native`` of this package,
or ``ROBUST_OD_TORCH_NATIVE_CACHE``), so the two packages never share a
``.so``; importing this module never builds anything.

  * ``coco_match.cc``: the COCOeval matcher core (the port's own copy of
    robust_object_detection_tpu/native). Optional: callers check
    :func:`available` and fall back to the numpy path;
    ``ROBUST_OD_DISABLE_NATIVE`` switches it off.
  * ``jpeg.cc``: the host JPEG codec (:func:`jpeg_probe`,
    :func:`jpeg_decode`, :func:`jpeg_encode`). It has no fallback: a failed
    build raises with g++'s stderr, and ``ROBUST_OD_DISABLE_NATIVE`` does
    not switch it off. Built without ``-march=native``: its integer
    arithmetic is the same on every x86-64 host. ctypes releases the GIL
    during each call, so threads decode and encode in parallel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

_SRC = Path(__file__).parent / "coco_match.cc"
_JPEG_SRC = Path(__file__).parent / "jpeg.cc"
_lib: Optional[ctypes.CDLL] = None
_tried = False
_jpeg: Optional[ctypes.CDLL] = None
_jpeg_lock = threading.Lock()
# -fwrapv: the codec's 32-bit products and sums wrap, as libjpeg-turbo's
# SIMD lanes do
_JPEG_FLAGS = ("-O3", "-fwrapv")


def _compile(src_path: Path, flags) -> Path:
    """The cached ``.so`` of `src_path` built with `flags`; raises
    RuntimeError with g++'s stderr where the build fails."""
    src = src_path.read_text()
    tag = hashlib.sha256((src + " ".join(flags)).encode()).hexdigest()[:16]
    cache = Path(os.environ.get("ROBUST_OD_TORCH_NATIVE_CACHE",
                                src_path.parent.parent / "_build" / "native"))
    cache.mkdir(parents=True, exist_ok=True)
    so = cache / f"{src_path.stem}_{tag}.so"
    if not so.exists():
        tmp = so.with_suffix(f".so.{os.getpid()}.{threading.get_ident()}.tmp")
        cmd = ["g++", *flags, "-shared", "-fPIC", "-std=c++17",
               str(src_path), "-o", str(tmp)]
        try:
            res = subprocess.run(cmd, capture_output=True, text=True,
                                 timeout=300)
        except (OSError, subprocess.SubprocessError) as e:
            raise RuntimeError(f"g++ could not build {src_path.name}: "
                               f"{e}") from e
        if res.returncode != 0:
            raise RuntimeError(f"g++ failed to build {src_path.name} "
                               f"(exit {res.returncode}):\n{res.stderr}")
        os.replace(tmp, so)
    return so


def _build() -> Optional[ctypes.CDLL]:
    try:
        lib = ctypes.CDLL(str(_compile(_SRC, ["-O3", "-march=native"])))
    except (OSError, RuntimeError):
        return None
    f = lib.coco_match_image_category
    f.restype = ctypes.c_int
    f.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
        ctypes.c_int,
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(ctypes.c_float), ctypes.c_int,
        ctypes.c_double, ctypes.c_double, ctypes.c_int,
        ctypes.POINTER(ctypes.c_double), ctypes.c_int,
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(ctypes.c_uint8),
    ]
    return lib


def get_lib() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if not _tried:
        _tried = True
        if os.environ.get("ROBUST_OD_DISABLE_NATIVE"):
            _lib = None
        else:
            _lib = _build()
    return _lib


def available() -> bool:
    return get_lib() is not None


def _cptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def match_image_category(dt_boxes: np.ndarray, dt_scores: np.ndarray,
                         gt_boxes: np.ndarray, gt_crowd: np.ndarray,
                         gt_areas: np.ndarray, area_rng, max_dets: int,
                         iou_thrs: np.ndarray):
    """Native counterpart of coco_map._match_image_category.

    Returns (dt_scores_sorted, matched (T, D) bool, dt_ignore (T, D) bool,
    n_pos) with D = min(len(dt), max_dets).
    """
    lib = get_lib()
    assert lib is not None
    n_dt = len(dt_scores)
    n_gt = len(gt_crowd)
    t = len(iou_thrs)
    d = min(n_dt, max_dets)

    dtb = np.ascontiguousarray(dt_boxes, np.float32)
    dts = np.ascontiguousarray(dt_scores, np.float32)
    gtb = np.ascontiguousarray(gt_boxes, np.float32)
    gtc = np.ascontiguousarray(gt_crowd, np.uint8)
    gta = np.ascontiguousarray(gt_areas, np.float32)
    thrs = np.ascontiguousarray(iou_thrs, np.float64)

    out_scores = np.zeros(d, np.float32)
    out_matched = np.zeros(t * d, np.uint8)
    out_ignore = np.zeros(t * d, np.uint8)
    n_pos = lib.coco_match_image_category(
        _cptr(dtb, ctypes.c_float), _cptr(dts, ctypes.c_float), n_dt,
        _cptr(gtb, ctypes.c_float), _cptr(gtc, ctypes.c_uint8),
        _cptr(gta, ctypes.c_float), n_gt,
        float(area_rng[0]), float(area_rng[1]), max_dets,
        _cptr(thrs, ctypes.c_double), t,
        _cptr(out_scores, ctypes.c_float),
        _cptr(out_matched, ctypes.c_uint8),
        _cptr(out_ignore, ctypes.c_uint8))
    return (out_scores, out_matched.reshape(t, d).astype(bool),
            out_ignore.reshape(t, d).astype(bool), int(n_pos))


# ── The host JPEG codec (jpeg.cc) ───────────────────────────────────────

def jpeg_lib() -> ctypes.CDLL:
    """The codec's library, built at the first call; raises RuntimeError
    with g++'s stderr where it cannot be built."""
    global _jpeg
    with _jpeg_lock:
        if _jpeg is None:
            lib = ctypes.CDLL(str(_compile(_JPEG_SRC, _JPEG_FLAGS)))
            c_int_p = ctypes.POINTER(ctypes.c_int)
            lib.rod_jpeg_probe.restype = ctypes.c_int
            lib.rod_jpeg_probe.argtypes = [
                ctypes.c_char_p, ctypes.c_size_t, c_int_p, c_int_p, c_int_p,
                c_int_p, ctypes.c_char_p, ctypes.c_int]
            lib.rod_jpeg_decode.restype = ctypes.c_int
            lib.rod_jpeg_decode.argtypes = [
                ctypes.c_char_p, ctypes.c_size_t, ctypes.c_void_p,
                ctypes.c_int, ctypes.c_int, ctypes.c_char_p, ctypes.c_int]
            lib.rod_jpeg_encode_bound.restype = ctypes.c_size_t
            lib.rod_jpeg_encode_bound.argtypes = [ctypes.c_int, ctypes.c_int]
            lib.rod_jpeg_encode.restype = ctypes.c_int
            lib.rod_jpeg_encode.argtypes = [
                ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_void_p, ctypes.c_size_t,
                ctypes.POINTER(ctypes.c_size_t), ctypes.c_char_p,
                ctypes.c_int]
            _jpeg = lib
    return _jpeg


_ERR = 512


def jpeg_probe(data: bytes, name="JPEG"):
    """(width, height, components, progressive) from the first SOFn
    marker; ValueError naming `name` and the cause where there is none."""
    lib = jpeg_lib()
    w, h, c, p = (ctypes.c_int() for _ in range(4))
    err = ctypes.create_string_buffer(_ERR)
    if lib.rod_jpeg_probe(data, len(data), w, h, c, p, err, _ERR):
        raise ValueError(f"{name}: {err.value.decode()}")
    return w.value, h.value, c.value, bool(p.value)


def jpeg_decode(data: bytes, name="JPEG") -> np.ndarray:
    """JPEG bytes -> a writable (H, W, 3) uint8 RGB array, equal to
    libjpeg-turbo's output at its defaults; ValueError naming `name` and
    the cause for a file it cannot decode."""
    w, h, _, _ = jpeg_probe(data, name)
    out = np.empty((h, w, 3), np.uint8)
    err = ctypes.create_string_buffer(_ERR)
    if jpeg_lib().rod_jpeg_decode(data, len(data), out.ctypes.data, w, h,
                                  err, _ERR):
        raise ValueError(f"{name}: {err.value.decode()}")
    return out


def jpeg_encode(img: np.ndarray, quality: int) -> bytes:
    """(H, W, 3) uint8 RGB -> baseline 4:2:0 JPEG bytes at `quality`
    (1-100), equal to libjpeg-turbo's at its defaults."""
    img = np.ascontiguousarray(img)
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"JPEG writer takes (H, W, 3) uint8 RGB, got "
                         f"{img.dtype} {img.shape}")
    lib = jpeg_lib()
    h, w = img.shape[:2]
    cap = lib.rod_jpeg_encode_bound(w, h)
    out = np.empty(cap, np.uint8)
    n = ctypes.c_size_t()
    err = ctypes.create_string_buffer(_ERR)
    if lib.rod_jpeg_encode(img.ctypes.data, w, h, int(quality),
                           out.ctypes.data, cap, ctypes.byref(n), err, _ERR):
        raise ValueError(f"JPEG encode: {err.value.decode()}")
    return out[:n.value].tobytes()
