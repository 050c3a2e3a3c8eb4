"""Native (C++) tier of the host scorer: lazy g++ build + ctypes bindings
with fallback (the port's own copy of robust_object_detection_tpu/native).

The COCOeval matcher core. The shared library is compiled on first use
with g++ -O3 into a per-source-hash cache of the port's own (``_build/
native`` of this package, or ``ROBUST_OD_TORCH_NATIVE_CACHE``), so the two
packages never share a ``.so``; import NEVER fails — callers check
:func:`available` and fall back to the numpy path.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Optional

import numpy as np

_SRC = Path(__file__).parent / "coco_match.cc"
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _build() -> Optional[ctypes.CDLL]:
    src = _SRC.read_text()
    tag = hashlib.sha256(src.encode()).hexdigest()[:16]
    cache = Path(os.environ.get("ROBUST_OD_TORCH_NATIVE_CACHE",
                                _SRC.parent.parent / "_build" / "native"))
    cache.mkdir(parents=True, exist_ok=True)
    so = cache / f"coco_match_{tag}.so"
    if not so.exists():
        tmp = so.with_suffix(f".so.{os.getpid()}.tmp")
        cmd = ["g++", "-O3", "-march=native", "-shared", "-fPIC",
               "-std=c++17", str(_SRC), "-o", str(tmp)]
        try:
            subprocess.run(cmd, check=True, capture_output=True,
                           timeout=120)
        except (OSError, subprocess.SubprocessError):
            return None
        os.replace(tmp, so)
    try:
        lib = ctypes.CDLL(str(so))
    except OSError:
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
