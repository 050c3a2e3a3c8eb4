"""Host image path: decode, encode, header sizes and the bilinear resize.

Every host decode, encode and resize of the port goes through this module,
on every machine, chosen by the file suffix:

  * ``.bmp``: a numpy codec for 24-bit uncompressed (BI_RGB) bottom-up
    bitmaps. The writer's bytes are the ones PIL's
    ``Image.fromarray(img).save(path)`` writes for an RGB array: a 54-byte
    header, 3780 pixels a metre, BGR rows bottom-up, each padded with zeros
    to 4 bytes. Any other bitmap (8 or 32 bits, top-down, RLE or bit
    fields) raises, naming what it found. A BMP split is lossless, so it
    keeps the frozen testsets' bit parity, and it needs no library: it is
    the format that runs on a machine with neither PIL nor cv2.
  * ``.jpg`` / ``.jpeg`` / ``.png``: PIL, imported at the call. Where PIL is
    not installed the call raises, saying that the format needs PIL.
  * :func:`image_size` reads only the header: BMP, PNG (IHDR) and JPEG (the
    first SOFn marker), equal to PIL's ``Image.open(p).size``.
  * :func:`resize_linear_u8` is a numpy copy of
    ``cv2.resize(img, (nw, nh), interpolation=cv2.INTER_LINEAR)`` on uint8
    HWC images, equal to it byte for byte: cv2's 11-bit fixed-point
    coefficients, its integer horizontal pass and the rounding of its
    vectorized vertical pass; an exact 0.5x on both axes is cv2's
    INTER_AREA 2x2 mean, as cv2 itself switches to it.
"""

from __future__ import annotations

import struct
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

BMP_EXTS = (".bmp",)
PIL_EXTS = (".jpg", ".jpeg", ".png")
IMAGE_EXTS = PIL_EXTS + BMP_EXTS

_BMP_PPM = 3780                 # 96 dpi, as PIL writes it
_COEF_BITS = 11                 # cv2's INTER_RESIZE_COEF_BITS
_COEF_SCALE = 1 << _COEF_BITS


def _suffix(path) -> str:
    return Path(path).suffix.lower()


def _pil_image():
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(
            "reading or writing .jpg / .jpeg / .png needs PIL, which is not "
            "installed here; use a .bmp split (the numpy codec of "
            "data/imageio.py)") from e
    return Image


def _unsupported(path) -> ValueError:
    return ValueError(f"{path}: unsupported image format "
                      f"{_suffix(path)!r}; expected one of {IMAGE_EXTS}")


# ── BMP ──────────────────────────────────────────────────────────────────

def _bmp_header(data: bytes, path) -> Tuple[int, int, int]:
    """(width, height, pixel offset) of a 24-bit BI_RGB bottom-up bitmap;
    raises for any other."""
    if len(data) < 54 or data[:2] != b"BM":
        raise ValueError(f"{path}: not a BMP file (no 'BM' signature)")
    offset, = struct.unpack_from("<I", data, 10)
    info, = struct.unpack_from("<I", data, 14)
    if info < 40:
        raise ValueError(f"{path}: BMP core header of {info} bytes "
                         f"(OS/2 1.x) is not supported; only the 40-byte "
                         f"BITMAPINFOHEADER and its successors")
    width, height, planes, bits, compression = struct.unpack_from(
        "<iiHHI", data, 18)
    if bits != 24:
        raise ValueError(f"{path}: {bits}-bit BMP is not supported; only "
                         f"24-bit")
    if compression != 0:
        names = {1: "RLE8", 2: "RLE4", 3: "BI_BITFIELDS", 4: "JPEG",
                 5: "PNG", 6: "BI_ALPHABITFIELDS"}
        raise ValueError(f"{path}: BMP compression "
                         f"{names.get(compression, compression)} is not "
                         f"supported; only uncompressed BI_RGB")
    if height < 0:
        raise ValueError(f"{path}: top-down BMP (negative height) is not "
                         f"supported; only bottom-up")
    if width <= 0 or height == 0 or planes != 1:
        raise ValueError(f"{path}: BMP with width {width}, height "
                         f"{height}, planes {planes}")
    return width, height, offset


def read_bmp(path) -> np.ndarray:
    """A 24-bit BI_RGB bottom-up BMP -> (H, W, 3) uint8 RGB."""
    data = Path(path).read_bytes()
    w, h, offset = _bmp_header(data, path)
    stride = (w * 3 + 3) & ~3
    if len(data) < offset + stride * h:
        raise ValueError(f"{path}: truncated BMP ({len(data)} bytes, "
                         f"{offset + stride * h} needed)")
    rows = np.frombuffer(data, np.uint8, stride * h, offset)
    rows = rows.reshape(h, stride)[::-1, :w * 3].reshape(h, w, 3)
    return np.ascontiguousarray(rows[:, :, ::-1])


def bmp_bytes(img: np.ndarray) -> bytes:
    """(H, W, 3) uint8 RGB -> the bytes of the BMP PIL writes for it."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"BMP writer takes (H, W, 3) uint8 RGB, got "
                         f"{img.dtype} {img.shape}")
    h, w = img.shape[:2]
    stride = (w * 3 + 3) & ~3
    size = stride * h
    rows = np.zeros((h, stride), np.uint8)
    rows[:, :w * 3] = img[::-1, :, ::-1].reshape(h, w * 3)
    header = (b"BM" + struct.pack("<III", 54 + size, 0, 54)
              + struct.pack("<IiiHHIIiiII", 40, w, h, 1, 24, 0, size,
                            _BMP_PPM, _BMP_PPM, 0, 0))
    return header + rows.tobytes()


# ── By suffix ────────────────────────────────────────────────────────────

def read_rgb(path) -> np.ndarray:
    """Decode an image file to a writable (H, W, 3) uint8 RGB array."""
    ext = _suffix(path)
    if ext in BMP_EXTS:
        return read_bmp(path)
    if ext in PIL_EXTS:
        with _pil_image().open(path) as im:
            return np.array(im.convert("RGB"))
    raise _unsupported(path)


def write_rgb(path, img: np.ndarray, quality: Optional[int] = 95) -> None:
    """Encode (H, W, 3) uint8 RGB: JPEG at `quality` (None: PIL's
    default), PNG and BMP lossless."""
    ext = _suffix(path)
    if ext in BMP_EXTS:
        Path(path).write_bytes(bmp_bytes(img))
    elif ext in (".jpg", ".jpeg"):
        kw = {} if quality is None else {"quality": quality}
        _pil_image().fromarray(img).save(path, **kw)
    elif ext == ".png":
        _pil_image().fromarray(img).save(path)
    else:
        raise _unsupported(path)


_SOF = {0xC0, 0xC1, 0xC2, 0xC3, 0xC5, 0xC6, 0xC7, 0xC9, 0xCA, 0xCB, 0xCD,
        0xCE, 0xCF}


def _jpeg_size(path) -> Tuple[int, int]:
    with open(path, "rb") as f:
        if f.read(2) != b"\xff\xd8":
            raise ValueError(f"{path}: not a JPEG file (no SOI marker)")
        while True:
            b = f.read(1)
            if not b:
                break
            if b != b"\xff":
                continue
            marker = f.read(1)
            while marker == b"\xff":             # fill bytes
                marker = f.read(1)
            if not marker:
                break
            m = marker[0]
            if m in (0x01, 0xD8) or 0xD0 <= m <= 0xD7:
                continue                          # markers without a length
            seg = f.read(2)
            if len(seg) < 2:
                break
            length, = struct.unpack(">H", seg)
            if m in _SOF:
                body = f.read(5)
                if len(body) < 5:
                    break
                h, w = struct.unpack(">HH", body[1:5])
                return w, h
            f.seek(length - 2, 1)
    raise ValueError(f"{path}: JPEG without a SOFn marker")


def image_size(path) -> Tuple[int, int]:
    """(width, height) from the file's header only."""
    ext = _suffix(path)
    if ext in BMP_EXTS:
        with open(path, "rb") as f:
            head = f.read(54)
        w, h, _ = _bmp_header(head, path)
        return w, h
    if ext == ".png":
        with open(path, "rb") as f:
            head = f.read(24)
        if head[:8] != b"\x89PNG\r\n\x1a\n" or head[12:16] != b"IHDR":
            raise ValueError(f"{path}: not a PNG file (no IHDR)")
        return struct.unpack(">II", head[16:24])
    if ext in (".jpg", ".jpeg"):
        return _jpeg_size(path)
    raise _unsupported(path)


# ── cv2's INTER_LINEAR on uint8 ──────────────────────────────────────────

def _linear_taps(n_in: int, n_out: int, clamp: bool):
    """Source index and the two 11-bit coefficients of each output
    coordinate: f32 coordinates, floor, and on the x axis (clamp) the
    weights pinned at the borders as cv2 pins them."""
    scale = 1.0 / (n_out / n_in)
    f = ((np.arange(n_out, dtype=np.float64) + 0.5) * scale
         - 0.5).astype(np.float32)
    s = np.floor(f)
    f = (f - s).astype(np.float32)
    s = s.astype(np.int64)
    if clamp:
        lo = s < 0
        f[lo], s[lo] = 0, 0
        hi = s >= n_in - 1
        f[hi], s[hi] = 0, n_in - 1
    c0 = np.rint((np.float32(1) - f) * np.float32(_COEF_SCALE))
    c1 = np.rint(f * np.float32(_COEF_SCALE))
    return s, c0.astype(np.int32), c1.astype(np.int32)


def resize_linear_u8(img: np.ndarray, nw: int, nh: int) -> np.ndarray:
    """``cv2.resize(img, (nw, nh), interpolation=cv2.INTER_LINEAR)`` for an
    (H, W, C) uint8 image, byte for byte."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or img.ndim != 3:
        raise ValueError(f"resize_linear_u8 takes (H, W, C) uint8, got "
                         f"{img.dtype} {img.shape}")
    h, w = img.shape[:2]
    if nw <= 0 or nh <= 0:
        raise ValueError(f"resize_linear_u8: output size {nw}x{nh}")
    if (nh, nw) == (h, w):
        return img.copy()
    if w == 2 * nw and h == 2 * nh:
        # cv2 takes INTER_AREA's 2x2 mean for an exact 0.5x on both axes
        x = img.astype(np.int32)
        s = x[0::2, 0::2] + x[0::2, 1::2] + x[1::2, 0::2] + x[1::2, 1::2]
        return ((s + 2) >> 2).astype(np.uint8)
    sx, a0, a1 = _linear_taps(w, nw, clamp=True)
    sy, b0, b1 = _linear_taps(h, nh, clamp=False)
    x = img.astype(np.int32)
    sx1 = np.minimum(sx + 1, w - 1)
    rows = x[:, sx] * a0[None, :, None] + x[:, sx1] * a1[None, :, None]
    y0 = np.clip(sy, 0, h - 1)
    y1 = np.clip(sy + 1, 0, h - 1)
    t = (((rows[y0] >> 4) * b0[:, None, None]) >> 16) \
        + (((rows[y1] >> 4) * b1[:, None, None]) >> 16)
    return np.clip((t + 2) >> 2, 0, 255).astype(np.uint8)
