"""Host image path: decode, encode, header sizes and the bilinear resize.

Every host decode, encode and resize of the port goes through this module,
on every machine, and none of it needs PIL or cv2. The codec is chosen by
the file's suffix (.jpg / .jpeg, .png, .bmp).

  * JPEG: the port's own codec in C++ (``native/jpeg.cc``, built with g++
    at the first call, no fallback). The decoder returns what
    ``Image.open(p).convert("RGB")`` and ``cv2.imread(p)[:, :, ::-1]``
    return (libjpeg-turbo at its defaults), byte for byte: baseline,
    extended and progressive Huffman, grey and three components at any
    integral sampling, restart intervals. Arithmetic coding, lossless,
    12-bit, CMYK / YCCK and truncated or corrupt data raise ValueError
    naming the file and the cause. The writer's bytes are those of
    ``Image.fromarray(img).save(p, quality=q)`` (baseline 4:2:0, the
    Annex K tables scaled to q, JFIF 1.01).
  * PNG: a numpy codec over the standard library's zlib. It reads 8-bit
    grey, grey + alpha, RGB, RGBA and palette images (and 1, 2 and 4-bit
    grey and palette), every filter, any IDAT split, CRCs checked; alpha
    is dropped as ``convert("RGB")`` drops it. Adam7 interlacing and 16-bit
    samples raise. The writer takes (H, W, 3) uint8 and makes the file
    Pillow makes: its per-row filter choice (None, Up, Sub, Paeth by the
    least sum of distances from zero), zlib level 6, memory level 9,
    Z_FILTERED, IDAT chunks of max(65536, 4 W) bytes; the bytes equal
    Pillow's where the standard library's zlib is the one Pillow links,
    the pixels everywhere.
  * BMP: a numpy codec for 24-bit uncompressed (BI_RGB) bottom-up
    bitmaps. The writer's bytes are the ones PIL's
    ``Image.fromarray(img).save(path)`` writes for an RGB array: a 54-byte
    header, 3780 pixels a metre, BGR rows bottom-up, each padded with zeros
    to 4 bytes. Any other bitmap (8 or 32 bits, top-down, RLE or bit
    fields) raises, naming what it found.
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
import zlib
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from .. import native

BMP_EXTS = (".bmp",)
JPEG_EXTS = (".jpg", ".jpeg")
PNG_EXTS = (".png",)
IMAGE_EXTS = JPEG_EXTS + PNG_EXTS + BMP_EXTS

_BMP_PPM = 3780                 # 96 dpi, as PIL writes it
_COEF_BITS = 11                 # cv2's INTER_RESIZE_COEF_BITS
_COEF_SCALE = 1 << _COEF_BITS
_PNG_SIG = b"\x89PNG\r\n\x1a\n"
_PNG_BLOCK = 65536              # PIL's ImageFile.MAXBLOCK


def _suffix(path) -> str:
    return Path(path).suffix.lower()


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


# ── PNG ──────────────────────────────────────────────────────────────────

# colour type -> (samples a pixel, the bit depths read)
_PNG_TYPES = {0: (1, (1, 2, 4, 8)), 2: (3, (8,)), 3: (1, (1, 2, 4, 8)),
              4: (2, (8,)), 6: (4, (8,))}


def _png_chunks(data: bytes, path):
    """(type, body) of each chunk up to IEND, CRCs checked."""
    if data[:8] != _PNG_SIG:
        raise ValueError(f"{path}: not a PNG file (no PNG signature)")
    pos = 8
    while True:
        if pos + 12 > len(data):
            raise ValueError(f"{path}: truncated PNG (no IEND chunk)")
        n, = struct.unpack_from(">I", data, pos)
        kind = data[pos + 4:pos + 8]
        if pos + 12 + n > len(data):
            raise ValueError(f"{path}: truncated PNG (the {kind!r} chunk "
                             f"runs past the end)")
        body = data[pos + 8:pos + 8 + n]
        crc, = struct.unpack_from(">I", data, pos + 8 + n)
        if zlib.crc32(kind + body) != crc:
            raise ValueError(f"{path}: corrupt PNG (CRC of the {kind!r} "
                             f"chunk)")
        yield kind, body
        if kind == b"IEND":
            return
        pos += 12 + n


def _png_unfilter(raw: np.ndarray, ftype: np.ndarray, bpp: int
                  ) -> np.ndarray:
    """Undo the five PNG filters of (H, U, bpp) filtered bytes (U units of
    bpp bytes a row). A unit needs its left, upper and upper-left
    neighbours, so the rows are skewed (row r shifted right by r) and the
    skewed columns, each a vector over every row, are done in turn: the
    left neighbour is in the column before, the upper one in the column
    before one row up, the upper-left one two columns before. Cells left
    of the image stay 0, the PNG edge; cells right of it are never read."""
    h, u = raw.shape[:2]
    n = h + u - 1
    f = np.zeros((n + 2, h, bpp), np.int16)     # skewed, two zero columns
    rr, cc = np.meshgrid(np.arange(h), np.arange(u), indexing="ij")
    f[rr + cc + 2, rr] = raw
    t = ftype.astype(np.int16)[:, None]
    m_sub, m_up, m_avg, m_paeth = (t == 1, t == 2, t == 3, t == 4)
    x = np.zeros((n + 2, h + 1, bpp), np.int16)  # row 0: above the image
    for d in range(2, n + 2):
        a = x[d - 1, 1:]
        b = x[d - 1, :-1]
        ul = x[d - 2, :-1]
        pa, pb, pc = np.abs(b - ul), np.abs(a - ul), np.abs(a + b - 2 * ul)
        paeth = np.where((pa <= pb) & (pa <= pc), a,
                         np.where(pb <= pc, b, ul))
        pred = (m_sub * a + m_up * b + m_avg * ((a + b) >> 1)
                + m_paeth * paeth)
        x[d, 1:] = (f[d] + pred) & 255
    return x[rr + cc + 2, rr + 1].astype(np.uint8)


def read_png(path) -> np.ndarray:
    """A PNG file -> (H, W, 3) uint8 RGB, as ``Image.open(p).convert("RGB")``
    returns it."""
    data = Path(path).read_bytes()
    head, palette, idat = None, None, []
    for kind, body in _png_chunks(data, path):
        if kind == b"IHDR":
            head = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
    if head is None:
        raise ValueError(f"{path}: PNG without an IHDR chunk")
    w, h, depth, ctype, method, fmethod, interlace = head
    if interlace:
        raise ValueError(f"{path}: Adam7 interlaced PNG is not supported")
    if depth == 16:
        raise ValueError(f"{path}: 16-bit PNG is not supported; only 8-bit "
                         f"(and 1, 2, 4-bit grey or palette)")
    if ctype not in _PNG_TYPES or depth not in _PNG_TYPES[ctype][1]:
        raise ValueError(f"{path}: PNG colour type {ctype} at {depth} bits "
                         f"is not a valid PNG")
    if method or fmethod or w == 0 or h == 0:
        raise ValueError(f"{path}: PNG header {head}")
    if ctype == 3 and palette is None:
        raise ValueError(f"{path}: palette PNG without a PLTE chunk")
    channels = _PNG_TYPES[ctype][0]
    bpp = max(1, channels * depth // 8)
    row = (w * channels * depth + 7) // 8
    z = zlib.decompressobj()
    try:
        flat = z.decompress(b"".join(idat))
    except zlib.error as e:
        raise ValueError(f"{path}: corrupt PNG image data ({e})") from e
    if not z.eof or len(flat) < h * (row + 1):
        raise ValueError(f"{path}: truncated PNG image data")
    rows = np.frombuffer(flat, np.uint8, h * (row + 1)).reshape(h, row + 1)
    ftype = rows[:, 0]
    if (ftype > 4).any():
        raise ValueError(f"{path}: corrupt PNG (filter type "
                         f"{int(ftype.max())})")
    px = _png_unfilter(rows[:, 1:].reshape(h, row // bpp, bpp), ftype, bpp)
    px = px.reshape(h, row)
    if depth < 8:                        # packed samples, high bits first
        bits = np.unpackbits(px, axis=1).reshape(h, -1, depth)
        vals = (bits * (1 << np.arange(depth - 1, -1, -1, dtype=np.uint8))
                ).sum(-1, dtype=np.uint8)[:, :w]
        if ctype == 0:
            vals = vals * np.uint8(255 // ((1 << depth) - 1))
        px = vals
    px = px.reshape(h, w, channels)
    if ctype == 3:
        lut = np.zeros((256, 3), np.uint8)
        lut[:len(palette)] = palette[:256]
        return lut[px[:, :, 0]]
    if ctype in (0, 4):
        return np.repeat(px[:, :, :1], 3, axis=2)
    return np.ascontiguousarray(px[:, :, :3])


def _png_chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body)))


def png_bytes(img: np.ndarray) -> bytes:
    """(H, W, 3) uint8 RGB -> the PNG PIL writes for it (see the module
    docstring)."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"PNG writer takes (H, W, 3) uint8 RGB, got "
                         f"{img.dtype} {img.shape}")
    h, w = img.shape[:2]
    x = img.reshape(h, w * 3)
    a = np.zeros_like(x)
    a[:, 3:] = x[:, :-3]                 # left
    b = np.zeros_like(x)
    b[1:] = x[:-1]                       # up
    c = np.zeros_like(x)
    c[1:, 3:] = x[:-1, :-3]              # upper left
    ai, bi, ci = (v.astype(np.int16) for v in (a, b, c))
    pa, pb, pc = np.abs(bi - ci), np.abs(ai - ci), np.abs(ai + bi - 2 * ci)
    paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    # PIL tries None, Up, Sub, Paeth in turn and keeps the first least sum
    # of distances from zero (a byte v counts min(v, 256 - v))
    ftypes = np.array([0, 2, 1, 4], np.uint8)
    cand = np.stack([x, x - b, x - a, x - paeth])       # uint8: mod 256
    cost = np.minimum(cand, -cand).sum(-1, dtype=np.int64)
    pick = cost.argmin(0)
    filtered = np.concatenate([ftypes[pick][:, None],
                               cand[pick, np.arange(h)]], axis=1)
    z = zlib.compressobj(6, zlib.DEFLATED, 15, 9, zlib.Z_FILTERED)
    stream = z.compress(filtered.tobytes()) + z.flush()
    block = max(_PNG_BLOCK, 4 * w)
    head = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    return (_PNG_SIG + _png_chunk(b"IHDR", head)
            + b"".join(_png_chunk(b"IDAT", stream[i:i + block])
                       for i in range(0, len(stream), block))
            + _png_chunk(b"IEND", b""))


# ── JPEG ─────────────────────────────────────────────────────────────────

def read_jpeg(path) -> np.ndarray:
    """A JPEG file -> (H, W, 3) uint8 RGB through the native codec."""
    return native.jpeg_decode(Path(path).read_bytes(), str(path))


def jpeg_bytes(img: np.ndarray, quality: Optional[int] = 95) -> bytes:
    """(H, W, 3) uint8 RGB -> the JPEG PIL writes at `quality` (None: PIL's
    default, libjpeg's 75)."""
    return native.jpeg_encode(img, 75 if quality is None else quality)


# ── By suffix ────────────────────────────────────────────────────────────

def read_rgb(path) -> np.ndarray:
    """Decode an image file to a writable (H, W, 3) uint8 RGB array."""
    ext = _suffix(path)
    if ext in JPEG_EXTS:
        return read_jpeg(path)
    if ext in PNG_EXTS:
        return read_png(path)
    if ext in BMP_EXTS:
        return read_bmp(path)
    raise _unsupported(path)


def write_rgb(path, img: np.ndarray, quality: Optional[int] = 95) -> None:
    """Encode (H, W, 3) uint8 RGB: JPEG at `quality` (None: PIL's
    default, 75), PNG and BMP lossless."""
    ext = _suffix(path)
    if ext in BMP_EXTS:
        data = bmp_bytes(img)
    elif ext in JPEG_EXTS:
        data = jpeg_bytes(img, quality)
    elif ext in PNG_EXTS:
        data = png_bytes(img)
    else:
        raise _unsupported(path)
    Path(path).write_bytes(data)


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
