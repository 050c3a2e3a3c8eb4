"""The port's PNG codec (data/imageio.py, numpy over the standard library's
zlib) against Pillow and cv2.

  * every colour type Pillow writes decodes as ``Image.open(p)
    .convert("RGB")`` does (and as cv2 does): RGB, RGBA, L, LA, palette at
    8, 4, 2 and 1 bits, 1-bit grey; with and without ``optimize``;
  * all five filter types, each row's chosen by hand, and the image data
    split over many IDAT chunks;
  * the writer: a round trip exact in pixels through Pillow, cv2 and the
    port; the bytes equal Pillow's ``Image.fromarray(img).save(p)`` where
    the standard library's zlib is the one Pillow links (it is in the test
    environment), including an image wide enough for IDAT chunks of 4 W;
  * a corrupt CRC, truncated data, Adam7 and 16-bit files raise a
    ValueError naming the file and the cause; ``image_size`` equals
    Pillow's.
"""

import io
import struct
import zlib

import cv2
import numpy as np
import pytest
from PIL import Image, features

from robust_object_detection_tpu_torch.data import imageio


def _img(h, w, seed=0):
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([xx * 255 // max(w - 1, 1), yy * 255 // max(h - 1, 1),
                     (xx * yy) % 256], -1)
    return np.clip(base + rng.randint(-30, 31, (h, w, 3)), 0,
                   255).astype(np.uint8)


def _pil_png(im, **kw):
    buf = io.BytesIO()
    im.save(buf, format="PNG", **kw)
    return buf.getvalue()


def _chunk(kind, body):
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body)))


MODES = [("RGB", {}), ("RGB", {"optimize": True}), ("RGBA", {}),
         ("L", {}), ("LA", {}), ("P", {}), ("P", {"bits": 4}),
         ("P", {"bits": 2}), ("P", {"bits": 1}), ("1", {})]


@pytest.mark.parametrize("mode, kw", MODES,
                         ids=[f"{m}{kw}" for m, kw in MODES])
def test_decode_equals_pil_and_cv2(mode, kw, tmp_path):
    for i, (h, w) in enumerate(((1, 1), (5, 7), (31, 45), (64, 3))):
        im = Image.fromarray(_img(h, w, seed=i))
        if mode == "P":
            colors = 1 << kw.get("bits", 8)
            im = im.quantize(min(colors, 200))
        else:
            im = im.convert(mode)
        p = tmp_path / f"{mode}{i}.png"
        p.write_bytes(_pil_png(im, **kw))
        want = np.asarray(Image.open(p).convert("RGB"))
        ours = imageio.read_rgb(p)
        np.testing.assert_array_equal(ours, want)
        np.testing.assert_array_equal(ours, cv2.imread(str(p))[:, :, ::-1])
        assert imageio.image_size(p) == Image.open(p).size == (w, h)


def _filter_rows(img, ftypes):
    """PNG filtering (RFC 2083, 6.3) of an (H, W, 3) image with the given
    filter per row, written out the slow way."""
    h, w = img.shape[:2]
    x = img.reshape(h, w * 3).astype(int)
    out = []
    for r in range(h):
        prev = x[r - 1] if r else np.zeros(w * 3, int)
        row = [ftypes[r]]
        for i in range(w * 3):
            a = x[r, i - 3] if i >= 3 else 0
            b = prev[i]
            c = prev[i - 3] if i >= 3 else 0
            p = a + b - c
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
            paeth = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
            pred = (0, a, b, (a + b) // 2, paeth)[ftypes[r]]
            row.append((x[r, i] - pred) % 256)
        out.append(bytes(row))
    return b"".join(out)


def test_every_filter_and_many_idat_chunks(tmp_path):
    img = _img(20, 13, seed=3)
    ftypes = [r % 5 for r in range(20)]
    stream = zlib.compress(_filter_rows(img, ftypes), 9)
    head = struct.pack(">IIBBBBB", 13, 20, 8, 2, 0, 0, 0)
    data = (b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", head)
            + b"".join(_chunk(b"IDAT", stream[i:i + 7])
                       for i in range(0, len(stream), 7))
            + _chunk(b"IEND", b""))
    p = tmp_path / "f.png"
    p.write_bytes(data)
    np.testing.assert_array_equal(np.asarray(Image.open(p).convert("RGB")),
                                  img)
    np.testing.assert_array_equal(imageio.read_rgb(p), img)


@pytest.mark.parametrize("hw", [(1, 1), (5, 7), (40, 61), (3, 300),
                                (300, 17), (7, 17000)],
                         ids=lambda hw: f"{hw[0]}x{hw[1]}")
def test_write_round_trips_and_equals_pil(hw, tmp_path):
    img = _img(*hw, seed=hw[1])
    p = tmp_path / "w.png"
    imageio.write_rgb(p, img)
    np.testing.assert_array_equal(imageio.read_rgb(p), img)
    np.testing.assert_array_equal(np.asarray(Image.open(p).convert("RGB")),
                                  img)
    np.testing.assert_array_equal(cv2.imread(str(p))[:, :, ::-1], img)
    assert imageio.image_size(p) == (hw[1], hw[0])
    # the bytes are Pillow's where both use one zlib (they do here)
    assert features.version("zlib") == zlib.ZLIB_RUNTIME_VERSION
    assert p.read_bytes() == _pil_png(Image.fromarray(img))


def test_broken_files_raise(tmp_path):
    data = _pil_png(Image.fromarray(_img(9, 11)))
    p = tmp_path / "b.png"
    bad = bytearray(data)
    bad[40] ^= 0xFF                       # inside IDAT: its CRC fails
    p.write_bytes(bytes(bad))
    with pytest.raises(ValueError, match=r"b\.png: corrupt PNG \(CRC"):
        imageio.read_rgb(p)
    for cut in (len(data) - 5, 50, 20):
        p.write_bytes(data[:cut])
        with pytest.raises(ValueError, match=r"b\.png: truncated PNG"):
            imageio.read_rgb(p)
    # Adam7: the interlace byte set (and the CRC fixed)
    ihdr = bytearray(data[16:29])
    ihdr[12] = 1
    p.write_bytes(data[:8] + _chunk(b"IHDR", bytes(ihdr)) + data[33:])
    with pytest.raises(ValueError, match="Adam7"):
        imageio.read_rgb(p)
    Image.fromarray(np.zeros((4, 5), np.uint16) + 300).save(p)
    with pytest.raises(ValueError, match="16-bit PNG"):
        imageio.read_rgb(p)
    with pytest.raises(ValueError, match=r"PNG writer takes \(H, W, 3\)"):
        imageio.png_bytes(np.zeros((4, 4), np.uint8))
