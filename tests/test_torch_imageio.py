"""The port's host image path (data/imageio.py) against PIL and cv2.

  * the BMP writer's bytes equal PIL's ``Image.fromarray(img).save`` for
    widths 1-9 (every residue of the 4-byte row padding) at two heights,
    the reader returns the array exactly, and reads PIL's files;
  * every other bitmap is refused with a message naming it;
  * ``image_size`` equals PIL's ``Image.open(p).size`` on BMP, PNG and
    JPEG (baseline and progressive);
  * ``resize_linear_u8`` equals ``cv2.resize(INTER_LINEAR)`` byte for byte
    on 80 seeded random shapes up and down, on the exact 0.5x case and on
    the letterbox scales of 765x1360, 1080x1920 and 1050x1400 to a 1024
    canvas;
  * JPEG and PNG need neither PIL nor cv2 (the codecs themselves are held
    in tests/test_torch_jpeg.py and tests/test_torch_png.py).
"""

import io
import struct
import sys

import cv2
import numpy as np
import pytest
from PIL import Image

from robust_object_detection_tpu_torch.data import imageio


def _img(rng, h, w):
    return rng.randint(0, 256, (h, w, 3)).astype(np.uint8)


@pytest.mark.parametrize("w", range(1, 10))
def test_bmp_bytes_equal_pil_and_round_trip(w, tmp_path):
    rng = np.random.RandomState(w)
    for h in (1, 6):
        img = _img(rng, h, w)
        buf = io.BytesIO()
        Image.fromarray(img).save(buf, format="BMP")
        assert imageio.bmp_bytes(img) == buf.getvalue(), (h, w)
        p = tmp_path / f"a{h}.bmp"
        imageio.write_rgb(p, img)
        assert p.read_bytes() == buf.getvalue()
        np.testing.assert_array_equal(imageio.read_rgb(p), img)
        np.testing.assert_array_equal(
            np.asarray(Image.open(p).convert("RGB")), img)
        assert imageio.image_size(p) == Image.open(p).size == (w, h)


def test_reads_what_pil_writes(tmp_path):
    img = _img(np.random.RandomState(0), 37, 53)
    p = tmp_path / "pil.BMP"
    Image.fromarray(img).save(p)
    np.testing.assert_array_equal(imageio.read_rgb(p), img)


def _bmp_with(tmp_path, name, **fields):
    """A 2x3 24-bit BMP with header fields overwritten."""
    data = bytearray(imageio.bmp_bytes(np.zeros((2, 3, 3), np.uint8)))
    offsets = {"height": (22, "<i"), "bits": (28, "<H"),
               "compression": (30, "<I"), "info": (14, "<I")}
    for k, v in fields.items():
        off, fmt = offsets[k]
        struct.pack_into(fmt, data, off, v)
    p = tmp_path / name
    p.write_bytes(bytes(data))
    return p


@pytest.mark.parametrize("fields, message", [
    ({"bits": 32}, "32-bit BMP"),
    ({"bits": 8}, "8-bit BMP"),
    ({"height": -2}, "top-down BMP"),
    ({"compression": 1}, "RLE8"),
    ({"compression": 3}, "BI_BITFIELDS"),
    ({"info": 12}, "core header"),
])
def test_other_bitmaps_are_refused(fields, message, tmp_path):
    p = _bmp_with(tmp_path, "x.bmp", **fields)
    with pytest.raises(ValueError, match=message):
        imageio.read_rgb(p)
    with pytest.raises(ValueError, match=message):
        imageio.image_size(p)


@pytest.mark.parametrize("mode", ["L", "RGBA", "P"])
def test_pil_bitmaps_of_other_depths_are_refused(mode, tmp_path):
    p = tmp_path / f"{mode}.bmp"
    Image.fromarray(_img(np.random.RandomState(1), 5, 7)).convert(mode) \
        .save(p)
    with pytest.raises(ValueError, match="-bit BMP is not supported"):
        imageio.read_rgb(p)


@pytest.mark.parametrize("ext, kw", [
    ("bmp", {}), ("png", {}), ("jpg", {"quality": 95}),
    ("jpeg", {"progressive": True}), ("jpg", {"subsampling": 0})])
def test_image_size_equals_pil(ext, kw, tmp_path):
    rng = np.random.RandomState(3)
    for i, (h, w) in enumerate(((1, 1), (17, 300), (765, 1360), (64, 9))):
        p = tmp_path / f"i{i}.{ext}"
        Image.fromarray(_img(rng, h, w)).save(p, **kw)
        assert imageio.image_size(p) == Image.open(p).size == (w, h)


def test_png_and_jpeg_decode_as_pil_and_cv2(tmp_path):
    img = _img(np.random.RandomState(4), 40, 61)
    for ext in ("png", "jpg"):
        p = tmp_path / f"a.{ext}"
        imageio.write_rgb(p, img)
        out = imageio.read_rgb(p)
        np.testing.assert_array_equal(
            out, np.asarray(Image.open(p).convert("RGB")))
        np.testing.assert_array_equal(out, cv2.imread(str(p))[:, :, ::-1])
    q = tmp_path / "q.jpg"
    imageio.write_rgb(q, img, quality=None)
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="JPEG")
    assert q.read_bytes() == buf.getvalue()


def test_jpeg_and_png_need_pil(monkeypatch, tmp_path):
    """JPEG and PNG need neither PIL nor cv2 any more: with both
    unimportable, read_rgb, write_rgb and image_size succeed and equal
    what PIL gave before the block (pixels, sizes and the written bytes)."""
    img = _img(np.random.RandomState(5), 13, 21)
    before = {}
    for ext in ("png", "jpg", "jpeg"):
        p = tmp_path / f"pil.{ext}"
        Image.fromarray(img).save(p, quality=95)
        buf = io.BytesIO()
        Image.fromarray(img).save(buf, format="PNG" if ext == "png"
                                  else "JPEG", quality=95)
        before[ext] = (np.asarray(Image.open(p).convert("RGB")),
                       Image.open(p).size, buf.getvalue())
    monkeypatch.setitem(sys.modules, "PIL", None)
    monkeypatch.setitem(sys.modules, "cv2", None)
    for ext, (pixels, size, written) in before.items():
        np.testing.assert_array_equal(
            imageio.read_rgb(tmp_path / f"pil.{ext}"), pixels)
        assert imageio.image_size(tmp_path / f"pil.{ext}") == size
        imageio.write_rgb(tmp_path / f"ours.{ext}", img)
        assert (tmp_path / f"ours.{ext}").read_bytes() == written, ext
    imageio.write_rgb(tmp_path / "c.bmp", img)      # BMP as before
    np.testing.assert_array_equal(imageio.read_rgb(tmp_path / "c.bmp"), img)
    with pytest.raises(ValueError, match="unsupported image format"):
        imageio.read_rgb(tmp_path / "a.tif")


def _cv2(img, nw, nh):
    return cv2.resize(img, (nw, nh), interpolation=cv2.INTER_LINEAR)


@pytest.mark.parametrize("seed", range(8))
def test_resize_equals_cv2_on_random_shapes(seed):
    """10 shapes a seed: 80 in all, up and down on either axis, 1-400 px
    in, 1-800 out."""
    rng = np.random.RandomState(100 + seed)
    for _ in range(10):
        h, w = (int(v) for v in rng.randint(1, 401, 2))
        nh, nw = (int(v) for v in rng.randint(1, 801, 2))
        img = _img(rng, h, w)
        np.testing.assert_array_equal(imageio.resize_linear_u8(img, nw, nh),
                                      _cv2(img, nw, nh), err_msg=str(
                                          (h, w, nh, nw)))


@pytest.mark.parametrize("hw", [(765, 1360), (1080, 1920), (1050, 1400),
                                (540, 960), (800, 1400)])
def test_resize_equals_cv2_at_letterbox_scales(hw):
    h, w = hw
    img = _img(np.random.RandomState(h), h, w)
    s = min(1024 / h, 1024 / w)
    nh, nw = round(h * s), round(w * s)
    np.testing.assert_array_equal(imageio.resize_linear_u8(img, nw, nh),
                                  _cv2(img, nw, nh))


@pytest.mark.parametrize("hw", [(2, 2), (64, 96), (766, 1360), (6, 1000)])
def test_resize_half_is_cv2_area(hw):
    """An exact 0.5x on both axes: cv2 takes INTER_AREA's 2x2 mean."""
    h, w = hw
    img = _img(np.random.RandomState(w), h, w)
    out = imageio.resize_linear_u8(img, w // 2, h // 2)
    np.testing.assert_array_equal(out, _cv2(img, w // 2, h // 2))
    np.testing.assert_array_equal(
        out, cv2.resize(img, (w // 2, h // 2), interpolation=cv2.INTER_AREA))


def test_resize_edges():
    img = _img(np.random.RandomState(9), 7, 5)
    np.testing.assert_array_equal(imageio.resize_linear_u8(img, 5, 7), img)
    for nw, nh in ((1, 1), (5, 14), (10, 7), (2, 3), (11, 1)):
        np.testing.assert_array_equal(imageio.resize_linear_u8(img, nw, nh),
                                      _cv2(img, nw, nh))
    gray = img[:, :, :1].copy()
    np.testing.assert_array_equal(imageio.resize_linear_u8(gray, 9, 4),
                                  _cv2(gray, 9, 4)[:, :, None])
    with pytest.raises(ValueError, match="uint8"):
        imageio.resize_linear_u8(img.astype(np.float32), 3, 3)
