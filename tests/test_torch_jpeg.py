"""The port's JPEG codec (native/jpeg.cc through data/imageio.py) against
Pillow 12.1 (libjpeg-turbo 3.1) and cv2.

  * decode: byte for byte Pillow's ``Image.open(p).convert("RGB")`` and
    ``cv2.imread(p)[:, :, ::-1]`` on a matrix, one case a row: sizes 1x1
    to 765x1360, qualities 1-100, 4:4:4 / 4:2:2 / 4:2:0, grey,
    progressive, optimised tables, restart intervals (rows and blocks),
    Adobe RGB, and cv2's 4:1:1 and 4:4:0; and a hypothesis search over
    sizes up to 70 px, qualities, subsamplings and progressive;
  * encode: the bytes of ``Image.fromarray(img).save(p, quality=q)`` at q
    75, 92 and 95 over the same sizes, and at every quality 1-100 on one;
  * truncated and corrupt streams, lossless (SOF3), arithmetic (SOF9),
    12-bit and CMYK files raise a ValueError naming the file and the cause;
  * ``image_size`` equals the codec's probe and Pillow's size;
  * the fixtures of tests/fixtures/jpeg are what tools/make_jpeg_fixtures.py
    writes, and decode to its manifest's digests; chip_smoke.py's golden
    digests are Pillow's;
  * the codec has no fallback: a failed g++ build raises, and
    ROBUST_OD_DISABLE_NATIVE does not turn it off; threads decode at once.
"""

import hashlib
import importlib.util
import io
import json
import os
import struct
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import cv2
import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st
from PIL import Image

from robust_object_detection_tpu_torch import native
from robust_object_detection_tpu_torch.data import imageio

ROOT = Path(__file__).resolve().parent.parent
FIXTURES = ROOT / "tests" / "fixtures" / "jpeg"


def _image(h, w, seed=0, grey=False):
    """A gradient with seeded noise: AC content in every block."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([xx * 255 // max(w - 1, 1), yy * 255 // max(h - 1, 1),
                     (xx + yy) * 255 // max(w + h - 2, 1)], -1)
    img = np.clip(base + rng.randint(-40, 41, (h, w, 3)), 0, 255)
    img = img.astype(np.uint8)
    return img[:, :, 0] if grey else img


def _pil_jpeg(img, **kw):
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="JPEG", **kw)
    return buf.getvalue()


def _assert_decodes_as_pil_and_cv2(data, tmp_path, name="a.jpg"):
    p = tmp_path / name
    p.write_bytes(data)
    ours = imageio.read_rgb(p)
    pil = np.asarray(Image.open(p).convert("RGB"))
    np.testing.assert_array_equal(ours, pil)
    np.testing.assert_array_equal(ours, cv2.imread(str(p))[:, :, ::-1])
    assert imageio.image_size(p) == Image.open(p).size
    w, h, comps, progressive = native.jpeg_probe(data)
    assert (w, h) == Image.open(p).size
    return comps, progressive


SIZES = [(1, 1), (7, 9), (8, 8), (15, 17), (16, 16), (33, 65), (765, 1360)]

DECODE_CASES = (
    [(f"size{h}x{w}", (h, w), {}) for h, w in SIZES]
    + [(f"q{q}", (33, 65), {"quality": q}) for q in (1, 50, 75, 92, 95, 100)]
    + [(f"subsampling{s}", (37, 51), {"subsampling": s}) for s in (0, 1, 2)]
    + [("grey", (33, 65), {"grey": True}),
       ("grey_progressive", (33, 65), {"grey": True, "progressive": True}),
       ("progressive", (33, 65), {"progressive": True}),
       ("progressive_444", (40, 23), {"progressive": True,
                                      "subsampling": 0}),
       ("progressive_422_q95", (17, 40), {"progressive": True,
                                          "subsampling": 1, "quality": 95}),
       ("optimize", (33, 65), {"optimize": True}),
       ("restart_rows", (40, 70), {"restart_marker_rows": 1}),
       ("restart_blocks", (40, 70), {"restart_marker_blocks": 3}),
       ("restart_blocks_progressive", (24, 40), {"restart_marker_blocks": 2,
                                                 "progressive": True}),
       ("adobe_rgb", (19, 29), {"keep_rgb": True, "subsampling": 0}),
       ("adobe_rgb_420", (19, 29), {"keep_rgb": True})])


@pytest.mark.parametrize("name, hw, kw", DECODE_CASES,
                         ids=[c[0] for c in DECODE_CASES])
def test_decode_equals_pil_and_cv2(name, hw, kw, tmp_path):
    kw = dict(kw)
    grey = kw.pop("grey", False)
    img = _image(*hw, seed=len(name), grey=grey)
    comps, progressive = _assert_decodes_as_pil_and_cv2(
        _pil_jpeg(img, **kw), tmp_path)
    assert comps == (1 if grey else 3)
    assert progressive == kw.get("progressive", False)


@pytest.mark.parametrize("factor", ["411", "440", "422", "420"])
def test_decode_cv2_sampling_factors(factor, tmp_path):
    """Factors Pillow does not write: 4:1:1 (box upsampling, h4v1) and
    4:4:0 (the h1v2 triangle filter), at widths 1-3 (box, not triangle,
    below a downsampled width of 3) and odd sizes."""
    flag = getattr(cv2, f"IMWRITE_JPEG_SAMPLING_FACTOR_{factor}")
    for i, (h, w) in enumerate(((1, 1), (2, 3), (3, 5), (9, 4), (33, 65),
                                (40, 17))):
        img = _image(h, w, seed=i)
        ok, enc = cv2.imencode(".jpg", img[:, :, ::-1],
                               [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, flag])
        assert ok
        _assert_decodes_as_pil_and_cv2(enc.tobytes(), tmp_path)


@settings(max_examples=40, deadline=None)
@given(h=st.integers(1, 70), w=st.integers(1, 70),
       quality=st.integers(1, 100), subsampling=st.sampled_from([0, 1, 2]),
       progressive=st.booleans(), seed=st.integers(0, 2 ** 16))
def test_decode_hypothesis(h, w, quality, subsampling, progressive, seed):
    data = _pil_jpeg(_image(h, w, seed), quality=quality,
                     subsampling=subsampling, progressive=progressive)
    ours = native.jpeg_decode(data)
    np.testing.assert_array_equal(
        ours, np.asarray(Image.open(io.BytesIO(data)).convert("RGB")))


@pytest.mark.parametrize("hw", SIZES + [(17, 300), (31, 1)],
                         ids=[f"{h}x{w}" for h, w in SIZES + [(17, 300),
                                                              (31, 1)]])
def test_encode_bytes_equal_pil(hw, tmp_path):
    img = _image(*hw, seed=hw[0] * 7 + hw[1])
    for q in (75, 92, 95):
        want = _pil_jpeg(img, quality=q)
        assert imageio.jpeg_bytes(img, q) == want, q
        imageio.write_rgb(tmp_path / "a.jpeg", img, quality=q)
        assert (tmp_path / "a.jpeg").read_bytes() == want
    imageio.write_rgb(tmp_path / "d.jpg", img, quality=None)
    assert (tmp_path / "d.jpg").read_bytes() == _pil_jpeg(img)


def test_encode_every_quality():
    img = _image(23, 37, seed=1)
    noise = np.random.RandomState(2).randint(0, 256, (23, 37, 3)).astype(
        np.uint8)
    for q in range(1, 101):
        assert imageio.jpeg_bytes(img, q) == _pil_jpeg(img, quality=q), q
        assert imageio.jpeg_bytes(noise, q) == _pil_jpeg(noise, quality=q), q


def test_encode_refuses_other_arrays():
    for bad in (np.zeros((4, 4), np.uint8), np.zeros((4, 4, 4), np.uint8),
                np.zeros((4, 4, 3), np.float32)):
        with pytest.raises(ValueError, match=r"\(H, W, 3\) uint8"):
            imageio.jpeg_bytes(bad)


def _entropy_start(data: bytes) -> int:
    """The offset of the first scan's entropy-coded data."""
    i = 2
    while True:
        n, = struct.unpack(">H", data[i + 2:i + 4])
        if data[i + 1] == 0xDA:
            return i + 2 + n
        i += 2 + n


@pytest.mark.parametrize("progressive", [False, True])
def test_truncated_and_corrupt_streams_raise(progressive, tmp_path):
    data = _pil_jpeg(_image(40, 61, seed=3), progressive=progressive)
    p = tmp_path / "t.jpg"
    for cut in (len(data) - 1, len(data) - 2, len(data) - 10,
                len(data) // 2, 300, 150, 20, 3):
        p.write_bytes(data[:cut])
        with pytest.raises(ValueError, match=r"t\.jpg: truncated"):
            imageio.read_rgb(p)
        with pytest.raises(OSError):       # Pillow raises as well
            Image.open(io.BytesIO(data[:cut])).convert("RGB")
    start = _entropy_start(data)
    bad = bytearray(data)
    bad[start:start + 64] = b"\xff\x00" * 32   # all-one codes: none valid
    p.write_bytes(bytes(bad))
    with pytest.raises(ValueError, match="corrupt entropy-coded data"):
        imageio.read_rgb(p)


@pytest.mark.parametrize("marker, message", [
    (0xC3, "lossless JPEG"), (0xC9, "arithmetic-coded JPEG"),
    (0xCA, "arithmetic-coded JPEG"), (0xC5, "hierarchical JPEG")])
def test_other_processes_raise(marker, message, tmp_path):
    data = bytearray(_pil_jpeg(_image(16, 16)))
    sof = data.index(b"\xff\xc0")
    data[sof + 1] = marker
    p = tmp_path / "x.jpg"
    p.write_bytes(bytes(data))
    with pytest.raises(ValueError, match=f"x.jpg: {message}"):
        imageio.read_rgb(p)
    assert imageio.image_size(p) == (16, 16)       # the header still reads


def test_twelve_bit_and_cmyk_raise(tmp_path):
    data = bytearray(_pil_jpeg(_image(16, 16)))
    sof = data.index(b"\xff\xc0")
    data[sof + 4] = 12
    (tmp_path / "p12.jpg").write_bytes(bytes(data))
    with pytest.raises(ValueError, match="12-bit precision"):
        imageio.read_rgb(tmp_path / "p12.jpg")
    Image.fromarray(_image(16, 16)).convert("CMYK").save(tmp_path / "k.jpg")
    with pytest.raises(ValueError, match=r"k\.jpg: four components"):
        imageio.read_rgb(tmp_path / "k.jpg")
    (tmp_path / "n.jpg").write_bytes(b"GIF89a" + bytes(20))
    with pytest.raises(ValueError, match=r"n\.jpg: not a JPEG file"):
        imageio.read_rgb(tmp_path / "n.jpg")


def test_image_size_equals_probe_and_pil(tmp_path):
    for i, (hw, kw) in enumerate(((
            (1, 1), {}), ((17, 300), {"progressive": True}),
            ((64, 9), {"subsampling": 0}), ((33, 65), {"optimize": True}))):
        data = _pil_jpeg(_image(*hw, seed=i), **kw)
        p = tmp_path / f"{i}.jpg"
        p.write_bytes(data)
        w, h, _, _ = native.jpeg_probe(data)
        assert imageio.image_size(p) == (w, h) == Image.open(p).size \
            == (hw[1], hw[0])


def _load_tool():
    spec = importlib.util.spec_from_file_location(
        "make_jpeg_fixtures", ROOT / "tools" / "make_jpeg_fixtures.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    return tool


def test_fixtures_are_the_tools_and_decode_to_the_manifest(tmp_path):
    tool = _load_tool()
    manifest = json.loads((FIXTURES / "MANIFEST.json").read_text())
    assert manifest == json.loads(json.dumps(tool.manifest()))
    assert sum(p.stat().st_size for p in FIXTURES.iterdir()) < 150_000
    for name, entry in manifest.items():
        p = FIXTURES / entry["file"]
        assert p.read_bytes() == tool.make(name), name
        px = imageio.read_rgb(p)
        assert hashlib.sha256(px.tobytes()).hexdigest() == \
            entry["pixels_sha256"], name
        np.testing.assert_array_equal(px, cv2.imread(str(p))[:, :, ::-1])


def test_chip_smoke_goldens_are_pils():
    """The SHA-256s chip_smoke.py phase 30 holds the codec to on the card
    (where there is no Pillow) are Pillow's bytes and pixels."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    for (h, w), q, file_sha, pixels_sha in smoke.JPEG_GOLDEN:
        data = _pil_jpeg(smoke.codec_image(h, w), quality=q)
        assert hashlib.sha256(data).hexdigest() == file_sha, (h, w, q)
        px = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
        assert hashlib.sha256(px.tobytes()).hexdigest() == pixels_sha


def test_threads_decode_and_encode_at_once():
    imgs = [_image(96, 128, seed=s) for s in range(8)]
    blobs = [_pil_jpeg(im, quality=90) for im in imgs]
    with ThreadPoolExecutor(4) as pool:
        dec = list(pool.map(native.jpeg_decode, blobs))
        enc = list(pool.map(lambda im: native.jpeg_encode(im, 90), imgs))
    assert enc == blobs
    for d, b in zip(dec, blobs):
        np.testing.assert_array_equal(
            d, np.asarray(Image.open(io.BytesIO(b)).convert("RGB")))


def test_a_failed_build_raises_without_fallback(monkeypatch, tmp_path):
    """No g++ (an empty cache, PATH without it), then a source g++ refuses:
    reading a JPEG raises with the cause, nothing falls back to PIL, and
    ROBUST_OD_DISABLE_NATIVE does not switch the codec off."""
    p = tmp_path / "a.jpg"
    p.write_bytes(_pil_jpeg(_image(8, 8)))
    path = os.environ["PATH"]
    monkeypatch.setenv("ROBUST_OD_DISABLE_NATIVE", "1")
    monkeypatch.setenv("ROBUST_OD_TORCH_NATIVE_CACHE", str(tmp_path / "c"))
    monkeypatch.setattr(native, "_jpeg", None)
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match=r"g\+\+ could not build jpeg.cc"):
        imageio.read_rgb(p)
    monkeypatch.setenv("PATH", path)
    bad = tmp_path / "jpeg.cc"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "_JPEG_SRC", bad)
    with pytest.raises(RuntimeError,
                       match=r"g\+\+ failed to build jpeg.cc(.|\n)*error"):
        imageio.read_rgb(p)
