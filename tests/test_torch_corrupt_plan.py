"""K1 (``csrc/corrupt.cu``) as redesigned for Hopper, held on the CPU:

  * the tile plan (``kernels.corrupt_plan``, ``corrupt_tile_floats``)
    writes every output element of an image exactly once, at 1024 x 1024
    x 3, at 8 x 8 x 3 and at H, W that are no multiple of the tile, in
    16-byte units and element by element;
  * a torch model of a tile's work on what it stages
    (``corrupt_window``: the tile and its halo, positions outside the
    image holding the pixel reflect-101 maps them to): lowres as the
    horizontal FIR once per staged row, then the vertical FIR on that
    buffer; blur as k taps along the staged row summed from 0. Both are
    bit-equal to the plain version ``fused_corruption_reference``;
  * the wrapper, through a recording stand-in for the kernel library,
    passes the plan (shared bytes, 16-byte route) in one launch.
"""

import numpy as np
import pytest
import torch
from test_torch_deform_plan import lib  # noqa: F401 (fixture)
from test_torch_front_plan import recorder  # noqa: F401 (fixture)

from robust_object_detection_tpu_torch import kernels as K
from robust_object_detection_tpu_torch.core.config import CorruptionConfig
from robust_object_detection_tpu_torch.ops import fused_corrupt as FC

torch.set_num_threads(1)

CFG = CorruptionConfig()
ALIGNED = (0, 0)
# (H, W, C): the train shape's image, the smallest one K1 takes, and maps
# no multiple of the 64 x 16 tile (ragged last column band and row band)
SHAPES = [(1024, 1024, 3), (8, 8, 3), (18, 70, 3), (40, 130, 3),
          (34, 66, 4), (10, 12, 1)]


def _image(seed, h, w, c):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(np.floor(rng.uniform(0, 256, (h, w, c)))
                            .astype(np.float32))


@pytest.mark.parametrize("vec", [True, False])
@pytest.mark.parametrize("shape", SHAPES)
def test_tiles_write_every_element_once(shape, vec):
    h, w, c = shape
    plan = K.corrupt_plan(1, h, w, c, CFG.blur_kernel, ALIGNED)
    vec = vec and bool(plan["vec"])     # 16-byte units where rows allow
    gx, gy, _ = plan["grid"]
    hits = np.zeros(h * w * c, np.int64)
    for by in range(gy):
        for bx in range(gx):
            np.add.at(hits, K.corrupt_tile_floats(plan, bx, by, vec), 1)
    assert (hits == 1).all()


def _tiles(plan):
    gx, gy, _ = plan["grid"]
    return [(bx, by) for by in range(gy) for bx in range(gx)]


def _staged(flat, plan, bx, by, hx, hy):
    rows, floats, a = K.corrupt_window(plan, bx, by, hx, hy)
    return flat[torch.from_numpy(rows)][:, torch.from_numpy(floats)], a


def _pair(a, b):
    return (a + b) * 0.5


def _fir(s1, s2):
    return 0.75 * s1 + 0.25 * s2


def lowres_model(img, plan):
    """A tile at a time: stage rows y0-2 .. y0+TH+1 and pixels x0-2 ..
    x0+TW+1, the horizontal FIR of every staged row at the tile's columns,
    then the vertical FIR on that buffer."""
    h, w, c = img.shape
    flat = img.reshape(h, w * c)
    out = torch.full_like(flat, float("nan"))
    tw, th = K.CORRUPT_TW, K.CORRUPT_TH
    for bx, by in _tiles(plan):
        s, a = _staged(flat, plan, bx, by, 2, 2)
        x0, y0 = bx * tw, by * th
        px = torch.arange(x0, min(x0 + tw, w))
        q1 = torch.where(px % 2 == 0, px, px - 1)
        q2 = torch.where(px % 2 == 0, px - 2, px + 1)
        ch = torch.arange(c)

        def col(q):            # staged column of pixel q, every channel
            return (q[:, None] * c + ch - a).reshape(-1)
        hb = _fir(_pair(s[:, col(q1)], s[:, col(q1 + 1)]),
                  _pair(s[:, col(q2)], s[:, col(q2 + 1)]))   # (TH+4, fn)
        for r in range(min(th, h - y0)):
            y = y0 + r
            r1, r2 = (y, y - 2) if y % 2 == 0 else (y - 1, y + 1)
            j1, j2 = r1 - y0 + 2, r2 - y0 + 2
            v = _fir(_pair(hb[j1], hb[j1 + 1]), _pair(hb[j2], hb[j2 + 1]))
            out[y, x0 * c:x0 * c + v.numel()] = torch.clamp(
                torch.floor(v + 0.5), 0.0, 255.0)
    return out.reshape(h, w, c)


def blur_model(img, plan, k):
    """A tile at a time: stage the tile's rows and pixels x0-k/2 ..
    x0+TW+k/2-1, then k taps along the staged row, summed from 0."""
    h, w, c = img.shape
    flat = img.reshape(h, w * c)
    out = torch.full_like(flat, float("nan"))
    tw, th, r = K.CORRUPT_TW, K.CORRUPT_TH, k // 2
    for bx, by in _tiles(plan):
        s, a = _staged(flat, plan, bx, by, r, 0)
        x0, y0 = bx * tw, by * th
        f = torch.arange(x0 * c, min(x0 + tw, w) * c)
        rows = min(th, h - y0)
        acc = torch.zeros(rows, f.numel())
        for t in range(-r, r + 1):
            acc = acc + s[:rows, f + t * c - a]
        out[y0:y0 + rows, f] = torch.clamp(torch.round(acc * (1.0 / k)),
                                           0.0, 255.0)
    return out.reshape(h, w, c)


@pytest.mark.parametrize("shape", SHAPES)
def test_staged_lowres_is_bit_equal_to_the_plain_version(shape):
    img = _image(0, *shape)
    plan = K.corrupt_plan(1, *shape, CFG.blur_kernel, ALIGNED)
    ref = FC.fused_corruption_reference(img[None], torch.tensor([3]),
                                        torch.tensor([0]))[0]
    assert torch.equal(lowres_model(img, plan), ref)


@pytest.mark.parametrize("k", [9, 3, 15])
@pytest.mark.parametrize("shape", SHAPES)
def test_staged_blur_is_bit_equal_to_the_plain_version(shape, k):
    if k // 2 >= shape[1]:
        pytest.skip("wider than the image")
    img = _image(1, *shape)
    cfg = CorruptionConfig(blur_kernel=k)
    plan = K.corrupt_plan(1, *shape, k, ALIGNED)
    ref = FC.fused_corruption_reference(img[None], torch.tensor([2]),
                                        torch.tensor([0]), cfg)[0]
    assert torch.equal(blur_model(img, plan, k), ref)


@pytest.mark.parametrize("shape,ptrs,vec", [
    ((2, 1024, 1024, 3), (0, 0), 1),
    ((2, 8, 8, 3), (0, 0), 1),
    ((2, 8, 10, 3), (0, 0), 0),        # W * C = 30: rows not 16-byte aligned
    ((2, 16, 16, 3), (4, 0), 0),       # misaligned x
    ((2, 16, 16, 3), (0, 8), 0)])      # misaligned y
def test_plan_takes_16_bytes_only_where_allowed(shape, ptrs, vec):
    plan = K.corrupt_plan(*shape, CFG.blur_kernel, ptrs)
    assert plan["vec"] == vec
    assert plan["smem"] <= K.CORRUPT_SMEM_LIMIT
    b, h, w, c = shape
    assert plan["grid"] == (-(-w // 64), -(-h // 16), b)


@pytest.mark.parametrize("args", [
    (0, 8, 8, 3, 9), (1, 9, 8, 3, 9), (1, 8, 6, 3, 9), (1, 8, 8, 3, 8),
    (1, 8, 8, 3, 17), (1, 8, 8, 2000, 9), (70000, 8, 8, 3, 9)])
def test_plan_refuses_what_the_kernel_cannot_take(args):
    with pytest.raises(ValueError):
        K.corrupt_plan(*args, ALIGNED)


@pytest.mark.parametrize("w,vec", [(24, 1), (10, 0)])
def test_wrapper_passes_the_plan_in_one_launch(lib, w, vec):
    img = _image(3, 2 * 16, w, 3).reshape(2, 16, w, 3).contiguous()
    choice = torch.tensor([1, 3], dtype=torch.int32)
    seeds = torch.tensor([5, 6], dtype=torch.int32)
    before = FC.fused_random_corruption.launches
    out = FC._corrupt_cuda(img, choice, seeds, CFG)
    assert FC.fused_random_corruption.launches == before + 1
    assert list(lib.calls) == ["corrupt_nhwc"]
    args = lib.calls["corrupt_nhwc"]
    plan = K.corrupt_plan(2, 16, w, 3, CFG.blur_kernel,
                          (img.data_ptr() % 16, out.data_ptr() % 16))
    assert args[:4] == (img.data_ptr(), out.data_ptr(), choice.data_ptr(),
                        seeds.data_ptr())
    assert args[4:8] == (2, 16, w, 3)
    assert args[9] == CFG.blur_kernel
    assert args[11:] == (plan["smem"], plan["vec"], 0)
    assert plan["vec"] == vec and out.shape == img.shape
