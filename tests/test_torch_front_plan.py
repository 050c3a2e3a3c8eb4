"""The launch plans of K2's tensor-core kernels, bf16 and f32
(robust_object_detection_tpu_torch/kernels: front_plan, front_bwd_plan,
FRONT_ROUTES) and the parity decomposition of K2-b's dA1, held on the CPU:

  * every pixel tile of P1, P2, dA1, dk2 and dk1 belongs to exactly one
    persistent block or pixel chunk;
  * the statistics and dgamma / dbeta partials the wrapper allocates are
    one row per block of the launch the kernel is given (P = blocks), and
    the filter-gradient scratch holds every chunk's partial; the wrappers
    run here against a recording stand-in for the kernel library;
  * the plans are fixed for a shape and a card: they do not depend on the
    tensors' addresses, so a repeated run sums in the same order;
  * 16-byte staging only where channel counts, W and pointers allow it;
  * shapes the kernels cannot take raise ValueError;
  * the four tap sets of the transposed stride-2 conv, each run as a plain
    stride-1 F.conv2d, give the autograd dX of P2, odd H/4 and W/4
    included.
"""

import contextlib

import pytest
import torch
import torch.nn.functional as F

from robust_object_detection_tpu_torch import kernels as K
from robust_object_detection_tpu_torch.ops import yolo_front as TF

torch.set_num_threads(1)

H100_SMS = 132
# (B, H, W, C1, C2): the train step's and the sweep's shapes, the card
# tests' odd ones (odd H/4, W/4; C1, C2 not multiples of 8), a wide front
SHAPES = [(16, 1024, 1024, 48, 96), (8, 1024, 1024, 48, 96),
          (2, 64, 64, 48, 96), (2, 34, 46, 16, 24), (1, 20, 36, 12, 20),
          (1, 16, 32, 64, 128), (3, 2, 2, 5, 7)]
ALIGNED = (0, 256, 512, 768, 1024)
DTYPES = ["bfloat16", "float32"]
# The taps of a stride-2, pad-1 3x3 conv's input gradient by the parity of
# the input row (or column), as front_da1_tc_kernel (csrc/front_tc.cuh)
# indexes them, {tap: offset}: input row 2 i takes tap 1 from output row i;
# input row 2 i + 1 takes tap 0 from row i + 1 and tap 2 from row i.
PARITY_TAPS = ({1: 0}, {0: 1, 2: 0})


def _owned(tiles, n):
    return sorted(t for c in range(n) for t in K.chunk_tiles(tiles, n, c))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", SHAPES)
def test_every_tile_belongs_to_one_block_or_chunk(shape, dtype):
    b, h, w, c1, c2 = shape
    h2, w2 = h // 2, w // 2
    h4, w4 = -(-h2 // 2), -(-w2 // 2)
    fw = K.front_plan(dtype, *shape, ALIGNED[:3], H100_SMS)
    bw = K.front_bwd_plan(dtype, *shape, ALIGNED, H100_SMS)
    def count(hh, ww, th, tw):
        return b * -(-hh // th) * -(-ww // tw)
    for tiles, n, want in (
            (fw["p1"]["tiles"], fw["p1"]["blocks"], count(h2, w2, 8, 16)),
            (fw["p2"]["tiles"], fw["p2"]["blocks"], count(h4, w4, 8, 16)),
            (bw["da_tiles"], bw["da_blocks"], count(h2, w2, 16, 32)),
            (bw["dk2_tiles"], bw["dk2_chunks"], count(h4, w4, 4, 16)),
            (bw["dk1_tiles"], bw["dk1_chunks"], count(h2, w2, 8, 16))):
        assert tiles == want and 1 <= n <= tiles
        assert _owned(tiles, n) == list(range(tiles))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", SHAPES)
def test_plans_are_fixed_for_a_shape(shape, dtype):
    def counts(ptrs):
        fw = K.front_plan(dtype, *shape, ptrs[:3], H100_SMS)
        bw = K.front_bwd_plan(dtype, *shape, ptrs, H100_SMS)
        return (fw["p1"]["blocks"], fw["p2"]["blocks"], bw["da_blocks"],
                bw["dk2_chunks"], bw["dk1_chunks"])
    runs = {counts(p) for p in (ALIGNED, (2, 18, 32, 6, 4096), ALIGNED,
                                (16 * 999,) * 5)}
    assert len(runs) == 1


# blocks (or chunks) an SM of P1, P2, dA1, dk2 and dk1: what each kernel's
# shared memory allows (bf16: 34, 214, 164, 81, 73 KB; f32: 64, 224, 212,
# 225, 202 KB), f32's filter gradients four times that (shorter
# tensor-core accumulation chains)
PER_SM = {"bfloat16": (4, 1, 1, 2, 2), "float32": (3, 1, 1, 4, 4)}


@pytest.mark.parametrize("dtype", DTYPES)
def test_path_shapes_fill_the_card(dtype):
    """At (16 or 8, 1024, 1024, 3) -> 48 -> 96 on 132 SMs: one
    channel slice each (dk2: two of its 48 y2 channels), 16-byte staging
    everywhere, about the blocks an SM that each kernel's shared memory
    allows."""
    p1, p2, da, dk2, dk1 = PER_SM[dtype]
    assert tuple(K.FRONT_ROUTES[dtype]["per_sm"].values()) == PER_SM[dtype]
    for batch in (16, 8):
        fw = K.front_plan(dtype, batch, 1024, 1024, 48, 96, ALIGNED[:3],
                          H100_SMS)
        assert fw["p1"] == dict(tiles=batch * 64 * 32, co_chunks=1, vec=1,
                                blocks=p1 * H100_SMS)
        assert fw["p2"] == dict(tiles=batch * 32 * 16, co_chunks=1, vec=1,
                                blocks=p2 * H100_SMS)
        bw = K.front_bwd_plan(dtype, batch, 1024, 1024, 48, 96, ALIGNED,
                              H100_SMS)
        assert (bw["vec"], bw["vec_x"], bw["da_co_chunks"]) == (1, 1, 1)
        assert bw["da_blocks"] == da * H100_SMS
        assert bw["dk2_chunks"] == dk2 * H100_SMS // 2   # over 2 slices
        assert bw["dk1_chunks"] == dk1 * H100_SMS


# ptrs: x, k1, k2, dy2 (the wrapper's own y1, y2 are aligned); the
# expected (p1, p2, vec, vec_x) by dtype. bf16 stages 8 channels a piece
# and the forward's filters by cp.async; f32 4 channels a piece (x: W a
# multiple of 4) and the forward's filters element by element
# (transposed and split), so k1 and k2 decide only K2-b's staging.
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("c1,c2,w,ptrs,want", [
    (48, 96, 64, (0, 256, 512, 768), dict(bfloat16=(1, 1, 1, 1),
                                          float32=(1, 1, 1, 1))),
    (16, 24, 46, (0, 256, 512, 768), dict(bfloat16=(0, 1, 1, 0),
                                          float32=(0, 1, 1, 0))),  # W
    (16, 24, 60, (0, 256, 512, 768), dict(bfloat16=(0, 1, 1, 0),
                                          float32=(1, 1, 1, 1))),  # W 4k
    (12, 20, 64, (0, 256, 512, 768), dict(bfloat16=(0, 0, 0, 0),
                                          float32=(1, 1, 1, 1))),
    (10, 20, 64, (0, 256, 512, 768), dict(bfloat16=(0, 0, 0, 0),
                                          float32=(1, 0, 0, 0))),
    (48, 20, 64, (0, 256, 512, 768), dict(bfloat16=(1, 0, 0, 0),
                                          float32=(1, 1, 1, 1))),
    (48, 96, 64, (2, 256, 512, 768), dict(bfloat16=(0, 1, 1, 0),
                                          float32=(0, 1, 1, 0))),  # x
    (48, 96, 64, (0, 8, 8, 768), dict(bfloat16=(0, 0, 0, 0),
                                      float32=(1, 1, 0, 0))),  # k1, k2
    (48, 96, 64, (0, 256, 512, 24), dict(bfloat16=(1, 1, 0, 0),
                                         float32=(1, 1, 0, 0)))])  # dy2
def test_16_byte_staging_only_where_allowed(c1, c2, w, ptrs, want, dtype):
    x, k1, k2, dy2 = ptrs
    fw = K.front_plan(dtype, 2, 32, w, c1, c2, (x, k1, k2), H100_SMS)
    bw = K.front_bwd_plan(dtype, 2, 32, w, c1, c2, (x, k2, 0, 0, dy2),
                          H100_SMS)
    assert (fw["p1"]["vec"], fw["p2"]["vec"], bw["vec"],
            bw["vec_x"]) == want[dtype]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [(0, 8, 8, 4, 4), (1, 1, 8, 4, 4),
                                   (1, 8, 0, 4, 4), (1, 8, 8, 0, 4),
                                   (1, 8, 8, 4, 0),
                                   (2 ** 20, 2 ** 12, 2 ** 12, 48, 96)])
def test_plans_refuse_shapes_the_kernels_cannot_take(shape, dtype):
    with pytest.raises(ValueError):
        K.front_plan(dtype, *shape, ALIGNED[:3], H100_SMS)
    with pytest.raises(ValueError):
        K.front_bwd_plan(dtype, *shape, ALIGNED, H100_SMS)
    with pytest.raises(KeyError):
        K.front_plan("float16", 1, 8, 8, 4, 4, ALIGNED[:3], H100_SMS)


class _Recorder:
    """Stands in for the kernel library: records each entry point's
    arguments, launches nothing and returns 0."""

    def __init__(self):
        self.calls = {}

    def __getattr__(self, name):
        def fn(*args):
            self.calls[name] = args
            return 0
        return fn


@pytest.fixture
def recorder(monkeypatch):
    """The wrappers' launch path on CPU tensors: the recording library, a
    132-SM card, and every tensor the wrapper allocates kept by address."""
    lib = _Recorder()
    made = {}
    real_empty, real_like = torch.empty, torch.empty_like

    def keep(t):
        made[t.data_ptr()] = t
        return t
    monkeypatch.setattr(K, "load", lambda: lib)
    monkeypatch.setattr(K, "sm_count", lambda dev: H100_SMS)
    monkeypatch.setattr(K, "stream_ptr", lambda dev: 0)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch, "empty",
                        lambda *a, **k: keep(real_empty(*a, **k)))
    monkeypatch.setattr(torch, "empty_like",
                        lambda *a, **k: keep(real_like(*a, **k)))
    return lib, made


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", [(2, 64, 64, 48, 96), (2, 34, 46, 16, 24),
                                   (1, 16, 32, 64, 128)])
def test_wrappers_allocate_one_partial_row_per_block(recorder, shape,
                                                     dtype):
    lib, made = recorder
    b, h, w, c1, c2 = shape
    name = str(dtype).split(".")[-1]
    route = K.FRONT_ROUTES[name]
    x = torch.rand(b, h, w, 3).to(dtype)
    k1 = torch.randn(3, 3, 3, c1)
    k2 = torch.randn(3, 3, c1, c2)
    sc1, bi1 = torch.ones(c1), torch.zeros(c1)
    TF._FrontFused.apply(x, k1, sc1, bi1, k2)
    assert set(lib.calls) == {route["train"]}
    args = lib.calls[route["train"]]
    assert args[15:20] == (b, h, w, c1, c2)
    blocks1, blocks2 = args[20:22]
    fw = K.front_plan(name, b, h, w, c1, c2, (args[0], args[1], args[4]),
                      H100_SMS)
    assert (blocks1, blocks2) == (fw["p1"]["blocks"], fw["p2"]["blocks"])
    assert made[args[7]].numel() == 2 * blocks1 * c1     # stats1
    assert made[args[8]].numel() == 2 * blocks2 * c2     # stats2

    h2, w2 = h // 2, w // 2
    h4, w4 = -(-h2 // 2), -(-w2 // 2)
    y1 = torch.zeros(b, h2, w2, c1, dtype=dtype)
    y2 = torch.zeros(b, h4, w4, c2, dtype=dtype)
    vec1, vec2 = torch.ones(c1), torch.ones(c2)
    TF._launch_backward(x, k2.to(dtype), y1, y2, vec1, vec1, vec1, vec1,
                        vec1, vec2, torch.zeros_like(y2), vec1, vec1, vec2,
                        vec2)
    args = lib.calls[route["bwd"]]
    assert args[24:29] == (b, h, w, c1, c2)
    da_blocks, dk2_chunks, dk1_chunks = args[29:32]
    bw = K.front_bwd_plan(name, b, h, w, c1, c2, tuple(args[:5]), H100_SMS)
    assert (da_blocks, dk2_chunks, dk1_chunks) == (
        bw["da_blocks"], bw["dk2_chunks"], bw["dk1_chunks"])
    assert made[args[16]].shape == y2.shape              # e2
    assert made[args[17]].numel() == 2 * da_blocks * c1  # gpart
    assert made[args[18]].numel() == max(dk2_chunks * 9 * c1 * c2,
                                         dk1_chunks * 27 * c1)   # wpart


@pytest.mark.parametrize("shape", [(2, 8, 12, 5, 7), (1, 9, 7, 4, 6),
                                   (2, 16, 16, 8, 8), (1, 1, 3, 3, 2)])
def test_parity_decomposition_gives_the_transposed_conv(shape):
    """dX of y2 = conv3x3/2(a1, k2) (pad 1) through four stride-1 convs,
    one per (row, column) parity class of the a1 pixel, over dy2 padded by
    one zero row and column at the far end: the sub-filter of a class
    holds the taps of PARITY_TAPS, ordered by their offset."""
    b, h2, w2, c1, c2 = shape
    g = torch.Generator().manual_seed(0)
    a1 = torch.randn(b, c1, h2, w2, generator=g, dtype=torch.float64,
                     requires_grad=True)
    k2 = torch.randn(c2, c1, 3, 3, generator=g, dtype=torch.float64)
    y2 = F.conv2d(a1, k2, stride=2, padding=1)
    h4, w4 = y2.shape[2:]
    assert (h4, w4) == (-(-h2 // 2), -(-w2 // 2))
    dy2 = torch.randn(y2.shape, generator=g, dtype=torch.float64)
    (ref,) = torch.autograd.grad(y2, a1, dy2)

    dx = torch.zeros_like(ref)
    padded = F.pad(dy2, (0, 1, 0, 1))
    for py in (0, 1):
        for px in (0, 1):
            ty, tx = PARITY_TAPS[py], PARITY_TAPS[px]
            ky = sorted(ty, key=ty.get)      # tap at offset 0, then 1
            kx = sorted(tx, key=tx.get)
            sub = k2[:, :, ky][:, :, :, kx].transpose(0, 1)  # (c1, c2, ., .)
            out = F.conv2d(padded, sub)
            ny, nx = len(range(py, h2, 2)), len(range(px, w2, 2))
            if ny and nx:
                dx[:, :, py::2, px::2] = out[:, :, :ny, :nx]
    torch.testing.assert_close(dx, ref, rtol=1e-12, atol=1e-12)
