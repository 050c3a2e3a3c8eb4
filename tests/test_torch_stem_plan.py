"""The launch plans of K4's bf16 tensor-core kernels
(robust_object_detection_tpu_torch/kernels: stem_plan, stem_bwd_plan) and
the decompositions the new kernels compute, held on the CPU:

  * every pixel tile (or item) of stem1, stem2a, stem2b, stem3, d(cat),
    dk3, the concat's backward, the 2x2 filter and input gradients and dk1
    belongs to exactly one persistent block or pixel chunk;
  * the statistics and dgamma / dbeta partials the wrappers allocate are
    one row per block of the launch the kernel is given, and the filter
    gradients' scratch holds every chunk's partial; the wrappers run here
    against a recording stand-in for the kernel library;
  * the plans are fixed for a shape and a card: they do not depend on the
    tensors' addresses, so a repeated run sums in the same order;
  * 16-byte staging only where W and the pointers allow it;
  * shapes the kernels cannot take raise ValueError;
  * the 2x2 filter gradient over its own 2x2 tap range equals the [1:, 1:]
    corner of the 3x3 pad-1 gradient and the autograd of the 2x2 conv; the
    transposed 2x2 conv from the taps up and left equals its autograd dX;
    the transposed stem3 as four parity classes equals its autograd dX;
  * K2's plans (front_plan, front_bwd_plan) are those of the templates
    before they were shared with K4.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from test_torch_front_plan import (  # noqa: F401 (recorder: a fixture)
    ALIGNED, H100_SMS, PARITY_TAPS, _owned, recorder)

from robust_object_detection_tpu_torch import kernels as K
from robust_object_detection_tpu_torch.ops import stem as ST

torch.set_num_threads(1)

# (B, H, W): the train step's and the sweep's shapes, the card tests' odd
# ones (H != W, H/4 odd, W not a multiple of 8), the smallest stem
SHAPES = [(8, 1024, 1024), (2, 36, 52), (1, 20, 44), (3, 4, 8),
          (2, 128, 128)]


def _count(b, h, w, th, tw):
    return b * -(-h // th) * -(-w // tw)


@pytest.mark.parametrize("shape", SHAPES)
def test_every_tile_belongs_to_one_block_or_chunk(shape):
    b, h, w = shape
    h2, w2, h4, w4 = h // 2, w // 2, h // 4, w // 4
    fw = K.stem_plan(b, h, w, ALIGNED, H100_SMS)
    bw = K.stem_bwd_plan(b, h, w, ALIGNED, H100_SMS)
    t2 = _count(b, h2, w2, 8, 16)
    cases = [(fw["p1"]["tiles"], fw["p1"]["blocks"], t2),
             (fw["c2a"]["tiles"], fw["c2a"]["blocks"], t2),
             (fw["c2b"]["tiles"], fw["c2b"]["blocks"], t2),
             (fw["p3"]["tiles"], fw["p3"]["blocks"], _count(b, h4, w4, 8, 16)),
             (bw["da_tiles"], bw["da_blocks"], _count(b, h2, w2, 16, 32)),
             (bw["dk3_tiles"], bw["dk3_chunks"], _count(b, h4, w4, 4, 16)),
             (bw["dk1_tiles"], bw["dk1_chunks"], t2)]
    cases += [(bw[f"{k}_tiles"], bw[f"{k}_{n}"], t2) for k, n in (
        ("wg2b", "chunks"), ("dx2b", "blocks"), ("wg2a", "chunks"),
        ("dx2a", "blocks"))]
    for tiles, n, want in cases:
        assert tiles == want and 1 <= n <= tiles
        assert _owned(tiles, n) == list(range(tiles))
    # the concat's backward: block i takes items i * 256 + t, + blocks * 256
    items, blocks = bw["asm_items"], bw["asm_blocks"]
    assert items == b * h2 * w2 * 4 and 1 <= blocks <= -(-items // 256)
    stride = blocks * 256
    seen = (np.arange(stride, dtype=np.int32)[:, None]
            + stride * np.arange(-(-items // stride), dtype=np.int32)).ravel()
    seen = np.sort(seen[seen < items])
    assert np.array_equal(seen, np.arange(items, dtype=np.int32))


@pytest.mark.parametrize("shape", SHAPES)
def test_plans_are_fixed_for_a_shape(shape):
    def counts(ptrs):
        fw = K.stem_plan(*shape, ptrs, H100_SMS)
        bw = K.stem_bwd_plan(*shape, ptrs, H100_SMS)
        return (tuple(fw[k]["blocks"] for k in ("p1", "c2a", "c2b", "p3")),
                fw["stats"],
                tuple(v for k, v in sorted(bw.items())
                      if k not in ("vec", "vec_x")))
    runs = {counts(p) for p in (ALIGNED, (2, 18, 32, 6, 4096), ALIGNED,
                                (16 * 999,) * 5)}
    assert len(runs) == 1


def test_path_shapes_fill_the_card():
    """At (8, 1024, 1024, 3) on 132 SMs: 16-byte staging everywhere, about
    the blocks an SM each kernel's shared memory allows."""
    fw = K.stem_plan(8, 1024, 1024, ALIGNED, H100_SMS)
    assert fw["p1"] == dict(tiles=8 * 64 * 32, vec=1, blocks=4 * H100_SMS)
    assert fw["c2a"] == fw["c2b"] == fw["p1"]
    assert fw["p3"] == dict(tiles=8 * 32 * 16, vec=1, blocks=H100_SMS)
    assert fw["stats"] == 2 * 4 * H100_SMS * 32
    bw = K.stem_bwd_plan(8, 1024, 1024, ALIGNED, H100_SMS)
    assert (bw["vec"], bw["vec_x"]) == (1, 1)
    assert bw["da_blocks"] == H100_SMS              # 2 x 132 over 2 slices
    assert bw["dk3_chunks"] == bw["dk1_chunks"] == 2 * H100_SMS
    assert bw["wg2b_chunks"] == bw["wg2a_chunks"] == 4 * H100_SMS
    assert bw["dx2b_blocks"] == bw["dx2a_blocks"] == 3 * H100_SMS
    assert bw["asm_blocks"] == 4 * H100_SMS


# ptrs: x, k1, k2a, k2b, k3, dy3 (the wrapper's own buffers are aligned)
@pytest.mark.parametrize("w,ptrs,fwd,bwd", [
    (64, (0, 256, 512, 768, 1024, 1280), (1, 1, 1, 1), (1, 1)),
    (52, (0, 256, 512, 768, 1024, 1280), (0, 1, 1, 1), (1, 0)),  # W % 8
    (64, (2, 256, 512, 768, 1024, 1280), (0, 1, 1, 1), (1, 0)),  # x
    (64, (0, 8, 512, 768, 1024, 1280), (0, 1, 1, 1), (1, 1)),    # k1
    (64, (0, 256, 8, 768, 1024, 1280), (1, 0, 1, 1), (0, 0)),    # k2a
    (64, (0, 256, 512, 8, 1024, 1280), (1, 1, 0, 1), (0, 0)),    # k2b
    (64, (0, 256, 512, 768, 8, 1280), (1, 1, 1, 0), (0, 0)),     # k3
    (64, (0, 256, 512, 768, 1024, 24), (1, 1, 1, 1), (0, 0))])   # dy3
def test_16_byte_staging_only_where_allowed(w, ptrs, fwd, bwd):
    x, k1, k2a, k2b, k3, dy3 = ptrs
    fw = K.stem_plan(2, 32, w, (x, k1, k2a, k2b, k3), H100_SMS)
    bw = K.stem_bwd_plan(2, 32, w, (x, k2a, k2b, k3, dy3), H100_SMS)
    assert tuple(fw[k]["vec"] for k in ("p1", "c2a", "c2b", "p3")) == fwd
    assert (bw["vec"], bw["vec_x"]) == bwd


@pytest.mark.parametrize("shape", [(0, 8, 8), (1, 6, 8), (1, 8, 6),
                                   (1, 0, 8), (1, 8, -4),
                                   (2 ** 10, 2 ** 12, 2 ** 12)])
def test_plans_refuse_shapes_the_kernels_cannot_take(shape):
    with pytest.raises(ValueError):
        K.stem_plan(*shape, ALIGNED, H100_SMS)
    with pytest.raises(ValueError):
        K.stem_bwd_plan(*shape, ALIGNED, H100_SMS)


@pytest.mark.parametrize("shape", [
    ((16, 1024, 1024, 48, 96), (528, 132), (132, 132, 264)),
    ((8, 1024, 1024, 48, 96), (528, 132), (132, 132, 264)),
    ((2, 34, 46, 16, 24), (12, 4), (4, 6, 12)),
    ((1, 18, 50, 64, 128), (4, 1), (1, 2, 4))])
def test_front_plans_are_unchanged(shape):
    """K2's plans on its path and card-test shapes are the values they had
    before its templates were shared with K4."""
    (b, h, w, c1, c2), (p1, p2), (da, dk2, dk1) = shape
    fw = K.front_plan("bfloat16", b, h, w, c1, c2, ALIGNED[:3], H100_SMS)
    bw = K.front_bwd_plan("bfloat16", b, h, w, c1, c2, ALIGNED, H100_SMS)
    assert (fw["p1"]["blocks"], fw["p2"]["blocks"]) == (p1, p2)
    assert (bw["da_blocks"], bw["dk2_chunks"], bw["dk1_chunks"]) == (
        da, dk2, dk1)
    assert fw["p1"]["co_chunks"] == -(-c1 // 48)
    assert fw["p2"]["co_chunks"] == -(-c2 // 96)
    assert bw["da_co_chunks"] == -(-c1 // 48)


def _params(rng):
    def rn(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    kers = (rn(3, 3, 3, 32), rn(2, 2, 32, 16), rn(2, 2, 16, 32),
            rn(3, 3, 64, 32))
    vecs = [torch.ones(c) for c in (32, 32, 16, 16, 32, 32)]
    return (kers[0], vecs[0], vecs[1], kers[1], vecs[2], vecs[3], kers[2],
            vecs[4], vecs[5], kers[3])


@pytest.mark.parametrize("shape", [(2, 64, 64), (2, 36, 52), (1, 8, 16)])
def test_wrappers_allocate_one_partial_row_per_block(recorder, shape):
    lib, made = recorder
    b, h, w = shape
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.random((b, h, w, 3), dtype=np.float32))
    params = _params(rng)

    ST._StemFused.apply(x.bfloat16(), *params)
    args = lib.calls["hgstem_train_tc_nhwc"]
    assert args[18:21] == (b, h, w)
    blocks = args[21:25]
    plan = K.stem_plan(b, h, w, (args[0], args[1], args[4], args[7],
                                 args[10]), H100_SMS)
    assert blocks == tuple(plan[k]["blocks"] for k in ("p1", "c2a", "c2b",
                                                       "p3"))
    assert args[25:29] == tuple(plan[k]["vec"] for k in ("p1", "c2a", "c2b",
                                                         "p3"))
    assert made[args[16]].numel() == 2 * max(
        n * c for n, c in zip(blocks, (32, 16, 32, 32)))        # stats

    h2, w2, h4, w4 = h // 2, w // 2, h // 4, w // 4

    def bz(*s):
        return torch.zeros(s, dtype=torch.bfloat16)
    kb = [p.bfloat16() for p in params if p.dim() == 4]
    saved = (x.bfloat16(), bz(b, h2, w2, 32), bz(b, h2, w2, 16),
             bz(b, h2, w2, 32), bz(b, h2, w2, 64), bz(b, h4, w4, 32), kb[1],
             kb[2], kb[3], torch.ones(32), torch.ones(16), torch.ones(32),
             torch.zeros(14, ST.SLOT))
    grads = ST._launch_backward(*saved, bz(b, h4, w4, 32), (None,) * 4,
                                (None,) * 4)
    args = lib.calls["hgstem_bwd_tc_nhwc"]
    assert args[29:32] == (b, h, w)
    counts = dict(zip(ST.STEM_BWD_PLAN, args[32:42]))
    bw = K.stem_bwd_plan(b, h, w, (args[0], args[6], args[7], args[8],
                                   args[13]), H100_SMS)
    assert counts == {k: bw[k] for k in ST.STEM_BWD_PLAN}
    assert made[args[20]].shape == (b, h4, w4, 32)                   # e3
    assert made[args[21]].numel() == 2 * max(
        counts["asm_blocks"] * 32, counts["dx2b_blocks"] * 16,
        counts["dx2a_blocks"] * 32)                                  # gpart
    assert made[args[22]].numel() == max(
        counts["dk3_chunks"] * 9 * 64 * 32, counts["wg2b_chunks"] * 4 * 512,
        counts["wg2a_chunks"] * 4 * 512, counts["dk1_chunks"] * 27 * 32)
    # the 2x2 filter gradients come back as written, over 2 x 2 taps
    assert made[args[25]].shape == (2, 2, 32, 16)                    # dk2a
    assert made[args[26]].shape == (2, 2, 16, 32)                    # dk2b
    assert grads[3].shape == (2, 2, 32, 16) and grads[6].shape == (
        2, 2, 16, 32)


def _rand(rng, *shape):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))


@pytest.mark.parametrize("shape", [(2, 8, 12, 32, 16), (1, 9, 7, 16, 32),
                                   (2, 16, 16, 8, 8), (1, 1, 3, 3, 2)])
def test_2x2_filter_gradient_over_its_own_taps(shape):
    """dk[dy, dx] = sum over pixels of a[p + (dy, dx)] (x) e[p] (a zero
    outside, the tap range of stem2x2_wgrad_tc_kernel) equals the autograd
    of the 2x2 conv (zero pad right/bottom) and the [1:, 1:] corner of the
    3x3 pad-1 filter gradient that the CUDA-core route computes."""
    b, h, w, ci, co = shape
    rng = np.random.default_rng(1)
    a = _rand(rng, b, ci, h, w)
    e = _rand(rng, b, co, h, w)
    ap = F.pad(a, (0, 1, 0, 1))
    taps = torch.stack([torch.einsum("bihw,bohw->io",
                                     ap[:, :, dy:dy + h, dx:dx + w], e)
                        for dy in (0, 1) for dx in (0, 1)])
    dk = taps.view(2, 2, ci, co)
    k = torch.zeros(co, ci, 2, 2, requires_grad=True)
    (auto,) = torch.autograd.grad(F.conv2d(ap, k), k, e)
    corner = torch.nn.grad.conv2d_weight(a, (co, ci, 3, 3), e, padding=1)
    torch.testing.assert_close(dk, auto.permute(2, 3, 1, 0), rtol=1e-4,
                               atol=1e-4)
    torch.testing.assert_close(dk, corner[:, :, 1:, 1:].permute(2, 3, 1, 0),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("shape", [(2, 8, 12, 16, 32), (1, 9, 7, 32, 16),
                                   (1, 1, 3, 3, 2)])
def test_2x2_input_gradient_from_taps_up_and_left(shape):
    """dA[i, j] = sum over taps of e[i - dy, j - dx] k[dy, dx] (e zero
    outside: the halo of stem2x2_dx_tc_kernel starts one row and column
    before its tile) equals the autograd dX of the 2x2 conv."""
    b, h, w, ca, ce = shape
    rng = np.random.default_rng(2)
    a = _rand(rng, b, ca, h, w).requires_grad_()
    k = _rand(rng, 2, 2, ca, ce)
    e = _rand(rng, b, ce, h, w)
    (auto,) = torch.autograd.grad(
        F.conv2d(F.pad(a, (0, 1, 0, 1)), k.permute(3, 2, 0, 1)), a, e)
    ep = F.pad(e, (1, 0, 1, 0))      # row and column -1 hold zeros
    da = sum(torch.einsum("behw,ae->bahw",
                          ep[:, :, 1 - dy:1 - dy + h, 1 - dx:1 - dx + w],
                          k[dy, dx]) for dy in (0, 1) for dx in (0, 1))
    torch.testing.assert_close(da, auto, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("shape", [(2, 36, 52), (1, 18, 26), (1, 2, 2),
                                   (2, 10, 6)])
def test_transposed_stem3_as_four_parity_classes(shape):
    """d(cat) of y3 = conv3x3/2(cat, k3) (64 -> 32, pad 1) through four
    stride-1 convs, one per (row, column) parity class of the concat pixel,
    over e3 padded by one zero row and column at the far end, equals the
    autograd dX (f32, seeded numpy inputs; odd H/4 and W/4 included)."""
    b, h2, w2 = shape
    rng = np.random.default_rng(3)
    cat = _rand(rng, b, 64, h2, w2).requires_grad_()
    k3 = _rand(rng, 32, 64, 3, 3) * 0.1
    y3 = F.conv2d(cat, k3, stride=2, padding=1)
    assert y3.shape[2:] == (-(-h2 // 2), -(-w2 // 2))
    e3 = _rand(rng, *y3.shape)
    (ref,) = torch.autograd.grad(y3, cat, e3)
    dx = torch.zeros_like(ref)
    padded = F.pad(e3, (0, 1, 0, 1))
    for py in (0, 1):
        for px in (0, 1):
            ty, tx = PARITY_TAPS[py], PARITY_TAPS[px]
            ky = sorted(ty, key=ty.get)
            kx = sorted(tx, key=tx.get)
            sub = k3[:, :, ky][:, :, :, kx].transpose(0, 1)
            out = F.conv2d(padded, sub)
            ny, nx = len(range(py, h2, 2)), len(range(px, w2, 2))
            dx[:, :, py::2, px::2] = out[:, :, :ny, :nx]
    torch.testing.assert_close(dx, ref, rtol=1e-4, atol=1e-4)
