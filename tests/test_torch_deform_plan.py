"""The launch plans and wrappers of K5-g1 (``stamp_scatter``,
csrc/stamp_scatter.cu) and K5 forward (``ms_deform_attn_slots``,
csrc/ms_deform_attn.cu) as redesigned for Hopper, held on the CPU:

  * K5-g1's tile plan puts every cell of every row in exactly one warp's
    range, fills the card at the RT-DETR-L levels and depends on the shape
    alone (16-byte stores aside);
  * ``stamp_scatter`` reads gw in the reference's layout and as the
    transposed view of a contiguous (B, heads, T, dh), and the two agree
    with each other and with the reference's ``_stamp_scatter``; the
    wrapper hands the kernel each layout's strides (a recording stand-in
    for the kernel library); ``bilinear_sample``'s backward hands it the
    row layout, and its gradients still match the reference;
  * a model of K5 forward's lanes (tap slot, channel group) covers every
    (level, point, corner, channel) exactly once, and the slot sums close
    over each channel group;
  * the cached level table equals ``_levels_arg``, the wrapper passes the
    plan, and ``_check`` refuses what it refused before, save the level
    and point counts, which only the card's route refuses.
"""

import ctypes

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
from test_torch_front_plan import H100_SMS, recorder  # noqa: F401 (fixture)

from robust_object_detection_tpu.ops import deform as JD
from robust_object_detection_tpu_torch import kernels as K
from robust_object_detection_tpu_torch.ops import deform as DF

torch.set_num_threads(1)

RTDETR_LEVELS = ((128, 128), (64, 64), (32, 32))
ROWS = 64                                     # batch 8 x 8 heads
# (rows, hw): the RT-DETR-L levels, the odd (6, 10) map at the smoke run's
# 6 rows and at 64, maps no multiple of the tile or of 4, a 2**20-cell map
STAMP_SHAPES = [(ROWS, 16384), (ROWS, 4096), (ROWS, 1024), (6, 60),
                (ROWS, 60), (6, 1000), (2, 7), (1, 129), (1, 1 << 20)]


@pytest.fixture
def lib(recorder, monkeypatch):  # noqa: F811
    """The recording kernel library, with CPU tensors standing in for the
    card's (the wrappers then enter the null device context)."""
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    return recorder[0]


@pytest.mark.parametrize("rows,hw", STAMP_SHAPES)
def test_stamp_plan_gives_every_cell_one_warp(rows, hw):
    plan = K.stamp_plan(rows, hw, 300, 32, (0, 0), 1)
    tile, tiles = plan["tile"], plan["tiles"]
    assert tile % K.STAMP_WARPS == 0 and 8 <= tile <= K.STAMP_MAX_TILE
    assert tiles == -(-hw // tile) and plan["blocks"] == rows * tiles
    owners = np.zeros((rows, hw), np.int64)
    for blk in range(min(plan["blocks"], 4 * tiles)):   # rows repeat
        row, c0 = blk // tiles, (blk % tiles) * tile
        for w in range(K.STAMP_WARPS):
            cells = [c for c in range(min(tile, hw - c0))
                     if K.stamp_owner(c) == w]
            owners[row, [c0 + c for c in cells]] += 1
    checked = min(rows, 4)
    assert np.array_equal(owners[:checked], np.ones((checked, hw), np.int64))


@pytest.mark.parametrize("h,w", RTDETR_LEVELS + ((6, 10), (32, 16)))
def test_stamp_owners_spread_map_rows_and_columns(h, w):
    """The clamped taps of samples outside a map pile on its border rows
    and columns; in every tile each row and column of the map spreads over
    at least min(4, its 4-cell groups there) warps, and no warp holds more
    than half of it (or one group)."""
    tile = K.stamp_plan(ROWS, h * w, 6848, 32, (0, 0), 1)["tile"]
    for c0 in range(0, h * w, tile):
        lines = [[y * w + x for x in range(w)] for y in range(h)]
        lines += [[y * w + x for y in range(h)] for x in range(w)]
        for line in lines:
            local = [c - c0 for c in line if c0 <= c < c0 + tile]
            if not local:
                continue
            warps = [K.stamp_owner(c) for c in local]
            groups = {c // 4 for c in local}
            assert len(set(warps)) >= min(4, len(groups))
            assert max(np.bincount(warps)) <= max(4, -(-len(local) // 2))


@pytest.mark.parametrize("hw", [h * w for h, w in RTDETR_LEVELS])
def test_stamp_plan_fills_the_card_at_the_rtdetr_levels(hw):
    plan = K.stamp_plan(ROWS, hw, 428 * 16, 32, (0, 0), 32)
    assert plan["tile"] == K.STAMP_TILE == 256
    assert plan["blocks"] >= H100_SMS
    # four blocks an SM fit the card's 227 KB of shared memory
    assert 4 * (plan["smem"] + 1024) <= 232448


@pytest.mark.parametrize("rows,hw", STAMP_SHAPES)
def test_stamp_plan_depends_on_the_shape_alone(rows, hw):
    """The tile depends on (rows, hw), not on the taps, the channels, the
    pointers or gw's layout; only ivec and pairs read those."""
    def fixed(ptrs, t, dh, ts):
        plan = K.stamp_plan(rows, hw, t, dh, ptrs, ts)
        return tuple(v for k, v in sorted(plan.items())
                     if k not in ("ivec", "pairs"))
    assert len({fixed(p, t, dh, ts)
                for p in ((0, 0), (4, 4), (4096 * 7, 12))
                for t, dh in ((300, 32), (6848, 8), (5, 48))
                for ts in (1, dh)}) == 1


@pytest.mark.parametrize("t,ts,ptrs,flags", [
    (6848, 1, (0, 0), (1, 1)),
    (6848, 32, (0, 0), (1, 0)),          # the row layout: no pairs
    (6848, 1, (4, 0), (0, 1)),           # idx not 16-byte aligned
    (6844, 1, (0, 0), (0, 1)),           # T not a multiple of 8
    (6843, 1, (0, 0), (0, 0)),           # T odd
    (6848, 1, (0, 4), (1, 0))])          # gw not 8-byte aligned
def test_stamp_plan_wide_accesses_only_where_allowed(t, ts, ptrs, flags):
    plan = K.stamp_plan(ROWS, 4096, t, 32, ptrs, ts)
    assert (plan["ivec"], plan["pairs"]) == flags


@pytest.mark.parametrize("shape", [(0, 16, 5, 8), (2, 0, 5, 8),
                                   (2, 16, 0, 8), (2, 16, 5, 0),
                                   (2 ** 20, 2 ** 20, 5, 8)])
def test_stamp_plan_refuses_what_the_kernel_cannot_take(shape):
    rows, hw, t, dh = shape
    with pytest.raises(ValueError):
        K.stamp_plan(rows, hw, t, dh, (0, 0), 1)


def _stamp_inputs(seed, b, heads, dh, t, hw):
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, hw, (b, heads, t)).astype(np.int32)
    idx[:, :, : t // 3] %= 3                  # taps piled on a few cells
    gw = rng.standard_normal((b, heads, dh, t)).astype(np.float32)
    return idx, gw


@pytest.mark.parametrize("case", [(2, 3, 32, 56, 60), (1, 2, 5, 37, 7),
                                  (2, 1, 8, 300, 129)])
def test_stamp_scatter_layouts_agree_with_reference(case):
    b, heads, dh, t, hw = case
    idx, gw = _stamp_inputs(0, *case)
    ref = np.asarray(JD._stamp_scatter(jnp.asarray(idx), jnp.asarray(gw),
                                       hw))
    ti, tg = torch.from_numpy(idx), torch.from_numpy(gw)
    rows = tg.transpose(2, 3).contiguous().transpose(2, 3)
    assert rows.stride(2) == 1 and not rows.is_contiguous()
    before = DF.stamp_scatter.launches
    out = DF.stamp_scatter(ti, tg, hw)
    assert DF.stamp_scatter.launches == before          # CPU: plain
    assert torch.equal(DF.stamp_scatter(ti, rows, hw), out)
    assert torch.equal(DF.stamp_scatter(ti.long(), rows, hw), out)
    np.testing.assert_allclose(out.numpy(), ref, rtol=0,
                               atol=1e-5 * np.abs(ref).max())


@pytest.mark.parametrize("layout", ["reference", "rows"])
def test_stamp_scatter_wrapper_passes_each_layouts_strides(lib, layout):
    b, heads, dh, t, hw = 2, 3, 32, 56, 60
    idx, gw = (torch.from_numpy(a) for a in _stamp_inputs(1, b, heads, dh,
                                                          t, hw))
    if layout == "rows":
        gw = gw.transpose(2, 3).contiguous().transpose(2, 3)
    strides = DF._gw_strides(gw)
    assert strides == ((t, 1) if layout == "reference" else (1, dh))
    for ix in (idx, idx.long()):
        before = DF.stamp_scatter.launches
        dv = DF._stamp_scatter_cuda(ix, gw, hw, strides)
        assert DF.stamp_scatter.launches == before + 1
        args = lib.calls["stamp_scatter"]
        plan = K.stamp_plan(b * heads, hw, t, dh,
                            (ix.data_ptr(), gw.data_ptr()), strides[1])
        assert args[:3] == (ix.data_ptr(), gw.data_ptr(), dv.data_ptr())
        assert args[3:] == (b * heads, t, hw, dh, *strides,
                            ix.element_size(), plan["tile"], plan["ivec"],
                            plan["pairs"], 0)
        assert plan["pairs"] == int(layout == "reference")
        assert dv.shape == (b, heads, dh, hw) and dv.dtype == torch.float32


def test_stamp_scatter_refuses_other_gw_layouts():
    idx = torch.zeros(2, 2, 5, dtype=torch.int32)
    for gw in (torch.zeros(2, 2, 8, 10)[..., ::2],
               torch.zeros(2, 2, 8, 5).transpose(0, 1),
               torch.zeros(2, 2, 5, 16)[..., ::2].permute(0, 1, 3, 2)):
        assert gw.shape == (2, 2, 8, 5) and DF._gw_strides(gw) is None
        with pytest.raises(ValueError, match="contiguous"):
            DF.stamp_scatter(idx, gw, 16)


def test_bilinear_backward_hands_k5_g1_the_row_layout(monkeypatch):
    """The backward's one copy of gw is the (B, heads, T, dh) layout, read
    by K5-g1 through its transpose; the gradients equal the reference's."""
    rng = np.random.default_rng(2)
    b, h, w, heads, dh, q, p = 2, 9, 8, 2, 32, 11, 4
    v = rng.standard_normal((b, h, w, heads, dh)).astype(np.float32)
    sx = rng.uniform(-1.5, w + 1.0, (b, q, heads, p)).astype(np.float32)
    sy = rng.uniform(-1.5, h + 1.0, (b, q, heads, p)).astype(np.float32)
    cot = rng.standard_normal((b, q, heads, p, dh)).astype(np.float32)
    seen = []
    real = DF.stamp_scatter

    def spy(idx, gw, hw):
        seen.append((gw.shape, gw.stride(), gw.transpose(2, 3)
                     .is_contiguous()))
        return real(idx, gw, hw)
    monkeypatch.setattr(DF, "stamp_scatter", spy)
    leaves = [torch.from_numpy(a.copy()).requires_grad_()
              for a in (v, sx, sy)]
    DF.bilinear_sample(*leaves).backward(torch.from_numpy(cot))
    t = q * p * 4
    assert seen == [((b, heads, dh, t), (heads * t * dh, t * dh, 1, dh),
                     True)]

    def loss(vv, xx, yy):
        return jnp.sum(JD.bilinear_sample(vv, xx, yy) * cot)
    refs = jax.grad(loss, argnums=(0, 1, 2))(*(jnp.asarray(a)
                                               for a in (v, sx, sy)))
    for leaf, ref in zip(leaves, refs):
        ref = np.asarray(ref)
        np.testing.assert_allclose(leaf.grad.numpy(), ref, rtol=0,
                                   atol=1e-5 * np.abs(ref).max())


def _lane_map(n_l, n_p, dh, esize):
    """{(tap, channel): [(lane, pass, round)]} of K5 forward's lanes, as
    ms_deform_attn_kernel indexes them: lane i, pass c, round r read tap k =
    r * slots + i // row_lanes and channels c * row_lanes * vec + (i %
    row_lanes) * vec + [0, vec), those below dh and taps below 4 L P."""
    plan = K.deform_fwd_plan(n_l, n_p, dh, esize, 0)
    vec, rl, slots = plan["vec"], plan["row_lanes"], plan["slots"]
    taps = 4 * n_l * n_p
    seen = {}
    for c in range(plan["passes"]):
        for r in range(plan["rounds"]):
            for lane in range(32):
                k = r * slots + lane // rl
                ch0 = c * rl * vec + (lane % rl) * vec
                if k >= taps or ch0 >= dh:
                    continue
                for ch in range(ch0, ch0 + vec):
                    assert ch < dh          # whole 16-byte pieces
                    seen.setdefault((k, ch), []).append((lane, c, r))
    return plan, seen


@pytest.mark.parametrize("esize", [2, 4])
@pytest.mark.parametrize("dh", [32, 24])
@pytest.mark.parametrize("n_l,n_p", [(3, 4), (2, 2), (4, 8)])
def test_k5_forward_lanes_cover_every_tap_and_channel_once(n_l, n_p, dh,
                                                           esize):
    plan, seen = _lane_map(n_l, n_p, dh, esize)
    assert plan["vec"] == 16 // esize
    assert plan["fixed"] == int((n_l, n_p, dh) == (3, 4, 32))
    want = {(4 * (l * n_p + p) + corner, ch) for l in range(n_l)
            for p in range(n_p) for corner in range(4) for ch in range(dh)}
    assert set(seen) == want
    assert all(len(v) == 1 for v in seen.values())
    if plan["fixed"]:       # all 48 taps' loads before the first FMA
        assert plan["rounds"] == (6 if esize == 2 else 12)
        assert plan["rounds"] * plan["slots"] == 48


@pytest.mark.parametrize("row_lanes", [1, 2, 4, 8, 16, 32])
def test_k5_forward_slot_sums_close_over_each_channel_group(row_lanes):
    """The xor shuffles over offsets row_lanes .. 16 give every lane the
    sum over exactly the lanes of its channel group."""
    held = [{lane} for lane in range(32)]
    off = row_lanes
    while off < 32:
        held = [held[lane] | held[lane ^ off] for lane in range(32)]
        off <<= 1
    for lane in range(32):
        assert held[lane] == {i for i in range(32)
                              if i % row_lanes == lane % row_lanes}


def test_k5_forward_plan_falls_back_to_element_loads_off_alignment():
    assert K.deform_fwd_plan(3, 4, 32, 2, 2)["vec"] == 1
    assert K.deform_fwd_plan(3, 4, 32, 2, 2)["fixed"] == 0
    assert K.deform_fwd_plan(3, 4, 30, 4, 0)["vec"] == 1      # 120 bytes
    assert K.deform_fwd_plan(3, 4, 200, 4, 0)["passes"] == 2


@pytest.mark.parametrize("shapes", [RTDETR_LEVELS, ((6, 10), (3, 5)),
                                    ((5, 7), (3, 3), (2, 1), (1, 1))])
def test_cached_level_table_equals_levels_arg(shapes):
    table, addr = DF._levels_table(shapes)
    assert list(table) == list(DF._levels_arg(shapes))
    assert addr == ctypes.addressof(table)
    assert DF._levels_table(shapes)[0] is table


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k5_forward_wrapper_passes_the_plan(lib, dtype):
    shapes = ((6, 10), (3, 5), (2, 2))
    rng = np.random.default_rng(3)
    b, q, heads, dh, p = 2, 7, 3, 32, 4
    values = torch.from_numpy(rng.standard_normal(
        (b, 79, heads, dh)).astype(np.float32)).to(dtype)
    loc = torch.from_numpy(rng.uniform(0, 1, (b, q, heads, 3, p, 2))
                           .astype(np.float32))
    attn = torch.from_numpy(rng.uniform(0, 1, (b, q, heads, 3, p))
                            .astype(np.float32))
    before = DF.ms_deform_attn_slots.launches
    out = DF._forward_cuda(values, shapes, loc, attn)
    assert DF.ms_deform_attn_slots.launches == before + 1
    args = lib.calls["ms_deform_attn_fwd"]
    plan = K.deform_fwd_plan(3, p, dh, values.element_size(),
                             values.data_ptr())
    assert args[:5] == (values.data_ptr(), loc.data_ptr(), attn.data_ptr(),
                        out.data_ptr(), DF._levels_table(shapes)[1])
    assert args[5:] == (b, 79, q, heads, dh, 3, p, K.dtype_code(dtype),
                        plan["vec"], plan["row_lanes"], plan["fixed"], 0)
    assert out.shape == (b, q, heads, dh) and out.dtype == dtype


def _refusals():
    """(values, shapes, loc, attn, match, card): card marks a shape every
    version but the kernels takes, refused on the card's route alone (the
    CPU runs the plain version at any L and P, as the reference does)."""
    shapes = ((4, 4), (2, 2))
    values = torch.zeros(1, 20, 2, 8)
    loc = torch.zeros(1, 3, 2, 2, 2, 2)
    attn = torch.zeros(1, 3, 2, 2, 2)
    return [
        (values[0], shapes, loc, attn, "takes values", False),
        (values, shapes, loc[:, :, :1], attn[:, :, :1], "do not match",
         False),
        (values, shapes, loc, attn[..., :1], "do not match", False),
        (values, ((4, 4), (2, 3)), loc, attn, "do not match shapes", False),
        (values, ((4, 4),), loc, attn, "do not match shapes", False),
        (torch.zeros(1, 21, 2, 8), ((1, 1),) * 5 + ((4, 4),),
         torch.zeros(1, 3, 2, 6, 2, 2), torch.zeros(1, 3, 2, 6, 2),
         "at most 4 levels", True),
        (values, shapes, torch.zeros(1, 3, 2, 2, 17, 2),
         torch.zeros(1, 3, 2, 2, 17), "at most 4 levels", True),
        (values, shapes, loc[:, :0], attn[:, :0], "no empty dimension",
         False),
        (values.half(), shapes, loc, attn, "float32 or bfloat16", False),
        (values, shapes, loc.double(), attn, "float32 loc", False),
        (values, shapes, loc, attn.bfloat16(), "float32 loc", False),
        (values.transpose(1, 2).contiguous().transpose(1, 2), shapes, loc,
         attn, "contiguous", False),
        (values, shapes, loc.transpose(1, 2).contiguous().transpose(1, 2),
         attn, "contiguous", False),
        (values.to("meta"), shapes, loc.to("meta"), attn.to("meta"),
         "runs on cpu or cuda", False),
    ]


@pytest.mark.parametrize("case", range(len(_refusals())))
def test_k5_forward_refuses_what_it_refused(lib, case):
    """Every version refuses a bad call; a shape the kernels do not
    instantiate passes the checks and is refused on the card's route
    before any launch (CPU tensors stand in for the card's)."""
    values, shapes, loc, attn, match, card = _refusals()[case]
    before = DF.ms_deform_attn_slots.launches
    with pytest.raises(ValueError, match=match):
        if card:
            DF._check(values, shapes, loc, attn)
            DF._forward_cuda(values, shapes, loc, attn)
        else:
            DF.ms_deform_attn_slots(values, shapes, loc, attn)
    assert DF.ms_deform_attn_slots.launches == before
    assert lib.calls == {}
