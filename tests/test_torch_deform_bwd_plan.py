"""The launch plan and wrappers of the deformable-attention backward shared
by K5 (``ms_deform_attn_backward``) and K5-g2
(``ms_deform_attn_sorted_backward``), csrc/deform_bwd.cu: a taps kernel on
K5 forward's lanes and K5-g1's owner scatter (csrc/owner_scatter.cuh),
held on the CPU with numpy models of the kernels and the recording stand-in
for the kernel library:

  * the taps kernel's lanes cover every (level, point, corner, channel)
    exactly once, and the corner sums close over each point, in one round
    or across rounds;
  * the level-major order in which it writes each tap's cell and
    coefficient is a bijection onto the row, puts each level's taps in one
    range and keeps, for every cell, the order of its taps;
  * a sequential model of the owner scatter (per block: the scanned range,
    the tile's taps in order, each warp adding the cells it owns from +0.0)
    equals a sort by (cell, tap) followed by a segmented sum, bit for bit
    in f32, on uniform, clustered and all-outside samples, and agrees with
    the plain backward;
  * the plan gives every cell one warp, scans the levels a tile overlaps
    and no more, and depends on the shape alone;
  * both wrappers pass the plan and make no ``torch.sort``,
    ``torch.zeros`` or dtype cast on the card's path, and refuse what they
    refused before.
"""

import ctypes

import numpy as np
import pytest
import torch
from test_torch_deform_plan import (  # noqa: F401 (fixture)
    RTDETR_LEVELS, ROWS, _refusals, lib)
from test_torch_front_plan import H100_SMS, recorder  # noqa: F401

from robust_object_detection_tpu_torch import kernels as K
from robust_object_detection_tpu_torch.ops import deform as DF

torch.set_num_threads(1)

Q_TRAIN = 428
# (shapes, batch, queries, heads, dh, points): the RT-DETR-L train step, odd
# maps whose levels straddle tiles, four levels, one level
BWD_CASES = [
    (RTDETR_LEVELS, 8, Q_TRAIN, 8, 32, 4),
    (((6, 10), (3, 5)), 2, 7, 3, 32, 2),
    (((5, 7), (3, 3), (2, 1), (1, 1)), 2, 13, 2, 8, 8),
    (((9, 4),), 1, 5, 1, 48, 3),
    (((40, 40), (20, 20)), 1, 50, 2, 40, 4)]


def _starts(shapes):
    return tuple(int(s) for s in np.cumsum([0] + [h * w for h, w in
                                                  shapes])[:-1])


def _plan(shapes, b, q, heads, dh, p, esize=2, ptr=0, transposed=False):
    return K.deform_bwd_plan(b * heads, shapes, q, p, dh, esize, ptr,
                             transposed)


# ---- the taps kernel --------------------------------------------------------


@pytest.mark.parametrize("transposed", [False, True])
@pytest.mark.parametrize("esize", [2, 4])
@pytest.mark.parametrize("dh", [32, 24, 8, 200])
@pytest.mark.parametrize("n_l,n_p", [(3, 4), (2, 2), (4, 8), (1, 3)])
def test_taps_lanes_cover_every_tap_and_channel_once(n_l, n_p, dh, esize,
                                                     transposed):
    """Lane i, pass c, round r of the taps kernel read tap k = r * slots + i
    // row_lanes and channels c * row_lanes * vec + (i % row_lanes) * vec +
    [0, vec), those below dh and taps below 4 L P."""
    plan = K.deform_bwd_plan(8, ((10, 10),) * n_l, 7, n_p, dh, esize, 0,
                             transposed)
    vec, rl, slots = plan["vec"], plan["row_lanes"], plan["slots"]
    assert rl * slots == 32 and plan["rounds"] * slots >= 4 * n_l * n_p
    seen = {}
    for c in range(plan["passes"]):
        for r in range(plan["rounds"]):
            for lane in range(32):
                k = r * slots + lane // rl
                ch0 = c * rl * vec + (lane % rl) * vec
                if k >= 4 * n_l * n_p or ch0 >= dh:
                    continue
                for ch in range(ch0, ch0 + vec):
                    assert ch < dh          # whole pieces
                    seen.setdefault((k, ch), []).append(lane)
    assert set(seen) == {(k, ch) for k in range(4 * n_l * n_p)
                         for ch in range(dh)}
    assert all(len(v) == 1 for v in seen.values())
    assert plan["fixed"] == int((n_l, n_p, dh) == (3, 4, 32) and vec > 1)


def _close_corners(plan, n_taps):
    """The taps kernel's corner sums, modelled on sets of taps: after the
    slot reduction every lane of slot s holds {k}; xor shuffles over
    offsets row_lanes .. min(slots, 4) * row_lanes - 1 close the corners
    within a round, a per-lane accumulator across rounds (reset at corner
    0), and the lane of channel group 0 in the first slot of the point's
    last corner group writes. Returns {point: [tap sets written]}."""
    rl, slots = plan["row_lanes"], plan["slots"]
    close = min(slots, 4)
    acc = [set() for _ in range(32)]
    written = {}
    for r in range(plan["rounds"]):
        held = [{r * slots + lane // rl} for lane in range(32)]
        off = rl
        while off < close * rl:
            held = [held[lane] | held[lane ^ off] for lane in range(32)]
            off <<= 1
        for lane in range(32):
            s, g = lane // rl, lane % rl
            k = r * slots + s
            corner = k % 4
            acc[lane] = set(held[lane]) if corner == 0 else \
                acc[lane] | held[lane]
            if k < n_taps and g == 0 and s % close == 0 and \
                    corner + close == 4:
                written.setdefault(k // 4, []).append(set(acc[lane]))
    return written


@pytest.mark.parametrize("dh,esize", [(32, 2), (32, 4), (8, 2), (200, 4),
                                      (48, 4), (30, 4), (64, 2)])
@pytest.mark.parametrize("n_l,n_p", [(3, 4), (2, 2), (4, 8), (1, 1)])
def test_corner_sums_close_over_each_point(n_l, n_p, dh, esize):
    plan = K.deform_bwd_plan(8, ((10, 10),) * n_l, 7, n_p, dh, esize, 0,
                             False)
    points = n_l * n_p
    written = _close_corners(plan, 4 * points)
    assert sorted(written) == list(range(points))
    for i, sets in written.items():
        assert sets == [{4 * i, 4 * i + 1, 4 * i + 2, 4 * i + 3}]


# ---- the level-major order --------------------------------------------------


def _geometry(seed, shapes, b, q, heads, p, kind):
    """loc, attn and the taps' (cell, coefficient) in the reference's order
    (B, Q, heads, L, P, 4): uniform samples (some outside), clustered ones
    (a few centres, many taps on few cells) or all outside the maps."""
    rng = np.random.default_rng(seed)
    n_l = len(shapes)
    if kind == "uniform":
        loc = rng.uniform(-0.2, 1.2, (b, q, heads, n_l, p, 2))
    elif kind == "clustered":
        centres = rng.uniform(0, 1, (b, 1, heads, 1, 1, 2))
        loc = centres + 0.02 * rng.standard_normal((b, q, heads, n_l, p, 2))
    else:
        loc = rng.uniform(1.6, 2.5, (b, q, heads, n_l, p, 2))
    loc = torch.from_numpy(loc.astype(np.float32))
    attn = torch.from_numpy(rng.uniform(0, 1, (b, q, heads, n_l, p))
                            .astype(np.float32))
    idx, w, _, _ = DF.tap_geometry_full(loc, shapes)
    coef = w * attn[..., None]
    return loc, attn, idx.numpy(), coef.numpy()


def _level_major(a):
    """(B, Q, heads, L, P, 4) -> rows (B * heads, L * Q * P * 4) in the
    taps kernel's write order."""
    b, q, heads, n_l, p, _ = a.shape
    return a.transpose(0, 2, 3, 1, 4, 5).reshape(b * heads, -1)


@pytest.mark.parametrize("case", BWD_CASES[1:])
def test_tap_index_is_the_level_major_order(case):
    shapes, b, q, heads, dh, p = case
    n_l = len(shapes)
    taps = 4 * n_l * p
    at = [[K.deform_bwd_tap_index(qq, k, q, p) for k in range(taps)]
          for qq in range(q)]
    flat = np.array(at).ravel()
    assert sorted(flat) == list(range(q * taps))           # a bijection
    tpl = q * 4 * p
    for qq in range(q):
        for k in range(taps):
            level = k // (4 * p)
            assert level * tpl <= at[qq][k] < (level + 1) * tpl
    marks = np.arange(b * q * heads * taps).reshape(b, q, heads, n_l, p, 4)
    rows = _level_major(marks)
    for qq in range(q):
        for k in range(taps):
            assert rows[0, at[qq][k]] == marks[0, qq, 0].ravel()[k]


@pytest.mark.parametrize("kind", ["uniform", "clustered", "outside"])
@pytest.mark.parametrize("case", BWD_CASES[1:])
def test_level_major_order_keeps_each_cells_tap_order(case, kind):
    """Within a row, the taps of any one cell come in the order of their
    position (query, level, point, corner) in the level-major order too, so
    a sum in that order is the sum in the sort keys' order."""
    shapes, b, q, heads, dh, p = case
    _, _, idx, _ = _geometry(0, shapes, b, q, heads, p, kind)
    pos = np.arange(idx[0, :, 0].size).reshape(idx.shape[1:2] +
                                               idx.shape[3:])
    pos = np.broadcast_to(pos[None, :, None], idx.shape)
    cells, order = _level_major(idx), _level_major(np.ascontiguousarray(pos))
    for r in range(cells.shape[0]):
        for c in np.unique(cells[r]):
            seq = order[r][cells[r] == c]
            assert np.all(np.diff(seq) > 0)


# ---- the owner scatter ------------------------------------------------------


def _scatter_model(plan, shapes, q, p, cells, coef, dout):
    """The owner scatter, one block after another: block (row, tile) scans
    its level's taps, lists those whose cell lies in its tile in tap order,
    and each warp adds, in list order, the terms coef * dout[q] of the cells
    it owns into an f32 tile from +0.0. cells, coef: (rows, T) level-major;
    dout (rows, Q, dh) f32. Returns dv (rows, hw, dh) f32 and the number of
    times each tap was added."""
    rows, taps = cells.shape
    hw = sum(h * w for h, w in shapes)
    dh = dout.shape[-1]
    tpq, tpl = 4 * p, q * 4 * p
    dv = np.full((rows, hw, dh), np.nan, np.float32)
    added = np.zeros((rows, taps), np.int64)
    for row in range(rows):
        for ti in range(plan["tiles"]):
            _, c0, ncell = K.deform_bwd_tile(plan, shapes, ti)
            ta, tb = K.deform_bwd_scan(plan, shapes, ti)
            listed = [t for t in range(ta, tb)
                      if c0 <= cells[row, t] < c0 + ncell]
            acc = np.zeros((ncell, dh), np.float32)
            for warp in range(K.STAMP_WARPS):
                for t in listed:
                    c = cells[row, t] - c0
                    if K.stamp_owner(c) != warp:
                        continue
                    qq = t % tpl // tpq
                    term = np.float32(coef[row, t]) * dout[row, qq]
                    acc[c] = acc[c] + term.astype(np.float32)
                    added[row, t] += 1
            dv[row, c0:c0 + ncell] = acc
    return dv, added


def _sorted_segment_sum(hw, q, p, cells, coef, dout):
    """The d(values) of the sorted route: the taps of a row sorted by
    (cell, tap) and each cell's terms summed in that order from +0.0."""
    rows, taps = cells.shape
    dh = dout.shape[-1]
    tpq, tpl = 4 * p, q * 4 * p
    dv = np.zeros((rows, hw, dh), np.float32)
    for row in range(rows):
        for t in np.lexsort((np.arange(taps), cells[row])):
            qq = t % tpl // tpq
            term = np.float32(coef[row, t]) * dout[row, qq]
            dv[row, cells[row, t]] = dv[row, cells[row, t]] + term
    return dv


@pytest.mark.parametrize("kind", ["uniform", "clustered", "outside"])
@pytest.mark.parametrize("case", BWD_CASES[1:])
def test_owner_scatter_model_equals_sort_and_segmented_sum(case, kind):
    shapes, b, q, heads, dh, p = case
    hw = sum(h * w for h, w in shapes)
    loc, attn, idx, coef = _geometry(1, shapes, b, q, heads, p, kind)
    rng = np.random.default_rng(2)
    dout = rng.standard_normal((b, q, heads, dh)).astype(np.float32)
    rows_dout = dout.transpose(0, 2, 1, 3).reshape(b * heads, q, dh)
    cells, coefs = _level_major(idx), _level_major(coef)
    plan = _plan(shapes, b, q, heads, dh, p)
    dv, added = _scatter_model(plan, shapes, q, p, cells, coefs, rows_dout)
    assert np.all(added == 1)                  # every tap once, none lost
    want = _sorted_segment_sum(hw, q, p, cells, coefs, rows_dout)
    assert np.array_equal(dv.view(np.uint32), want.view(np.uint32))
    ref = DF.ms_deform_attn_backward_ref(
        torch.zeros(b, hw, heads, dh), shapes, loc, attn,
        torch.from_numpy(dout))[0].numpy()
    got = dv.reshape(b, heads, hw, dh).transpose(0, 2, 1, 3)
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=1e-6 * max(1.0, np.abs(ref).max()))
    if kind == "outside":
        assert not np.any(coefs)               # clipped cells, coef 0
        assert np.array_equal(got, np.zeros_like(got))


# ---- the plan ---------------------------------------------------------------


@pytest.mark.parametrize("case", BWD_CASES)
def test_plan_gives_every_cell_one_warp(case):
    """The tiles of a row cover every cell once, level by level, and the
    warps of a tile's block own each of its cells once."""
    shapes, b, q, heads, dh, p = case
    hw = sum(h * w for h, w in shapes)
    plan = _plan(shapes, b, q, heads, dh, p)
    assert plan["blocks"] == b * heads * plan["tiles"]
    assert plan["tiles"] == sum(-(-h * w // t) for (h, w), t in
                                zip(shapes, plan["level_tiles"]))
    owners = np.zeros(hw, np.int64)
    for ti in range(plan["tiles"]):
        level, c0, ncell = K.deform_bwd_tile(plan, shapes, ti)
        assert 0 < ncell <= plan["level_tiles"][level]
        for w in range(K.STAMP_WARPS):
            cells = [c for c in range(ncell) if K.stamp_owner(c) == w]
            owners[[c0 + c for c in cells]] += 1
    assert np.array_equal(owners, np.ones(hw, np.int64))
    with pytest.raises(IndexError):
        K.deform_bwd_tile(plan, shapes, plan["tiles"])


@pytest.mark.parametrize("case", BWD_CASES)
def test_a_tile_lies_in_one_level_and_its_block_scans_that_level(case):
    shapes, b, q, heads, dh, p = case
    plan = _plan(shapes, b, q, heads, dh, p)
    starts = _starts(shapes) + (sum(h * w for h, w in shapes),)
    tpl = plan["taps_per_level"]
    assert tpl == q * 4 * p and plan["taps"] == len(shapes) * tpl
    for ti in range(plan["tiles"]):
        level, c0, ncell = K.deform_bwd_tile(plan, shapes, ti)
        assert starts[level] <= c0 and c0 + ncell <= starts[level + 1]
        assert ncell <= plan["level_tiles"][level]
        assert K.deform_bwd_scan(plan, shapes, ti) == (level * tpl,
                                                       (level + 1) * tpl)


def test_plan_at_the_rtdetr_train_shapes():
    """Q 428, 8 x 8 rows, values (8, 21504, 8, 32): the (3, 4) x 32-channel
    instantiation, 256-cell tiles at every level, 16-byte cell loads and
    d(values) stores; a block scans one level's 6,848 taps, a third of the
    row, so the scan reads 147 MB of cells from L2, not 442."""
    for esize, vec in ((2, 8), (4, 4)):
        plan = K.deform_bwd_plan(ROWS, RTDETR_LEVELS, Q_TRAIN, 4, 32, esize,
                                 0, False)
        assert (plan["vec"], plan["fixed"], plan["svec"]) == (vec, 1, vec)
        assert plan["rounds"] * plan["slots"] == 48
        assert plan["level_tiles"] == (256, 256, 256)
        assert (plan["tiles"], plan["blocks"]) == (84, 5376)
        assert plan["blocks"] >= H100_SMS
        assert plan["ivec"] == 1 and plan["taps"] == 20544
        assert 4 * (plan["smem"] + 1024) <= 232448   # four blocks an SM
    ranges = [K.deform_bwd_scan(plan, RTDETR_LEVELS, t) for t in range(84)]
    scanned = sum(tb - ta for ta, tb in ranges)
    assert scanned == 84 * 6848
    assert round(ROWS * scanned * 4 / 1e6) == 147
    assert round(ROWS * 84 * 20544 * 4 / 1e6) == 442


@pytest.mark.parametrize("case", BWD_CASES)
def test_plan_depends_on_the_shape_alone(case):
    """The scatter's tiles, and so the cells each warp owns and the ranges
    its blocks scan, depend on the shape alone, not on the dtype, the
    pointer or the layout; only the lanes and the store width read those."""
    shapes, b, q, heads, dh, p = case
    lanes = {"vec", "row_lanes", "slots", "passes", "rounds", "fixed",
             "svec"}

    def fixed(esize, ptr, transposed):
        plan = _plan(shapes, b, q, heads, dh, p, esize, ptr, transposed)
        return tuple(v for k, v in sorted(plan.items()) if k not in lanes)
    assert len({fixed(e, ptr, t) for e in (2, 4) for ptr in (0, 2, 4096 * 7)
                for t in (False, True)}) == 1


@pytest.mark.parametrize("dh,esize,ptr,transposed,vec,svec", [
    (32, 2, 0, False, 8, 8), (32, 2, 2, False, 1, 8),   # misaligned values
    (32, 2, 2, True, 8, 0),                             # values_t: no need
    (30, 4, 0, False, 1, 1), (30, 4, 0, True, 1, 0),    # 120-byte rows
    (12, 2, 0, True, 1, 0), (12, 4, 0, False, 4, 4),
    (48, 4, 0, True, 4, 0)])
def test_plan_wide_accesses_only_where_allowed(dh, esize, ptr, transposed,
                                               vec, svec):
    shapes = ((6, 10), (3, 5))
    plan = K.deform_bwd_plan(6, shapes, 7, 2, dh, esize, ptr, transposed)
    assert (plan["vec"], plan["svec"]) == (vec, svec)
    assert plan["ivec"] == 1                            # 56 taps a level
    assert K.deform_bwd_plan(6, shapes, 7, 3, dh, esize, ptr,
                             transposed)["ivec"] == 0      # 84 taps


@pytest.mark.parametrize("args", [
    (0, ((6, 10), (3, 5)), 7, 2, 32), (6, ((6, 10), (0, 5)), 7, 2, 32),
    (6, (), 7, 2, 32), (6, ((6, 10),), 0, 2, 32), (6, ((6, 10),), 7, 2, 0),
    (2 ** 20, ((1024, 1024),), 7, 2, 32),
    (1, ((6, 10),) * 4, 2 ** 25, 8, 32)])
def test_plan_refuses_what_the_kernels_cannot_take(args):
    with pytest.raises(ValueError):
        K.deform_bwd_plan(*args, 2, 0, False)


# ---- the wrappers -----------------------------------------------------------


def _wrapper_inputs(dtype, dout_dtype, transposed):
    shapes = ((6, 10), (3, 5), (2, 2))
    rng = np.random.default_rng(4)
    b, q, heads, dh, p = 2, 7, 3, 32, 4
    values = torch.from_numpy(rng.standard_normal((b, 79, heads, dh))
                              .astype(np.float32)).to(dtype)
    if transposed:
        values = DF.values_to_t(values)
    loc = torch.from_numpy(rng.uniform(0, 1, (b, q, heads, 3, p, 2))
                           .astype(np.float32))
    attn = torch.from_numpy(rng.uniform(0, 1, (b, q, heads, 3, p))
                            .astype(np.float32))
    dout = torch.from_numpy(rng.standard_normal((b, q, heads, dh))
                            .astype(np.float32)).to(dout_dtype)
    return shapes, values, loc, attn, dout


@pytest.fixture
def card_path(lib, monkeypatch):
    """The wrappers' card path on CPU tensors: the recording library and
    the card check passed; arm() then makes every call that would sort,
    zero-fill or cast a tensor fail."""
    monkeypatch.setattr(DF, "_require_card", lambda *a: None)

    def refuse(*args, **kwargs):
        raise AssertionError("a sort, zero fill or cast on the card's path")

    def arm():
        for name in ("sort", "argsort", "zeros", "zeros_like"):
            monkeypatch.setattr(torch, name, refuse)
        for name in ("to", "float", "bfloat16", "type", "sort", "zero_"):
            monkeypatch.setattr(torch.Tensor, name, refuse)
    return lib, arm


@pytest.mark.parametrize("entry", ["k5", "k5_g2", "k5_g2_t"])
@pytest.mark.parametrize("dtype,dout_dtype", [
    (torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
    (torch.bfloat16, torch.float32)])
def test_backward_wrappers_pass_the_plan(card_path, entry, dtype,
                                         dout_dtype):
    transposed = entry == "k5_g2_t"
    shapes, values, loc, attn, dout = _wrapper_inputs(dtype, dout_dtype,
                                                      transposed)
    fn = DF.ms_deform_attn_backward if entry == "k5" else \
        DF.ms_deform_attn_sorted_backward
    lib, arm = card_path
    arm()
    before = fn.launches
    if entry == "k5":
        dv, dloc, dattn = fn(values, list(shapes), loc, attn, dout)
    else:
        dv, dloc, dattn = fn(values, list(shapes), loc, attn, dout,
                             transposed)
    assert fn.launches == before + 1
    args = lib.calls["ms_deform_attn_bwd"]
    b, q, heads, dh = dout.shape
    plan = K.deform_bwd_plan(b * heads, shapes, q, 4, dh,
                             values.element_size(), values.data_ptr(),
                             transposed)
    assert args[:4] == (values.data_ptr(), loc.data_ptr(), attn.data_ptr(),
                        dout.data_ptr())                # dout as given
    assert args[4:6] == (dloc.data_ptr(), dattn.data_ptr())
    assert args[8] == dv.data_ptr()                     # no cast after
    assert args[9] == DF._levels_table(shapes)[1]
    tiles = ctypes.cast(args[10], ctypes.POINTER(ctypes.c_int))
    assert tuple(tiles[:3]) == plan["level_tiles"]
    assert args[11:21] == (b, 79, q, heads, dh, 3, 4, K.dtype_code(dtype),
                           K.dtype_code(dout_dtype), int(transposed))
    assert args[21:] == (plan["vec"], plan["row_lanes"], plan["fixed"],
                         plan["ivec"], plan["svec"], 0)
    assert dv.dtype == dtype and dv.shape == values.shape
    assert dv.is_contiguous()
    assert dloc.shape == loc.shape and dattn.shape == attn.shape


def test_backward_wrappers_make_scratch_of_the_plans_size(lib, recorder,
                                                          monkeypatch):
    """cell (int32) and coef (f32), one row of L Q P 4 taps a (batch, head),
    are the wrapper's only scratch."""
    monkeypatch.setattr(DF, "_require_card", lambda *a: None)
    shapes, values, loc, attn, dout = _wrapper_inputs(torch.bfloat16,
                                                      torch.bfloat16, False)
    made = recorder[1]
    made.clear()
    DF.ms_deform_attn_backward(values, shapes, loc, attn, dout)
    args = lib.calls["ms_deform_attn_bwd"]
    cell, coef = made[args[6]], made[args[7]]
    assert cell.dtype == torch.int32 and coef.dtype == torch.float32
    assert cell.shape == coef.shape == (2 * 3, 3 * 7 * 4 * 4)
    assert len(made) == 5              # cell, coef, dloc, dattn, dv


@pytest.mark.parametrize("case", range(len(_refusals())))
def test_backward_wrappers_refuse_what_they_refused(lib, monkeypatch, case):
    """As the forward: a shape the kernels do not instantiate is refused on
    the card's route (CPU tensors standing in) before any launch."""
    values, shapes, loc, attn, match, card = _refusals()[case]
    if card:
        monkeypatch.setattr(DF, "_require_card", lambda *a: None)
    dout = torch.zeros(loc.shape[:3] + values.shape[3:])
    for fn in (DF.ms_deform_attn_backward, DF.ms_deform_attn_sorted_backward):
        before = fn.launches
        with pytest.raises(ValueError, match=match):
            fn(values, shapes, loc, attn, dout)
        assert fn.launches == before
    assert lib.calls == {}


@pytest.mark.parametrize("bad,match", [
    (lambda d: d[:, :2], "takes dout"),
    (lambda d: d.unsqueeze(0), "takes dout"),
    (lambda d: d.half(), "values' dtype or float32"),
    (lambda d: d.double(), "values' dtype or float32")])
def test_backward_wrappers_refuse_a_bad_dout(monkeypatch, bad, match):
    monkeypatch.setattr(DF, "_require_card", lambda *a: None)
    shapes, values, loc, attn, dout = _wrapper_inputs(torch.bfloat16,
                                                      torch.bfloat16, False)
    for fn in (DF.ms_deform_attn_backward, DF.ms_deform_attn_sorted_backward):
        before = fn.launches
        with pytest.raises(ValueError, match=match):
            fn(values, shapes, loc, attn, bad(dout))
        assert fn.launches == before


def test_backward_wrappers_refuse_the_cpu():
    shapes, values, loc, attn, dout = _wrapper_inputs(torch.float32,
                                                      torch.float32, False)
    with pytest.raises(ValueError, match="CUDA card"):
        DF.ms_deform_attn_backward(values, shapes, loc, attn, dout)
    with pytest.raises(ValueError, match="CUDA card"):
        DF.ms_deform_attn_sorted_backward(values, shapes, loc, attn, dout)
