"""K5-g2 forward as redesigned for Hopper (``ms_deform_attn`` /
``ms_deform_attn_t`` on the card: K5's gather with an f32 out, and for
values_t a tiled relayout into rows before it), held on the CPU:

  * a model of ``values_t_to_rows_kernel`` driven by
    ``kernels.deform_relayout_plan`` writes every (batch, cell, channel)
    element of the rows exactly once, with the value of values_t, at odd
    shapes (HW 15, 79, 136; heads x dh 3 x 32 and 2 x 4) and with values_t
    one element past a 16-byte boundary; its 16-byte accesses are aligned
    and its staged tile meets at most 2-way bank conflicts;
  * the wrapper (a recording stand-in for the kernel library) passes the
    gather's plan, the cached level table and, for values_t alone, a
    workspace of the map's size and the relayout's plan; a call neither
    loads the library nor enters a device context;
  * a plain-torch model of the values_t route (rows by ``values_from_t``,
    then the plain sum) against the reference's sorted-tap kernel in
    interpret mode (2e-2 x max|ref|: it casts values to bf16 and multiplies
    bf16 one-hots) and against ``ms_deform_attn_ref`` (1e-5 x max|ref|: the
    same f32 products summed in another order), and bit-equal to the
    `values` route on the rows the relayout model makes.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp
from test_torch_deform_sorted import CASES, _inputs, _to_t
from test_torch_front_plan import recorder  # noqa: F401 (fixture)

from robust_object_detection_tpu.ops import deform as JD
from robust_object_detection_tpu_torch import kernels as K
from robust_object_detection_tpu_torch.ops import deform as DF

torch.set_num_threads(1)

BANKS = 32


def _indices(n, threads):
    """The indices a block-strided loop `for (i = t; i < n; i += threads)`
    visits, in the order (iteration, thread): one row per iteration."""
    i = np.arange(threads)[None, :] + threads * np.arange(
        -(-n // threads))[:, None]
    return np.where(i < n, i, -1)


def _max_conflict(words):
    """Most distinct 4-byte words one bank serves in a warp's access."""
    words = np.unique(words[words >= 0])
    return max(np.bincount(words % BANKS).max(), 1) if words.size else 0


def _relayout_model(plan, src, esize, ptr):
    """values_t_to_rows_kernel's index arithmetic on src (B, C, HW): returns
    the rows (B, HW, C), each element's write count and the worst bank
    conflict of the vector phases. Raises where a 16-byte access would be
    misaligned or an element access would leave the matrix."""
    b, c, hw = src.shape
    tc, tp, th, v = (plan[k] for k in ("tile_c", "tile_p", "threads",
                                       "piece"))
    pitch = plan["pitch"]
    assert pitch * esize % 4 == 0 and (pitch * esize // 4) % 2 == 1
    flat = src.reshape(-1)
    rows = np.zeros((b, hw, c), src.dtype)
    writes = np.zeros((b, hw, c), np.int64)
    worst = 0
    gx, gy, gz = plan["grid"]
    for bz in range(gz):
        for by in range(gy):
            for bx in range(gx):
                p0, c0 = bx * tp, by * tc
                full = c0 + tc <= c and p0 + tp <= hw
                # the staged tile, as flat indices into src (-1: unset)
                tile = np.full(tc * pitch, -1, np.int64)
                base = (bz * c + c0) * hw + p0    # src[bz, c0, p0], flat
                if plan["ld_vec"] and full:
                    for it in _indices(tc * tp // v, th):
                        for warp in it.reshape(-1, 32):
                            i = warp[warp >= 0]
                            cc, pp = i // (tp // v), i % (tp // v) * v
                            addr = ptr + (base + cc * hw + pp) * esize
                            assert (addr % 16 == 0).all()
                            word = (cc * pitch + pp) * esize
                            assert (word % 4 == 0).all()
                            for m in range(4):
                                worst = max(worst,
                                            _max_conflict(word // 4 + m))
                            for j in range(v):
                                tile[cc * pitch + pp + j] = \
                                    base + cc * hw + pp + j
                else:
                    for it in _indices(tc * tp, th):
                        e = it[it >= 0]
                        cc, pp = e // tp, e % tp
                        m = (c0 + cc < c) & (p0 + pp < hw)
                        tile[cc[m] * pitch + pp[m]] = base + cc[m] * hw + pp[m]
                if plan["st_vec"] and full:
                    for it in _indices(tp * tc // v, th):
                        for warp in it.reshape(-1, 32):
                            i = warp[warp >= 0]
                            pp, cc = i // (tc // v), i % (tc // v) * v
                            addr = ((bz * hw + p0 + pp) * c + c0 + cc) \
                                * esize
                            assert (addr % 16 == 0).all()
                            for j in range(v):
                                worst = max(worst, _max_conflict(
                                    ((cc + j) * pitch + pp) * esize // 4))
                                got = tile[(cc + j) * pitch + pp]
                                assert (got >= 0).all()
                                rows[bz, p0 + pp, c0 + cc + j] = flat[got]
                                writes[bz, p0 + pp, c0 + cc + j] += 1
                else:
                    for it in _indices(tp * tc, th):
                        e = it[it >= 0]
                        pp, cc = e // tc, e % tc
                        m = (c0 + cc < c) & (p0 + pp < hw)
                        got = tile[cc[m] * pitch + pp[m]]
                        assert (got >= 0).all()
                        rows[bz, p0 + pp[m], c0 + cc[m]] = flat[got]
                        np.add.at(writes, (bz, p0 + pp[m], c0 + cc[m]), 1)
    return rows, writes, worst


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("esize", [2, 4])
@pytest.mark.parametrize("n_h,dh", [(3, 32), (2, 4), (8, 32)])
@pytest.mark.parametrize("hw", [15, 79, 128, 136])
def test_relayout_writes_every_element_once(hw, n_h, dh, esize, offset):
    """offset: values_t one element past a 16-byte boundary."""
    b = 2
    ptr = 4096 + offset * esize
    plan = K.deform_relayout_plan(b, n_h, dh, hw, esize, ptr)
    c = n_h * dh
    assert plan["c"] == c
    src = np.arange(b * c * hw, dtype=np.int64).reshape(b, c, hw)
    rows, writes, worst = _relayout_model(plan, src, esize, ptr)
    np.testing.assert_array_equal(writes, np.ones_like(writes))
    np.testing.assert_array_equal(rows, src.transpose(0, 2, 1))
    assert worst <= 2


@pytest.mark.parametrize("args,want", [
    ((8, 8, 32, 21504, 2, 0), (1, 1, (336, 4, 8))),   # the train shapes
    ((8, 8, 32, 21504, 4, 0), (1, 1, (336, 4, 8))),
    ((8, 8, 32, 21504, 2, 2), (0, 1, (336, 4, 8))),   # values_t misaligned
    ((2, 3, 32, 79, 2, 0), (0, 1, (2, 2, 2))),        # HW 79: no 16 bytes
    ((2, 2, 4, 16, 4, 0), (1, 1, (1, 1, 2))),
    ((2, 2, 3, 16, 2, 0), (1, 0, (1, 1, 2))),         # 6 channels
    ((1, 1, 1, 1, 4, 0), (0, 0, (1, 1, 1)))])
def test_relayout_plan_flags_and_grid(args, want):
    plan = K.deform_relayout_plan(*args)
    assert (plan["ld_vec"], plan["st_vec"], plan["grid"]) == want
    assert plan["piece"] == 16 // args[4]
    assert plan["threads"] == 256 and plan["tile_c"] == plan["tile_p"] == 64


@pytest.mark.parametrize("args", [(0, 8, 32, 64, 2, 0), (1, 8, 0, 64, 2, 0),
                                  (1, 8, 32, 0, 2, 0),
                                  (70000, 1, 8, 64, 2, 0),
                                  (1, 1 << 16, 65, 64, 4, 0)])
def test_relayout_plan_refuses_what_the_grid_cannot_take(args):
    with pytest.raises(ValueError):
        K.deform_relayout_plan(*args)


SHAPES = ((8, 10), (4, 5), (2, 2))      # HW 104, a multiple of 16 bytes


def _stub_inputs(dtype, b=2, q=7, heads=3, dh=32, p=4, misaligned=False,
                 transposed=False):
    rng = np.random.default_rng(3)
    hw = sum(h * w for h, w in SHAPES)
    values = torch.from_numpy(rng.standard_normal(
        (b, hw, heads, dh)).astype(np.float32)).to(dtype)
    if transposed:
        values = DF.values_to_t(values)
    if misaligned:         # one element past a 16-byte boundary
        flat = torch.empty(values.numel() + 1, dtype=dtype)
        flat[1:] = values.reshape(-1)
        values = flat[1:].view(values.shape)
    loc = torch.from_numpy(rng.uniform(0, 1, (b, q, heads, 3, p, 2))
                           .astype(np.float32))
    attn = torch.from_numpy(rng.uniform(0, 1, (b, q, heads, 3, p))
                            .astype(np.float32))
    return values, loc, attn


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("layout", ["values", "values_t",
                                    "values_t misaligned"])
def test_sorted_forward_passes_the_plan_and_a_workspace_for_values_t(
        recorder, monkeypatch, dtype, layout):  # noqa: F811
    lib, made = recorder
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    transposed = layout != "values"
    values, loc, attn = _stub_inputs(dtype, misaligned="mis" in layout,
                                     transposed=transposed)
    b, q, heads, n_l, p = attn.shape
    dh = values.shape[2] if transposed else values.shape[3]
    hw = sum(h * w for h, w in SHAPES)
    esize = values.element_size()
    made.clear()
    out = DF._sorted_forward_cuda(values, SHAPES, loc, attn, transposed)
    args = lib.calls["ms_deform_attn_sorted_fwd"]
    assert args[:4] == (values.data_ptr(), loc.data_ptr(), attn.data_ptr(),
                        out.data_ptr())
    assert args[5] == DF._levels_table(SHAPES)[1]
    assert out.shape == (b, q, heads, dh) and out.dtype == torch.float32
    ws = args[4]
    if transposed:
        # the workspace: the map in rows, values' dtype; out beside it
        assert set(made) == {out.data_ptr(), ws}
        assert made[ws].shape == (b, hw, heads, dh)
        assert made[ws].dtype == dtype
        rows_ptr = ws
        relayout = K.deform_relayout_plan(b, heads, dh, hw, esize,
                                          values.data_ptr())
        flags = (relayout["ld_vec"], relayout["st_vec"])
        assert flags == ((0, 1) if "mis" in layout else (1, 1))
    else:
        assert ws == 0 and set(made) == {out.data_ptr()}
        rows_ptr, flags = values.data_ptr(), (0, 0)
    plan = K.deform_fwd_plan(n_l, p, dh, esize, rows_ptr)
    # the gather reads the aligned workspace in 16-byte pieces even where
    # values_t itself is misaligned
    assert plan["vec"] == 16 // esize and plan["fixed"] == 1
    assert args[6:] == (b, hw, q, heads, dh, n_l, p, K.dtype_code(dtype),
                        int(transposed), plan["vec"], plan["row_lanes"],
                        plan["fixed"], *flags, 0)


@pytest.mark.parametrize("route", ["K5", "values", "values_t"])
def test_a_call_neither_loads_the_library_nor_enters_a_device_context(
        recorder, monkeypatch, route):  # noqa: F811
    """Once the library is loaded and the entry looked up, a call goes
    straight to the entry on the current stream."""
    lib, _ = recorder
    monkeypatch.setattr(K, "_lib", lib)             # the library, loaded
    monkeypatch.setattr(K, "_entries", {})
    # a CPU tensor's device index (None) stands for the current device
    monkeypatch.setattr(torch.cuda, "current_device", lambda: None)
    monkeypatch.setattr(DF, "_require_card", lambda *a: None)
    values, loc, attn = _stub_inputs(torch.bfloat16,
                                     transposed=route == "values_t")
    if route == "K5":
        counter = DF.ms_deform_attn_slots

        def call():
            DF._forward_cuda(values, SHAPES, loc, attn)
    else:
        counter = DF.ms_deform_attn_sorted_forward

        def call():
            DF.ms_deform_attn_sorted_forward(values, SHAPES, loc, attn,
                                             route == "values_t")
    call()                                          # looks the entry up
    loads = []
    monkeypatch.setattr(K, "load", lambda: loads.append(1) or lib)

    def no_context(dev):
        raise AssertionError(f"entered a device context for {dev}")
    monkeypatch.setattr(torch.cuda, "device", no_context)
    before = counter.launches
    call()
    assert loads == [] and counter.launches == before + 1
    name = "ms_deform_attn_fwd" if route == "K5" \
        else "ms_deform_attn_sorted_fwd"
    assert set(lib.calls) == {name}


@pytest.mark.parametrize("name", list(CASES))
def test_values_t_route_model_matches_reference(name):
    """The values_t route as the card runs it, in plain torch: the map
    relaid into rows, then the plain f32 sum."""
    values, shapes, loc, attn, _ = _inputs(7, **CASES[name])
    vt = _to_t(values)
    got = DF._ref_sum(DF.values_from_t(torch.from_numpy(vt)), shapes,
                      torch.from_numpy(loc), torch.from_numpy(attn)).numpy()
    ref = np.asarray(JD.ms_deform_attn_ref(
        jnp.asarray(values), shapes, jnp.asarray(loc), jnp.asarray(attn)))
    assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()
    JD._INTERPRET = True
    try:
        tpu = np.asarray(JD._ms_deform_attn_tpu_t(
            shapes, jnp.asarray(vt), jnp.asarray(loc), jnp.asarray(attn)))
    finally:
        JD._INTERPRET = False
    assert np.abs(got - tpu).max() <= 2e-2 * np.abs(tpu).max()


@pytest.mark.parametrize("name", ["p4_production_points", "dh32",
                                  "taps_outside"])
def test_values_t_route_gives_the_values_route_bits(name):
    """The relayout model's rows are values, bit for bit, so the gather on
    them sums the same products in the same order as on `values`."""
    values, shapes, loc, attn, _ = _inputs(8, **CASES[name])
    b, hw, heads, dh = values.shape
    vt = _to_t(values)
    plan = K.deform_relayout_plan(b, heads, dh, hw, 4, 0)
    rows, _, _ = _relayout_model(plan, vt.reshape(b, heads * dh, hw), 4, 0)
    np.testing.assert_array_equal(rows.reshape(values.shape), values)
    args = (torch.from_numpy(loc), torch.from_numpy(attn))
    assert torch.equal(
        DF._ref_sum(torch.from_numpy(rows.reshape(values.shape)), shapes,
                    *args),
        DF._ref_sum(torch.from_numpy(values), shapes, *args))
