"""Multi-scale deformable attention, forward and backward (counterpart of
ops/deform.py ``ms_deform_attn_slots`` / ``ms_deform_attn_ref``).

For every (batch, query, head): over L levels x P points, bilinear-sample
the level's value map at ``loc`` (normalised [0, 1]; pixel coordinate
``loc * size - 0.5``, the four taps around it, weight 0 for a tap outside
the map), weight by ``attn`` and sum. Values are one flat (B, HW, heads,
dh) tensor, the levels' row-major maps one after another in ``shapes``
order — the layout of the reference's ``ms_deform_attn_ref``. (The
reference's transposed ``values_t`` exists to fill TPU lanes; here a tap's
dh channels are one contiguous row.)

:func:`ms_deform_attn_slots` launches ``ms_deform_attn_fwd`` of
``csrc/ms_deform_attn.cu`` (K5 forward) on CUDA tensors and runs
:func:`ms_deform_attn_ref`, the plain gather version, on CPU tensors. Any
other device, dtype, layout or shape raises. On CUDA it is a
``torch.autograd.Function`` whose backward launches ``ms_deform_attn_bwd``
(K5 backward, :func:`ms_deform_attn_backward`); on the CPU the backward is
autograd through the plain version's ``torch.gather``.

Both versions sum in f32 and return values' dtype (one rounding). The
backward (``csrc/deform_bwd.cu``, shared with K5-g2) is two launches: a
taps kernel writes d(loc) and d(attn), the same bits for any query order,
and each tap's cell and coefficient; an owner scatter sums d(values) cell by
cell in tap order and writes it once in values' dtype: the same bits on
every run.

The two earlier generations of the reference's op family are here too, with
the reference's signatures and layouts:

* :func:`bilinear_sample` (one level, pixel coordinates) with the
  reference's custom backward: the forward and d(sx), d(sy) are gathers and
  elementwise products, d(v) is :func:`stamp_scatter` (K5-g1,
  ``csrc/stamp_scatter.cu``; plain version :func:`stamp_scatter_ref`);
* :func:`ms_deform_attn` (values (B, HW, heads, dh)) and
  :func:`ms_deform_attn_t` (values_t (B, heads, dh, HW)), the sorted-tap
  generation (K5-g2 forward, ``csrc/ms_deform_attn_sorted.cu``). They
  return f32 whatever values' dtype: K5's gather (``csrc/deform_fwd.cuh``)
  stores its f32 sums, so on `values` they are K5's out before its
  rounding. values_t is first relaid into rows by a tiled transpose into a
  workspace the size of the map (freed after the call), then gathered the
  same way: the same bits as `values`. Their backward is K5's
  (``csrc/deform_bwd.cu``) in either layout, d(values) in values' dtype and
  layout, the same bits as K5's on the same inputs. Plain versions:
  :func:`ms_deform_attn_ref` in f32 and :func:`ms_deform_attn_backward_ref`.

On CPU tensors every entry point runs its plain version; on CUDA tensors it
launches its kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence, Tuple

import torch

from .. import kernels

MAX_LEVELS = 4     # csrc/ms_deform_attn.cu: MAX_LEVELS, and L * P <= 32


def _pixel_taps(sx: torch.Tensor, sy: torch.Tensor, h, w):
    """The four bilinear taps around pixel coordinates (sx, sy) of a map of
    h rows and w columns (numbers, or f32 tensors that broadcast against
    sx). Returns (idx int64, weight, dweight/dsx, dweight/dsy), each sx's
    shape + (4,): the cell y * w + x clipped into the map, and the weight
    and both derivatives 0 for a tap outside it (``_tap_geometry``)."""
    h = torch.as_tensor(h, dtype=torch.float32, device=sx.device)
    w = torch.as_tensor(w, dtype=torch.float32, device=sx.device)
    x0, y0 = torch.floor(sx), torch.floor(sy)
    fx, fy = sx - x0, sy - y0
    taps = ((x0, y0, (1 - fx) * (1 - fy), -(1 - fy), -(1 - fx)),
            (x0 + 1, y0, fx * (1 - fy), 1 - fy, -fx),
            (x0, y0 + 1, (1 - fx) * fy, -fy, 1 - fx),
            (x0 + 1, y0 + 1, fx * fy, fy, fx))
    idxs, wgts, dxs, dys = [], [], [], []
    for xi, yi, wgt, dwx, dwy in taps:
        inside = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
        xi_c = torch.minimum(xi.clamp(min=0), w - 1).long()
        yi_c = torch.minimum(yi.clamp(min=0), h - 1).long()
        idxs.append(yi_c * w.long() + xi_c)
        zero = torch.zeros_like(wgt)
        wgts.append(torch.where(inside, wgt, zero))
        dxs.append(torch.where(inside, dwx, zero))
        dys.append(torch.where(inside, dwy, zero))
    return (torch.stack(idxs, -1), torch.stack(wgts, -1),
            torch.stack(dxs, -1), torch.stack(dys, -1))


def tap_geometry_full(loc: torch.Tensor, shapes: Sequence[Tuple[int, int]]):
    """loc (B, Q, heads, L, P, 2) f32 -> (idx int64, weight, dwx, dwy), each
    (B, Q, heads, L, P, 4): the flat cell index over the merged HW axis
    (level offsets applied, clipped into the level), the bilinear weight of
    the four taps and its derivatives by the level's PIXEL coordinates, all
    three 0 for a tap outside (``_merged_geometry``)."""
    dev = loc.device
    w_l = torch.tensor([w for _, w in shapes], dtype=torch.float32,
                       device=dev)[:, None]
    h_l = torch.tensor([h for h, _ in shapes], dtype=torch.float32,
                       device=dev)[:, None]
    starts, total = [], 0
    for h, w in shapes:
        starts.append(total)
        total += h * w
    off_l = torch.tensor(starts, dtype=torch.int64, device=dev)[:, None, None]
    sx = loc[..., 0] * w_l - 0.5                       # (B, Q, heads, L, P)
    sy = loc[..., 1] * h_l - 0.5
    idx, wgt, dwx, dwy = _pixel_taps(sx, sy, h_l, w_l)
    return idx + off_l, wgt, dwx, dwy


def tap_geometry(loc: torch.Tensor, shapes: Sequence[Tuple[int, int]]
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The (idx, weight) of :func:`tap_geometry_full`
    (``_geometry_batched``)."""
    return tap_geometry_full(loc, shapes)[:2]


def _gather_taps(values: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """values (B, HW, heads, dh), idx (B, Q, heads, N) cells -> the rows
    values[b, idx, head] as (B, Q, heads, N, dh)."""
    b, hw, n_h, dh = values.shape
    q = idx.shape[1]
    heads = torch.arange(n_h, device=values.device)[None, None, :, None]
    gidx = (idx * n_h + heads).reshape(b, -1)
    g = torch.gather(values.reshape(b, hw * n_h, dh), 1,
                     gidx[..., None].expand(-1, -1, dh))
    return g.reshape(b, q, n_h, -1, dh)


def _ref_sum(values, shapes, loc, attn) -> torch.Tensor:
    """The plain version's f32 sum, (B, Q, heads, dh)."""
    b, _, n_h, _ = values.shape
    q = loc.shape[1]
    idx, w = tap_geometry(loc.float(), shapes)         # (B,Q,heads,L,P,4)
    c = w * attn.float()[..., None]
    g = _gather_taps(values, idx.reshape(b, q, n_h, -1)).float()
    return (g * c.reshape(b, q, n_h, -1, 1)).sum(3)


def ms_deform_attn_ref(values: torch.Tensor,
                       shapes: Sequence[Tuple[int, int]], loc: torch.Tensor,
                       attn: torch.Tensor) -> torch.Tensor:
    """Plain version: gather the taps' rows, weight, sum. values (B, HW,
    heads, dh); loc (B, Q, heads, L, P, 2); attn (B, Q, heads, L, P) ->
    (B, Q, heads, dh) in values' dtype."""
    return _ref_sum(values, shapes, loc, attn).to(values.dtype)


def ms_deform_attn_backward_ref(values, shapes, loc, attn, dout):
    """Plain version of the backward, written out as the kernels compute it
    (``_tpu_bwd_core``): the per-tap scalars s = <dout[q], values[cell]>
    give d(attn) = sum_tap s * weight and d(loc) = attn * sum_tap s *
    (dwx * W_l, dwy * H_l); d(values) adds dout[q] * attn * weight into each
    tap's cell with ``index_add_``. values (B, HW, heads, dh), dout (B, Q,
    heads, dh) -> (d values in values' dtype, d loc f32, d attn f32)."""
    b, hw, n_h, dh = values.shape
    q = loc.shape[1]
    idx, w, dwx, dwy = tap_geometry_full(loc.float(), shapes)
    flat_idx = idx.reshape(b, q, n_h, -1)
    dout = dout.float()
    taps = _gather_taps(values, flat_idx).float()      # (B,Q,heads,LP4,dh)
    s = (taps * dout[:, :, :, None, :]).sum(-1).reshape(idx.shape)
    dattn = (s * w).sum(-1)
    ds = s * attn.float()[..., None]
    scale = torch.tensor([(w_, h_) for h_, w_ in shapes],
                         dtype=torch.float32, device=values.device)
    dloc = torch.stack([(ds * dwx).sum(-1), (ds * dwy).sum(-1)], -1) \
        * scale[:, None, :]
    c = (w * attn.float()[..., None]).reshape(b, q, n_h, -1, 1)
    heads = torch.arange(n_h, device=values.device)[None, None, :, None]
    batch = torch.arange(b, device=values.device)[:, None, None, None]
    rows = ((batch * hw + flat_idx) * n_h + heads).reshape(-1)
    dv = torch.zeros(b * hw * n_h, dh, dtype=torch.float32,
                     device=values.device)
    dv.index_add_(0, rows, (dout[:, :, :, None, :] * c).reshape(-1, dh))
    return dv.reshape(values.shape).to(values.dtype), dloc, dattn


def _check(values, shapes, loc, attn, transposed: bool = False) -> None:
    """Raises on what no version takes: shapes, dtypes, devices, layout.
    transposed: values is the (B, heads, dh, HW) layout of
    :func:`ms_deform_attn_t`. The kernels' own limits are
    :func:`_kernel_limits`, checked by the card's routes alone."""
    if values.dim() != 4 or loc.dim() != 6 or attn.dim() != 5:
        layout = "(B,heads,dh,HW)" if transposed else "(B,HW,heads,dh)"
        raise ValueError(f"ms_deform_attn takes values {layout}, loc "
                         f"(B,Q,heads,L,P,2) and attn (B,Q,heads,L,P), got "
                         f"{tuple(values.shape)}, {tuple(loc.shape)}, "
                         f"{tuple(attn.shape)}")
    if transposed:
        b, n_h, _, hw = values.shape
    else:
        b, hw, n_h, _ = values.shape
    n_l, n_p = loc.shape[3], loc.shape[4]
    if (loc.shape[0] != b or loc.shape[2] != n_h or loc.shape[5] != 2
            or tuple(attn.shape) != tuple(loc.shape[:5])):
        raise ValueError(f"ms_deform_attn: loc {tuple(loc.shape)} / attn "
                         f"{tuple(attn.shape)} do not match values "
                         f"{tuple(values.shape)}")
    if len(shapes) != n_l or sum(h * w for h, w in shapes) != hw:
        raise ValueError(f"ms_deform_attn: {n_l} levels over {hw} cells do "
                         f"not match shapes {tuple(shapes)}")
    if 0 in loc.shape or 0 in values.shape:
        raise ValueError(f"ms_deform_attn takes no empty dimension, got "
                         f"values {tuple(values.shape)}, loc "
                         f"{tuple(loc.shape)}")
    if (values.dtype not in (torch.float32, torch.bfloat16)
            or loc.dtype != torch.float32 or attn.dtype != torch.float32):
        raise ValueError(f"ms_deform_attn takes float32 or bfloat16 values "
                         f"and float32 loc and attn, got {values.dtype}, "
                         f"{loc.dtype}, {attn.dtype}")
    if loc.device != values.device or attn.device != values.device:
        raise ValueError("ms_deform_attn: all tensors must be on one device")
    if not (values.is_contiguous() and loc.is_contiguous()
            and attn.is_contiguous()):
        raise ValueError("ms_deform_attn takes contiguous tensors")
    if values.device.type not in ("cpu", "cuda"):
        raise ValueError(f"ms_deform_attn runs on cpu or cuda, got "
                         f"{values.device}")


def _kernel_limits(loc) -> None:
    """Raises, before any launch, on the level and point counts the kernels
    do not instantiate. The plain versions on the CPU take any L and P, as
    the reference does off the TPU."""
    n_l, n_p = loc.shape[3], loc.shape[4]
    if n_l > MAX_LEVELS or n_l * n_p > 32:
        raise ValueError(f"the deformable-attention kernels take at most "
                         f"{MAX_LEVELS} levels and 32 sampling points a "
                         f"query and head, got L {n_l} P {n_p}")


def _levels_arg(shapes):
    levels, start = [], 0
    for h, w in shapes:
        levels += [h, w, start]
        start += h * w
    return (ctypes.c_int * len(levels))(*levels)


@functools.lru_cache(maxsize=64)
def _levels_table(shapes):
    """The level table of :func:`_levels_arg` for a tuple of (H, W) int
    pairs, built once (the kernels copy it at launch) and its address."""
    table = _levels_arg(shapes)
    return table, ctypes.addressof(table)


@functools.lru_cache(maxsize=64)
def _fwd_plan(n_l, n_p, dh, esize, aligned):
    return kernels.deform_fwd_plan(n_l, n_p, dh, esize, 0 if aligned else 1)


def _forward_cuda(values, shapes, loc, attn) -> torch.Tensor:
    _kernel_limits(loc)
    b, hw, n_h, dh = values.shape
    q, n_l, n_p = loc.shape[1], loc.shape[3], loc.shape[4]
    out = torch.empty((b, q, n_h, dh), dtype=values.dtype,
                      device=values.device)
    plan = _fwd_plan(n_l, n_p, dh, values.element_size(),
                     values.data_ptr() % 16 == 0)
    err = kernels.launch(
        values.device, "ms_deform_attn_fwd", values.data_ptr(),
        loc.data_ptr(), attn.data_ptr(), out.data_ptr(),
        _levels_table(shapes)[1], b, hw, q, n_h, dh, n_l, n_p,
        kernels.dtype_code(values.dtype), plan["vec"], plan["row_lanes"],
        plan["fixed"])
    kernels.check(err, "ms_deform_attn_fwd")
    ms_deform_attn_slots.launches += 1
    return out


def _require_card(values, name, what) -> None:
    """Raises unless values lies on a CUDA card: `name` launches `what`
    there and has no CPU version."""
    if values.device.type != "cuda":
        raise ValueError(f"{name} launches {what} on a CUDA card, got "
                         f"{values.device}")


def _shape_key(shapes):
    """``shapes`` as a tuple of (H, W) int pairs (the level table's key)."""
    return tuple((int(h), int(w)) for h, w in shapes)


def _dout_arg(name, values, dout, want):
    """dout checked against its shape `want` and values' device, in values'
    dtype or f32 as given (the kernel reads either), contiguous."""
    if tuple(dout.shape) != want or dout.device != values.device:
        raise ValueError(f"{name} takes dout {want} on values' device, got "
                         f"{tuple(dout.shape)} on {dout.device}")
    if dout.dtype not in (values.dtype, torch.float32):
        raise ValueError(f"{name} takes dout in values' dtype or float32, "
                         f"got {dout.dtype}")
    return dout.contiguous()


@functools.lru_cache(maxsize=256)
def _bwd_plan(rows, shapes, q, n_p, dh, esize, aligned, transposed):
    """The plan of :func:`kernels.deform_bwd_plan` as the launch takes it:
    the level tiles' host table and its address, the lane and store
    arguments (vec, row_lanes, fixed, ivec, svec) and the taps of a row."""
    plan = kernels.deform_bwd_plan(rows, shapes, q, n_p, dh, esize,
                                   0 if aligned else 1, transposed)
    tiles = (ctypes.c_int * len(shapes))(*plan["level_tiles"])
    return ((tiles, ctypes.addressof(tiles)),
            tuple(plan[k] for k in ("vec", "row_lanes", "fixed", "ivec",
                                    "svec")), plan["taps"])


def _backward_cuda(values, shapes, loc, attn, dout, transposed):
    """The two launches of the backward (``ms_deform_attn_bwd``) on a
    checked call: the taps kernel, then the owner scatter. shapes: the
    level table's key; dout as :func:`_dout_arg` returns it. Returns (d
    values in values' dtype and layout, d loc, d attn)."""
    _kernel_limits(loc)
    b, hw, n_h, dh, q, n_l, n_p = _sizes(values, loc, transposed)
    tiles, args, taps = _bwd_plan(b * n_h, shapes, q, n_p, dh,
                                  values.element_size(),
                                  values.data_ptr() % 16 == 0, transposed)
    dev = values.device
    cell = torch.empty((b * n_h, taps), dtype=torch.int32, device=dev)
    coef = torch.empty((b * n_h, taps), dtype=torch.float32, device=dev)
    dloc = torch.empty_like(loc)
    dattn = torch.empty_like(attn)
    dv = torch.empty_like(values)
    err = kernels.launch(
        dev, "ms_deform_attn_bwd", values.data_ptr(), loc.data_ptr(),
        attn.data_ptr(), dout.data_ptr(), dloc.data_ptr(), dattn.data_ptr(),
        cell.data_ptr(), coef.data_ptr(), dv.data_ptr(),
        _levels_table(shapes)[1], tiles[1], b, hw, q, n_h, dh, n_l, n_p,
        kernels.dtype_code(values.dtype), kernels.dtype_code(dout.dtype),
        int(transposed), *args)
    kernels.check(err, "ms_deform_attn_bwd")
    return dv, dloc, dattn


def ms_deform_attn_backward(values, shapes, loc, attn, dout):
    """K5 backward on the card: values (B, HW, heads, dh), loc, attn as
    :func:`ms_deform_attn_slots` takes them and dout (B, Q, heads, dh) in
    values' dtype or f32 -> (d values in values' dtype, d loc f32, d attn
    f32). Two launches (``csrc/deform_bwd.cu``); d(values) has the same bits
    on every run, and those of :func:`ms_deform_attn_sorted_backward` on the
    same inputs. CUDA tensors only: on the CPU the backward is the autograd
    of :func:`ms_deform_attn_ref`."""
    _check(values, shapes, loc, attn)
    _require_card(values, "ms_deform_attn_backward", "K5 backward")
    b, _, n_h, dh = values.shape
    dout = _dout_arg("ms_deform_attn_backward", values, dout,
                     (b, loc.shape[1], n_h, dh))
    grads = _backward_cuda(values, _shape_key(shapes), loc, attn, dout,
                           False)
    ms_deform_attn_backward.launches += 1
    return grads


ms_deform_attn_backward.launches = 0


class _MsDeformAttn(torch.autograd.Function):

    @staticmethod
    def forward(ctx, values, loc, attn, shapes):
        ctx.save_for_backward(values, loc, attn)
        ctx.shapes = shapes
        return _forward_cuda(values, shapes, loc, attn)

    @staticmethod
    def backward(ctx, dout):
        values, loc, attn = ctx.saved_tensors
        dv, dloc, dattn = ms_deform_attn_backward(values, ctx.shapes, loc,
                                                  attn, dout)
        return dv, dloc, dattn, None


def ms_deform_attn_slots(values: torch.Tensor,
                         shapes: Sequence[Tuple[int, int]],
                         loc: torch.Tensor,
                         attn: torch.Tensor) -> torch.Tensor:
    """values (B, HW, heads, dh) f32 or bf16, the levels of ``shapes``
    ((H_l, W_l), ...) flattened row-major and concatenated; loc (B, Q,
    heads, L, P, 2) f32 in [0, 1]; attn (B, Q, heads, L, P) f32. Returns
    (B, Q, heads, dh) in values' dtype. Any query order gives the same
    result, bit for bit. Differentiable in values, loc and attn."""
    _check(values, shapes, loc, attn)
    if values.device.type == "cpu":
        return ms_deform_attn_ref(values, shapes, loc, attn)
    shapes = tuple((int(h), int(w)) for h, w in shapes)
    if torch.is_grad_enabled() and (values.requires_grad or loc.requires_grad
                                    or attn.requires_grad):
        return _MsDeformAttn.apply(values, loc, attn, shapes)
    return _forward_cuda(values, shapes, loc, attn)


ms_deform_attn_slots.launches = 0


# ── generation 1: one level's bilinear sampling, d(v) by stamp scatter ────


def stamp_scatter_ref(idx: torch.Tensor, gw: torch.Tensor, hw: int
                      ) -> torch.Tensor:
    """Plain version of :func:`stamp_scatter`: ``index_add_`` of every
    tap's column into its cell."""
    b, n_h, dh, t = gw.shape
    rows = torch.arange(b * n_h, device=gw.device).reshape(b, n_h, 1)
    out = torch.zeros(b * n_h * hw, dh, dtype=torch.float32, device=gw.device)
    out.index_add_(0, (rows * hw + idx.long()).reshape(-1),
                   gw.float().permute(0, 1, 3, 2).reshape(-1, dh))
    return out.reshape(b, n_h, hw, dh).permute(0, 1, 3, 2).contiguous()


def _gw_strides(gw: torch.Tensor):
    """(channel, tap) element strides of a gw (B, heads, dh, T) that the
    kernel reads in place: a contiguous gw, (T, 1), or the transpose of a
    contiguous (B, heads, T, dh), (1, dh); None for any other layout."""
    if gw.is_contiguous():
        return gw.shape[3], 1
    if gw.transpose(2, 3).is_contiguous():
        return 1, gw.shape[2]
    return None


def stamp_scatter(idx: torch.Tensor, gw: torch.Tensor, hw: int
                  ) -> torch.Tensor:
    """idx (B, heads, T) int32 or int64 cells in [0, hw); gw (B, heads, dh,
    T) f32, contiguous or the transposed view of a contiguous (B, heads, T,
    dh) (a tap's dh channels then one row). Returns dv (B, heads, dh, hw)
    f32 with dv[b, h, :, c] the sum of gw[b, h, :, t] over the taps t with
    idx[b, h, t] == c, taken in the order of t from +0.0
    (``_stamp_scatter``). On CUDA tensors: one launch of K5-g1, which
    writes every cell once; two runs give the same bits."""
    if idx.dim() != 3 or gw.dim() != 4 or hw <= 0 or 0 in gw.shape or (
            tuple(idx.shape) != (gw.shape[0], gw.shape[1], gw.shape[3])):
        raise ValueError(f"stamp_scatter takes idx (B,heads,T), gw "
                         f"(B,heads,dh,T) and hw > 0, got "
                         f"{tuple(idx.shape)}, {tuple(gw.shape)}, hw {hw}")
    if idx.dtype not in (torch.int32, torch.int64) \
            or gw.dtype != torch.float32:
        raise ValueError(f"stamp_scatter takes int32 or int64 idx and "
                         f"float32 gw, got {idx.dtype}, {gw.dtype}")
    if idx.device != gw.device or gw.device.type not in ("cpu", "cuda"):
        raise ValueError(f"stamp_scatter: idx and gw must be on one cpu or "
                         f"cuda device, got {idx.device}, {gw.device}")
    strides = _gw_strides(gw)
    if not idx.is_contiguous() or strides is None:
        raise ValueError("stamp_scatter takes a contiguous idx and a "
                         "contiguous gw or the transpose of a contiguous "
                         "(B,heads,T,dh)")
    if gw.device.type == "cpu":
        return stamp_scatter_ref(idx, gw, hw)
    return _stamp_scatter_cuda(idx, gw, hw, strides)


def _stamp_scatter_cuda(idx, gw, hw, strides) -> torch.Tensor:
    """One launch of K5-g1 on a checked call; strides: gw's (channel, tap)
    element strides."""
    b, n_h, dh, t = gw.shape
    dv = torch.empty((b, n_h, dh, hw), dtype=torch.float32, device=gw.device)
    plan = _stamp_plan(b * n_h, hw, t, dh, idx.data_ptr() % 16,
                       gw.data_ptr() % 8, strides[1])
    err = kernels.launch(gw.device, "stamp_scatter", idx.data_ptr(),
                         gw.data_ptr(), dv.data_ptr(), b * n_h, t, hw, dh,
                         *strides, idx.element_size(), *plan)
    kernels.check(err, "stamp_scatter")
    stamp_scatter.launches += 1
    return dv


stamp_scatter.launches = 0


@functools.lru_cache(maxsize=256)
def _stamp_plan(rows, hw, t, dh, idx_offset, gw_offset, tap_stride):
    """(tile, ivec, pairs) of :func:`kernels.stamp_plan` for pointers whose
    16-byte (idx) and 8-byte (gw) offsets are given."""
    plan = kernels.stamp_plan(rows, hw, t, dh, (idx_offset, gw_offset),
                              tap_stride)
    return plan["tile"], plan["ivec"], plan["pairs"]


def _level_taps(v, sx, sy):
    """(idx, weight, dwx, dwy, tap rows) of one level: the first four (B,
    Q, heads, P, 4), the rows (B, Q, heads, P, 4, dh) f32."""
    b, h, w, n_h, dh = v.shape
    geo = _pixel_taps(sx.float(), sy.float(), h, w)
    taps = _gather_taps(v.reshape(b, h * w, n_h, dh), geo[0].flatten(3))
    return (*geo, taps.float().reshape(*geo[0].shape, dh))


def bilinear_sample_ref(v, sx, sy) -> torch.Tensor:
    """Plain version of :func:`bilinear_sample`: the same gather and
    weights in f32 with no custom backward (autograd differentiates the
    gather), (B, Q, heads, P, dh) float32."""
    _, wgt, _, _, taps = _level_taps(v, sx, sy)
    return (taps * wgt[..., None]).sum(-2)


class _BilinearSample(torch.autograd.Function):
    """The reference's custom VJP (``_fwd_rule`` / ``_bwd_rule``)."""

    @staticmethod
    def forward(ctx, v, sx, sy):
        ctx.save_for_backward(v, sx, sy)
        return bilinear_sample_ref(v, sx, sy).to(torch.result_type(v, sx))

    @staticmethod
    def backward(ctx, g):
        v, sx, sy = ctx.saved_tensors
        b, h, w, n_h, dh = v.shape
        idx, wgt, dwx, dwy, taps = _level_taps(v, sx, sy)
        g = g.float()
        gd = (g[..., None, :] * taps).sum(-1)           # (B,Q,heads,P,4)
        dsx = (gd * dwx).sum(-1).to(sx.dtype)
        dsy = (gd * dwy).sum(-1).to(sy.dtype)
        if not ctx.needs_input_grad[0]:
            return None, dsx, dsy
        # d(v): the cotangent times each tap's weight, stamped per head
        gw = g[..., None, :] * wgt[..., None]           # (B,Q,heads,P,4,dh)
        idx_t = idx.permute(0, 2, 1, 3, 4).reshape(b, n_h, -1)
        # one copy into (B, heads, T, dh): a tap's dh channels are one row;
        # the kernel reads its (B, heads, dh, T) transpose in place
        gw_t = gw.permute(0, 2, 1, 3, 4, 5).reshape(b, n_h, -1, dh)
        dv = stamp_scatter(idx_t.int().contiguous(),
                           gw_t.contiguous().transpose(2, 3), h * w)
        dv = dv.permute(0, 3, 1, 2).reshape(b, h, w, n_h, dh)
        return dv.to(v.dtype), dsx, dsy


def bilinear_sample(v: torch.Tensor, sx: torch.Tensor, sy: torch.Tensor
                    ) -> torch.Tensor:
    """v (B, H, W, heads, dh) f32 or bf16; sx, sy (B, Q, heads, P) f32 pixel
    coordinates. Returns (B, Q, heads, P, dh), zero outside the map.
    Differentiable in all three; d(v) goes through :func:`stamp_scatter`
    (K5-g1 on CUDA tensors)."""
    if v.dim() != 5 or sx.dim() != 4 or sx.shape != sy.shape or (
            (sx.shape[0], sx.shape[2]) != (v.shape[0], v.shape[3])) \
            or 0 in v.shape or 0 in sx.shape:
        raise ValueError(f"bilinear_sample takes v (B,H,W,heads,dh) and sx, "
                         f"sy (B,Q,heads,P), got {tuple(v.shape)}, "
                         f"{tuple(sx.shape)}, {tuple(sy.shape)}")
    if v.dtype not in (torch.float32, torch.bfloat16) \
            or sx.dtype != torch.float32 or sy.dtype != torch.float32:
        raise ValueError(f"bilinear_sample takes float32 or bfloat16 v and "
                         f"float32 sx and sy, got {v.dtype}, {sx.dtype}, "
                         f"{sy.dtype}")
    if sx.device != v.device or sy.device != v.device \
            or v.device.type not in ("cpu", "cuda"):
        raise ValueError("bilinear_sample: all tensors must be on one cpu "
                         "or cuda device")
    return _BilinearSample.apply(v, sx, sy)


# ── generation 2: sorted taps, either layout of the value maps ────────────


def values_to_t(values: torch.Tensor) -> torch.Tensor:
    """(B, HW, heads, dh) -> the (B, heads, dh, HW) layout of
    :func:`ms_deform_attn_t`, contiguous."""
    return values.permute(0, 2, 3, 1).contiguous()


def values_from_t(values_t: torch.Tensor) -> torch.Tensor:
    """(B, heads, dh, HW) -> (B, HW, heads, dh), contiguous."""
    return values_t.permute(0, 3, 1, 2).contiguous()


def _sizes(values, loc, transposed):
    """(B, HW, heads, dh, Q, L, P) of a checked call."""
    if transposed:
        b, n_h, dh, hw = values.shape
    else:
        b, hw, n_h, dh = values.shape
    return b, hw, n_h, dh, loc.shape[1], loc.shape[3], loc.shape[4]


@functools.lru_cache(maxsize=256)
def _relayout_plan(b, n_h, dh, hw, esize, aligned):
    """(ld_vec, st_vec) of :func:`kernels.deform_relayout_plan` for a
    values_t whose pointer is 16-byte aligned or not."""
    plan = kernels.deform_relayout_plan(b, n_h, dh, hw, esize,
                                        0 if aligned else 1)
    return plan["ld_vec"], plan["st_vec"]


def _sorted_forward_cuda(values, shapes, loc, attn, transposed):
    """K5-g2 forward's launch on a checked call (``ms_deform_attn_sorted_
    fwd``): K5's gather with an f32 out on `values`; for values_t, first its
    relayout into a workspace (B, HW, heads, dh) in values' dtype, freed
    after the call, then the gather on it. shapes: the level table's key.
    Returns (B, Q, heads, dh) f32."""
    _kernel_limits(loc)
    b, hw, n_h, dh, q, n_l, n_p = _sizes(values, loc, transposed)
    dev, esize = values.device, values.element_size()
    out = torch.empty((b, q, n_h, dh), dtype=torch.float32, device=dev)
    if transposed:
        rows = torch.empty((b, hw, n_h, dh), dtype=values.dtype, device=dev)
        relayout = _relayout_plan(b, n_h, dh, hw, esize,
                                  values.data_ptr() % 16 == 0)
        ws = rows.data_ptr()
    else:
        rows, relayout, ws = values, (0, 0), 0
    plan = _fwd_plan(n_l, n_p, dh, esize, rows.data_ptr() % 16 == 0)
    err = kernels.launch(
        dev, "ms_deform_attn_sorted_fwd", values.data_ptr(), loc.data_ptr(),
        attn.data_ptr(), out.data_ptr(), ws, _levels_table(shapes)[1], b, hw,
        q, n_h, dh, n_l, n_p, kernels.dtype_code(values.dtype),
        int(transposed), plan["vec"], plan["row_lanes"], plan["fixed"],
        *relayout)
    kernels.check(err, "ms_deform_attn_sorted_fwd")
    return out


def ms_deform_attn_sorted_forward(values, shapes, loc, attn,
                                  transposed: bool = False) -> torch.Tensor:
    """K5-g2 forward on the card: values in either layout (transposed: (B,
    heads, dh, HW)) -> (B, Q, heads, dh) f32, the f32 sums K5 rounds to
    values' dtype; values_t gives the bits of the same map as `values`. One
    launch, or two for values_t (relayout, gather). CUDA tensors only."""
    _check(values, shapes, loc, attn, transposed)
    _require_card(values, "ms_deform_attn_sorted_forward", "K5-g2")
    out = _sorted_forward_cuda(values, _shape_key(shapes), loc, attn,
                               transposed)
    ms_deform_attn_sorted_forward.launches += 1
    return out


ms_deform_attn_sorted_forward.launches = 0


def ms_deform_attn_sorted_backward(values, shapes, loc, attn, dout,
                                   transposed: bool = False):
    """K5-g2 backward on the card: dout (B, Q, heads, dh) in f32 or values'
    dtype -> (d values in values' dtype and layout, d loc f32, d attn f32).
    K5's two launches (``csrc/deform_bwd.cu``), values read in either
    layout: d(values) has the same bits on every run, and in the `values`
    layout those of :func:`ms_deform_attn_backward`. CUDA tensors only."""
    _check(values, shapes, loc, attn, transposed)
    _require_card(values, "ms_deform_attn_sorted_backward",
                  "K5-g2 backward")
    b, _, n_h, dh, q, _, _ = _sizes(values, loc, transposed)
    dout = _dout_arg("ms_deform_attn_sorted_backward", values, dout,
                     (b, q, n_h, dh))
    grads = _backward_cuda(values, _shape_key(shapes), loc, attn, dout,
                           transposed)
    ms_deform_attn_sorted_backward.launches += 1
    return grads


ms_deform_attn_sorted_backward.launches = 0


class _MsDeformAttnSorted(torch.autograd.Function):

    @staticmethod
    def forward(ctx, values, loc, attn, shapes, transposed):
        ctx.save_for_backward(values, loc, attn)
        ctx.shapes, ctx.transposed = shapes, transposed
        return ms_deform_attn_sorted_forward(values, shapes, loc, attn,
                                             transposed)

    @staticmethod
    def backward(ctx, dout):
        values, loc, attn = ctx.saved_tensors
        dv, dloc, dattn = ms_deform_attn_sorted_backward(
            values, ctx.shapes, loc, attn, dout, ctx.transposed)
        return dv, dloc, dattn, None, None


def _sorted_entry(values, shapes, loc, attn, transposed):
    _check(values, shapes, loc, attn, transposed)
    if values.device.type == "cpu":
        flat = values_from_t(values) if transposed else values
        return _ref_sum(flat, shapes, loc, attn)
    shapes = tuple((int(h), int(w)) for h, w in shapes)
    return _MsDeformAttnSorted.apply(values, loc, attn, shapes, transposed)


def ms_deform_attn(values: torch.Tensor, shapes: Sequence[Tuple[int, int]],
                   loc: torch.Tensor, attn: torch.Tensor) -> torch.Tensor:
    """Multi-scale deformable attention core, sorted-tap generation. values
    (B, HW, heads, dh) f32 or bf16, the levels of ``shapes`` flattened
    row-major and concatenated; loc (B, Q, heads, L, P, 2) f32 in [0, 1];
    attn (B, Q, heads, L, P) f32. Returns (B, Q, heads, dh) float32.
    Differentiable in values, loc and attn; on CUDA tensors d(values) is a
    sum in a fixed order (the same bits every run)."""
    return _sorted_entry(values, shapes, loc, attn, False)


def ms_deform_attn_t(values_t: torch.Tensor,
                     shapes: Sequence[Tuple[int, int]], loc: torch.Tensor,
                     attn: torch.Tensor) -> torch.Tensor:
    """:func:`ms_deform_attn` for value maps laid out (B, heads, dh, HW).
    On the card the forward relays them into rows first (a workspace the
    size of the map) and the backward reads them in place; d(values_t)
    comes back in the same layout."""
    return _sorted_entry(values_t, shapes, loc, attn, True)
