"""Multi-scale deformable attention, forward (counterpart of ops/deform.py
``ms_deform_attn_slots`` / ``ms_deform_attn_ref``).

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
other device, dtype, layout or shape raises. There is no backward yet:
on CUDA, inputs that require a gradient raise ``NotImplementedError``
rather than return a result without a graph.

Both versions sum in f32 and return values' dtype (one rounding).
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch

from .. import kernels

MAX_LEVELS = 4     # csrc/ms_deform_attn.cu: MAX_LEVELS, and L * P <= 32


def tap_geometry(loc: torch.Tensor, shapes: Sequence[Tuple[int, int]]
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """loc (B, Q, heads, L, P, 2) f32 -> (idx int64, weight f32), each (B,
    Q, heads, L, P, 4): the flat cell index over the merged HW axis (level
    offsets applied, clipped into the level) and the bilinear weight (0
    outside) of the four taps (``_geometry_batched``)."""
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
    x0, y0 = torch.floor(sx), torch.floor(sy)
    fx, fy = sx - x0, sy - y0
    taps = ((x0, y0, (1 - fx) * (1 - fy)), (x0 + 1, y0, fx * (1 - fy)),
            (x0, y0 + 1, (1 - fx) * fy), (x0 + 1, y0 + 1, fx * fy))
    idxs, wgts = [], []
    for xi, yi, wgt in taps:
        inside = (xi >= 0) & (xi < w_l) & (yi >= 0) & (yi < h_l)
        xi_c = torch.minimum(xi.clamp(min=0), w_l - 1).long()
        yi_c = torch.minimum(yi.clamp(min=0), h_l - 1).long()
        idxs.append(yi_c * w_l.long() + xi_c)
        wgts.append(torch.where(inside, wgt, torch.zeros_like(wgt)))
    return torch.stack(idxs, -1) + off_l, torch.stack(wgts, -1)


def ms_deform_attn_ref(values: torch.Tensor,
                       shapes: Sequence[Tuple[int, int]], loc: torch.Tensor,
                       attn: torch.Tensor) -> torch.Tensor:
    """Plain version: gather the taps' rows, weight, sum. values (B, HW,
    heads, dh); loc (B, Q, heads, L, P, 2); attn (B, Q, heads, L, P) ->
    (B, Q, heads, dh) in values' dtype."""
    b, hw, n_h, dh = values.shape
    q = loc.shape[1]
    idx, w = tap_geometry(loc.float(), shapes)         # (B,Q,heads,L,P,4)
    c = w * attn.float()[..., None]
    heads = torch.arange(n_h, device=values.device)[None, None, :, None]
    flat = values.reshape(b, hw * n_h, dh)
    gidx = (idx.reshape(b, q, n_h, -1) * n_h + heads).reshape(b, -1)
    g = torch.gather(flat, 1, gidx[..., None].expand(-1, -1, dh))
    g = g.reshape(b, q, n_h, -1, dh).float()           # (B,Q,heads,LP4,dh)
    out = (g * c.reshape(b, q, n_h, -1, 1)).sum(3)
    return out.to(values.dtype)


def _check(values, shapes, loc, attn) -> None:
    if values.dim() != 4 or loc.dim() != 6 or attn.dim() != 5:
        raise ValueError(f"ms_deform_attn takes values (B,HW,heads,dh), loc "
                         f"(B,Q,heads,L,P,2) and attn (B,Q,heads,L,P), got "
                         f"{tuple(values.shape)}, {tuple(loc.shape)}, "
                         f"{tuple(attn.shape)}")
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
    if n_l > MAX_LEVELS or n_l * n_p > 32 or 0 in loc.shape or 0 in \
            values.shape:
        raise ValueError(f"ms_deform_attn takes at most {MAX_LEVELS} levels "
                         f"and 32 sampling points a query and head, and no "
                         f"empty dimension, got L {n_l} P {n_p}")
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


def ms_deform_attn_slots(values: torch.Tensor,
                         shapes: Sequence[Tuple[int, int]],
                         loc: torch.Tensor,
                         attn: torch.Tensor) -> torch.Tensor:
    """values (B, HW, heads, dh) f32 or bf16, the levels of ``shapes``
    ((H_l, W_l), ...) flattened row-major and concatenated; loc (B, Q,
    heads, L, P, 2) f32 in [0, 1]; attn (B, Q, heads, L, P) f32. Returns
    (B, Q, heads, dh) in values' dtype. Any query order gives the same
    result, bit for bit."""
    _check(values, shapes, loc, attn)
    if values.device.type == "cpu":
        return ms_deform_attn_ref(values, shapes, loc, attn)
    if torch.is_grad_enabled() and any(t.requires_grad
                                       for t in (values, loc, attn)):
        raise NotImplementedError(
            "the backward of ms_deform_attn_slots (K5 backward) is not "
            "ported yet: call it under torch.no_grad() / inference_mode()")
    b, hw, n_h, dh = values.shape
    q, n_l, n_p = loc.shape[1], loc.shape[3], loc.shape[4]
    levels, start = [], 0
    for h, w in shapes:
        levels += [h, w, start]
        start += h * w
    levels = (ctypes.c_int * len(levels))(*levels)
    out = torch.empty((b, q, n_h, dh), dtype=values.dtype,
                      device=values.device)
    lib = kernels.load()
    with torch.cuda.device(values.device):
        err = lib.ms_deform_attn_fwd(
            values.data_ptr(), loc.data_ptr(), attn.data_ptr(),
            out.data_ptr(), ctypes.addressof(levels), b, hw, q, n_h, dh,
            n_l, n_p, kernels.dtype_code(values.dtype),
            kernels.stream_ptr(values.device))
    kernels.check(err, "ms_deform_attn_fwd")
    ms_deform_attn_slots.launches += 1
    return out


ms_deform_attn_slots.launches = 0
