"""RT-DETR-L, eval and train forward (counterpart of
robust_object_detection_tpu/models/rtdetr.py): HGNetv2-L backbone, hybrid
encoder (AIFI + CCFF), two-stage query selection, six deformable-attention
decoder layers with iterative box refinement. Decoding is NMS-free.

The module tree is the Ultralytics RT-DETR-L's: ``self.model`` is a
ModuleList indexed like the rtdetr-l yaml (0-9 HGNetv2, 10-27 hybrid
encoder, 28 the RTDETRDecoder), so ``state_dict`` keys (``model.{i}.…``)
match a real ``rtdetr-l.pt`` and models/convert.py maps the JAX variables
onto them.

The input is NHWC in [0, 1], as in the reference; inside, modules take and
return NCHW-indexed tensors. Kernels on the path:

  * :class:`HGStem` always runs stem1..stem3 through ops.stem (K4-f on the
    card, its plain version on the CPU; in train mode ``stem_fused`` with
    batch statistics, whose backward is K4-b), then BN3 + ReLU in f32 and
    the 1x1 stem4;
  * the dense 3x3 stage-1 :class:`HGBlock` (48 -> 48, six convs) runs its
    convs through ops.conv3x3 (K3-f, and K3-f / K3-b in its backward), in
    NHWC (the reference's planes layout is TPU lane padding);
  * every :class:`MSDeformAttn` runs ops.deform.ms_deform_attn_slots (K5
    forward, K5 backward under autograd), six a forward.

``dtype`` is the compute type of the convs and of the matmuls the
reference runs in it (flax ``Dense(dtype=...)``, attention); BatchNorm,
LayerNorm, the sampling-offset / attention-weight / score projections and
the last layer of every MLP run in f32, as in the reference. Conv weights
are stored in ``dtype`` (eval), every other parameter in f32 and cast where
it is used. Where the bf16 model rounds differently from the reference's:
an eval ConvBnAct normalises the conv's bf16 output in f32 (the
reference's fused stage-1 block normalises an f32 accumulator), and K5
rounds its f32 sum to bf16 once (the reference casts its f32 result in the
output projection). In f32 the two models differ by summation order only.

Train mode (``model.train()``, built by ``create(..., train=True)`` with
float32 master weights): every BatchNorm takes its batch statistics with
flax semantics (layers.bn_train), its output in ``bn_dtype``; ``dn``
(contrastive denoising queries, train/rtdetr.build_dn_queries) prepends
the denoising queries, masks the decoder self-attention and adds
``dn_logits`` / ``dn_boxes`` to the outputs. The decoder's inputs after
query selection and the reference boxes between layers are detached, as
the reference's ``stop_gradient``s. Row permutations are ``torch.gather``,
whose backward is a scatter-add: right for a permutation, and left to
PyTorch (the reference writes the inverse gather by hand only because
XLA's scatter serialises on a TPU).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.nn.attention import SDPBackend, sdpa_kernel

from ..ops.deform import ms_deform_attn_slots
from ..ops.stem import stem_fused, stem_fused_inference
from ..parallel.mesh import copy_to_model, reduce_from_model
from .layers import (ConvBnAct, bn_train, from_nhwc, resolve_device,
                     update_running, upsample2x)


@dataclasses.dataclass(frozen=True)
class RtDetrConfig:
    num_classes: int = 6
    hidden: int = 256
    heads: int = 8
    ffn: int = 1024
    levels: int = 3                  # P3, P4, P5
    points: int = 4
    dec_layers: int = 6
    queries: int = 300
    # order decoder queries by the row-major 128-grid cell of their initial
    # reference centre; one permutation shared by all decoder layers and
    # undone on the outputs. The reference does it for its TPU kernel's
    # tile bounds; K5 on a GPU gains nothing from it, but the port keeps it
    # so the two models agree output for output.
    spatial_sort: bool = True


def _hwio(w: torch.Tensor) -> torch.Tensor:
    return w.permute(2, 3, 1, 0).contiguous()


def linear(x: torch.Tensor, lin: nn.Linear,
           dtype: torch.dtype) -> torch.Tensor:
    """flax ``Dense(dtype=dtype)``: input, weight and bias cast to dtype."""
    return F.linear(x.to(dtype), lin.weight.to(dtype), lin.bias.to(dtype))


def layer_norm(x: torch.Tensor, ln: nn.LayerNorm) -> torch.Tensor:
    """flax LayerNorm: f32 statistics and output, whatever x's dtype."""
    return F.layer_norm(x.float(), ln.normalized_shape, ln.weight, ln.bias,
                        ln.eps)


# scaled_dot_product_attention's backends but cuDNN's: in bf16 on an H100
# cuDNN's attention gives one of two results for the same inputs in
# different processes (tools/tp_determinism.py: the AIFI output of two
# RT-DETR-L model ranks parted in 7 of 19 pairs, in none of 14 without
# it), and every model rank computes the replicated layers for itself
SDPA_BACKENDS = [SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION,
                 SDPBackend.MATH]


def attention(mha: nn.MultiheadAttention, q, k, v, dtype: torch.dtype,
              mask: Optional[torch.Tensor] = None,
              tp_group=None) -> torch.Tensor:
    """flax ``MultiHeadDotProductAttention(dtype=dtype)`` on the packed
    parameters of an nn.MultiheadAttention: q, k, v (B, N, C) -> (B, N, C)
    in dtype; ``mask`` (B, 1, N, N) bool, True = may attend (flax's and
    ``scaled_dot_product_attention``'s convention). Outside every TPU
    kernel in the reference, so the product itself is PyTorch's.

    tp_group: the module holds this rank's heads (parallel/mesh.
    rtdetr_decoder_tp: a share of each of q, k, v's rows, out_proj's
    matching columns); the inputs enter through Megatron's "f", the
    partial out_proj products are summed over the group ("g") and the
    bias is added once after the sum."""
    c = mha.embed_dim
    width = mha.in_proj_weight.shape[0] // 3     # this rank's q / k / v
    heads = mha.num_heads * width // c
    w, b = mha.in_proj_weight.to(dtype), mha.in_proj_bias.to(dtype)
    if tp_group is not None:
        q, v = copy_to_model(q, tp_group), copy_to_model(v, tp_group)
        k = q if k is q else copy_to_model(k, tp_group)

    def proj(x, i):
        y = F.linear(x.to(dtype), w[i * width:(i + 1) * width],
                     b[i * width:(i + 1) * width])
        return y.reshape(*y.shape[:2], heads, c // mha.num_heads
                         ).transpose(1, 2)

    with sdpa_kernel(SDPA_BACKENDS):
        o = F.scaled_dot_product_attention(proj(q, 0), proj(k, 1),
                                           proj(v, 2), attn_mask=mask)
    o = o.transpose(1, 2).reshape(q.shape[0], q.shape[1], width)
    if tp_group is None:
        return F.linear(o, mha.out_proj.weight.to(dtype),
                        mha.out_proj.bias.to(dtype))
    y = reduce_from_model(F.linear(o, mha.out_proj.weight.to(dtype)),
                          tp_group)
    return y + mha.out_proj.bias.to(dtype)


# ── HGNetv2 backbone ─────────────────────────────────────────────────────

class LightConv(nn.Module):
    """1x1 conv (no act) + depthwise kxk conv (ReLU): PP-HGNet's cheap
    conv."""

    def __init__(self, c1: int, c2: int, k: int, **kw):
        super().__init__()
        self.conv1 = ConvBnAct(c1, c2, 1, act=False, **kw)
        self.conv2 = ConvBnAct(c2, c2, k, groups=c2, act_fn="relu", **kw)

    def forward(self, x):
        return self.conv2(self.conv1(x))


class Conv2x2Pad(nn.Module):
    """The parameters of an HGStem 2x2 conv + BN (Ultralytics ``Conv(k=2,
    p=0)`` after a right/bottom zero pad). :class:`HGStem` reads them for
    the fused stem; the module computes nothing itself."""

    def __init__(self, c1: int, c2: int, dtype: torch.dtype):
        super().__init__()
        # dtype: the storage type of the weight
        self.conv = nn.Conv2d(c1, c2, 2, 1, 0, bias=False, dtype=dtype)
        self.bn = nn.BatchNorm2d(c2, eps=1e-3, momentum=0.03)


class HGStem(nn.Module):
    """PP-HGNetv2 stem: 3x3/2 -> [2x2 pool | two 2x2 convs] -> concat
    (pool first) -> 3x3/2 -> 1x1. stem1..stem3 run as one fused op
    (ops.stem: K4-f on the card, the plain version on the CPU) that
    returns stem3's output before its BN; BN3 + ReLU in f32 and the 1x1
    stem4 follow here. In train mode the fused op is ``stem_fused`` (K4-f
    train, K4-b in its backward): it returns the four batch means and
    variances, from which the running statistics are updated here and
    with which y3 is normalised. x (B, H, W, 3) NHWC in [0, 1] -> NCHW
    view of an NHWC tensor (B, c2, H/4, W/4)."""

    def __init__(self, cm: int, c2: int, dtype: torch.dtype = torch.float32,
                 param_dtype: Optional[torch.dtype] = None,
                 bn_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype, self.bn_dtype = dtype, bn_dtype
        kw = dict(dtype=dtype, param_dtype=param_dtype, bn_dtype=bn_dtype)
        self.stem1 = ConvBnAct(3, cm, 3, 2, act_fn="relu", **kw)
        self.stem2a = Conv2x2Pad(cm, cm // 2, param_dtype or dtype)
        self.stem2b = Conv2x2Pad(cm // 2, cm, param_dtype or dtype)
        self.stem3 = ConvBnAct(2 * cm, cm, 3, 2, act_fn="relu", **kw)
        self.stem4 = ConvBnAct(cm, c2, 1, act_fn="relu", **kw)

    def _forward_train(self, x: torch.Tensor) -> torch.Tensor:
        s1, s2a, s2b, s3 = self.stem1, self.stem2a, self.stem2b, self.stem3
        y3, means, variances = stem_fused(
            x.to(self.dtype).contiguous(), _hwio(s1.conv.weight),
            s1.bn.weight, s1.bn.bias, _hwio(s2a.conv.weight), s2a.bn.weight,
            s2a.bn.bias, _hwio(s2b.conv.weight), s2b.bn.weight, s2b.bn.bias,
            _hwio(s3.conv.weight))
        for m, mean, var in zip((s1, s2a, s2b, s3), means, variances):
            update_running(m.bn, mean, var)
        # BN3 + ReLU with the reference's association: normalise in f32,
        # then the affine, then the cast
        yn = (y3.float() - means[3]) * torch.rsqrt(variances[3] + s3.bn.eps)
        yn = yn * s3.bn.weight + s3.bn.bias
        return self.stem4(F.relu(from_nhwc(yn.to(self.bn_dtype))))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            return self._forward_train(x)
        dtype = self.dtype
        s1, s2a, s2b, s3 = self.stem1, self.stem2a, self.stem2b, self.stem3
        y3 = stem_fused_inference(
            x.to(dtype).contiguous(), _hwio(s1.conv.weight.to(dtype)),
            s1.bn.weight, s1.bn.bias, _hwio(s2a.conv.weight.to(dtype)),
            s2a.bn.weight, s2a.bn.bias, _hwio(s2b.conv.weight.to(dtype)),
            s2b.bn.weight, s2b.bn.bias, _hwio(s3.conv.weight.to(dtype)),
            tuple(m.bn.running_mean for m in (s1, s2a, s2b)),
            tuple(m.bn.running_var for m in (s1, s2a, s2b)))
        a3 = F.relu(s3.bn(from_nhwc(y3).float()))
        return self.stem4(a3)


class HGBlock(nn.Module):
    """n chained (Light)Convs, concat of the input and every tap, squeeze
    and excite 1x1 convs, optional shortcut. The dense 3x3 block whose
    input width equals cm (stage 1 of HGNetv2-L) routes its convs through
    ops.conv3x3 (K3-f), as the reference routes them through its planes
    kernel."""

    def __init__(self, c1: int, cm: int, c2: int, k: int = 3, n: int = 6,
                 lightconv: bool = False, shortcut: bool = False, **kw):
        super().__init__()
        hand = not lightconv and k == 3 and c1 == cm
        if lightconv:
            self.m = nn.ModuleList(
                LightConv(c1 if i == 0 else cm, cm, k, **kw)
                for i in range(n))
        else:
            self.m = nn.ModuleList(
                ConvBnAct(c1 if i == 0 else cm, cm, k, act_fn="relu",
                          hand_kernel=hand, **kw) for i in range(n))
        self.sc = ConvBnAct(c1 + n * cm, c2 // 2, 1, act_fn="relu", **kw)
        self.ec = ConvBnAct(c2 // 2, c2, 1, act_fn="relu", **kw)
        self.add = shortcut and c1 == c2

    def forward(self, x):
        y = [x]
        for m in self.m:
            y.append(m(y[-1]))
        out = self.ec(self.sc(torch.cat(y, 1)))
        return out + x if self.add else out


# ── Hybrid encoder ───────────────────────────────────────────────────────

def sincos_pos_embed_2d(h: int, w: int, dim: int,
                        temperature: float = 10000.0) -> np.ndarray:
    """(h*w, dim) 2D sine-cosine positional embedding (AIFI), with the
    Ultralytics ``meshgrid(w, h, indexing="ij")`` orientation: the first
    sin/cos half runs over flat_index // h, the second over flat_index %
    h."""
    pos_dim = dim // 4
    omega = 1.0 / (temperature ** (np.arange(pos_dim, dtype=np.float32)
                                   / pos_dim))
    gw, gh = np.meshgrid(np.arange(w, dtype=np.float32),
                         np.arange(h, dtype=np.float32), indexing="ij")
    out_w = gw.reshape(-1, 1) * omega[None]
    out_h = gh.reshape(-1, 1) * omega[None]
    return np.concatenate([np.sin(out_w), np.cos(out_w),
                           np.sin(out_h), np.cos(out_h)],
                          axis=1).astype(np.float32)


class AIFI(nn.Module):
    """One transformer encoder layer over the flattened P5 map: post-norm,
    exact GELU, LayerNorm eps 1e-5, the sequence kept in f32."""

    def __init__(self, c: int, ffn: int, heads: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.ma = nn.MultiheadAttention(c, heads, batch_first=True)
        self.fc1 = nn.Linear(c, ffn)
        self.fc2 = nn.Linear(ffn, c)
        self.norm1 = nn.LayerNorm(c)
        self.norm2 = nn.LayerNorm(c)

    def forward(self, x):
        b, c, h, w = x.shape
        seq = x.flatten(2).permute(0, 2, 1).float()
        pos = torch.from_numpy(sincos_pos_embed_2d(h, w, c)).to(x.device)
        q = seq + pos
        attn = attention(self.ma, q, q, seq, self.dtype)
        seq = layer_norm(seq + attn, self.norm1)
        ff = linear(F.gelu(linear(seq, self.fc1, self.dtype)), self.fc2,
                    self.dtype)
        seq = layer_norm(seq + ff.float(), self.norm2)
        return seq.permute(0, 2, 1).reshape(b, c, h, w)


class RepConv(nn.Module):
    """Structural-reparam conv, train form: 3x3 + 1x1 conv-BN branches
    summed, then SiLU."""

    def __init__(self, c: int, **kw):
        super().__init__()
        self.conv1 = ConvBnAct(c, c, 3, act=False, **kw)
        self.conv2 = ConvBnAct(c, c, 1, act=False, **kw)

    def forward(self, x):
        return F.silu(self.conv1(x) + self.conv2(x))


class RepC3(nn.Module):
    """CSP-style fusion block: cv2(x) + RepConv chain(cv1(x))."""

    def __init__(self, c1: int, c2: int, n: int = 3, **kw):
        super().__init__()
        self.cv1 = ConvBnAct(c1, c2, 1, **kw)
        self.cv2 = ConvBnAct(c1, c2, 1, **kw)
        self.m = nn.Sequential(*[RepConv(c2, **kw) for _ in range(n)])

    def forward(self, x):
        return self.m(self.cv1(x)) + self.cv2(x)


class Upsample(nn.Module):
    def forward(self, x):
        return upsample2x(x)


# ── Deformable attention and the decoder ─────────────────────────────────

def inverse_sigmoid(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    x = x.clamp(eps, 1 - eps)
    return torch.log(x / (1 - x))


def offset_bias_init(n_h: int, n_l: int, n_p: int) -> torch.Tensor:
    """Deformable-DETR init: heads point at a ring of directions."""
    thetas = np.arange(n_h, dtype=np.float32) * (2 * np.pi / n_h)
    grid = np.stack([np.cos(thetas), np.sin(thetas)], -1)
    grid /= np.abs(grid).max(-1, keepdims=True)
    grid = np.tile(grid[:, None, None, :], (1, n_l, n_p, 1))
    for p in range(n_p):
        grid[:, :, p, :] *= p + 1
    return torch.from_numpy(grid.reshape(-1))


class MSDeformAttn(nn.Module):
    """Multi-scale deformable attention. The sampling offsets and
    attention weights are f32 projections of the query; the value
    projection is a plain matmul in ``dtype``; sampling, weighting and the
    sum are ops.deform.ms_deform_attn_slots (K5 forward on the card)."""

    def __init__(self, cfg: RtDetrConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        c = cfg.hidden
        self.cfg, self.dtype = cfg, dtype
        n = cfg.heads * cfg.levels * cfg.points
        self.sampling_offsets = nn.Linear(c, n * 2)
        self.attention_weights = nn.Linear(c, n)
        self.value_proj = nn.Linear(c, c)
        self.output_proj = nn.Linear(c, c)

    def forward(self, query, ref_boxes, memory, shapes):
        """query (B, Q, C) f32; ref_boxes (B, Q, 4) normalised cxcywh;
        memory (B, HW, C) the flattened value maps in ``dtype``; shapes
        ((H_l, W_l), ...)."""
        cfg = self.cfg
        b, q, c = query.shape
        n_h, n_l, n_p = cfg.heads, cfg.levels, cfg.points
        offsets = self.sampling_offsets(query).reshape(b, q, n_h, n_l, n_p, 2)
        attn = self.attention_weights(query).reshape(b, q, n_h, n_l * n_p)
        attn = attn.softmax(-1).reshape(b, q, n_h, n_l, n_p)
        ref_xy = ref_boxes[:, :, None, None, None, :2]
        ref_wh = ref_boxes[:, :, None, None, None, 2:]
        loc = ref_xy + offsets / n_p * ref_wh * 0.5       # normalised [0,1]
        values = linear(memory, self.value_proj, self.dtype)
        out = ms_deform_attn_slots(
            values.reshape(b, -1, n_h, c // n_h), shapes, loc.contiguous(),
            attn.contiguous())
        return linear(out.reshape(b, q, c), self.output_proj, self.dtype)


class MLP(nn.Module):
    """Linear stack with ReLU between; the hidden layers run in ``dtype``,
    the last one in f32 with an f32 output."""

    def __init__(self, c_in: int, hidden: int, c_out: int, num_layers: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        dims = [c_in] + [hidden] * (num_layers - 1)
        self.layers = nn.ModuleList(
            nn.Linear(a, b) for a, b in zip(dims, dims[1:] + [c_out]))

    def forward(self, x):
        for layer in self.layers[:-1]:
            x = F.relu(linear(x, layer, self.dtype))
        return self.layers[-1](x.float())


class DecoderLayer(nn.Module):
    def __init__(self, cfg: RtDetrConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        c = cfg.hidden
        self.dtype = dtype
        self.self_attn = nn.MultiheadAttention(c, cfg.heads, batch_first=True)
        self.norm1 = nn.LayerNorm(c)
        self.cross_attn = MSDeformAttn(cfg, dtype)
        self.norm2 = nn.LayerNorm(c)
        self.linear1 = nn.Linear(c, cfg.ffn)
        self.linear2 = nn.Linear(cfg.ffn, c)
        self.norm3 = nn.LayerNorm(c)
        # the model group when parallel/mesh.apply_tp sharded this layer
        self.tp_group = None

    def forward(self, query, ref_boxes, memory, shapes, query_pos,
                attn_mask=None):
        tp = self.tp_group
        q = query + query_pos
        sa = attention(self.self_attn, q, q, query, self.dtype, attn_mask,
                       tp)
        query = layer_norm(query + sa, self.norm1)
        ca = self.cross_attn(query + query_pos, ref_boxes, memory, shapes)
        query = layer_norm(query + ca, self.norm2)
        if tp is None:
            ff = linear(F.relu(linear(query, self.linear1, self.dtype)),
                        self.linear2, self.dtype)
        else:       # linear1 column-split, linear2 row-split (Megatron)
            h = F.relu(linear(copy_to_model(query, tp), self.linear1,
                              self.dtype))
            ff = reduce_from_model(F.linear(
                h, self.linear2.weight.to(self.dtype)), tp)
            ff = ff + self.linear2.bias.to(self.dtype)
        return layer_norm(query + ff.float(), self.norm3)


class Decoder(nn.Module):
    def __init__(self, cfg: RtDetrConfig, dtype: torch.dtype):
        super().__init__()
        self.layers = nn.ModuleList(DecoderLayer(cfg, dtype)
                                    for _ in range(cfg.dec_layers))


def build_anchors(shapes: Sequence[Tuple[int, int]],
                  grid_size: float = 0.05) -> Tuple[np.ndarray, np.ndarray]:
    """Per-anchor init boxes in inverse-sigmoid space (0 where invalid) and
    the validity mask."""
    anchors, valids = [], []
    for lvl, (h, w) in enumerate(shapes):
        gy, gx = np.mgrid[0:h, 0:w].astype(np.float32)
        cx = (gx + 0.5) / w
        cy = (gy + 0.5) / h
        wh = np.full_like(cx, grid_size * (2.0 ** lvl))
        a = np.stack([cx, cy, wh, wh], -1).reshape(-1, 4)
        anchors.append(a)
        valids.append(((a > 0.01) & (a < 0.99)).all(-1))
    a = np.concatenate(anchors)
    v = np.concatenate(valids)
    a = np.log(a / (1 - a), where=(a > 0) & (a < 1), out=np.zeros_like(a))
    a[~v] = 0.0
    return a, v


def top_k(scores: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k largest of the last axis, largest first, ties by lower index
    (``jax.lax.top_k``; ``torch.topk`` leaves the order of ties open)."""
    vals, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def permute_rows(x: torch.Tensor, order: torch.Tensor) -> torch.Tensor:
    """x[b, order[b], ...]."""
    return torch.gather(x, 1, order.reshape(
        order.shape + (1,) * (x.dim() - 2)).expand(-1, -1, *x.shape[2:]))


def dn_attention_mask(group_ids: torch.Tensor, total: int) -> torch.Tensor:
    """Self-attention mask of contrastive denoising: (B, 1, total, total)
    bool, True = may attend. A denoising slot attends its own group and the
    matching queries; matching queries attend only each other; an empty
    slot (group -1) only itself, so no row is fully masked."""
    b, d = group_ids.shape
    q_gid = torch.full((b, total - d), -2, dtype=group_ids.dtype,
                       device=group_ids.device)        # matching queries
    gid = torch.cat([group_ids, q_gid], 1)             # (B, total)
    same = gid[:, :, None] == gid[:, None, :]
    valid = gid[:, None, :] != -1                      # empty dn: no keys
    dn_sees_match = (gid[:, :, None] >= 0) & (gid[:, None, :] == -2)
    diag = torch.eye(total, dtype=torch.bool, device=gid.device)[None]
    return ((same & valid) | dn_sees_match | diag)[:, None]


class RTDETRDecoder(nn.Module):
    """Layer 28: per-level input projections, two-stage query selection,
    the decoder layers and their per-layer score / box heads."""

    def __init__(self, cfg: RtDetrConfig, dtype: torch.dtype = torch.float32,
                 param_dtype: Optional[torch.dtype] = None,
                 bn_dtype: torch.dtype = torch.float32):
        super().__init__()
        c, nc = cfg.hidden, cfg.num_classes
        self.cfg, self.dtype, self.bn_dtype = cfg, dtype, bn_dtype
        self.input_proj = nn.ModuleList(
            nn.Sequential(nn.Conv2d(c, c, 1, bias=False,
                                    dtype=param_dtype or dtype),
                          nn.BatchNorm2d(c, eps=1e-3, momentum=0.03))
            for _ in range(cfg.levels))
        self.decoder = Decoder(cfg, dtype)
        # one row more than the classes (the reference's table): the
        # content of the denoising queries, row nc for an empty slot
        self.denoising_class_embed = nn.Embedding(nc + 1, c)
        self.query_pos_head = MLP(4, 2 * c, c, 2, dtype)
        self.enc_output = nn.Sequential(nn.Linear(c, c), nn.LayerNorm(c))
        self.enc_score_head = nn.Linear(c, nc)
        self.enc_bbox_head = MLP(c, c, 4, 3, dtype)
        self.dec_score_head = nn.ModuleList(
            nn.Linear(c, nc) for _ in range(cfg.dec_layers))
        self.dec_bbox_head = nn.ModuleList(
            MLP(c, c, 4, 3, dtype) for _ in range(cfg.dec_layers))

    def _project(self, proj: nn.Sequential, f: torch.Tensor) -> torch.Tensor:
        y = F.conv2d(f.to(self.dtype), proj[0].weight.to(self.dtype))
        if self.training:
            return bn_train(y, proj[1], self.bn_dtype)
        return proj[1](y.float())

    def forward(self, feats, dn: Optional[Dict[str, torch.Tensor]] = None
                ) -> Dict[str, torch.Tensor]:
        """dn (training): classes (B, D) int, boxes (B, D, 4) noised
        normalised cxcywh, group_ids (B, D) int, -1 = empty slot. With it
        the outputs gain dn_logits / dn_boxes (L, B, D, ...)."""
        cfg, dtype = self.cfg, self.dtype
        levels = [self._project(proj, f)
                  for proj, f in zip(self.input_proj, feats)]
        shapes = tuple((f.shape[2], f.shape[3]) for f in levels)
        flat = torch.cat([f.flatten(2).permute(0, 2, 1) for f in levels], 1)
        dev = flat.device
        anchors, valid = (torch.from_numpy(a).to(dev)
                          for a in build_anchors(shapes))

        mem = layer_norm(linear(flat, self.enc_output[0], dtype),
                         self.enc_output[1])
        enc_logits = self.enc_score_head(mem)
        enc_logits = enc_logits.masked_fill(~valid[None, :, None], -1e4)
        enc_boxes = torch.sigmoid(self.enc_bbox_head(mem) + anchors[None])

        # top-k query selection (clamped for tiny maps)
        _, topi = top_k(enc_logits.amax(-1),
                        min(cfg.queries, enc_logits.shape[1]))
        # the encoder's auxiliary-loss targets keep their gradients; the
        # decoder's inputs are detached (two-stage query selection)
        content = permute_rows(mem, topi).detach()
        enc_topk_logits = permute_rows(enc_logits, topi)
        enc_topk_boxes = permute_rows(enc_boxes, topi)
        ref = enc_topk_boxes.detach()

        n_dn, attn_mask = 0, None
        if dn is not None:
            n_dn = dn["classes"].shape[1]
            dn_content = self.denoising_class_embed(
                dn["classes"].long().clamp(0, cfg.num_classes))
            content = torch.cat([dn_content.float(), content], 1)
            ref = torch.cat([dn["boxes"].float(), ref], 1)
            attn_mask = dn_attention_mask(dn["group_ids"], content.shape[1])

        inv = None
        if cfg.spatial_sort and content.shape[1] > 1:
            grid = 128
            cell = ((ref[..., 1] * grid).to(torch.int32).clamp(0, grid - 1)
                    * grid
                    + (ref[..., 0] * grid).to(torch.int32).clamp(0, grid - 1))
            order = torch.argsort(cell, dim=1, stable=True)
            inv = torch.argsort(order, 1)
            content = permute_rows(content, order)
            ref = permute_rows(ref, order)
            if attn_mask is not None:     # rows and columns alike
                total = order.shape[1]
                attn_mask = torch.gather(
                    attn_mask, 2,
                    order[:, None, :, None].expand(-1, -1, -1, total))
                attn_mask = torch.gather(
                    attn_mask, 3,
                    order[:, None, None, :].expand(-1, -1, total, -1))

        def unperm(x):
            return x if inv is None else permute_rows(x, inv)

        memory = flat.to(dtype)      # shared by the six value projections
        layers_logits: List[torch.Tensor] = []
        layers_boxes: List[torch.Tensor] = []
        query = content
        for li, layer in enumerate(self.decoder.layers):
            query_pos = self.query_pos_head(ref)
            query = layer(query, ref, memory, shapes, query_pos, attn_mask)
            delta = self.dec_bbox_head[li](query)
            new_ref = torch.sigmoid(delta + inverse_sigmoid(ref))
            layers_logits.append(unperm(self.dec_score_head[li](query)))
            layers_boxes.append(unperm(new_ref))
            ref = new_ref.detach()
        logits = torch.stack(layers_logits)          # (L, B, D + Q, nc)
        boxes = torch.stack(layers_boxes)
        out = {"enc_logits": enc_topk_logits, "enc_boxes": enc_topk_boxes,
               "logits": logits[:, :, n_dn:], "boxes": boxes[:, :, n_dn:]}
        if dn is not None:
            out["dn_logits"] = logits[:, :, :n_dn]
            out["dn_boxes"] = boxes[:, :, :n_dn]
        return out


class RTDETR(nn.Module):
    """x (B, S, S, 3) NHWC in [0, 1] -> dict: enc_logits (B, Q, nc),
    enc_boxes (B, Q, 4) sigmoid cxcywh of the selected anchors; logits (L,
    B, Q, nc), boxes (L, B, Q, 4) per decoder layer; with ``dn`` also
    dn_logits (L, B, D, nc) and dn_boxes (L, B, D, 4); all f32.

    ``dtype``: conv and matmul compute type; ``param_dtype``: conv weight
    storage (default ``dtype``; a trainer keeps float32 masters);
    ``bn_dtype``: train-mode BatchNorm output."""

    def __init__(self, cfg: RtDetrConfig = RtDetrConfig(),
                 dtype: torch.dtype = torch.float32,
                 param_dtype: Optional[torch.dtype] = None,
                 bn_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.cfg, self.dtype = cfg, dtype
        c = cfg.hidden
        kw = dict(dtype=dtype, param_dtype=param_dtype, bn_dtype=bn_dtype)
        self.model = nn.ModuleList([
            HGStem(32, 48, **kw),                                      # 0
            HGBlock(48, 48, 128, 3, **kw),                             # 1
            ConvBnAct(128, 128, 3, 2, act=False, groups=128, **kw),    # 2
            HGBlock(128, 96, 512, 3, **kw),                            # 3 P3
            ConvBnAct(512, 512, 3, 2, act=False, groups=512, **kw),    # 4
            HGBlock(512, 192, 1024, 5, lightconv=True, **kw),          # 5
            HGBlock(1024, 192, 1024, 5, lightconv=True, shortcut=True,
                    **kw),                                             # 6
            HGBlock(1024, 192, 1024, 5, lightconv=True, shortcut=True,
                    **kw),                                             # 7 P4
            ConvBnAct(1024, 1024, 3, 2, act=False, groups=1024, **kw),  # 8
            HGBlock(1024, 384, 2048, 5, lightconv=True, **kw),         # 9 P5
            ConvBnAct(2048, c, 1, act=False, **kw),                    # 10
            AIFI(c, cfg.ffn, cfg.heads, dtype),                        # 11
            ConvBnAct(c, c, 1, **kw),                                  # 12
            Upsample(),                                                # 13
            ConvBnAct(1024, c, 1, act=False, **kw),                    # 14
            nn.Identity(),                                             # 15
            RepC3(2 * c, c, **kw),                                     # 16
            ConvBnAct(c, c, 1, **kw),                                  # 17
            Upsample(),                                                # 18
            ConvBnAct(512, c, 1, act=False, **kw),                     # 19
            nn.Identity(),                                             # 20
            RepC3(2 * c, c, **kw),                                     # 21
            ConvBnAct(c, c, 3, 2, **kw),                               # 22
            nn.Identity(),                                             # 23
            RepC3(2 * c, c, **kw),                                     # 24
            ConvBnAct(c, c, 3, 2, **kw),                               # 25
            nn.Identity(),                                             # 26
            RepC3(2 * c, c, **kw),                                     # 27
            RTDETRDecoder(cfg, **kw),                                  # 28
        ])

    def backbone(self, x: torch.Tensor):
        """HGNetv2-L: (P3 512ch, P4 1024ch, P5 2048ch)."""
        m = self.model
        p3 = m[3](m[2](m[1](m[0](x))))
        p4 = m[7](m[6](m[5](m[4](p3))))
        p5 = m[9](m[8](p4))
        return p3, p4, p5

    def encoder(self, feats):
        """Hybrid encoder: 1x1 projections, AIFI on P5, CCFF top-down then
        bottom-up; the upsampled branch comes first in every concat."""
        m = self.model
        p3, p4, p5 = feats
        lat5 = m[12](m[11](m[10](p5)))
        t4 = m[16](torch.cat([m[13](lat5), m[14](p4)], 1))
        lat4 = m[17](t4)
        t3 = m[21](torch.cat([m[18](lat4), m[19](p3)], 1))
        o4 = m[24](torch.cat([m[22](t3), lat4], 1))
        o5 = m[27](torch.cat([m[25](o4), lat5], 1))
        return t3, o4, o5

    def forward(self, x: torch.Tensor,
                dn: Optional[Dict[str, torch.Tensor]] = None
                ) -> Dict[str, torch.Tensor]:
        return self.model[28](self.encoder(self.backbone(x)), dn)


def _lecun_normal_(w: torch.Tensor, fan_in: int,
                   generator: torch.Generator) -> None:
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    t = torch.empty(w.shape)
    nn.init.trunc_normal_(t, 0.0, std, -2 * std, 2 * std, generator=generator)
    w.copy_(t)


def init_weights(model: RTDETR, generator: torch.Generator) -> RTDETR:
    """The reference's flax init: lecun-normal conv, dense and attention
    kernels (truncated at 2 std), zero biases, the sampling offsets' zero
    kernel and ring-of-directions bias, BN / LN affine 1/0 and running
    stats 0/1, a unit-variance-in embedding. Draws come from `generator`
    (on the CPU)."""
    cfg = model.cfg
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, (nn.Conv2d, nn.Linear)):
                _lecun_normal_(mod.weight, mod.weight[0].numel(), generator)
                if mod.bias is not None:
                    mod.bias.zero_()
            elif isinstance(mod, nn.MultiheadAttention):
                _lecun_normal_(mod.in_proj_weight, mod.embed_dim, generator)
                mod.in_proj_bias.zero_()
            elif isinstance(mod, (nn.BatchNorm2d, nn.LayerNorm)):
                mod.reset_parameters()
            elif isinstance(mod, nn.Embedding):
                _lecun_normal_(mod.weight, mod.embedding_dim, generator)
        for mod in model.modules():
            if isinstance(mod, MSDeformAttn):
                mod.sampling_offsets.weight.zero_()
                mod.sampling_offsets.bias.copy_(offset_bias_init(
                    cfg.heads, cfg.levels, cfg.points))
    return model


def create(num_classes: int = 6, dtype: torch.dtype = torch.float32,
           device: Optional[torch.device] = None,
           generator: Optional[torch.Generator] = None, train: bool = False,
           bn_dtype: torch.dtype = torch.float32, **config) -> RTDETR:
    """An RT-DETR-L on `device` (None: the CUDA card; raises when there is
    none), randomly initialised from `generator` (seed 0 when None).
    train=False: eval mode, conv weights stored in `dtype`; train=True:
    train mode, float32 master weights, train-mode BatchNorm output in
    `bn_dtype`. config: other RtDetrConfig fields (dec_layers, queries,
    ...)."""
    device = resolve_device(device)
    gen = generator or torch.Generator().manual_seed(0)
    model = RTDETR(RtDetrConfig(num_classes=num_classes, **config), dtype,
                   param_dtype=torch.float32 if train else dtype,
                   bn_dtype=bn_dtype)
    return init_weights(model, gen).to(device).train(train)


def postprocess(outputs: Dict[str, torch.Tensor], img_size: int,
                max_det: int = 300):
    """NMS-free decode, Ultralytics val semantics: each query contributes
    its max-class sigmoid score, then the top max_det queries by score.
    Returns (boxes xyxy px (B, K, 4), scores (B, K), classes int32 (B, K),
    valid (B, K)), K = min(max_det, Q)."""
    logits = outputs["logits"][-1]                  # (B, Q, nc)
    boxes = outputs["boxes"][-1]                    # (B, Q, 4) cxcywh [0,1]
    scores = torch.sigmoid(logits)
    q_scores, q_cls = scores.max(-1)
    top_s, q_idx = top_k(q_scores, min(max_det, logits.shape[1]))
    cls = torch.gather(q_cls, 1, q_idx).to(torch.int32)
    bsel = permute_rows(boxes, q_idx)
    cx, cy, w, h = bsel.unbind(-1)
    xyxy = torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2],
                       -1) * img_size
    return xyxy, top_s, cls, top_s > 0.0
