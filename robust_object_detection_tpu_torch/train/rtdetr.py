"""RT-DETR training (counterpart of robust_object_detection_tpu/train/
rtdetr.py): set matching, varifocal / L1 / GIoU losses with deep
supervision, contrastive denoising queries, AdamW with global-norm clipping
and an EMA, and the training loop.

The module-level ``ASSIGNMENT`` knob picks the matcher of the 7 matchings
a train step makes (six decoder layers and the encoder proposals):
"auction" (the default; ``ops.assignment.auction_assignment``, K6 on the
card, capped at ``AUCTION_MAX_ROUNDS`` rounds with a greedy completion, the
count of capped image-matchings surfaced as ``matcher_capped``), "greedy"
(the globally cheapest pair each round, on the tensors' device) or
"hungarian" (the exact optimum, in float64 numpy on the host).

:func:`train` is the reference's loop on one device, with the reference's
epoch-level resume (``last`` keyed by epoch); validation and
:func:`load_checkpoint` predict with the EMA weights
(``train.detector.ema_forward``).
"""

from __future__ import annotations

import dataclasses
import math
import time
from pathlib import Path
from typing import Callable, Dict, Mapping, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from ..core import artifacts
from ..core.checkpoint import CheckpointManager
from ..core.config import CorruptionConfig, ExperimentConfig
from ..data import pipeline as pipe
from ..models import rtdetr as rtdetr_lib
from ..models.layers import resolve_device
from ..ops import boxes as box_ops
from ..ops.assignment import BIG, _first_max, auction_assignment
from ..ops.corrupt import random_corruption_fast
from ..ops.fused_corrupt import draw_choice
from ..parallel import distributed as dist
from ..parallel import mesh as mesh_lib
from ..parallel.mesh import global_sum
from . import augment as aug
from . import validation
from .detector import (TrainState, _ckpt_payload, compute_dtype,
                       resume_payload, ema_forward, ema_module,
                       epoch_batches, load_pretrained, restore_state,
                       restore_weights, train_samples)
from .frcnn import step_generator

# Ultralytics RT-DETR gains: the matcher weighs the focal class cost at 2,
# the loss weighs VFL at 1
W_CLASS, W_L1, W_GIOU = 1.0, 5.0, 2.0
COST_CLASS, COST_L1, COST_GIOU = 2.0, 5.0, 2.0
# Trained-regime costs converge in 3-15 rounds; near-tied costs (random
# init, crowded duplicates) would need hundreds at any eps and every
# maximal matching is near-optimal there, so capped images take the greedy
# completion.
AUCTION_MAX_ROUNDS = 16
# "auction" (eps-optimal, the default) | "greedy" | "hungarian" (exact)
ASSIGNMENT = "auction"


def to_norm_cxcywh(boxes_xyxy: torch.Tensor, img_size: float) -> torch.Tensor:
    b = boxes_xyxy / img_size
    return torch.stack([(b[..., 0] + b[..., 2]) / 2,
                        (b[..., 1] + b[..., 3]) / 2,
                        b[..., 2] - b[..., 0], b[..., 3] - b[..., 1]], -1)


def _cxcywh_to_xyxy(b: torch.Tensor) -> torch.Tensor:
    return torch.stack([b[..., 0] - b[..., 2] / 2, b[..., 1] - b[..., 3] / 2,
                        b[..., 0] + b[..., 2] / 2, b[..., 1] + b[..., 3] / 2],
                       -1)


def _take_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (B, M, ...)[b, idx[b, q]] -> (B, Q, ...)."""
    return rtdetr_lib.permute_rows(x, idx.long())


def _hungarian_rows(a: np.ndarray) -> np.ndarray:
    """Exact min-cost assignment of every row of a (n, m), n <= m, to a
    distinct column (shortest augmenting paths with potentials, float64).
    Returns the column of each row."""
    n, m = a.shape
    u = np.zeros(n + 1)
    v = np.zeros(m + 1)
    p = np.zeros(m + 1, np.int64)       # p[j]: the row (1-based) at column j
    way = np.zeros(m + 1, np.int64)
    for i in range(1, n + 1):
        p[0] = i
        j0 = 0
        minv = np.full(m + 1, np.inf)
        used = np.zeros(m + 1, bool)
        while True:
            used[j0] = True
            i0 = p[j0]
            free = ~used[1:]
            cur = a[i0 - 1] - u[i0] - v[1:]
            better = free & (cur < minv[1:])
            minv[1:][better] = cur[better]
            way[1:][better] = j0
            masked = np.where(free, minv[1:], np.inf)
            j1 = int(np.argmin(masked)) + 1
            delta = masked[j1 - 1]
            u[p[used]] += delta
            v[used] -= delta
            minv[1:][free] -= delta
            j0 = j1
            if p[j0] == 0:
                break
        while j0:
            j1 = way[j0]
            p[j0] = p[j1]
            j0 = j1
    cols = np.zeros(n, np.int64)
    for j in range(1, m + 1):
        if p[j]:
            cols[p[j] - 1] = j - 1
    return cols


def _solve_assignment(cost: torch.Tensor, exact: bool = False
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched one-to-one assignment of cost (B, Q, M) -> (rows, cols),
    each (B, K) int32, K = min(Q, M): pairs in assignment order; slots
    left unfilled hold (0, M), which the caller drops.

    exact=False, the greedy matcher: each round takes the globally
    cheapest (query, GT) pair (ties to the lowest flat index) and retires
    its row and column, for K rounds or until only costs >= BIG / 2
    remain; batched on the tensors' device, one host sync a call.
    exact=True: the optimal assignment of each image's columns that have a
    cost below BIG / 2 (padded GTs are matched by no one), in float64 numpy
    on the host; pairs in row order."""
    b, qn, m = cost.shape
    k = min(qn, m)
    dev = cost.device
    rows = torch.zeros((b, k), dtype=torch.int64, device=dev)
    cols = torch.full((b, k), m, dtype=torch.int64, device=dev)
    if exact:
        host = cost.detach().double().cpu().numpy()
        for i in range(b):
            keep = np.flatnonzero(host[i].min(0) < BIG / 2)
            a = host[i][:, keep]
            if not len(keep):
                continue
            if len(keep) <= qn:         # every kept GT gets a query
                r = _hungarian_rows(a.T)
                q_idx, m_idx = r, keep
            else:                       # every query gets a GT
                r = _hungarian_rows(a)
                q_idx, m_idx = np.arange(qn), keep[r]
            order = np.argsort(q_idx, kind="stable")
            n = len(order)
            rows[i, :n] = torch.from_numpy(q_idx[order]).to(dev)
            cols[i, :n] = torch.from_numpy(m_idx[order]).to(dev)
        return rows.to(torch.int32), cols.to(torch.int32)

    n_iter = min(int((cost.amin(1) < BIG / 2).sum(1).max()), k)
    q_used = torch.zeros((b, qn), dtype=torch.bool, device=dev)
    m_used = torch.zeros((b, m), dtype=torch.bool, device=dev)
    ar = torch.arange(b, device=dev)
    for i in range(n_iter):
        masked = cost + (q_used[:, :, None] | m_used[:, None, :]) * BIG
        best, idx = _first_max(-masked.reshape(b, -1), 1)
        qi, mi = idx // m, idx % m
        take = -best < BIG / 2
        rows[:, i] = torch.where(take, qi, rows[:, i])
        cols[:, i] = torch.where(take, mi, cols[:, i])
        q_used[ar, qi] |= take
        m_used[ar, mi] |= take
    return rows.to(torch.int32), cols.to(torch.int32)


def _pairs_to_gt_for_query(rows: torch.Tensor, cols: torch.Tensor,
                           valid: torch.Tensor, qn: int) -> torch.Tensor:
    """(rows, cols) pairs -> gt_for_query (B, Q) int32, -1 = unmatched.
    Pairs on a padded GT or an unfilled slot (col == M) write to an
    overflow slot, so they never clobber a real query's assignment."""
    m = valid.shape[1]
    in_range = cols < m
    cols_c = cols.clamp(max=m - 1).long()
    matched = torch.gather(valid, 1, cols_c) & in_range
    slot = torch.where(matched, rows.long(), qn)
    out = torch.full((rows.shape[0], qn + 1), -1, dtype=torch.int32,
                     device=rows.device)
    out.scatter_(1, slot, torch.where(matched, cols_c, -1).to(torch.int32))
    return out[:, :qn]


@torch.no_grad()
def hungarian_match(logits: torch.Tensor, boxes: torch.Tensor,
                    gt_boxes: torch.Tensor, gt_classes: torch.Tensor,
                    max_match: int = 300, method: Optional[str] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor, Dict]:
    """Per-image assignment of queries to GTs. logits (B, Q, nc); boxes (B,
    Q, 4) normalised cxcywh; gt_boxes (B, M, 4) normalised cxcywh;
    gt_classes (B, M) with -1 padding. GTs beyond `max_match` slots are
    ignored. Cost = 2 focal class + 5 L1 + 2 (1 - GIoU), padded GTs at BIG.
    method: "auction", "greedy" or "hungarian"; None reads the module's
    ``ASSIGNMENT``.

    Returns (gt_for_query (B, Q) int32, -1 = unmatched; iou_q (B, Q), the
    IoU of each matched pair; {"cost": (B, Q, M), "capped": (B,) bool, True
    where the auction hit its round cap and was completed greedily; always
    False for the greedy and Hungarian matchers}). Under an active mesh
    with a model axis (parallel/mesh.active), gt_for_query and capped are
    model index 0's on every rank of the model group."""
    m = min(max_match, gt_boxes.shape[1])
    gtb = gt_boxes[:, :m]
    gtc = gt_classes[:, :m]
    valid = gtc >= 0

    prob = torch.sigmoid(logits.float())
    alpha, gamma = 0.25, 2.0
    neg = (1 - alpha) * prob ** gamma * (-torch.log1p(-prob + 1e-8))
    pos = alpha * (1 - prob) ** gamma * (-torch.log(prob + 1e-8))
    col = gtc.clamp(min=0).long()[:, None, :].expand(-1, logits.shape[1], -1)
    cls_sel = torch.gather(pos - neg, 2, col)                 # (B, Q, M)

    l1 = sum((boxes[:, :, None, i] - gtb[:, None, :, i]).abs()
             for i in range(4))
    qx = _cxcywh_to_xyxy(boxes)
    gx = _cxcywh_to_xyxy(gtb)
    giou = box_ops.pairwise_giou(qx, gx)
    cost = COST_CLASS * cls_sel + COST_L1 * l1 + COST_GIOU * (1.0 - giou)
    cost = torch.where(valid[:, None, :], cost, BIG).contiguous()

    method = ASSIGNMENT if method is None else method
    if method == "auction":
        gt_for_query, capped = auction_assignment(
            cost, valid, max_rounds=AUCTION_MAX_ROUNDS)
    elif method in ("greedy", "hungarian"):
        rows, cols = _solve_assignment(cost, exact=method == "hungarian")
        gt_for_query = _pairs_to_gt_for_query(rows, cols, valid,
                                              logits.shape[1])
        capped = torch.zeros(cost.shape[0], dtype=torch.bool,
                             device=cost.device)
    else:
        raise ValueError(f"method {method!r}: 'auction', 'greedy' or "
                         f"'hungarian'")
    # under the decoder split every model rank reads model index 0's
    # matching: the reference makes one
    ctx = mesh_lib.active()
    if ctx is not None and ctx.n_model > 1:
        mesh_lib.broadcast_over_model([gt_for_query, capped], ctx)
    tgt_x = _take_rows(gx, gt_for_query.clamp(min=0))
    iou_q = box_ops.iou_elementwise(qx, tgt_x)
    iou_q = torch.where(gt_for_query >= 0, iou_q, 0.0)
    return gt_for_query, iou_q, {"cost": cost, "capped": capped}


def varifocal_loss(logits: torch.Tensor, target_cls: torch.Tensor,
                   target_iou: torch.Tensor, alpha: float = 0.75,
                   gamma: float = 2.0) -> torch.Tensor:
    """VFL, Ultralytics semantics: weight = alpha p^gamma (1 - label) +
    gt_score label; the label, not the score, gates the branches. Returns
    the raw sum; the caller normalises."""
    nc = logits.shape[-1]
    label = (F.one_hot(target_cls.clamp(min=0).long(), nc)
             * (target_cls >= 0)[..., None]).to(logits.dtype)
    t = label * target_iou[..., None]
    p = torch.sigmoid(logits)
    weight = alpha * p ** gamma * (1.0 - label) + t * label
    bce = F.binary_cross_entropy_with_logits(logits, t, reduction="none")
    return (bce * weight).sum()


def _layer_loss(logits, boxes, gt_boxes_n, gt_classes):
    gt_for_q, iou_q, aux = hungarian_match(logits.detach(), boxes.detach(),
                                           gt_boxes_n, gt_classes)
    matched = gt_for_q >= 0
    # over the global batch in a data-parallel step
    n_pos = global_sum(matched.sum()).clamp(min=1).to(logits.dtype)
    safe = gt_for_q.clamp(min=0)
    tgt_cls = torch.where(
        matched, torch.gather(gt_classes.clamp(min=0), 1, safe.long()), -1)
    # Ultralytics normalises VFL by .mean(1).sum() / num_gts: both the query
    # count and the GT count divide the sum
    nq = logits.shape[1]
    cls_l = varifocal_loss(logits, tgt_cls, iou_q) / nq / n_pos

    tgt_box = _take_rows(gt_boxes_n, safe)
    l1 = ((boxes - tgt_box).abs().sum(-1) * matched).sum() / n_pos
    giou = box_ops.giou(_cxcywh_to_xyxy(boxes), _cxcywh_to_xyxy(tgt_box))
    giou_l = ((1.0 - giou) * matched).sum() / n_pos
    return W_CLASS * cls_l + W_L1 * l1 + W_GIOU * giou_l, {
        "cls": cls_l, "l1": l1, "giou": giou_l, "n_pos": n_pos,
        "capped": aux["capped"].sum()}


# ── Contrastive denoising (CDN) ──────────────────────────────────────────

def build_dn_queries(gt_boxes_n: torch.Tensor, gt_classes: torch.Tensor,
                     generator: torch.Generator, num_groups: int = 2,
                     max_gt: int = 32, box_noise: float = 0.4,
                     label_noise: float = 0.5, num_classes: int = 6,
                     total: Optional[int] = None,
                     rows: slice = slice(None)):
    """Noised GT queries for denoising training. Slot layout: per group,
    `max_gt` positive slots (small box noise, target = the source GT) then
    `max_gt` negative slots (large noise, target = background). Empty GT
    slots get class `num_classes` and group -1 (attention-isolated,
    loss-excluded). `generator` lives on the GTs' device; the draws follow
    the reference's distributions, not its bits.

    Returns (dn dict for the model: classes (B, D) int32, boxes (B, D, 4),
    group_ids (B, D) int32; dn_gt (B, D) int32, the source GT index, -1 =
    negative or empty; dn_active (B, D) bool). The GTs may be the `rows`
    of a global batch of `total` (a data-parallel rank's): every draw is
    made for the global batch and sliced."""
    b = gt_boxes_n.shape[0] if total is None else total
    m = min(max_gt, gt_boxes_n.shape[1])
    dev = gt_boxes_n.device
    gtb = gt_boxes_n[:, :m]
    gtc = gt_classes[:, :m]
    valid = gtc >= 0

    def uniform(shape, lo, hi):
        u = torch.rand((b,) + tuple(shape[1:]), generator=generator,
                       device=dev)[rows]
        return u * (hi - lo) + lo

    cls_s, box_s, gid_s, gt_s = [], [], [], []
    gt_idx = torch.arange(m, dtype=torch.int32, device=dev)[None].expand(
        gtb.shape[0], m)
    none = torch.full_like(gt_idx, -1)
    for g in range(num_groups):
        for positive in (True, False):
            wh = gtb[..., 2:]
            # positive: centre within 0.5 wh noise; negative: pushed out to
            # (0.5..1) wh noise, wrong but near
            lo, hi = (0.0, 0.5) if positive else (0.5, 1.0)
            mag = uniform(wh.shape, lo, hi)
            sign = torch.where(uniform(wh.shape, 0.0, 1.0) < 0.5, 1.0, -1.0)
            centre = gtb[..., :2] + sign * mag * wh * box_noise
            scale = uniform(wh.shape, 1 - box_noise * hi, 1 + box_noise * hi)
            boxes = torch.cat([centre, wh * scale], -1).clamp(1e-4, 1 - 1e-4)
            flip = uniform(gtc.shape, 0.0, 1.0) < label_noise
            rand_cls = torch.randint(0, num_classes, (b,) + gtc.shape[1:],
                                     generator=generator, device=dev)[rows]
            cls = torch.where(flip, rand_cls, gtc.clamp(min=0).long())
            cls_s.append(torch.where(valid, cls, num_classes))
            box_s.append(boxes)
            gid_s.append(torch.where(valid, g, -1))
            gt_s.append(torch.where(valid, gt_idx, none) if positive
                        else none)
    dn = {"classes": torch.cat(cls_s, 1).to(torch.int32),
          "boxes": torch.cat(box_s, 1),
          "group_ids": torch.cat(gid_s, 1).to(torch.int32)}
    dn_gt = torch.cat(gt_s, 1).to(torch.int32)
    dn_active = torch.cat([valid] * (2 * num_groups), 1)
    return dn, dn_gt, dn_active


def dn_loss(dn_logits: torch.Tensor, dn_boxes: torch.Tensor,
            dn_gt: torch.Tensor, dn_active: torch.Tensor,
            gt_boxes_n: torch.Tensor, gt_classes: torch.Tensor
            ) -> torch.Tensor:
    """One layer's denoising loss with the known assignment (no matching):
    positives regress their source GT and take VFL with its class;
    negatives take background VFL; inactive slots' logits are forced to
    -1e4 and weigh nothing."""
    pos = dn_gt >= 0
    n_pos = global_sum(pos.sum()).clamp(min=1).to(dn_logits.dtype)
    safe = dn_gt.clamp(min=0)
    tgt_box = _take_rows(gt_boxes_n, safe)
    tgt_cls = torch.where(
        pos, torch.gather(gt_classes.clamp(min=0), 1, safe.long()), -1)
    qx = _cxcywh_to_xyxy(dn_boxes)
    gx = _cxcywh_to_xyxy(tgt_box)
    iou = box_ops.iou_elementwise(qx, gx) * pos
    masked = torch.where(dn_active[..., None], dn_logits, -1e4)
    cls_l = (varifocal_loss(masked, tgt_cls, iou.detach())
             / dn_logits.shape[1] / n_pos)
    l1 = ((dn_boxes - tgt_box).abs().sum(-1) * pos).sum() / n_pos
    giou_l = ((1.0 - box_ops.giou(qx, gx)) * pos).sum() / n_pos
    return W_CLASS * cls_l + W_L1 * l1 + W_GIOU * giou_l


def rtdetr_loss(outputs: Dict[str, torch.Tensor], gt_boxes_xyxy: torch.Tensor,
                gt_classes: torch.Tensor, img_size: int
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Deep-supervised set loss: every decoder layer and the encoder
    proposals, one matching each. Metrics: dec_cls / dec_l1 / dec_giou /
    dec_n_pos of the last layer, enc_cls, and matcher_capped, the count of
    image-matchings the auction did not finish within its round cap."""
    gt_n = to_norm_cxcywh(gt_boxes_xyxy, img_size)
    total = 0.0
    metrics: Dict[str, torch.Tensor] = {}
    capped = 0
    n_layers = outputs["logits"].shape[0]
    for li in range(n_layers):
        l, m = _layer_loss(outputs["logits"][li], outputs["boxes"][li], gt_n,
                           gt_classes)
        total = total + l
        capped = capped + m["capped"]
        if li == n_layers - 1:
            metrics = {f"dec_{k}": v for k, v in m.items() if k != "capped"}
    enc_l, enc_m = _layer_loss(outputs["enc_logits"], outputs["enc_boxes"],
                               gt_n, gt_classes)
    metrics["enc_cls"] = enc_m["cls"]
    metrics["matcher_capped"] = capped + enc_m["capped"]
    return total + enc_l, metrics


# ── Train and predict steps ──────────────────────────────────────────────

@dataclasses.dataclass
class RtdetrTrainState(TrainState):
    """train.detector.TrainState plus the global-norm clip the optimizer
    chain starts with, and the decoder's tensor-parallel plan
    (parallel/mesh.rtdetr_decoder_tp) when the model holds shards."""
    clip: float = 0.1
    tp_plan: Optional[Dict] = None


def make_optimizer(lr: float = 1e-4, weight_decay: float = 1e-4,
                   warmup_steps: int = 500, total_steps: int = 100000,
                   clip: float = 0.1, lrf: float = 1.0
                   ) -> Tuple[Callable, Callable[[int], float]]:
    """(tx, sched). sched(count): linear warmup 0 -> lr over warmup_steps,
    then linear lr -> lr * lrf over the remaining steps, evaluated at the
    count BEFORE the update (step 0 runs at lr 0). tx(model) -> (AdamW,
    LambdaLR, clip): AdamW (betas 0.9 / 0.999, eps 1e-8) over every
    parameter, weight decay on all of them (BatchNorm and biases included,
    as optax.adamw decays every leaf), gradients first scaled by
    clip / max(global norm, clip). A parameter that gets no gradient
    (``denoising_class_embed`` with ``denoise=False``) is skipped by
    PyTorch's AdamW, decay included, where optax would still decay it."""
    decay_steps = max(1, total_steps - warmup_steps)

    def sched(count: int) -> float:
        if count < warmup_steps:
            return lr * count / warmup_steps
        frac = min(count - warmup_steps, decay_steps) / decay_steps
        return lr + (lr * lrf - lr) * frac

    def tx(model: torch.nn.Module):
        params = [p for p in model.parameters() if p.requires_grad]
        opt = torch.optim.AdamW(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                                weight_decay=weight_decay)
        return opt, torch.optim.lr_scheduler.LambdaLR(
            opt, lambda count: sched(count) / lr), clip

    return tx, sched


def init_state(model: torch.nn.Module, tx: Callable) -> RtdetrTrainState:
    """A fresh state for `model` (in train mode, ``rtdetr.create(...,
    train=True)``): EMA = a copy of the parameters, optimizer from `tx`."""
    opt, sched, clip = tx(model)
    ema = {n: p.detach().clone() for n, p in model.named_parameters()
           if p.requires_grad}
    return RtdetrTrainState(model, ema, opt, sched, clip=clip)


# metrics that add up over the ranks of a data-parallel step
ADDITIVE = ("loss", "dec_cls", "dec_l1", "dec_giou", "enc_cls",
            "matcher_capped", "dn")


def replicated_grads(state: "RtdetrTrainState") -> list:
    """The gradients of the leaves the tensor-parallel plan replicates
    (none without a plan)."""
    plan = state.tp_plan
    if not plan:
        return []
    return [p.grad for n, p in state.model.named_parameters()
            if p.grad is not None and plan.get(n) is None]


def global_grad_norm(state: "RtdetrTrainState",
                     mesh: Optional[mesh_lib.MeshContext]) -> torch.Tensor:
    """The global norm of the gradients with each element counted once:
    under tensor parallelism a sharded leaf's squares sum over the model
    group, a replicated leaf (the same on every model rank: the step
    broadcasts model index 0's gradient) counts once."""
    plan = state.tp_plan
    named = [(n, p.grad) for n, p in state.model.named_parameters()
             if p.grad is not None]
    if not plan or mesh is None or mesh.n_model == 1:
        return torch.nn.utils.get_total_norm([g for _, g in named])
    sharded = [g for n, g in named if plan.get(n) is not None]
    replicated = [g for n, g in named if plan.get(n) is None]
    sq = torch.nn.utils.get_total_norm(sharded) ** 2
    sq = mesh_lib.sum_over_model(sq, mesh)
    return torch.sqrt(sq + torch.nn.utils.get_total_norm(replicated) ** 2)


def make_train_step(img_size: int, corruption: Optional[CorruptionConfig],
                    augment: bool, ema_decay: float = 0.9999,
                    denoise: bool = True, dn_groups: int = 2,
                    dn_max_gt: int = 32, base_augment: bool = False,
                    mesh: Optional[mesh_lib.MeshContext] = None
                    ) -> Callable:
    """Train step: (state, images_u8 (B, S, S, 3), gt_boxes (B, M, 4) xyxy
    canvas px, gt_classes (B, M) with -1 padding, generator on the images'
    device) -> metrics {loss, grad_norm (before clipping), dec_cls, dec_l1,
    dec_giou, dec_n_pos, enc_cls, matcher_capped, dn} as device tensors;
    `state` is updated in place.

    Order, as the reference: uint8 -> bf16 -> HSV -> flip (base_augment)
    -> f32 -> corruption with p = 0.5 (augment; ``random_corruption_fast``:
    K1 at blur angle 0) -> /255 -> denoising
    queries -> train forward -> rtdetr_loss + one dn_loss per decoder layer
    -> backward -> clip by global norm -> AdamW -> EMA of the parameters
    with d = decay * (1 - exp(-(step + 1) / 2000)).

    mesh: the (data, model) mesh. The images are this rank's data rows
    (the ranks of one model group hold the same rows); draws, BatchNorm
    statistics and the set losses' positive counts span the global batch,
    gradients and additive metrics are summed over the data group, and a
    model holding decoder shards (parallel/mesh.apply_tp) takes model
    index 0's matchings and replicated leaves' gradients on every model
    rank (the reference's one array: parallel/mesh.broadcast_over_model)
    and clips by the norm that counts each element once
    (:func:`global_grad_norm`)."""

    def step(state: RtdetrTrainState, images_u8: torch.Tensor,
             gt_boxes: torch.Tensor, gt_classes: torch.Tensor,
             generator: torch.Generator) -> Dict[str, torch.Tensor]:
        model = state.model
        model.train()
        n, rows = mesh_lib.draw_rows(images_u8.shape[0], mesh)
        x = images_u8.to(torch.bfloat16)
        if base_augment:
            x = aug.random_hsv(x, generator, total=n, rows=rows)
            x, gt_boxes = aug.random_flip_lr(x, gt_boxes, gt_classes,
                                             generator, total=n, rows=rows)
        x = x.float()
        if augment:
            choice, seeds = draw_choice(n, generator, corruption)
            x, _ = random_corruption_fast(x.contiguous(), None, corruption,
                                          choice=choice[rows],
                                          seeds=seeds[rows])
        x = x / 255.0

        dn = dn_gt = dn_active = None
        gt_n = to_norm_cxcywh(gt_boxes, img_size)
        if denoise:
            dn, dn_gt, dn_active = build_dn_queries(
                gt_n, gt_classes, generator, num_groups=dn_groups,
                max_gt=dn_max_gt, num_classes=model.cfg.num_classes,
                total=n, rows=rows)

        state.optimizer.zero_grad(set_to_none=True)
        with mesh_lib.data_parallel(mesh):
            outs = model(x, dn)
            loss, metrics = rtdetr_loss(outs, gt_boxes, gt_classes,
                                        img_size)
            if denoise:
                dn_total = sum(
                    dn_loss(outs["dn_logits"][li], outs["dn_boxes"][li],
                            dn_gt, dn_active, gt_n, gt_classes)
                    for li in range(outs["dn_logits"].shape[0]))
                loss = loss + dn_total
                metrics = dict(metrics, dn=dn_total)
            loss.backward()
        mesh_lib.all_reduce_grads(model.parameters(), mesh)
        mesh_lib.broadcast_over_model(replicated_grads(state), mesh)
        metrics = mesh_lib.sum_over_data(dict(metrics, loss=loss), mesh,
                                         ADDITIVE)
        loss = metrics.pop("loss")

        grads = [p.grad for p in model.parameters() if p.grad is not None]
        grad_norm = global_grad_norm(state, mesh)
        # optax.clip_by_global_norm: g * clip / max(norm, clip)
        torch._foreach_mul_(grads,
                            state.clip / grad_norm.clamp(min=state.clip))
        state.optimizer.step()
        state.scheduler.step()

        d = ema_decay * (1.0 - math.exp(-(state.step + 1) / 2000.0))
        with torch.no_grad():
            named = [(state.ema[n], p) for n, p in model.named_parameters()
                     if n in state.ema]
            emas = [e for e, _ in named]
            torch._foreach_mul_(emas, d)
            torch._foreach_add_(emas, [p.detach() for _, p in named],
                                alpha=1.0 - d)
        state.step += 1
        return dict({k: v.detach() for k, v in metrics.items()},
                    loss=loss.detach(), grad_norm=grad_norm)

    return step


def make_predict_step(img_size: int, max_det: int = 300,
                      use_ema: bool = False) -> Callable:
    """Inference: (model, images (B, S, S, 3) in [0, 255]) -> NMS-free
    detections (boxes (B, max_det, 4) canvas xyxy, scores, classes int32,
    valid), fixed capacity: the contract of
    ``train.detector.make_predict_step``, so ``eval.fused_sweep`` takes
    either. use_ema=True: the step takes a train state in place of the
    model and runs its EMA weights (``train.detector.ema_forward``), as
    the reference's default predict step and every validation does."""

    @torch.inference_mode()
    def step(model, images: torch.Tensor):
        x = images.float() / 255.0
        outs = ema_forward(model, x) if use_ema else model(x)
        return rtdetr_lib.postprocess(outs, img_size, max_det)

    return step


# ── The training loop ────────────────────────────────────────────────────

def _opt_names(model: torch.nn.Module) -> list:
    """Parameter names in the optimizer's index order (make_optimizer's
    ``requires_grad`` parameters)."""
    return [n for n, p in model.named_parameters() if p.requires_grad]


def _relayout(payload: dict, names: list, fn) -> dict:
    """A ``last`` / ``best`` payload with fn(name, tensor) applied to the
    model's, the EMA's and the optimizer's per-parameter tensors."""
    out = dict(payload)
    out["model"] = {k: fn(k, v) for k, v in payload["model"].items()}
    out["ema"] = {k: fn(k, v) for k, v in payload["ema"].items()}
    if "optimizer" in payload:
        opt = dict(payload["optimizer"])
        opt["state"] = {i: {k: (fn(names[i], v) if torch.is_tensor(v)
                                and v.dim() > 0 else v)
                            for k, v in st.items()}
                        for i, st in payload["optimizer"]["state"].items()}
        out["optimizer"] = opt
    return out


def full_payload(state: RtdetrTrainState,
                 mesh: Optional[mesh_lib.MeshContext],
                 resume: bool = True) -> dict:
    """The ``last`` (resume=True) or ``best`` payload in the layout of a
    run without tensor parallelism: shards gathered over the model group
    (a collective: every rank calls it)."""
    payload = (resume_payload(state) if resume else _ckpt_payload(state))
    if not state.tp_plan or mesh is None or mesh.n_model == 1:
        return payload
    plan = state.tp_plan
    return _relayout(payload, _opt_names(state.model),
                     lambda k, v: mesh_lib.gather_shards(v, plan.get(k),
                                                         mesh))


def shard_payload(state: RtdetrTrainState,
                  mesh: Optional[mesh_lib.MeshContext], payload: dict
                  ) -> dict:
    """A full-layout payload cut to this rank's shards."""
    if not state.tp_plan or mesh is None or mesh.n_model == 1:
        return payload
    plan = state.tp_plan
    return _relayout(payload, _opt_names(state.model),
                     lambda k, v: mesh_lib.take_shard(
                         v, plan.get(k), mesh.model_index, mesh.n_model))


RTDETR_HEADS = ("model.28.enc_score_head.", "model.28.dec_score_head.")
DN_TABLE = "model.28.denoising_class_embed.weight"


def train(cfg: ExperimentConfig, data_root: str | Path, out_dir: str | Path,
          augment: bool = False, epochs: int = 100, img_size: int = 1024,
          batch_size: int = 4, max_steps: Optional[int] = None,
          max_boxes: int = 600, layout: str = "coco", val_interval: int = 1,
          lrf: float = 0.01,
          pretrained: Optional[Union[str, Path, Mapping]] = None,
          allow_pickle: bool = False,
          dtype: Optional[str] = None, base_augment: bool = True,
          mosaic: bool = True, close_mosaic: int = 10,
          model_kwargs: Optional[dict] = None,
          device: Optional[torch.device] = None,
          load_image: Callable = pipe.load_image_rgb) -> dict:
    """The RT-DETR training loop (reference: 100 epochs, batch 2 at 1024
    px) on `device` (None: the CUDA card; raises when there is none).

    lrf: final-LR fraction, warmup then linear decay lr0 -> lr0 * lrf over
    the run. val_interval: a val mAP pass every N epochs and on the last,
    keeping the best-mAP50 checkpoint. dtype: "bfloat16" (the card's
    default) or "float32"; parameters and statistics stay f32.
    base_augment / mosaic / close_mosaic: on-card HSV + flip and host
    mosaic + affine until the last close_mosaic epochs. pretrained: an
    rtdetr-l-layout state_dict or its file; the class-dependent score
    heads keep their fresh init when their shape differs, and a shorter
    denoising class table fills its first rows; allow_pickle: read a
    pickled-module file (trusted files only). model_kwargs: extra
    RtDetrConfig fields. The matcher is the module's ``ASSIGNMENT``; the
    image-matchings the auction capped are logged as ``matcher_capped``.

    Across processes cfg.mesh factors the group into (data, model): the
    step is data-parallel over the data axis (as ``train.detector.train``),
    and with ``mesh.model > 1`` the decoder layers run Megatron-style over
    the model axis (parallel/mesh.rtdetr_decoder_tp; heads and ffn must
    divide it). The optimizer's moments and the EMA keep shards; the
    checkpoints hold the full tensors, so ``load_checkpoint`` reads a
    tensor-parallel run as any other.

    Writes ``history.jsonl`` and the checkpoints under `out_dir`: ``last``
    every epoch, keyed by the epoch (not the step, as in the YOLO trainer),
    and a run that finds one resumes after its epoch. Returns {out_dir,
    steps, final_loss}."""
    rcfg = rtdetr_lib.RtDetrConfig(num_classes=6, **(model_kwargs or {}))
    n_model = max(1, cfg.mesh.model)
    if n_model > 1 and (rcfg.heads % n_model or rcfg.ffn % n_model):
        raise ValueError(
            f"tensor parallelism needs heads ({rcfg.heads}) and ffn "
            f"({rcfg.ffn}) divisible by mesh.model ({n_model})")
    device = resolve_device(device)
    model_dtype = compute_dtype(dtype, device)
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    primary = dist.is_primary()
    mesh = mesh_lib.make_mesh(cfg.mesh)
    local_bs = mesh_lib.local_batch(mesh, batch_size)

    samples = train_samples(data_root, layout)
    steps_per_epoch = max(1, len(samples) // batch_size)
    samples = dist.shard_samples(samples, mesh.data_index, mesh.n_data)
    model = rtdetr_lib.create(6, model_dtype, device,
                              torch.Generator().manual_seed(cfg.train.seed),
                              train=True, bn_dtype=model_dtype,
                              **(model_kwargs or {}))
    if pretrained:
        report = load_pretrained(model, pretrained, RTDETR_HEADS,
                                 (DN_TABLE,), allow_pickle=allow_pickle)
        print(f"pretrained import: imported {len(report['imported'])} "
              f"tensors, skipped {report['skipped']}")
    mesh_lib.replicate_tree(mesh, model)
    plan = None
    if mesh.n_model > 1:
        plan = mesh_lib.rtdetr_decoder_tp(mesh, model)
        mesh_lib.apply_tp(mesh, model, plan)
        if primary:
            print(f"[rtdetr.train] decoder TP over the {mesh.n_model}-way "
                  f"model axis", flush=True)
    tx, sched = make_optimizer(total_steps=epochs * steps_per_epoch, lrf=lrf)
    state = init_state(model, tx)
    state.tp_plan = plan
    step_fn = make_train_step(img_size, cfg.corruption, augment,
                              base_augment=base_augment, mesh=mesh)

    val_samples = validation.index_val_samples(data_root, layout)
    predict_fn = (make_predict_step(img_size, use_ema=True)
                  if val_samples else None)

    ckpt = CheckpointManager(out_dir)
    hist = artifacts.HistoryLogger(out_dir)
    steps = 0
    mean_loss = 0.0
    start_epoch = 1
    restored = ckpt.restore_last(map_location=device)
    if restored is not None:
        restore_state(state, shard_payload(state, mesh, restored["state"]))
        start_epoch = restored["step"] + 1
        steps = state.step
    for epoch in range(start_epoch, epochs + 1):
        t0 = time.time()
        losses, capped = [], []
        # mosaic until the last close_mosaic epochs (the recipe the YOLO
        # trainer shares)
        batch_iter = epoch_batches(
            samples, local_bs, img_size, max_boxes, cfg.train.seed + epoch,
            mosaic and epoch <= max(0, epochs - close_mosaic), load_image)
        for batch in pipe.prefetch(batch_iter):
            images, gt_boxes, gt_classes, _ = pipe.device_put_sharded(
                batch, device)
            m = step_fn(state, images, gt_boxes, gt_classes,
                        step_generator(cfg.train.seed, state.step, device))
            losses.append(m["loss"])
            capped.append(m["matcher_capped"])
            steps += 1
            if max_steps and steps >= max_steps:
                break
        mean_loss = float(torch.stack(losses).mean()) if losses else 0.0
        record = dict(epoch=epoch, train_loss=mean_loss,
                      lr=float(sched(steps)),
                      # image-matchings this epoch where the auction hit
                      # its round cap (greedy-completed)
                      matcher_capped=float(torch.stack(capped).sum())
                      if capped else 0.0,
                      epoch_sec=round(time.time() - t0, 2))
        if validation.should_validate(epoch, epochs, val_interval,
                                      bool(val_samples)):
            vm = validation.run_validation(
                predict_fn, state, val_samples, img_size, batch_size, device,
                max_boxes=max_boxes, load_image=load_image, mesh=mesh)
            record.update(vm)
            best = full_payload(state, mesh, resume=False)
            if primary:
                ckpt.save_best(epoch, best, vm["mAP50"])
        last = full_payload(state, mesh)
        if primary:
            hist.log(**record)
            ckpt.save_last(epoch, last)
        if max_steps and steps >= max_steps:
            break
    best = full_payload(state, mesh, resume=False)
    if primary and ckpt.best_metric() is None:
        ckpt.save_best(epochs, best, 0.0)
    ckpt.close()
    mesh_lib.barrier(mesh)      # the artifacts are on disk for every rank
    return {"out_dir": str(out_dir), "steps": steps, "final_loss": mean_loss}


def load_checkpoint(out_dir: str | Path, dtype: torch.dtype = torch.float32,
                    device: Optional[torch.device] = None,
                    model_kwargs: Optional[dict] = None) -> torch.nn.Module:
    """A trained checkpoint under `out_dir` (``best``, else the newest
    ``last``) as an eval-mode RT-DETR on `device` (None: the CUDA card)
    carrying the EMA weights, which the reference predicts with.
    model_kwargs: the RtDetrConfig fields the run trained with."""
    device = resolve_device(device)
    payload = restore_weights(out_dir, device)
    return ema_module(rtdetr_lib.create(6, dtype, device,
                                        **(model_kwargs or {})), payload)
