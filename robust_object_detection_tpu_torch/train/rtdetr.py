"""RT-DETR training and inference steps (counterpart of
robust_object_detection_tpu/train/rtdetr.py): set matching by the auction
solver, varifocal / L1 / GIoU losses with deep supervision, contrastive
denoising queries, AdamW with global-norm clipping and an EMA.

The matcher is ``ops.assignment.auction_assignment`` (K6 on the card): 7
matchings a train step (six decoder layers and the encoder proposals), each
capped at ``AUCTION_MAX_ROUNDS`` rounds with a greedy completion, the count
of capped image-matchings surfaced as the ``matcher_capped`` metric. The
reference's "greedy" and "hungarian" matchers are not ported.

The host-side ``train()`` loop (mosaic, data pipeline, checkpoints,
validation) is not ported yet.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..core.config import CorruptionConfig
from ..models import rtdetr as rtdetr_lib
from ..ops import boxes as box_ops
from ..ops.assignment import BIG, auction_assignment
from ..ops.fused_corrupt import fused_random_corruption
from . import augment as aug
from .detector import TrainState

# Ultralytics RT-DETR gains: the matcher weighs the focal class cost at 2,
# the loss weighs VFL at 1
W_CLASS, W_L1, W_GIOU = 1.0, 5.0, 2.0
COST_CLASS, COST_L1, COST_GIOU = 2.0, 5.0, 2.0
# Trained-regime costs converge in 3-15 rounds; near-tied costs (random
# init, crowded duplicates) would need hundreds at any eps and every
# maximal matching is near-optimal there, so capped images take the greedy
# completion.
AUCTION_MAX_ROUNDS = 16


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


@torch.no_grad()
def hungarian_match(logits: torch.Tensor, boxes: torch.Tensor,
                    gt_boxes: torch.Tensor, gt_classes: torch.Tensor,
                    max_match: int = 300
                    ) -> Tuple[torch.Tensor, torch.Tensor, Dict]:
    """Per-image assignment of queries to GTs. logits (B, Q, nc); boxes (B,
    Q, 4) normalised cxcywh; gt_boxes (B, M, 4) normalised cxcywh;
    gt_classes (B, M) with -1 padding. GTs beyond `max_match` slots are
    ignored. Cost = 2 focal class + 5 L1 + 2 (1 - GIoU), padded GTs at BIG.

    Returns (gt_for_query (B, Q) int32, -1 = unmatched; iou_q (B, Q), the
    IoU of each matched pair; {"cost": (B, Q, M), "capped": (B,) bool, True
    where the auction hit its round cap and was completed greedily})."""
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

    gt_for_query, capped = auction_assignment(cost, valid,
                                              max_rounds=AUCTION_MAX_ROUNDS)
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
    n_pos = matched.sum().clamp(min=1).to(logits.dtype)
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
                     label_noise: float = 0.5, num_classes: int = 6):
    """Noised GT queries for denoising training. Slot layout: per group,
    `max_gt` positive slots (small box noise, target = the source GT) then
    `max_gt` negative slots (large noise, target = background). Empty GT
    slots get class `num_classes` and group -1 (attention-isolated,
    loss-excluded). `generator` lives on the GTs' device; the draws follow
    the reference's distributions, not its bits.

    Returns (dn dict for the model: classes (B, D) int32, boxes (B, D, 4),
    group_ids (B, D) int32; dn_gt (B, D) int32, the source GT index, -1 =
    negative or empty; dn_active (B, D) bool)."""
    b = gt_boxes_n.shape[0]
    m = min(max_gt, gt_boxes_n.shape[1])
    dev = gt_boxes_n.device
    gtb = gt_boxes_n[:, :m]
    gtc = gt_classes[:, :m]
    valid = gtc >= 0

    def uniform(shape, lo, hi):
        return torch.rand(shape, generator=generator, device=dev) * (hi - lo) \
            + lo

    cls_s, box_s, gid_s, gt_s = [], [], [], []
    gt_idx = torch.arange(m, dtype=torch.int32, device=dev)[None].expand(b, m)
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
            rand_cls = torch.randint(0, num_classes, gtc.shape,
                                     generator=generator, device=dev)
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
    n_pos = pos.sum().clamp(min=1).to(dn_logits.dtype)
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
    chain starts with."""
    clip: float = 0.1


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


def make_train_step(img_size: int, corruption: Optional[CorruptionConfig],
                    augment: bool, ema_decay: float = 0.9999,
                    denoise: bool = True, dn_groups: int = 2,
                    dn_max_gt: int = 32, base_augment: bool = False
                    ) -> Callable:
    """Train step: (state, images_u8 (B, S, S, 3), gt_boxes (B, M, 4) xyxy
    canvas px, gt_classes (B, M) with -1 padding, generator on the images'
    device) -> metrics {loss, grad_norm (before clipping), dec_cls, dec_l1,
    dec_giou, dec_n_pos, enc_cls, matcher_capped, dn} as device tensors;
    `state` is updated in place.

    Order, as the reference: uint8 -> bf16 -> HSV -> flip (base_augment)
    -> f32 -> K1 corruption with p = 0.5 (augment) -> /255 -> denoising
    queries -> train forward -> rtdetr_loss + one dn_loss per decoder layer
    -> backward -> clip by global norm -> AdamW -> EMA of the parameters
    with d = decay * (1 - exp(-(step + 1) / 2000))."""

    def step(state: RtdetrTrainState, images_u8: torch.Tensor,
             gt_boxes: torch.Tensor, gt_classes: torch.Tensor,
             generator: torch.Generator) -> Dict[str, torch.Tensor]:
        model = state.model
        model.train()
        x = images_u8.to(torch.bfloat16)
        if base_augment:
            x = aug.random_hsv(x, generator)
            x, gt_boxes = aug.random_flip_lr(x, gt_boxes, gt_classes,
                                             generator)
        x = x.float()
        if augment:
            x, _ = fused_random_corruption(x.contiguous(), generator,
                                           corruption)
        x = x / 255.0

        dn = dn_gt = dn_active = None
        gt_n = to_norm_cxcywh(gt_boxes, img_size)
        if denoise:
            dn, dn_gt, dn_active = build_dn_queries(
                gt_n, gt_classes, generator, num_groups=dn_groups,
                max_gt=dn_max_gt, num_classes=model.cfg.num_classes)

        state.optimizer.zero_grad(set_to_none=True)
        outs = model(x, dn)
        loss, metrics = rtdetr_loss(outs, gt_boxes, gt_classes, img_size)
        if denoise:
            dn_total = sum(
                dn_loss(outs["dn_logits"][li], outs["dn_boxes"][li], dn_gt,
                        dn_active, gt_n, gt_classes)
                for li in range(outs["dn_logits"].shape[0]))
            loss = loss + dn_total
            metrics = dict(metrics, dn=dn_total)
        loss.backward()

        grads = [p.grad for p in model.parameters() if p.grad is not None]
        grad_norm = torch.nn.utils.get_total_norm(grads)
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


def make_predict_step(img_size: int, max_det: int = 300) -> Callable:
    """Inference: (model, images (B, S, S, 3) in [0, 255]) -> NMS-free
    detections (boxes (B, max_det, 4) canvas xyxy, scores, classes int32,
    valid), fixed capacity: the contract of
    ``train.detector.make_predict_step``, so ``eval.fused_sweep`` takes
    either."""

    @torch.inference_mode()
    def step(model: torch.nn.Module, images: torch.Tensor):
        x = images.float() / 255.0
        return rtdetr_lib.postprocess(model(x), img_size, max_det)

    return step
