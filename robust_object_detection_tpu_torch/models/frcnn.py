"""Faster R-CNN ResNet-50-FPN-v2, inference (counterpart of
robust_object_detection_tpu/models/frcnn.py).

Torchvision's ``fasterrcnn_resnet50_fpn_v2`` with a 7-class head (bg + 6
VisDrone classes), in the reference's static-shape form:

  * ResNet-50 + FPN (models/resnet.py, models/fpn.py), P2..P6,
  * the v2 RPN head (two 3x3 convs), 3 anchors a location (sizes 32..512,
    one a level, ratios 0.5 / 1 / 2),
  * proposals: per-level top-k, then one NMS keyed on the level into a
    fixed budget with a validity mask,
  * RoIAlign (models/fpn.py) + the v2 box head (4 conv + BN, FC 1024) with
    class-specific box regression.

The module tree and its ``state_dict`` keys are torchvision's
(``backbone.body``, ``backbone.fpn``, ``rpn.head``, ``roi_heads.box_head``
with the FC at index 5, ``roi_heads.box_predictor``), so a
``fasterrcnn_resnet50_fpn_v2`` checkpoint loads by ``load_state_dict``
(models/convert.frcnn_from_jax_variables makes one from the reference's
variables). Modules take NCHW-indexed tensors, channels_last on the card;
images come in NHWC in [0, 1] and are normalised inside ``extract``, as
torchvision's transform does. ``extract`` and ``roi_forward`` take
``train=``: every BatchNorm (ResNet, FPN, box head) then runs in flax's
train mode at momentum 0.99 (models/resnet.batch_norm).

``dtype`` (the reference's ``FasterRCNN(dtype=...)``) is the compute type
of the backbone, FPN, RPN and box-head convs and ``fc6``; parameters stay
f32 and are cast in the forward, every BatchNorm outputs f32. The RPN's
``cls_logits`` / ``bbox_pred`` and the box predictor take no dtype in the
reference, so flax promotes their bf16 input with the f32 kernel: here the
input is cast up and they compute in f32, as do the losses, proposals and
every IoU. The training
targets are pure functions: anchor matching (:func:`match_anchors`) and
the balanced sampler (:func:`sample_targets`), whose uniforms come as
tensors or from a ``torch.Generator``.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops import boxes as box_ops
from ..ops import nms as nms_ops
from . import fpn as fpn_lib
from . import resnet as resnet_lib
from .layers import resolve_device
from .resnet import batch_norm, conv, linear
from .rtdetr import top_k

ANCHOR_SIZES = (32, 64, 128, 256, 512)       # one per level P2..P6
ASPECT_RATIOS = (0.5, 1.0, 2.0)
RPN_STRIDES = (4, 8, 16, 32, 64)
NUM_CLASSES = 7                              # bg + 6
# GeneralizedRCNNTransform image_mean/std: torchvision normalises inside
# the detector, so imported checkpoints expect it
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
# uint8 letterbox pad matching torchvision's zero-pad of the NORMALISED
# tensor (batch_images pads with 0 == pixel value mean*255)
PAD_RGB = tuple(int(round(m * 255)) for m in IMAGENET_MEAN)


@dataclasses.dataclass(frozen=True)
class FrcnnConfig:
    num_classes: int = NUM_CLASSES
    # proposal budget (static): per-level pre-NMS topk and joint post-NMS
    pre_nms_topk: int = 1000
    num_proposals: int = 512
    rpn_nms_thresh: float = 0.7
    # box head
    box_score_thresh: float = 0.05
    box_nms_thresh: float = 0.5
    box_detections: int = 100
    # training
    rpn_pos_iou: float = 0.7
    rpn_neg_iou: float = 0.3
    rpn_batch: int = 256
    rpn_pos_frac: float = 0.5
    roi_pos_iou: float = 0.5
    roi_batch: int = 512
    roi_pos_frac: float = 0.25
    # v2 FPN layout (bias-free conv + BN in lateral/post blocks); False =
    # the classic bias-conv FPN
    fpn_norm: bool = True
    # backbone stage depths; (3, 4, 6, 3) is ResNet-50
    blocks: tuple = (3, 4, 6, 3)
    # torchvision trainable_backbone_layers (5 = train everything)
    trainable_layers: int = 5
    # imagenet normalisation inside the forward (torchvision semantics);
    # False is for tensor-level parity tests against transform-free models
    normalize: bool = True


# ── Anchors ──────────────────────────────────────────────────────────────
# Canvas sizes are an int (square) or an (H, W) tuple (the aspect-bucket
# eval's rectangular canvases).

def _hw(size) -> Tuple[int, int]:
    return (size, size) if isinstance(size, int) else (size[0], size[1])


def anchor_boxes(img_size) -> np.ndarray:
    """All anchors over P2..P6 for one canvas: (A, 4) xyxy float32."""
    return np.concatenate(_anchors_hw_major(img_size))


def _anchors_hw_major(img_size) -> List[np.ndarray]:
    """Per level, anchors laid out (H*W*A, 4) with A fastest, matching an
    (H, W, A*4) head layout. torchvision's AnchorGenerator geometry:
    base-anchor corners rounded to integers and a corner-aligned grid
    (shift = i * stride, not cell centres) over ceil(H / stride) cells."""
    ih, iw = _hw(img_size)
    per_level = []
    for size, stride in zip(ANCHOR_SIZES, RPN_STRIDES):
        nh, nw = -(-ih // stride), -(-iw // stride)
        cy, cx = np.mgrid[0:nh, 0:nw].astype(np.float32) * stride
        base = np.round(np.stack(
            [np.asarray([-size * np.sqrt(1.0 / r) / 2,
                         -size * np.sqrt(r) / 2,
                         size * np.sqrt(1.0 / r) / 2,
                         size * np.sqrt(r) / 2], np.float32)
             for r in ASPECT_RATIOS]))                  # (A, 4) rounded
        shifts = np.stack([cx, cy, cx, cy], axis=-1)    # (nh, nw, 4)
        lvl = shifts[:, :, None, :] + base[None, None]  # (nh, nw, A, 4)
        per_level.append(lvl.reshape(-1, 4).astype(np.float32))
    return per_level


@functools.lru_cache(maxsize=None)
def _anchor_tensor(hw: Tuple[int, int], device: torch.device) -> torch.Tensor:
    return torch.from_numpy(anchor_boxes(hw)).to(device)


def level_slices(img_size) -> List[Tuple[int, int]]:
    ih, iw = _hw(img_size)
    out, off = [], 0
    for stride in RPN_STRIDES:
        n = (-(-ih // stride)) * (-(-iw // stride)) * len(ASPECT_RATIOS)
        out.append((off, off + n))
        off += n
    return out


# ── Box delta codec ──────────────────────────────────────────────────────

def encode_deltas(boxes: torch.Tensor, anchors: torch.Tensor,
                  weights=(1.0, 1.0, 1.0, 1.0)) -> torch.Tensor:
    """xyxy boxes vs anchors -> (dx, dy, dw, dh)."""
    aw = anchors[..., 2] - anchors[..., 0]
    ah = anchors[..., 3] - anchors[..., 1]
    ax = anchors[..., 0] + aw / 2
    ay = anchors[..., 1] + ah / 2
    bw = torch.clamp(boxes[..., 2] - boxes[..., 0], min=1e-3)
    bh = torch.clamp(boxes[..., 3] - boxes[..., 1], min=1e-3)
    bx = boxes[..., 0] + bw / 2
    by = boxes[..., 1] + bh / 2
    wx, wy, ww, wh = weights
    return torch.stack([wx * (bx - ax) / aw, wy * (by - ay) / ah,
                        ww * torch.log(bw / aw), wh * torch.log(bh / ah)], -1)


def decode_deltas(deltas: torch.Tensor, anchors: torch.Tensor,
                  weights=(1.0, 1.0, 1.0, 1.0),
                  clip: float = 4.135) -> torch.Tensor:
    """(dx, dy, dw, dh) -> xyxy; dw, dh clipped above at log(1000 / 16)
    like torchvision."""
    aw = anchors[..., 2] - anchors[..., 0]
    ah = anchors[..., 3] - anchors[..., 1]
    ax = anchors[..., 0] + aw / 2
    ay = anchors[..., 1] + ah / 2
    wx, wy, ww, wh = weights
    dx = deltas[..., 0] / wx
    dy = deltas[..., 1] / wy
    dw = torch.clamp(deltas[..., 2] / ww, max=clip)
    dh = torch.clamp(deltas[..., 3] / wh, max=clip)
    cx = ax + dx * aw
    cy = ay + dy * ah
    w = aw * torch.exp(dw)
    h = ah * torch.exp(dh)
    return torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1)


# ── Modules ──────────────────────────────────────────────────────────────

class RPNHead(nn.Module):
    """v2 RPN head: two 3x3 convs (bias, ReLU), then objectness and deltas
    a location."""

    def __init__(self, features: int = 256,
                 num_anchors: int = len(ASPECT_RATIOS),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.conv = nn.Sequential(*(
            nn.Sequential(nn.Conv2d(features, features, 3, 1, 1))
            for _ in range(2)))
        self.cls_logits = nn.Conv2d(features, num_anchors, 1)
        self.bbox_pred = nn.Conv2d(features, num_anchors * 4, 1)

    def forward(self, feats: Sequence[torch.Tensor]
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """-> objectness (B, sum H*W*A), deltas (B, sum H*W*A, 4), each
        level (H, W, A)-major."""
        objs, boxes = [], []
        for f in feats:
            h = f
            for block in self.conv:
                h = F.relu(conv(h, block[0], self.dtype))
            b = f.shape[0]
            h = h.float()        # flax's promotion: the 1x1s compute in f32
            objs.append(self.cls_logits(h).permute(0, 2, 3, 1).reshape(b, -1))
            boxes.append(self.bbox_pred(h).permute(0, 2, 3, 1)
                         .reshape(b, -1, 4))
        return torch.cat(objs, 1), torch.cat(boxes, 1)


class BoxPredictor(nn.Module):
    def __init__(self, fc_dim: int, num_classes: int):
        super().__init__()
        self.cls_score = nn.Linear(fc_dim, num_classes)
        self.bbox_pred = nn.Linear(fc_dim, num_classes * 4)


class BoxHead(nn.Module):
    """v2 box head: 4 x (3x3 conv bias-free + BN + ReLU), flatten (C, H, W
    order), FC 1024 + ReLU -> class scores + per-class deltas.
    ``box_head`` is torchvision's FastRCNNConvFCHead Sequential (index 4
    the flatten, 5 the FC)."""

    def __init__(self, num_classes: int = NUM_CLASSES, features: int = 256,
                 fc_dim: int = 1024, pool: int = 7,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_classes = num_classes
        self.dtype = dtype
        convs = [nn.Sequential(nn.Conv2d(features, features, 3, 1, 1,
                                         bias=False),
                               nn.BatchNorm2d(features)) for _ in range(4)]
        self.box_head = nn.Sequential(
            *convs, nn.Flatten(), nn.Linear(features * pool * pool, fc_dim))
        self.box_predictor = BoxPredictor(fc_dim, num_classes)

    def forward(self, rois: torch.Tensor, train: bool = False
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """rois (B, R, 7, 7, C) -> scores (B, R, K), deltas (B, R, K, 4).
        With train=True the BatchNorms take their statistics over all B x R
        RoIs, valid or not, as the reference's do."""
        b, r = rois.shape[:2]
        x = rois.reshape(b * r, *rois.shape[2:]).permute(0, 3, 1, 2)
        d = self.dtype
        for i in range(4):
            c, bn = self.box_head[i]
            x = F.relu(batch_norm(conv(x, c, d), bn, train))
        x = F.relu(linear(x.flatten(1), self.box_head[5], d))
        x = x.float()            # the predictor computes in f32 (promotion)
        scores = self.box_predictor.cls_score(x)
        deltas = self.box_predictor.bbox_pred(x)
        return (scores.reshape(b, r, self.num_classes),
                deltas.reshape(b, r, self.num_classes, 4))


class FasterRCNN(nn.Module):
    """Backbone + FPN + RPN + RoI heads. ``forward`` returns raw pieces;
    proposals and inference are the functions below and
    train/frcnn.make_predict_step."""

    def __init__(self, cfg: FrcnnConfig = FrcnnConfig(),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        self.backbone = nn.ModuleDict(
            {"body": resnet_lib.ResNet(cfg.blocks, cfg.trainable_layers,
                                       dtype),
             "fpn": fpn_lib.FPN(norm=cfg.fpn_norm, dtype=dtype)})
        self.rpn = nn.ModuleDict({"head": RPNHead(dtype=dtype)})
        self.roi_heads = BoxHead(cfg.num_classes, dtype=dtype)

    def pyramid(self, images: torch.Tensor,
                train: bool = False) -> List[torch.Tensor]:
        """images (B, H, W, 3) in [0, 1] -> P2..P6, each (B, 256, H_l,
        W_l). Normalised in f32; the stem conv casts to the dtype."""
        if self.cfg.normalize:
            mean = images.new_tensor(IMAGENET_MEAN)
            std = images.new_tensor(IMAGENET_STD)
            images = (images - mean) / std
        return self.backbone["fpn"](
            self.backbone["body"](images.permute(0, 3, 1, 2), train), train)

    def extract(self, images: torch.Tensor, train: bool = False):
        """images (B, H, W, 3) in [0, 1] -> (pyramid P2..P6, objectness
        (B, A), RPN deltas (B, A, 4))."""
        pyramid = self.pyramid(images, train)
        obj, deltas = self.rpn["head"](pyramid)
        return pyramid, obj, deltas

    def roi_forward(self, pyramid, proposals: torch.Tensor,
                    train: bool = False):
        rois = fpn_lib.roi_align(tuple(pyramid[:4]), proposals)
        return self.roi_heads(rois, train)

    def roi_forward_pooled(self, _images, rois: torch.Tensor,
                           train: bool = False):
        """Box head on pre-pooled (B, R, 7, 7, C) RoI features."""
        return self.roi_heads(rois, train)

    def forward(self, images: torch.Tensor,
                proposals: Optional[torch.Tensor] = None,
                train: bool = False) -> Dict[str, torch.Tensor]:
        """extract + RoI heads on given proposals, or on 8 dummy ones."""
        pyramid, obj, deltas = self.extract(images, train)
        if proposals is None:
            proposals = images.new_tensor([[0.0, 0.0, 32.0, 32.0]]).expand(
                images.shape[0], 8, 4)
        scores, box_deltas = self.roi_forward(pyramid, proposals, train)
        return {"obj": obj, "rpn_deltas": deltas, "scores": scores,
                "box_deltas": box_deltas}


# ── Proposal generation (static shapes) ──────────────────────────────────

def generate_proposals(obj: torch.Tensor, rpn_deltas: torch.Tensor,
                       img_size, cfg: FrcnnConfig = FrcnnConfig()
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, A) objectness + (B, A, 4) deltas -> (B, P, 4) proposals + valid.

    Per level, the top-k raw logits (k = min(pre_nms_topk, level size),
    ties to the lower index as ``lax.top_k``), then the sigmoid; boxes
    under 1e-3 px score 0; one NMS keyed on the level (torchvision
    suppresses within a level only, then keeps the global score top) into
    cfg.num_proposals. img_size: int (square) or (H, W) canvas."""
    ih, iw = _hw(img_size)
    anchors = _anchor_tensor((ih, iw), obj.device)
    boxes = box_ops.clip_to_image(decode_deltas(rpn_deltas, anchors), ih, iw)

    sel_scores, sel_boxes, sel_levels = [], [], []
    for lvl, (lo, hi) in enumerate(level_slices((ih, iw))):
        s, idx = top_k(obj[:, lo:hi], min(cfg.pre_nms_topk, hi - lo))
        sel_scores.append(s)
        sel_boxes.append(torch.gather(boxes[:, lo:hi], 1,
                                      idx[..., None].expand(-1, -1, 4)))
        sel_levels.append(torch.full_like(idx, lvl))
    scores = torch.sigmoid(torch.cat(sel_scores, 1))
    cand = torch.cat(sel_boxes, 1)
    # drop tiny boxes (torchvision min_size=1e-3) via the score
    wh_ok = ((cand[..., 2] - cand[..., 0] > 1e-3)
             & (cand[..., 3] - cand[..., 1] > 1e-3))
    scores = torch.where(wh_ok, scores, 0.0)
    pb, _, _, pv = nms_ops.batched_nms(
        cand, scores, torch.cat(sel_levels, 1),
        num_candidates=min(4096, cand.shape[1]),
        max_outputs=cfg.num_proposals, iou_thresh=cfg.rpn_nms_thresh,
        score_thresh=0.0, class_aware=True)
    return pb, pv


# ── Training targets ─────────────────────────────────────────────────────

def match_anchors(anchors: torch.Tensor, gt_boxes: torch.Tensor,
                  gt_classes: torch.Tensor, pos_iou: float, neg_iou: float,
                  allow_low_quality: bool = True
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """torchvision Matcher semantics, vectorised. anchors (A, 4); gt_boxes
    (B, M, 4) xyxy, gt_classes (B, M) with -1 padding. Returns (matched
    (B, A) int64, each anchor's best GT; labels (B, A) int32: 1 positive,
    0 negative, -1 ignored).

    With allow_low_quality every GT's best anchors (IoU within 1e-5 of that
    GT's best) become positive; ``matched`` stays each anchor's own argmax
    GT (torchvision's set_low_quality_matches_ restores the pre-threshold
    match). An image with no GT is all negative. Ties in the argmax go to
    the lower GT index, as ``jnp.argmax``."""
    valid = gt_classes >= 0                                   # (B, M)
    iou = box_ops.pairwise_iou(anchors, gt_boxes)             # (B, A, M)
    iou = torch.where(valid[:, None, :], iou, -1.0)
    best_iou, matched = iou.max(-1)                           # (B, A)
    labels = torch.where(best_iou >= pos_iou, 1,
                         torch.where(best_iou < neg_iou, 0, -1))
    if allow_low_quality:
        gt_best = torch.where(valid, iou.amax(1), -2.0)       # (B, M)
        is_best = (iou >= gt_best[:, None, :] - 1e-5) & valid[:, None, :]
        labels = torch.where(is_best.any(-1), 1, labels)
    has_gt = valid.any(-1, keepdim=True)
    labels = torch.where(has_gt, labels, 0)
    return matched, labels.to(torch.int32)


def draw_uniform(shape, generator: torch.Generator, lo: float = 0.01,
                 hi: float = 1.0) -> torch.Tensor:
    """Uniforms in [lo, hi) on the generator's device (the samplers'
    ``jax.random.uniform(key, shape, minval, maxval)``)."""
    u = torch.rand(tuple(shape), generator=generator,
                   device=generator.device)
    return u * (hi - lo) + lo


def _topk_random(mask: torch.Tensor, k: int,
                 u: Optional[torch.Tensor] = None,
                 generator: Optional[torch.Generator] = None
                 ) -> torch.Tensor:
    """Keep at most k random Trues a row (static k): those whose uniform
    (in [0.01, 1), drawn from `generator` when `u` is None) reaches the
    row's k-th largest among the Trues."""
    if u is None:
        u = draw_uniform(mask.shape, generator)
    pr = torch.where(mask, u, 0.0)
    kth = torch.topk(pr, min(k, mask.shape[-1]), -1).values[..., -1:]
    return mask & (pr >= torch.clamp(kth, min=1e-9))


def _topk_random_dynamic(mask: torch.Tensor, k: torch.Tensor,
                         u: Optional[torch.Tensor] = None,
                         generator: Optional[torch.Generator] = None
                         ) -> torch.Tensor:
    """Keep at most k (a row's own count, (B, 1)) random Trues a row: the
    Trues ranked by their uniform, descending, by a stable sort (ties to
    the lower index, as ``jnp.argsort``)."""
    if u is None:
        u = draw_uniform(mask.shape, generator)
    pr = torch.where(mask, u, 0.0)
    order = torch.argsort(-pr, dim=-1, stable=True)
    rank = torch.empty_like(order).scatter_(
        -1, order, torch.arange(mask.shape[-1], device=mask.device)
        .expand_as(order))
    return mask & (rank < k)


def sample_targets(labels: torch.Tensor, batch: int, pos_frac: float,
                   generator: Optional[torch.Generator] = None,
                   u_pos: Optional[torch.Tensor] = None,
                   u_neg: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Balanced sampling: (pos_mask, neg_mask), each (B, N) bool, at most
    int(batch * pos_frac) positives a row and negatives filling the row
    to `batch`. The uniforms (u_pos, then u_neg, each labels' shape in
    [0.01, 1)) are drawn from `generator` when not given."""
    if u_pos is None:
        u_pos = draw_uniform(labels.shape, generator)
    if u_neg is None:
        u_neg = draw_uniform(labels.shape, generator)
    pos_keep = _topk_random(labels == 1, int(batch * pos_frac), u_pos)
    n_pos = pos_keep.sum(-1, keepdim=True)
    neg_keep = _topk_random_dynamic(labels == 0, batch - n_pos, u_neg)
    return pos_keep, neg_keep


# ── Construction ─────────────────────────────────────────────────────────

def init_weights(model: FasterRCNN,
                 generator: torch.Generator) -> FasterRCNN:
    """flax's init: lecun-normal conv and dense kernels (truncated at 2
    std, fan-in), zero biases, BN affine 1 / 0 (each bottleneck's last BN
    scale 0) and running statistics 0 / 1. Draws come from `generator`
    (on the CPU)."""
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, (nn.Conv2d, nn.Linear)):
                w = mod.weight
                fan_in = w[0].numel()
                std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
                t = torch.empty(w.shape)
                nn.init.trunc_normal_(t, 0.0, std, -2 * std, 2 * std,
                                      generator=generator)
                w.copy_(t)
                if mod.bias is not None:
                    mod.bias.zero_()
            elif isinstance(mod, nn.BatchNorm2d):
                mod.reset_parameters()
        for mod in model.modules():
            if isinstance(mod, resnet_lib.BottleneckBlock):
                mod.bn3.weight.zero_()
    return model


def create(cfg: FrcnnConfig = FrcnnConfig(),
           device: Optional[torch.device] = None,
           generator: Optional[torch.Generator] = None,
           dtype: torch.dtype = torch.float32) -> FasterRCNN:
    """A Faster R-CNN on `device` (None: the CUDA card; raises when there
    is none), randomly initialised from `generator` (seed 0 when None), in
    eval mode, f32 weights in channels_last memory; `dtype` the compute
    type."""
    device = resolve_device(device)
    gen = generator or torch.Generator().manual_seed(0)
    model = init_weights(FasterRCNN(cfg, dtype), gen)
    return model.to(device, memory_format=torch.channels_last).eval()
