"""Faster R-CNN training and inference steps and the training driver
(counterpart of robust_object_detection_tpu/train/frcnn.py).

The reference's recipe (train_frcnn_baseline.py / train_frcnn_augmented.py):
SGD lr 0.005, momentum 0.9, weight decay 5e-4, StepLR(8, 0.1), 24 epochs,
batch 2; BCE objectness + smooth-L1 RPN loss over balanced anchor samples,
CE + smooth-L1 box-head loss over balanced RoI samples; in the Augmented
mode each image is corrupted on the card with probability 0.5 (K1,
``ops/fused_corrupt``). Training runs on a fixed square letterbox
(``img_size``) or, with ``native_res``, at torchvision's min800 / max1333
scale padded into aspect buckets, one canvas a batch.

The predict step keeps the contract of ``train.detector.make_predict_step``
(model, (B, H, W, 3) images in [0, 255] -> fixed-capacity canvas-xyxy
detections), so ``eval.fused_sweep`` and ``eval.detector_eval`` take it as
they take YOLOv8's and RT-DETR's.

In the port a model carries its weights and running statistics: a
:class:`FrcnnTrainState` holds the module, its optimizer, its schedule and
the step count, and the train step updates it in place. The step's random
draws (the corruption's choice and seeds, the RPN and RoI samplers'
uniforms, the RoI compaction's) come from a ``torch.Generator`` seeded by
(seed, step) on the images' device, so they depend on the step alone, as
the reference's ``fold_in(key, step)``; every step also takes them as
tensors (:func:`draw_train`). Training runs in f32.
"""

from __future__ import annotations

import dataclasses
import json
import time
from pathlib import Path
from typing import Callable, Dict, Mapping, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as TF

from ..core import artifacts
from ..core.checkpoint import CheckpointManager
from ..core.config import CorruptionConfig, ExperimentConfig
from ..data import pipeline as pipe
from ..models import frcnn as F
from ..models import resnet as resnet_lib
from ..models.layers import resolve_device
from ..ops import boxes as box_ops
from ..ops import nms as nms_ops
from ..ops.fused_corrupt import draw_choice, fused_random_corruption
from . import validation

HEAD_DELTA_WEIGHTS = (10.0, 10.0, 5.0, 5.0)


# ── Losses and targets ───────────────────────────────────────────────────

def smooth_l1(x: torch.Tensor, beta: float) -> torch.Tensor:
    ax = x.abs()
    return torch.where(ax < beta, 0.5 * ax * ax / beta, ax - 0.5 * beta)


def rpn_loss(obj: torch.Tensor, rpn_deltas: torch.Tensor,
             anchors: torch.Tensor, gt_boxes: torch.Tensor,
             gt_classes: torch.Tensor, cfg: F.FrcnnConfig,
             generator: Optional[torch.Generator] = None,
             u_pos: Optional[torch.Tensor] = None,
             u_neg: Optional[torch.Tensor] = None
             ) -> Dict[str, torch.Tensor]:
    """RPN objectness (sigmoid BCE over the sampled anchors) and box loss
    (smooth-L1, beta 1/9, over the sampled positives), both divided by the
    batch's sampled count. The sampler's uniforms as in
    ``models.frcnn.sample_targets``."""
    matched, labels = F.match_anchors(anchors, gt_boxes, gt_classes,
                                      cfg.rpn_pos_iou, cfg.rpn_neg_iou)
    pos, neg = F.sample_targets(labels, cfg.rpn_batch, cfg.rpn_pos_frac,
                                generator, u_pos, u_neg)
    sampled = pos | neg
    n = torch.clamp(sampled.sum(), min=1).float()
    tgt_boxes = torch.gather(gt_boxes, 1, matched[..., None].expand(-1, -1, 4))
    tgt_deltas = F.encode_deltas(tgt_boxes, anchors[None])
    box_l = (smooth_l1(rpn_deltas - tgt_deltas, 1.0 / 9.0).sum(-1)
             * pos).sum() / n
    obj_l = (TF.binary_cross_entropy_with_logits(
        obj, (labels == 1).float(), reduction="none") * sampled).sum() / n
    return {"rpn_obj": obj_l, "rpn_box": box_l}


def roi_targets(proposals: torch.Tensor, prop_valid: torch.Tensor,
                gt_boxes: torch.Tensor, gt_classes: torch.Tensor,
                cfg: F.FrcnnConfig,
                generator: Optional[torch.Generator] = None,
                u_pos: Optional[torch.Tensor] = None,
                u_neg: Optional[torch.Tensor] = None,
                u_gather: Optional[torch.Tensor] = None):
    """Append the GTs to the proposals, match, sample a fixed RoI batch.

    Returns (rois (B, R, 4), roi_valid (B, R) bool, cls_target (B, R)
    int64 with 0 the background, delta_target (B, R, 4), pos_mask (B, R)).
    The sampled candidates are compacted into R slots by priority (2 a
    positive, 1 a negative, plus a uniform in [0, 0.5): u_gather, drawn
    after the sampler's when absent); unsampled ones have priority -1 and
    fill the remaining slots from the lowest index, as ``lax.top_k``'s
    ties do (a stable descending sort)."""
    cand = torch.cat([proposals, gt_boxes], 1)                # (B, C, 4)
    valid_gt = gt_classes >= 0
    cand_valid = torch.cat([prop_valid, valid_gt], 1)
    iou = box_ops.pairwise_iou(cand, gt_boxes)                # (B, C, M)
    iou = torch.where(valid_gt[:, None, :], iou, -1.0)
    best, matched = iou.max(-1)
    labels = torch.where(best >= cfg.roi_pos_iou, 1, 0)       # no ignore band
    labels = torch.where(cand_valid, labels, -1)              # pad = ignore

    pos, neg = F.sample_targets(labels, cfg.roi_batch, cfg.roi_pos_frac,
                                generator, u_pos, u_neg)
    sampled = pos | neg
    if u_gather is None:
        u_gather = F.draw_uniform(sampled.shape, generator, 0.0, 0.5)
    pri = pos.float() * 2.0 + neg.float() + u_gather
    pri = torch.where(sampled, pri, -1.0)
    idx = torch.sort(pri, dim=1, descending=True,
                     stable=True).indices[:, :cfg.roi_batch]  # (B, R)
    rois = torch.gather(cand, 1, idx[..., None].expand(-1, -1, 4))
    roi_valid = torch.gather(sampled, 1, idx)
    pos_s = torch.gather(pos, 1, idx)
    matched_s = torch.gather(matched, 1, idx)
    tgt_boxes = torch.gather(gt_boxes, 1,
                             matched_s[..., None].expand(-1, -1, 4))
    tgt_cls = torch.gather(torch.clamp(gt_classes, min=0).long(), 1,
                           matched_s) + 1                      # 1..6
    cls_target = torch.where(pos_s, tgt_cls, 0)               # bg = 0
    delta_target = F.encode_deltas(tgt_boxes, rois, HEAD_DELTA_WEIGHTS)
    return rois, roi_valid, cls_target, delta_target, pos_s


def head_loss(scores: torch.Tensor, box_deltas: torch.Tensor,
              cls_target: torch.Tensor, delta_target: torch.Tensor,
              roi_valid: torch.Tensor, pos_mask: torch.Tensor
              ) -> Dict[str, torch.Tensor]:
    """Box head: softmax CE over the valid RoIs, smooth-L1 (beta 1/9, as
    torchvision's fastrcnn_loss) of the target class's deltas over the
    positives, both divided by the batch's valid count.

    The positives are selected before the loss, as the reference's
    multiply by a bool mask selects: a RoI slot filled with a zero-size
    padding box has non-finite delta targets, which must add 0, not NaN,
    to the value and to the gradient."""
    n = torch.clamp(roi_valid.sum(), min=1).float()
    ce = TF.cross_entropy(scores.flatten(0, 1), cls_target.flatten(),
                          reduction="none").view(cls_target.shape)
    cls_l = (ce * roi_valid).sum() / n
    sel = torch.gather(box_deltas, 2, cls_target[..., None, None].expand(
        -1, -1, 1, 4))[..., 0, :]
    diff = torch.where(pos_mask[..., None], sel - delta_target, 0.0)
    box_l = smooth_l1(diff, 1.0 / 9.0).sum() / n
    return {"head_cls": cls_l, "head_box": box_l}


# ── State, optimizer, draws ──────────────────────────────────────────────

@dataclasses.dataclass
class FrcnnTrainState:
    """The module (weights and running statistics), its optimizer and
    schedule, the step count."""
    model: F.FasterRCNN
    optimizer: torch.optim.Optimizer
    scheduler: torch.optim.lr_scheduler.LRScheduler
    step: int = 0


def make_optimizer(lr: float = 0.005, momentum: float = 0.9,
                   weight_decay: float = 5e-4, step_epochs: int = 8,
                   steps_per_epoch: int = 1000, gamma: float = 0.1,
                   frozen: Optional[set] = None
                   ) -> Tuple[Callable, Callable[[int], float]]:
    """SGD + StepLR(8, 0.1) (train_frcnn_baseline.py:149-153). (tx, sched).

    sched(count): lr, times gamma from count 8 * steps_per_epoch and again
    from 16 * steps_per_epoch (optax's ``piecewise_constant_schedule``),
    read at the count BEFORE an update. tx(model) -> (SGD, LambdaLR):
    momentum with dampening 0 (optax's ``sgd`` trace) and weight decay on
    every parameter, BatchNorm scales and biases too (the reference's
    unmasked ``add_decayed_weights``). frozen: the backbone's flax labels
    (``resnet.frozen_param_labels``); their parameters stay out of the
    optimizer (the reference masks their decay; their gradients are
    zero)."""
    boundaries = (step_epochs * steps_per_epoch,
                  2 * step_epochs * steps_per_epoch)

    def sched(count: int) -> float:
        return lr * gamma ** sum(count >= b for b in boundaries)

    def tx(model: F.FasterRCNN):
        prefixes = tuple(f"backbone.body.{m}." for m in resnet_lib.
                         module_names(model.cfg.blocks, frozen or ()))
        params = [p for n, p in model.named_parameters()
                  if not n.startswith(prefixes)]
        opt = torch.optim.SGD(params, lr=lr, momentum=momentum,
                              weight_decay=weight_decay)
        return opt, torch.optim.lr_scheduler.LambdaLR(
            opt, lambda count: sched(count) / lr)

    return tx, sched


def init_state(model: F.FasterRCNN, tx: Callable) -> FrcnnTrainState:
    opt, sched = tx(model)
    return FrcnnTrainState(model, opt, sched)


def step_generator(seed: int, step: int,
                   device: Union[str, torch.device]) -> torch.Generator:
    """The generator of step `step` of a run seeded `seed`, on `device`:
    seeded by numpy's SeedSequence of (seed, step), 32 bits (the CPU
    generator keeps no more)."""
    mixed = np.random.SeedSequence([seed, step]).generate_state(1)[0]
    return torch.Generator(device).manual_seed(int(mixed))


def draw_train(batch: int, n_anchors: int, n_cand: int,
               generator: torch.Generator,
               corruption: CorruptionConfig = CorruptionConfig()
               ) -> Dict[str, torch.Tensor]:
    """Every draw of one train step, in this order: the corruption's
    ``choice`` and ``seeds`` (B,) (``fused_corrupt.draw_choice``), the RPN
    sampler's ``rpn_pos`` and ``rpn_neg`` (B, A), the RoI sampler's
    ``roi_pos`` and ``roi_neg`` (B, P + M) in [0.01, 1), and the RoI
    compaction's ``roi_gather`` (B, P + M) in [0, 0.5)."""
    choice, seeds = draw_choice(batch, generator, corruption)
    out = {"choice": choice, "seeds": seeds}
    for name, n in (("rpn_pos", n_anchors), ("rpn_neg", n_anchors),
                    ("roi_pos", n_cand), ("roi_neg", n_cand)):
        out[name] = F.draw_uniform((batch, n), generator)
    out["roi_gather"] = F.draw_uniform((batch, n_cand), generator, 0.0, 0.5)
    return out


def native_res_epoch_plan(buckets: Dict, batch_size: int, seed: int
                          ) -> Tuple[list, int]:
    """One epoch's (bucket, samples-chunk) schedule for native-res training.

    Same-shape batches (one canvas a batch) in GLOBALLY shuffled order, the
    torchvision GroupedBatchSampler property: the reference's loader is
    shuffle=True over all images (train_frcnn_baseline.py:121-127), so
    resolution must not correlate with position in the epoch / LR
    schedule. Within-bucket order reshuffles per epoch; sub-batch
    remainders are dropped and COUNTED so the caller can log them
    (VisDrone's skewed shape distribution makes this nonzero)."""
    import random as _random
    rnd = _random.Random(seed)
    chunks = []
    dropped = 0
    for bkt in sorted(buckets):
        g = list(buckets[bkt])
        rnd.shuffle(g)
        n_full = len(g) // batch_size
        dropped += len(g) - n_full * batch_size
        for i in range(n_full):
            chunks.append((bkt, g[i * batch_size:(i + 1) * batch_size]))
    rnd.shuffle(chunks)
    return chunks, dropped


# ── Steps ────────────────────────────────────────────────────────────────

def make_train_step(model: F.FasterRCNN, img_size,
                    corruption: Optional[CorruptionConfig],
                    augment: bool) -> Callable:
    """Train step: (state, images_u8 (B, H, W, 3), gt_boxes (B, M, 4) xyxy
    canvas px, gt_classes (B, M) with -1 padding, seed, draws=None) ->
    metrics {rpn_obj, rpn_box, head_cls, head_box, loss, grad_norm} as
    device tensors; `state` is updated in place. img_size: int (square
    canvas) or (H, W).

    Order, as the reference: uint8 -> f32 -> K1 corruption with p 0.5
    (augment) -> /255 -> train-mode extract -> rpn_loss -> proposals
    (outside autograd) -> roi_targets -> train-mode roi_forward ->
    head_loss -> the sum -> backward -> SGD. grad_norm is the global norm
    of every gradient before the update. draws: :func:`draw_train`'s dict;
    drawn from ``step_generator(seed, state.step)`` when None."""
    cfg = model.cfg
    hw = F._hw(img_size)
    corruption = corruption or CorruptionConfig()

    def step(state: FrcnnTrainState, images_u8: torch.Tensor,
             gt_boxes: torch.Tensor, gt_classes: torch.Tensor,
             seed: int = 0,
             draws: Optional[Dict[str, torch.Tensor]] = None
             ) -> Dict[str, torch.Tensor]:
        net = state.model
        anchors = F._anchor_tensor(hw, images_u8.device)
        if draws is None:
            draws = draw_train(
                images_u8.shape[0], anchors.shape[0],
                cfg.num_proposals + gt_boxes.shape[1],
                step_generator(seed, state.step, images_u8.device),
                corruption)
        x = images_u8.float()
        if augment:
            x, _ = fused_random_corruption(x.contiguous(), None, corruption,
                                           choice=draws["choice"],
                                           seeds=draws["seeds"])
        x = x / 255.0

        state.optimizer.zero_grad(set_to_none=True)
        pyramid, obj, rpn_deltas = net.extract(x, train=True)
        losses = rpn_loss(obj, rpn_deltas, anchors, gt_boxes, gt_classes,
                          cfg, u_pos=draws["rpn_pos"],
                          u_neg=draws["rpn_neg"])
        with torch.no_grad():
            proposals, prop_valid = F.generate_proposals(
                obj.detach(), rpn_deltas.detach(), hw, cfg)
            rois, roi_valid, cls_t, delta_t, pos = roi_targets(
                proposals, prop_valid, gt_boxes, gt_classes, cfg,
                u_pos=draws["roi_pos"], u_neg=draws["roi_neg"],
                u_gather=draws["roi_gather"])
        scores, box_deltas = net.roi_forward(pyramid, rois, train=True)
        losses.update(head_loss(scores, box_deltas, cls_t, delta_t,
                                roi_valid, pos))
        total = sum(losses.values())
        total.backward()
        grad_norm = torch.nn.utils.get_total_norm(
            [p.grad for p in net.parameters() if p.grad is not None])
        state.optimizer.step()
        state.scheduler.step()
        state.step += 1
        return dict({k: v.detach() for k, v in losses.items()},
                    loss=total.detach(), grad_norm=grad_norm)

    return step


def detect(cfg: F.FrcnnConfig, proposals: torch.Tensor,
           prop_valid: torch.Tensor, scores: torch.Tensor,
           box_deltas: torch.Tensor, img_hw):
    """The RoI heads' outputs -> detections: softmax, per-class decode
    with HEAD_DELTA_WEIGHTS, clip to the canvas, drop the background and
    sub-0.01 px boxes (torchvision's remove_small_boxes(min_size=1e-2)),
    then one class-aware NMS over min(2048, P * (K-1)) candidates."""
    ih, iw = img_hw
    probs = torch.softmax(scores, -1)                       # (B, P, K)
    k = cfg.num_classes
    boxes_k = F.decode_deltas(box_deltas, proposals[..., None, :],
                              HEAD_DELTA_WEIGHTS)           # (B, P, K, 4)
    boxes_k = box_ops.clip_to_image(boxes_k, ih, iw)
    b, p = probs.shape[:2]
    wh_ok = ((boxes_k[..., 2] - boxes_k[..., 0] > 1e-2)
             & (boxes_k[..., 3] - boxes_k[..., 1] > 1e-2))
    fg_probs = probs[..., 1:] * prop_valid[..., None] * wh_ok[..., 1:]
    cand_scores = fg_probs.reshape(b, -1)
    cand_boxes = boxes_k[..., 1:, :].reshape(b, -1, 4)
    cand_classes = torch.arange(
        k - 1, dtype=torch.int32, device=scores.device).expand(
            b, p, k - 1).reshape(b, -1)
    return nms_ops.batched_nms(
        cand_boxes, cand_scores, cand_classes,
        num_candidates=min(2048, cand_scores.shape[1]),
        max_outputs=cfg.box_detections, iou_thresh=cfg.box_nms_thresh,
        score_thresh=cfg.box_score_thresh)


def make_predict_step(model: F.FasterRCNN, img_size) -> Callable:
    """uint8 or float batch in [0, 255] -> per-image fixed-capacity
    detections (boxes (B, box_detections, 4) canvas xyxy, scores, classes
    int32 0-based foreground, valid).

    `model` gives the configuration; the step runs the module it is given
    (``step(model, images)``), BatchNorm from the running statistics.
    img_size: int (square canvas) or (H, W)."""
    cfg = model.cfg
    hw = F._hw(img_size)

    @torch.inference_mode()
    def step(net: F.FasterRCNN, images: torch.Tensor):
        pyramid, obj, rpn_deltas = net.extract(images.float() / 255.0)
        proposals, prop_valid = F.generate_proposals(obj, rpn_deltas, hw,
                                                     cfg)
        scores, box_deltas = net.roi_forward(pyramid, proposals)
        return detect(cfg, proposals, prop_valid, scores, box_deltas, hw)

    return step


# ── Pretrained weights ───────────────────────────────────────────────────

def load_pretrained(model: F.FasterRCNN,
                    state: Union[str, Path, Mapping[str, torch.Tensor]]
                    ) -> Dict[str, list]:
    """Load a torchvision ``fasterrcnn_resnet50_fpn_v2`` state_dict (the
    port's key layout; a path to a ``torch.save`` file, read with
    ``weights_only=True``, plain or under ``"model"``) into `model`. The
    ``roi_heads.box_predictor`` tensors whose shape differs (a COCO-91
    checkpoint onto the 7-class head) keep their fresh init, as the
    reference's ``import_frcnn(strict_head=False)``; any other missing,
    extra or mismatched tensor raises. Returns {"imported", "skipped"}."""
    if not isinstance(state, Mapping):
        state = torch.load(state, map_location="cpu", weights_only=True)
        if isinstance(state.get("model"), Mapping):
            state = state["model"]
    own = model.state_dict()
    merged, report = {}, {"imported": [], "skipped": []}
    for key, t in own.items():
        if key.endswith("num_batches_tracked"):
            merged[key] = t
            continue
        if key not in state:
            raise ValueError(f"pretrained state has no {key}")
        src = state[key]
        if tuple(src.shape) != tuple(t.shape):
            if not key.startswith("roi_heads.box_predictor."):
                raise ValueError(f"{key}: {tuple(src.shape)} does not fit "
                                 f"{tuple(t.shape)}")
            report["skipped"].append(
                f"{key} {tuple(src.shape)} vs {tuple(t.shape)}")
            merged[key] = t
            continue
        merged[key] = src
        report["imported"].append(key)
    extra = [k for k in state if k not in own
             and not k.endswith("num_batches_tracked")]
    if extra:
        raise ValueError(f"{len(extra)} pretrained tensors unmapped, first: "
                         f"{extra[:5]}")
    model.load_state_dict(merged)
    return report


# ── Full training driver ─────────────────────────────────────────────────

def batch_to_device(batch: pipe.Batch, device: torch.device):
    """(images, boxes, classes) of a host batch on `device`, through pinned
    memory and a non-blocking copy when it is the card."""
    arrays = (batch.images, batch.boxes, batch.classes)
    out = []
    for a in arrays:
        t = torch.from_numpy(a)
        if device.type == "cuda":
            t = t.pin_memory()
        out.append(t.to(device, non_blocking=True))
    return out


def train(cfg: ExperimentConfig, data_root: str | Path, out_dir: str | Path,
          augment: bool = False, epochs: int = 24, img_size: int = 1024,
          batch_size: int = 2, max_steps: Optional[int] = None,
          max_boxes: int = 600, val_interval: int = 0,
          pretrained: Optional[Union[str, Path, Mapping]] = None,
          trainable_layers: Optional[int] = None,
          model_kwargs: Optional[dict] = None,
          native_res: bool = False, min_side: float = 800.0,
          max_side: float = 1333.0, bucket_mult: int = 64,
          device: Optional[torch.device] = None) -> dict:
    """The Faster R-CNN training driver (reference: 24 epochs, batch 2), in
    f32 on `device` (None: the CUDA card; raises when there is none).

    val_interval=0 reproduces the reference pattern, a single validation
    after the final epoch; N adds one every N epochs. Each validation logs
    mAP50 / mAP50_95 into history.jsonl and keeps the best-mAP50 weights.
    pretrained: a torchvision-layout state_dict or its file
    (:func:`load_pretrained`). trainable_layers: torchvision's 0..5; None
    is 3 with pretrained weights, 5 without. model_kwargs: extra
    FrcnnConfig fields. native_res=True trains every image at the exact
    min_side / max_side scale padded into the smallest bucket_mult-aligned
    canvas (img_size then sizes only the validation canvas).

    Writes ``config.json`` (the model configuration stamp), history and
    checkpoints (``last`` every epoch with the optimizer, the schedule and
    the step, for resume; ``best`` by mAP50) under `out_dir`; a run that
    finds a ``last`` checkpoint there resumes after its epoch. Returns
    {out_dir, steps, final_loss}."""
    if trainable_layers is None:
        trainable_layers = 3 if pretrained else 5
    device = resolve_device(device)
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)

    samples = pipe.index_coco(data_root, "train")
    buckets: dict = {}
    bucket_scale: dict = {}
    if native_res:
        from ..eval.detector_eval import tv_target
        for s in samples:
            th, tw, sc = tv_target(s.height, s.width, min_side, max_side)
            bkt = (-(-th // bucket_mult) * bucket_mult,
                   -(-tw // bucket_mult) * bucket_mult)
            buckets.setdefault(bkt, []).append(s)
            bucket_scale[s.image_id] = sc
        steps_per_epoch = max(1, sum(len(g) // batch_size
                                     for g in buckets.values()))
    else:
        steps_per_epoch = max(1, len(samples) // batch_size)
    fcfg = F.FrcnnConfig(trainable_layers=trainable_layers,
                         **(model_kwargs or {}))
    # the model configuration beside the checkpoints: load_checkpoint
    # prefers it over its defaults
    artifacts.write_json(out_dir / "config.json",
                         {"frcnn": dataclasses.asdict(fcfg),
                          "augment": augment, "img_size": img_size,
                          "batch_size": batch_size, "epochs": epochs,
                          "native_res": native_res})
    model = F.create(fcfg, device,
                     torch.Generator().manual_seed(cfg.train.seed))
    if pretrained:
        report = load_pretrained(model, pretrained)
        print(f"pretrained import: imported {len(report['imported'])} "
              f"tensors, skipped {report['skipped']}")
    tx, sched = make_optimizer(
        steps_per_epoch=steps_per_epoch,
        frozen=resnet_lib.frozen_param_labels(fcfg.blocks, trainable_layers))
    state = init_state(model, tx)
    step_fns: dict = {}            # one step a canvas

    def step_for(canvas):
        if canvas not in step_fns:
            step_fns[canvas] = make_train_step(model, canvas, cfg.corruption,
                                               augment)
        return step_fns[canvas]

    val_samples = validation.index_val_samples(data_root, "coco")
    predict_fn = make_predict_step(model, img_size) if val_samples else None

    ckpt = CheckpointManager(out_dir)
    hist = artifacts.HistoryLogger(out_dir)
    steps = 0
    mean_loss = 0.0
    start_epoch = 1
    restored = ckpt.restore_last(map_location=device)
    if restored is not None:
        r = restored["state"]
        model.load_state_dict(r["model"])
        state.optimizer.load_state_dict(r["optimizer"])
        state.scheduler.load_state_dict(r["scheduler"])
        state.step = steps = int(r["step"])
        start_epoch = restored["step"] + 1
    for epoch in range(start_epoch, epochs + 1):
        t0 = time.time()
        losses = []
        dropped = 0
        if native_res:
            chunks, dropped = native_res_epoch_plan(
                buckets, batch_size, cfg.train.seed + epoch)

            def epoch_batches():
                for bkt, chunk in chunks:
                    for b in pipe.make_batches(
                            chunk, batch_size, bkt, max_boxes=max_boxes,
                            scale_fn=lambda s: bucket_scale[s.image_id],
                            pad_value=(124, 116, 104)):
                        yield bkt, b
            batch_iter = pipe.prefetch(epoch_batches())
        else:
            batch_iter = ((img_size, b) for b in pipe.prefetch(
                pipe.make_batches(
                    samples, batch_size, img_size, max_boxes=max_boxes,
                    shuffle=True, seed=cfg.train.seed + epoch,
                    drop_remainder=True)))
        for canvas, batch in batch_iter:
            images, gt_boxes, gt_classes = batch_to_device(batch, device)
            m = step_for(canvas)(state, images, gt_boxes, gt_classes,
                                 cfg.train.seed)
            losses.append(m["loss"])
            steps += 1
            if max_steps and steps >= max_steps:
                break
        mean_loss = float(torch.stack(losses).mean()) if losses else 0.0
        record = dict(epoch=epoch, train_loss=mean_loss,
                      lr=float(sched(steps)),
                      epoch_sec=round(time.time() - t0, 2))
        if native_res:
            # images in sub-batch bucket remainders, skipped this epoch
            record["dropped_images"] = dropped
        if validation.should_validate(epoch, epochs, val_interval,
                                      bool(val_samples)):
            vm = validation.run_validation(predict_fn, model, val_samples,
                                           img_size, batch_size, device,
                                           max_boxes=max_boxes)
            record.update(vm)
            ckpt.save_best(epoch, model.state_dict(), vm["mAP50"])
        hist.log(**record)
        ckpt.save_last(epoch, {"model": model.state_dict(),
                               "optimizer": state.optimizer.state_dict(),
                               "scheduler": state.scheduler.state_dict(),
                               "step": state.step})
        if max_steps and steps >= max_steps:
            break
    if ckpt.best_metric() is None:
        ckpt.save_best(epochs, model.state_dict(), 0.0)
    ckpt.close()
    return {"out_dir": str(out_dir), "steps": steps, "final_loss": mean_loss}


def load_checkpoint(out_dir: str | Path,
                    cfg: F.FrcnnConfig = F.FrcnnConfig(),
                    device: Optional[torch.device] = None) -> F.FasterRCNN:
    """A trained checkpoint under `out_dir` (``best``, else the newest
    ``last``) as an eval-mode model on `device` (None: the CUDA card). The
    reference returns (model, state); a port model carries its weights.

    A ``config.json`` stamp written by :func:`train` OVERRIDES `cfg` for
    the fields it records: forward-semantics knobs (normalize, fpn_norm,
    blocks) change a loaded checkpoint's outputs if they drift from the
    training run. A checkpoint whose tensors do not fit a v2 (fpn_norm)
    model is loaded as the classic bias-conv FPN, as the reference's
    legacy fallback does."""
    stamp = Path(out_dir) / "config.json"
    if stamp.exists():
        try:
            fr = json.loads(stamp.read_text()).get("frcnn")
        except json.JSONDecodeError:
            fr = None
        if fr:
            fields = {f.name for f in dataclasses.fields(F.FrcnnConfig)}
            cfg = F.FrcnnConfig(**{
                k: (tuple(v) if isinstance(v, list) else v)
                for k, v in fr.items() if k in fields})
    elif cfg.normalize:
        print(f"[frcnn.load_checkpoint] {out_dir}: no config.json stamp; "
              f"assuming normalize={cfg.normalize} (pass cfg explicitly "
              f"for checkpoints trained without it)")
    try:
        return _load_checkpoint_cfg(out_dir, cfg, device)
    except FileNotFoundError:
        raise
    except Exception:
        if not cfg.fpn_norm:
            raise
        legacy = dataclasses.replace(cfg, fpn_norm=False)
        model = _load_checkpoint_cfg(out_dir, legacy, device)
        print(f"[frcnn.load_checkpoint] {out_dir}: legacy bias-conv FPN "
              f"layout; loaded with fpn_norm=False")
        return model


def _load_checkpoint_cfg(out_dir: str | Path, cfg: F.FrcnnConfig,
                         device: Optional[torch.device]) -> F.FasterRCNN:
    device = resolve_device(device)
    ckpt = CheckpointManager(out_dir)
    try:
        state = ckpt.restore_best(map_location=device)
        if state is None:
            latest = ckpt.restore_last(map_location=device)
            if latest is None:
                raise FileNotFoundError(f"no checkpoint under {out_dir}")
            state = latest["state"]["model"]
    finally:
        ckpt.close()
    model = F.create(cfg, device)
    model.load_state_dict(state)
    return model
