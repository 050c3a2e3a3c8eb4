"""YOLO detector training: the train and predict steps and the training
loop (counterpart of robust_object_detection_tpu/train/detector.py).

In the port a model carries its own weights and running statistics, so a
:class:`TrainState` holds the module, the EMA of its parameters, the
optimizer, its learning-rate schedule and the step count, and the train
step updates it in place. Optimisation follows the reference run configs
(SGD lr0=0.01, lrf=0.01, nesterov momentum 0.937, weight decay 5e-4 on
conv weights only, linear warmup then linear decay; EMA decay 0.9999 with
the Ultralytics ramp). As in the reference, validation and a loaded
checkpoint predict with the EMA weights (:func:`ema_forward`): the
module's forward in eval mode with ``state.ema`` in place of its
parameters and its own BatchNorm running statistics.

:func:`train` is the reference's loop on one device: the Baseline and
Augmented modes (K1 inside the step), host mosaic + affine until the last
``close_mosaic`` epochs, validation every ``val_interval`` epochs with the
best-mAP50 checkpoint, and resume at the exact batch. A step's random
draws (HSV, flip, corruption) come from ``train.frcnn.step_generator(seed,
step)``, so a resumed run draws what an uninterrupted one would.
"""

from __future__ import annotations

import dataclasses
import itertools
import math
import time
from pathlib import Path
from typing import Callable, Dict, Mapping, Optional, Sequence, Tuple, Union

import torch

from ..core import artifacts
from ..core import checkpoint as ckpt_lib
from ..core.checkpoint import CheckpointManager
from ..core.config import CorruptionConfig, ExperimentConfig
from ..core.profiling import span
from ..data import pipeline as pipe
from ..models import yolov8 as yolo_lib
from ..models.layers import resolve_device
from ..ops import nms as nms_ops
from ..ops.corrupt import random_corruption_fast
from ..ops.fused_corrupt import draw_choice
from ..parallel import distributed as dist
from ..parallel import mesh as mesh_lib
from . import augment as aug
from . import detection as det_loss
from . import validation
from .frcnn import compute_dtype, step_generator


def make_optimizer(lr0: float = 0.01, lrf: float = 0.01,
                   momentum: float = 0.937, weight_decay: float = 5e-4,
                   warmup_steps: int = 100, total_steps: int = 10000
                   ) -> Tuple[Callable, Callable[[int], float]]:
    """(tx, sched). sched(count): linear warmup 0 -> lr0 over warmup_steps,
    then linear decay lr0 -> lr0 * lrf over the remaining steps, evaluated
    at the count BEFORE the update (step 0 runs at lr 0), as optax
    evaluates ``join_schedules``. tx(model) -> (SGD, LambdaLR): nesterov
    SGD (optax's ``trace`` recursion), weight decay only on conv weights
    (parameters with ndim > 1; BatchNorm and biases take none), and the
    schedule as a LambdaLR stepped after each update."""
    decay_steps = max(1, total_steps - warmup_steps)

    def sched(count: int) -> float:
        if count < warmup_steps:
            return lr0 * count / warmup_steps
        frac = min(count - warmup_steps, decay_steps) / decay_steps
        return lr0 + (lr0 * lrf - lr0) * frac

    def tx(model: torch.nn.Module):
        params = [p for p in model.parameters() if p.requires_grad]
        groups = [{"params": [p for p in params if p.dim() > 1],
                   "weight_decay": weight_decay},
                  {"params": [p for p in params if p.dim() <= 1],
                   "weight_decay": 0.0}]
        opt = torch.optim.SGD(groups, lr=lr0, momentum=momentum,
                              nesterov=True)
        return opt, torch.optim.lr_scheduler.LambdaLR(
            opt, lambda count: sched(count) / lr0)

    return tx, sched


@dataclasses.dataclass
class TrainState:
    """The module (parameters and BatchNorm running statistics), the EMA of
    its parameters by name, the optimizer and its schedule, the step."""
    model: torch.nn.Module
    ema: Dict[str, torch.Tensor]
    optimizer: torch.optim.Optimizer
    scheduler: torch.optim.lr_scheduler.LRScheduler
    step: int = 0


def init_state(model: torch.nn.Module, tx: Callable) -> TrainState:
    """A fresh state for `model` (in train mode, e.g. ``yolov8.create(...,
    train=True)``): EMA = a copy of the parameters, optimizer from `tx`."""
    opt, sched = tx(model)
    ema = {n: p.detach().clone() for n, p in model.named_parameters()
           if p.requires_grad}
    return TrainState(model, ema, opt, sched)


# metrics that add up over the ranks of a data-parallel step (each
# normalised by the global batch's count, or a count)
ADDITIVE = ("loss", "box", "cls", "dfl", "num_fg")


def make_train_step(img_size: int, corruption: CorruptionConfig,
                    augment: bool, ema_decay: float = 0.9999,
                    base_augment: bool = False,
                    mesh: Optional[mesh_lib.MeshContext] = None
                    ) -> Callable:
    """Train step: (state, images_u8 (B, S, S, 3), gt_boxes (B, M, 4) xyxy
    canvas px, gt_classes (B, M) with -1 padding, generator on the images'
    device) -> metrics {loss, box, cls, dfl, num_fg, grad_norm} as device
    tensors; `state` is updated in place.

    Order, as the reference: uint8 -> bf16 -> HSV -> flip (base_augment)
    -> f32 -> corruption with p = 0.5 (augment, the reference's
    Augmented mode; ``random_corruption_fast``: K1 at blur angle 0) ->
    /255 -> train forward -> loss -> backward -> SGD -> EMA of the
    parameters with d = decay * (1 - exp(-(step + 1) / 2000)).

    mesh: a data-parallel mesh (parallel/mesh.make_mesh); the images are
    then this rank's rows of the global batch. The draws are made for the
    global batch and sliced (parallel/mesh.draw_rows), BatchNorm
    statistics and TAL's normaliser span the global batch, gradients are
    summed over the data group and the additive metrics too, so every
    rank holds the one-process step's state and metrics.

    Spans (core/profiling.span): ``train.step`` (``step=``) around the call,
    and inside it ``train.augment``, ``train.forward``, ``train.loss``,
    ``train.backward``, ``train.optimizer``, ``train.ema``.
    """

    def body(state, images_u8, gt_boxes, gt_classes, generator):
        model = state.model
        model.train()
        n, rows = mesh_lib.draw_rows(images_u8.shape[0], mesh)
        with span("train.augment"):
            # the augmentation chain runs in bf16, as the reference's does
            x = images_u8.to(torch.bfloat16)
            if base_augment:
                x = aug.random_hsv(x, generator, total=n, rows=rows)
                x, gt_boxes = aug.random_flip_lr(x, gt_boxes, gt_classes,
                                                 generator, total=n,
                                                 rows=rows)
            x = x.float()
            if augment:
                choice, seeds = draw_choice(n, generator, corruption)
                x, _ = random_corruption_fast(x.contiguous(), None,
                                              corruption, choice=choice[rows],
                                              seeds=seeds[rows])
            x = x / 255.0

        state.optimizer.zero_grad(set_to_none=True)
        with mesh_lib.data_parallel(mesh):
            with span("train.forward"):
                outs = model(x)
            with span("train.loss"):
                loss, metrics = det_loss.yolo_loss(outs, gt_boxes,
                                                   gt_classes, img_size)
            with span("train.backward"):
                loss.backward()
        with span("train.optimizer"):
            mesh_lib.all_reduce_grads(model.parameters(), mesh)
            metrics = mesh_lib.sum_over_data(dict(metrics, loss=loss), mesh,
                                             ADDITIVE)
            loss = metrics.pop("loss")
            grad_norm = torch.nn.utils.get_total_norm(
                [p.grad for p in model.parameters() if p.grad is not None])
            state.optimizer.step()
            state.scheduler.step()

        with span("train.ema"):
            d = ema_decay * (1.0 - math.exp(-(state.step + 1) / 2000.0))
            with torch.no_grad():
                for name, p in model.named_parameters():
                    if name in state.ema:
                        state.ema[name].mul_(d).add_(p, alpha=1.0 - d)
        state.step += 1
        return dict({k: v.detach() for k, v in metrics.items()},
                    loss=loss.detach(), grad_norm=grad_norm)

    def step(state: TrainState, images_u8: torch.Tensor,
             gt_boxes: torch.Tensor, gt_classes: torch.Tensor,
             generator: torch.Generator) -> Dict[str, torch.Tensor]:
        with span("train.step", step=state.step):
            return body(state, images_u8, gt_boxes, gt_classes, generator)

    return step


def ema_forward(state: TrainState, *args):
    """state.model's forward on `args` in eval mode with the EMA weights
    (``state.ema``) in place of its parameters and its own BatchNorm
    running statistics, as the reference's predict step reads
    ``ema_params`` beside the raw model's ``batch_stats``. The module's
    parameters, buffers and autograd state are left as they were; its
    train / eval mode is restored."""
    model = state.model
    training = model.training
    model.eval()
    try:
        return torch.func.functional_call(model, state.ema, args)
    finally:
        model.train(training)


def make_predict_step(img_size: int, conf: float = 0.001, iou: float = 0.7,
                      max_det: int = 300, num_candidates: int = 30000,
                      multi_label: bool = True, use_ema: bool = False
                      ) -> Callable:
    """Inference: (model, images (B, S, S, 3) in [0, 255]) -> NMS'd
    detections (boxes (B, max_det, 4) canvas xyxy, scores, classes int32,
    valid), fixed capacity. use_ema=True: the step takes a
    :class:`TrainState` in place of the model and runs its EMA weights
    (:func:`ema_forward`), as the reference's default predict step and
    every validation does.

    multi_label=True is the Ultralytics VAL protocol the reference
    evaluates under (every class above `conf` yields a candidate per box);
    multi_label=False is the PREDICT path (per-box argmax class).
    """

    @torch.inference_mode()
    def step(model, images: torch.Tensor):
        with span("predict.forward"):
            x = images.float() / 255.0
            outs = ema_forward(model, x) if use_ema else model(x)
        with span("predict.decode"):
            boxes, scores = yolo_lib.decode(outs, img_size)
        with span("predict.nms"):
            if multi_label:
                return nms_ops.multilabel_nms(
                    boxes, scores,
                    num_candidates=min(num_candidates,
                                       scores.shape[1] * scores.shape[2]),
                    max_outputs=max_det, iou_thresh=iou, score_thresh=conf)
            best_score, best_cls = scores.max(-1)
            return nms_ops.batched_nms(
                boxes, best_score, best_cls,
                num_candidates=min(num_candidates, boxes.shape[1]),
                max_outputs=max_det, iou_thresh=iou, score_thresh=conf)

    return step


# ── Pretrained weights ───────────────────────────────────────────────────

def load_pretrained(model: torch.nn.Module,
                    state: Union[str, Path, Mapping[str, torch.Tensor]],
                    head_prefixes: Sequence[str] = ("model.22.cv3.",),
                    partial_rows: Sequence[str] = (),
                    allow_pickle: bool = False) -> Dict[str, list]:
    """Load an Ultralytics-layout state_dict (the port's key layout; a path
    to a ``torch.save`` file, plain or under ``"ema"`` / ``"model"``, read
    by ``core.checkpoint.load_weights``: a pickled ``nn.Module`` needs
    `allow_pickle`) into `model`. Tensors under
    `head_prefixes` whose shape differs (the class-count-dependent heads of
    a COCO-80 checkpoint onto the 6-class model) keep their fresh init,
    as the reference's ``import_yolov8(strict_head=False)``; a table in
    `partial_rows` with fewer rows of the same width fills its first rows
    (the rest keep their init). Any other missing, extra or mismatched
    tensor raises. Returns {"imported", "skipped"}."""
    if not isinstance(state, Mapping):
        state = ckpt_lib.load_weights(state, allow_pickle)
    for key in ("ema", "model"):
        if isinstance(state.get(key), Mapping):
            state = state[key]
            break
    own = model.state_dict()
    merged, report = {}, {"imported": [], "skipped": []}
    for key, t in own.items():
        if key.endswith("num_batches_tracked"):
            merged[key] = t
            continue
        if key not in state:
            raise ValueError(f"pretrained state has no {key}")
        src = state[key]
        if tuple(src.shape) == tuple(t.shape):
            merged[key] = src
            report["imported"].append(key)
            continue
        if (key in partial_rows and src.dim() == 2
                and src.shape[1] == t.shape[1] and src.shape[0] < t.shape[0]):
            merged[key] = torch.cat([src.to(t.dtype), t[src.shape[0]:]])
            report["imported"].append(key)
            continue
        if not key.startswith(tuple(head_prefixes)) \
                and key not in partial_rows:
            raise ValueError(f"{key}: {tuple(src.shape)} does not fit "
                             f"{tuple(t.shape)}")
        report["skipped"].append(f"{key} {tuple(src.shape)} vs "
                                 f"{tuple(t.shape)}")
        merged[key] = t
    extra = [k for k in state if k not in own
             and not k.endswith("num_batches_tracked")]
    if extra:
        raise ValueError(f"{len(extra)} pretrained tensors unmapped, first: "
                         f"{extra[:5]}")
    model.load_state_dict(merged)
    return report


# ── The training loop ────────────────────────────────────────────────────

def train_samples(data_root: str | Path, layout: str) -> list:
    """The train split of a COCO- or YOLO-layout root."""
    if layout == "coco":
        return pipe.index_coco(data_root, "train")
    if layout == "yolo":
        return pipe.index_yolo(data_root, "train")
    raise ValueError(f"layout {layout!r}: 'coco' or 'yolo'")


def epoch_batches(samples, batch_size: int, img_size: int, max_boxes: int,
                  seed: int, use_mosaic: bool, load_image: Callable):
    """One epoch's host batches: mosaic + affine, or the shuffled
    letterboxed stream (drop_remainder), both seeded by `seed`."""
    if use_mosaic:
        return aug.mosaic_batches(samples, batch_size, img_size,
                                  max_boxes=max_boxes, seed=seed,
                                  load_image=load_image)
    return pipe.make_batches(samples, batch_size, img_size,
                             max_boxes=max_boxes, shuffle=True, seed=seed,
                             drop_remainder=True, load_image=load_image)


def _ckpt_payload(state: TrainState) -> dict:
    """What ``best`` keeps: the module (weights and running statistics)
    and the EMA."""
    return {"model": state.model.state_dict(), "ema": state.ema}


def resume_payload(state: TrainState) -> dict:
    """What ``last`` keeps: the best payload, the optimizer, the schedule
    and the step."""
    return dict(_ckpt_payload(state),
                optimizer=state.optimizer.state_dict(),
                scheduler=state.scheduler.state_dict(), step=state.step)


def restore_state(state: TrainState, r: dict) -> None:
    """Load a ``last`` payload into `state` in place."""
    state.model.load_state_dict(r["model"])
    for n, e in state.ema.items():
        e.copy_(r["ema"][n])
    state.optimizer.load_state_dict(r["optimizer"])
    state.scheduler.load_state_dict(r["scheduler"])
    state.step = int(r["step"])


def train(cfg: ExperimentConfig, data_root: str | Path, out_dir: str | Path,
          augment: bool = False, variant: str = "m",
          epochs: Optional[int] = None, img_size: Optional[int] = None,
          batch_size: Optional[int] = None, max_steps: Optional[int] = None,
          max_boxes: int = 600, layout: str = "coco",
          base_augment: bool = True, mosaic: bool = True,
          close_mosaic: int = 10, val_interval: int = 1,
          pretrained: Optional[Union[str, Path, Mapping]] = None,
          allow_pickle: bool = False,
          dtype: Optional[str] = None,
          save_every_steps: Optional[int] = None,
          device: Optional[torch.device] = None,
          load_image: Callable = pipe.load_image_rgb) -> dict:
    """Train a YOLO detector on a COCO- or YOLO-layout dataset root, on
    `device` (None: the CUDA card; raises when there is none).

    layout="yolo" covers the VID experiments (VisDrone-VID frames in YOLO
    layout). augment: the Augmented mode (K1 with p 0.5 inside the step);
    base_augment: HSV + flip on the card; mosaic: host mosaic + affine
    until the last `close_mosaic` epochs. val_interval: a val-split mAP
    pass every N epochs and always on the final one (0: final only),
    logging mAP50 / mAP50_95 and keeping the best-mAP50 checkpoint; skipped
    when the root has no val split. pretrained: an Ultralytics-layout
    state_dict or its file (:func:`load_pretrained`; the class-dependent
    head keeps its fresh init); allow_pickle: read a pickled-module file
    (an Ultralytics ``.pt``; trusted files only). dtype: "bfloat16" (the card's default, as
    the reference's on the TPU) or "float32"; parameters and running
    statistics stay f32. save_every_steps: also write ``last`` every N
    steps, keyed by the global step with {epoch, batch_in_epoch,
    epoch_done}, so a run killed mid-epoch resumes at the exact batch.
    load_image(sample) -> (H, W, 3) uint8: the decoder of both splits.

    Writes ``config.json``, ``history.jsonl`` and the checkpoints under
    `out_dir`; a run that finds a ``last`` checkpoint there resumes from
    it. Returns {out_dir, steps, final_loss}.

    Across processes (a process group joined by parallel/distributed.
    maybe_initialize; cfg.mesh factors it): each process decodes its
    sample shard into its slice of the global `batch_size`, the step is
    data-parallel (:func:`make_train_step`'s mesh), validation is sharded,
    and only the primary process writes the artifacts; every process
    resumes from them."""
    device = resolve_device(device)
    model_dtype = compute_dtype(dtype, device)
    tcfg = cfg.train
    epochs = epochs or tcfg.epochs
    img_size = img_size or cfg.data.image_size
    batch_size = batch_size or tcfg.batch_size
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    primary = dist.is_primary()
    if primary:
        artifacts.write_json(out_dir / "config.json", dict(
            dataclasses.asdict(cfg), augment=augment, variant=variant,
            img_size=img_size, batch_size=batch_size, epochs=epochs))
    mesh = mesh_lib.make_mesh(cfg.mesh)

    samples = train_samples(data_root, layout)
    steps_per_epoch = max(1, len(samples) // batch_size)
    # this process's rows: its sample shard and its slice of the global
    # batch (steps_per_epoch is unchanged: local_len / local_bs ==
    # global_len / global_bs)
    local_bs = mesh_lib.local_batch(mesh, batch_size)
    samples = dist.shard_samples(samples, mesh.data_index, mesh.n_data)
    total_steps = epochs * steps_per_epoch
    model = yolo_lib.create(6, variant, model_dtype, device,
                            torch.Generator().manual_seed(tcfg.seed),
                            train=True, bn_dtype=model_dtype)
    if pretrained:
        report = load_pretrained(model, pretrained,
                                 allow_pickle=allow_pickle)
        print(f"pretrained import: imported {len(report['imported'])} "
              f"tensors, skipped {report['skipped']}")
    mesh_lib.replicate_tree(mesh, model)
    tx, sched = make_optimizer(lr0=0.01, warmup_steps=min(
        3 * steps_per_epoch, max(1, total_steps // 10)),
        total_steps=total_steps)
    state = init_state(model, tx)
    train_step = make_train_step(img_size, cfg.corruption, augment,
                                 base_augment=base_augment, mesh=mesh)

    val_samples = validation.index_val_samples(data_root, layout)
    predict_fn = (make_predict_step(img_size, use_ema=True)
                  if val_samples else None)

    ckpt = CheckpointManager(out_dir)
    hist = artifacts.HistoryLogger(out_dir)
    steps = 0
    mean_loss = 0.0     # survives a resume of an already-complete run
    start_epoch = 1
    skip_batches = 0
    restored = ckpt.restore_last(map_location=device)
    if restored is not None:
        restore_state(state, restored["state"])
        ex = restored["extra"]
        if ex["epoch_done"]:
            start_epoch = int(ex["epoch"]) + 1
        else:
            start_epoch = int(ex["epoch"])
            skip_batches = int(ex["batch_in_epoch"])
        steps = state.step
    for epoch in range(start_epoch, epochs + 1):
        t0 = time.time()
        losses = []
        # mosaic until the last `close_mosaic` epochs
        use_mosaic = mosaic and epoch <= max(0, epochs - close_mosaic)
        batch_iter = epoch_batches(samples, local_bs, img_size, max_boxes,
                                   tcfg.seed + epoch, use_mosaic, load_image)
        k = 0
        if skip_batches:
            batch_iter = itertools.islice(batch_iter, skip_batches, None)
            k, skip_batches = skip_batches, 0
        for batch in pipe.prefetch(batch_iter):
            images, gt_boxes, gt_classes, _ = pipe.device_put_sharded(
                batch, device)
            m = train_step(state, images, gt_boxes, gt_classes,
                           step_generator(tcfg.seed, state.step, device))
            losses.append(m["loss"])
            steps += 1
            k += 1
            if save_every_steps and steps % save_every_steps == 0 \
                    and primary:
                ckpt.save_last(steps, resume_payload(state),
                               extra={"epoch": epoch, "batch_in_epoch": k,
                                      "epoch_done": False})
            if max_steps and steps >= max_steps:
                break
        mean_loss = float(torch.stack(losses).mean()) if losses else 0.0
        record = dict(epoch=epoch, train_loss=mean_loss,
                      lr=float(sched(steps)),
                      epoch_sec=round(time.time() - t0, 2))
        if validation.should_validate(epoch, epochs, val_interval,
                                      bool(val_samples)):
            vm = validation.run_validation(
                predict_fn, state, val_samples, img_size, batch_size, device,
                max_boxes=max_boxes, load_image=load_image, mesh=mesh)
            record.update(vm)
            if primary:
                ckpt.save_best(epoch, _ckpt_payload(state), vm["mAP50"])
        if primary:
            hist.log(**record)
            ckpt.save_last(steps, resume_payload(state),
                           extra={"epoch": epoch, "batch_in_epoch": k,
                                  "epoch_done": True})
        if max_steps and steps >= max_steps:
            break
    if primary and ckpt.best_metric() is None:
        # no val split, or the run broke off before any val pass:
        # final = best
        ckpt.save_best(epochs, _ckpt_payload(state), 0.0)
    ckpt.close()
    mesh_lib.barrier(mesh)      # the artifacts are on disk for every rank
    return {"out_dir": str(out_dir), "steps": steps,
            "final_loss": mean_loss}


def restore_weights(out_dir: str | Path, device: torch.device) -> dict:
    """The weights payload {"model", "ema"} of ``best``, else of the newest
    ``last`` (which carries the whole resume payload)."""
    ckpt = CheckpointManager(out_dir)
    try:
        state = ckpt.restore_best(map_location=device)
        if state is None:
            latest = ckpt.restore_last(map_location=device)
            if latest is None:
                raise FileNotFoundError(f"no checkpoint under {out_dir}")
            state = latest["state"]
    finally:
        ckpt.close()
    return state


def ema_module(model: torch.nn.Module, payload: dict) -> torch.nn.Module:
    """`model` in eval mode with the payload's running statistics and its
    EMA weights in place of the raw ones."""
    model.load_state_dict(payload["model"])
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name in payload["ema"]:
                p.copy_(payload["ema"][name])
    return model.eval()


def load_checkpoint(out_dir: str | Path, variant: str = "m",
                    dtype: torch.dtype = torch.float32,
                    device: Optional[torch.device] = None
                    ) -> torch.nn.Module:
    """A trained checkpoint under `out_dir` (``best``, else the newest
    ``last``) as an eval-mode YOLOv8 on `device` (None: the CUDA card)
    carrying the EMA weights, which the reference predicts with; its
    running statistics are the raw model's. The reference returns (model,
    state); a port model carries its weights. dtype: the conv compute
    type."""
    device = resolve_device(device)
    payload = restore_weights(out_dir, device)
    return ema_module(yolo_lib.create(6, variant, dtype, device), payload)
