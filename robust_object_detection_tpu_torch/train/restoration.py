"""Restoration U-Net training (counterpart of
robust_object_detection_tpu/train/restoration.py).

(corrupted, clean) patch pairs, loss L1 + 0.3 (1 - SSIM), AdamW (lr 1e-3,
weight decay 1e-4 on every parameter) with a cosine decay to ``lr_min``
over all epochs, validation every ``val_every`` epochs keeping the best-PSNR
checkpoint. One step: random horizontal flip, a corruption drawn uniformly
from noise / blur / lowres (``ops/corrupt.corrupt_variant``, op by op as
the reference's step, not K1), forward, loss, backward, AdamW; the step
updates the model and optimizer in place.

Random draws: a step draws from one ``torch.Generator`` on the batch's
device, in the order flip (B,), corruption id (B,), noise (B, H, W, 3)
standard normal; every step function also takes the draws as arrays, so
tests hand both packages the same ones. The reference folds the step
into a key and splits it instead.

``PatchDataset`` decodes and resizes through data/imageio.py (``.bmp`` in
numpy, JPEG and PNG through PIL at the call, cv2's INTER_LINEAR in numpy).
"""

from __future__ import annotations

import dataclasses
import math
import time
from pathlib import Path
from typing import Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from ..core import artifacts
from ..core import config as config_lib
from ..core.checkpoint import CheckpointManager
from ..core.config import CorruptionConfig, ExperimentConfig, RestorationConfig
from ..data import imageio
from ..models import unet as unet_lib
from ..models.layers import resolve_device
from ..ops import corrupt as corrupt_ops
from ..ops import ssim as ssim_ops

# ── Host-side patch dataset ──────────────────────────────────────────────

class PatchDataset:
    """Random (train) / centre (val) square crops from a directory of
    images, uint8 RGB. Images smaller than the patch are first resized up
    (cv2's INTER_LINEAR, ``imageio.resize_linear_u8``) to at least the
    patch on each side.

    Train crops draw (y, x) from ``RandomState(seed + epoch)`` after the
    epoch's shuffle, image by image in batch order (decode runs on a
    thread pool, the draws on the calling thread, so the crops do not
    depend on the thread count)."""

    def __init__(self, img_dir: str | Path, patch: int = 256,
                 train: bool = True, seed: int = 42):
        self.paths = sorted(p for p in Path(img_dir).glob("*.*")
                            if p.suffix.lower() in imageio.IMAGE_EXTS)
        if not self.paths:
            raise FileNotFoundError(f"no images under {img_dir}")
        self.patch = patch
        self.train = train
        self.seed = seed

    def __len__(self) -> int:
        return len(self.paths)

    def _decode(self, idx: int) -> np.ndarray:
        img = imageio.read_rgb(self.paths[idx])
        h, w = img.shape[:2]
        s = self.patch
        if h < s or w < s:
            img = imageio.resize_linear_u8(img, max(w, s), max(h, s))
        return img

    def _crop(self, img: np.ndarray, rng: np.random.RandomState
              ) -> np.ndarray:
        h, w = img.shape[:2]
        s = self.patch
        if self.train:
            y = rng.randint(0, h - s + 1)
            x = rng.randint(0, w - s + 1)
        else:
            y, x = (h - s) // 2, (w - s) // 2
        return np.ascontiguousarray(img[y:y + s, x:x + s])

    def batches(self, batch_size: int, epoch: int = 0,
                num_threads: int = 8) -> Iterator[np.ndarray]:
        """Yield (B, S, S, 3) uint8 batches; the train order reshuffles
        every epoch and drops the last partial batch, the val order pads
        it with its last image."""
        from concurrent.futures import ThreadPoolExecutor
        rng = np.random.RandomState(self.seed + epoch)
        order = np.arange(len(self.paths))
        if self.train:
            rng.shuffle(order)
        with ThreadPoolExecutor(max_workers=num_threads) as pool:
            for start in range(0, len(order), batch_size):
                idxs = order[start:start + batch_size]
                if len(idxs) < batch_size:
                    if self.train:
                        break
                    idxs = np.concatenate(
                        [idxs, idxs[-1:].repeat(batch_size - len(idxs))])
                imgs = list(pool.map(self._decode, idxs))
                yield np.stack([self._crop(im, rng) for im in imgs])


# ── Optimizer and steps ──────────────────────────────────────────────────

def make_optimizer(cfg: RestorationConfig, steps_per_epoch: int
                   ) -> Tuple[Callable, Callable[[int], float]]:
    """(tx, sched). sched(count): optax's ``cosine_decay_schedule(lr,
    epochs * steps_per_epoch, lr_min / lr)`` at the count BEFORE an update
    (the first update runs at sched(0) = lr). tx(model) -> (AdamW,
    LambdaLR): optax's ``adamw`` defaults (betas 0.9 / 0.999, eps 1e-8),
    weight decay on every parameter, the schedule stepped after each
    update."""
    decay_steps = cfg.epochs * max(1, steps_per_epoch)
    alpha = cfg.lr_min / cfg.lr

    def sched(count: int) -> float:
        frac = min(count, decay_steps) / decay_steps
        cosine = 0.5 * (1.0 + math.cos(math.pi * frac))
        return cfg.lr * ((1.0 - alpha) * cosine + alpha)

    def tx(model: torch.nn.Module):
        opt = torch.optim.AdamW(model.parameters(), lr=cfg.lr,
                                betas=(0.9, 0.999), eps=1e-8,
                                weight_decay=cfg.weight_decay)
        return opt, torch.optim.lr_scheduler.LambdaLR(
            opt, lambda count: sched(count) / cfg.lr)

    return tx, sched


@dataclasses.dataclass
class TrainState:
    """The module (weights and running statistics), its optimizer and
    schedule, the step count."""
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    scheduler: torch.optim.lr_scheduler.LRScheduler
    step: int = 0


def init_state(model: torch.nn.Module, tx: Callable) -> TrainState:
    opt, sched = tx(model)
    return TrainState(model, opt, sched)


def draw_corruption(shape, generator: torch.Generator
                    ) -> Dict[str, torch.Tensor]:
    """The corruption draws of a (B, H, W, 3) batch: ``variant`` (B,)
    uniform over NOISE / BLUR / LOWRES, then ``noise`` (B, H, W, 3)
    standard normal."""
    dev = generator.device
    variant = torch.randint(corrupt_ops.NOISE, corrupt_ops.LOWRES + 1,
                            (shape[0],), generator=generator, device=dev)
    noise = torch.randn(tuple(shape), generator=generator, device=dev)
    return {"variant": variant, "noise": noise}


def draw_train(shape, generator: torch.Generator) -> Dict[str, torch.Tensor]:
    """A train step's draws: ``flip`` (B,) bool (p 0.5), then the
    corruption's."""
    flip = torch.rand(shape[0], generator=generator,
                      device=generator.device) < 0.5
    return dict(flip=flip, **draw_corruption(shape, generator))


def corrupt_uniform3(img: torch.Tensor, generator: Optional[torch.Generator],
                     cfg: CorruptionConfig,
                     draws: Optional[Dict[str, torch.Tensor]] = None
                     ) -> torch.Tensor:
    """Always corrupt, uniform over noise / blur / lowres; f32 [0, 255]
    NHWC in and out. Draws from `generator` unless `draws` are given."""
    if draws is None:
        draws = draw_corruption(img.shape, generator)
    return corrupt_ops.corrupt_variant(img, draws["variant"], None, cfg,
                                       noise=draws["noise"])


def make_train_step(corruption: CorruptionConfig,
                    ssim_weight: float = 0.3) -> Callable:
    """Train step: (state, batch_u8 (B, S, S, 3), generator on the batch's
    device, draws=None) -> metrics {loss, psnr, grad_norm} as device
    tensors; `state` is updated in place. Order, as the reference: uint8 ->
    f32 -> flip -> corrupt -> /255 -> train forward -> loss against the
    flipped clean batch -> backward -> AdamW; psnr of the forward's output,
    grad_norm the global norm of the gradients."""

    def step(state: TrainState, batch_u8: torch.Tensor,
             generator: Optional[torch.Generator] = None,
             draws: Optional[Dict[str, torch.Tensor]] = None
             ) -> Dict[str, torch.Tensor]:
        if draws is None:
            draws = draw_train(batch_u8.shape, generator)
        model = state.model
        model.train()
        x = batch_u8.float()
        x = torch.where(draws["flip"].view(-1, 1, 1, 1), x.flip(2), x)
        corrupted = corrupt_uniform3(x, None, corruption, draws) / 255.0
        clean = x / 255.0

        state.optimizer.zero_grad(set_to_none=True)
        out = model(corrupted)
        loss = ssim_ops.restoration_loss(out, clean, ssim_weight)
        loss.backward()
        grad_norm = torch.nn.utils.get_total_norm(
            [p.grad for p in model.parameters() if p.grad is not None])
        state.optimizer.step()
        state.scheduler.step()
        state.step += 1
        return {"loss": loss.detach(),
                "psnr": ssim_ops.psnr(out.detach(), clean),
                "grad_norm": grad_norm}

    return step


def make_eval_step(corruption: CorruptionConfig) -> Callable:
    """Eval step: (model, batch_u8, generator, draws=None) -> {psnr, ssim,
    psnr_in}: the restored and the corrupted input against the clean
    batch (restoration must beat psnr_in, not just be positive)."""

    @torch.no_grad()
    def step(model: torch.nn.Module, batch_u8: torch.Tensor,
             generator: Optional[torch.Generator] = None,
             draws: Optional[Dict[str, torch.Tensor]] = None
             ) -> Dict[str, torch.Tensor]:
        model.eval()
        x = batch_u8.float()
        clean = x / 255.0
        corrupted = corrupt_uniform3(x, generator, corruption, draws) / 255.0
        out = model(corrupted)
        return {"psnr": ssim_ops.psnr(out, clean),
                "ssim": ssim_ops.ssim(out, clean),
                "psnr_in": ssim_ops.psnr(corrupted, clean)}

    return step


# ── Full training driver ─────────────────────────────────────────────────

def train(cfg: ExperimentConfig, train_dir: str | Path, val_dir: str | Path,
          out_dir: Optional[str | Path] = None,
          max_steps: Optional[int] = None,
          device: Optional[torch.device] = None) -> dict:
    """Train the restoration U-Net on `device` (None: the CUDA card);
    writes ``config.json``, ``history.jsonl`` and checkpoints (``best`` by
    val PSNR, ``last`` every epoch) under `out_dir`; returns {best,
    out_dir, param_count}. Validation draws restart from the same seed at
    every validation, so every epoch sees the same val corruptions."""
    rcfg = cfg.restoration
    out_dir = Path(out_dir or cfg.out_dir / "restoration")
    out_dir.mkdir(parents=True, exist_ok=True)
    artifacts.write_json(out_dir / "config.json", config_lib.to_dict(cfg))
    device = resolve_device(device)

    train_ds = PatchDataset(train_dir, rcfg.patch_size, train=True,
                            seed=rcfg.seed)
    val_ds = PatchDataset(val_dir, rcfg.patch_size, train=False,
                          seed=rcfg.seed)
    steps_per_epoch = len(train_ds) // rcfg.batch_size

    model = unet_lib.create(rcfg.channels, device=device,
                            generator=torch.Generator().manual_seed(
                                rcfg.seed), train=True)
    tx, sched = make_optimizer(rcfg, steps_per_epoch)
    state = init_state(model, tx)
    train_step = make_train_step(cfg.corruption, rcfg.ssim_weight)
    eval_step = make_eval_step(cfg.corruption)

    ckpt = CheckpointManager(out_dir)
    hist = artifacts.HistoryLogger(out_dir)
    gen = torch.Generator(device).manual_seed(rcfg.seed)
    best = {"psnr": -1.0, "ssim": 0.0, "epoch": -1}
    total_steps = 0

    for epoch in range(1, rcfg.epochs + 1):
        t0 = time.time()
        losses: List[torch.Tensor] = []
        for batch in train_ds.batches(rcfg.batch_size, epoch):
            b = torch.from_numpy(batch).to(device)
            losses.append(train_step(state, b, gen)["loss"])
            total_steps += 1
            if max_steps and total_steps >= max_steps:
                break
        mean_loss = float(torch.stack(losses).mean()) if losses else 0.0

        record = {"epoch": epoch, "train_loss": mean_loss,
                  "lr": float(sched(total_steps)),
                  "epoch_sec": round(time.time() - t0, 2)}
        if epoch % rcfg.val_every == 0 or epoch == rcfg.epochs or max_steps:
            val_gen = torch.Generator(device).manual_seed(rcfg.seed + 1)
            ms = [eval_step(model, torch.from_numpy(b).to(device), val_gen)
                  for b in val_ds.batches(rcfg.batch_size)]
            for k in ("psnr", "ssim", "psnr_in"):
                record[f"val_{k}"] = float(torch.stack([m[k] for m in ms])
                                           .mean())
            if record["val_psnr"] > best["psnr"]:
                best = {"psnr": record["val_psnr"],
                        "ssim": record["val_ssim"], "epoch": epoch}
                ckpt.save_best(epoch, model.state_dict(), record["val_psnr"])
        hist.log(**record)
        ckpt.save_last(epoch, {"model": model.state_dict(),
                               "optimizer": state.optimizer.state_dict()})
        if max_steps and total_steps >= max_steps:
            break

    ckpt.close()
    return {"best": best, "out_dir": str(out_dir),
            "param_count": unet_lib.param_count(model)}


def load_best(out_dir: str | Path, channels=(32, 64, 128, 256),
              device: Optional[torch.device] = None
              ) -> unet_lib.RestorationUNet:
    """The best checkpoint under `out_dir` as an eval-mode U-Net on
    `device` (None: the CUDA card). The reference returns (model,
    variables); a port model carries its weights."""
    device = resolve_device(device)
    ckpt = CheckpointManager(out_dir)
    state = ckpt.restore_best(map_location=device)
    ckpt.close()
    if state is None:
        raise FileNotFoundError(f"no best checkpoint under {out_dir}")
    model = unet_lib.create(channels, device=device)
    model.load_state_dict(state)
    return model
