"""The sweep driver: the robustness evaluation, closed loop.

Each call is one ``eval/fused_sweep.run_fused_sweep`` over the traffic's
in-memory val split: every batch becomes the four variants (clean, noise,
blur, lowres), each detected, and with a U-Net the three corrupted ones
restored and detected again (8 passes), then the host scores every
(strategy, variant). Set-up makes the split and the weights from the seed
and warms every shape with one call on one batch. The window runs whole
calls back to back until `seconds` have passed; the rate is every
image-pass of every call over the time from the first call's start to the
last call's end. With --trace 1 one more call runs under the profiler.

What the program is handed is its own: its detector and U-Net behind a
:class:`Tap` that keeps, for one batch of the window's first call and some
of its rows (both drawn from the seed), what each returns, and its predict
step, wrapped to keep what it returns. Once the window has closed and the
program's models are freed, the reference checks that batch stage by
stage: the restorations against the plain U-Net on the reference's own
corrupted variants; every anchor of every pass against the plain
detector (on the reference's letterboxed variants, and in the restored
passes on the program's restorations, checked above); the selection
(decode + NMS) redone on the program's own head outputs against the
detections it returned; and the host scorer redone on one (strategy,
variant) of a call.
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from benchmark.harness import checks, timing, traffic as gen
from benchmark.harness.trace import device_profile, reduce_profile
from benchmark.harness.weights import (calibration_images, load_into,
                                       seeded_weights)
from benchmark.reference import coco_map, sweep_ops, unet as ref_unet
from benchmark.reference.precision import BELOW, exact_float32

VARIANTS = ("Test_Clean", "Test_Noise", "Test_Blur", "Test_LowRes")


def _rows(out, rows):
    if isinstance(out, torch.Tensor):
        return out[rows].clone()
    return type(out)(_rows(o, rows) for o in out)


class Tap(torch.nn.Module):
    """The program's module, called as it is; while ``armed`` it keeps
    ``rows`` of what each call returns."""

    def __init__(self, inner: torch.nn.Module, rows):
        super().__init__()
        self.inner = inner
        self.rows = rows
        self.armed = False
        self.kept: list = []

    def forward(self, x):
        out = self.inner(x)
        if self.armed:
            self.kept.append(_rows(out, self.rows))
        return out


def unet_weights(restore: dict, seed: int, device):
    """The U-Net's weights from the seed, and its BatchNorms' running
    statistics from a calibration pass of the plain U-Net."""
    model = ref_unet.RestorationUNet(restore["channels"]).to(device)
    w = seeded_weights(ref_unet.weight_spec(model), seed, device, tag="unet")
    model.load_state_dict(w, strict=False)
    ref_unet.calibrate(model, calibration_images(seed, device, 2, 256, 256))
    w.update({n: b.detach().clone() for n, b in model.named_buffers()
              if ".running_" in n})
    return w


def det_weights(ctx, dev):
    """The detector's weights, its running statistics taken on two seeded
    images of the traffic's native size, letterboxed as the sweep does."""
    cfg, tr = ctx.cell.config, ctx.cell.traffic
    h, w = tr["native_hw"]
    canvas, _, _ = sweep_ops.letterbox(
        calibration_images(ctx.seed, dev, 2, h, w) * 255.0, cfg["imgsz"])
    return ctx.family.eval_weights(cfg, ctx.seed, dev, canvas / 255.0)


def program_unet(restore: dict, device, w):
    from robust_object_detection_tpu_torch.models import unet as U

    with torch.device(device):
        model = U.RestorationUNet(restore["channels"], torch.float32)
    model = model.to(memory_format=torch.channels_last)
    load_into(model, w)
    return model.eval()


def run(ctx) -> dict:
    from robust_object_detection_tpu_torch.core.config import \
        CorruptionConfig
    from robust_object_detection_tpu_torch.eval import fused_sweep as FS

    cfg, tr, dev, fam = ctx.cell.config, ctx.cell.traffic, ctx.device, \
        ctx.family
    images, samples = gen.sweep_split(tr, cfg["nc"], ctx.seed)
    restore = tr.get("restore")
    n_pass = 8 if restore else 4
    rng = np.random.default_rng(gen.sub_seed(ctx.seed, "sample"))
    j = int(rng.integers(-(-len(samples) // tr["batch"])))
    rows = np.sort(rng.choice(min(tr["batch"], len(samples) - j *
                                  tr["batch"]), tr["check_images"],
                              replace=False)).tolist()
    det = Tap(fam.program_eval(cfg, dev, det_weights(ctx, dev)), rows)
    unet = (Tap(program_unet(restore, dev, unet_weights(restore, ctx.seed,
                                                        dev)), rows)
            if restore else None)
    inner = fam.program_predict(cfg)
    captured: list = []
    capture = [False]

    def predict(model, canvas):
        p = len(captured[-1])           # this call's predict calls so far
        det.armed = capture[0] and p // n_pass == j
        out = inner(model, canvas)
        captured[-1].append(out)
        if unet is not None:            # a restoration precedes passes 5-7
            nxt = p + 1
            unet.armed = (capture[0] and nxt // n_pass == j
                          and nxt % n_pass >= 5)
        return out

    corruption = CorruptionConfig(**cfg["corruption"])
    base = gen.sub_seed(ctx.seed, "steps")

    def call(k: int, subset):
        captured.append([])
        capture[0] = k == 0
        return FS.run_fused_sweep(predict, det, unet, None, subset,
                                  cfg["imgsz"], tr["batch"], corruption,
                                  seed=base + k,
                                  load_image=lambda s: images[s.image_id])

    call(-1, samples[:tr["batch"]])          # warm-up: one batch
    captured.clear()
    timing.synchronize(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    outs, ends = [], []
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < ctx.seconds:
        outs.append(call(len(outs), samples))
        ends.append(time.perf_counter() - t0)
    window_s = time.perf_counter() - t0
    ctx.log(f"[sweep] calls ended at {ends} s")
    setup_s = t0 - ctx.t_process
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    passes = sum(o["images_evaluated"] for o in outs)
    failed = sum(int((~torch.isfinite(b).all(-1).all(-1)).sum())
                 for c in captured for b, *_ in c)
    e2e = {"eval_passes_per_s": timing.rate(passes, window_s),
           "peak_mem_gib": peak / 2 ** 30, "setup_s": setup_s}
    record = {"kind": "sweep", "batch": tr["batch"], "window_s": window_s,
              "config": cfg, "family": fam}
    profile = None
    if ctx.trace:
        n_img = tr["trace_images"]
        timing.synchronize(dev)
        with device_profile(dev) as prof:
            p0 = time.perf_counter()
            call(len(outs), samples[:n_img])
            timing.synchronize(dev)
            prof_wall = time.perf_counter() - p0
        profile = reduce_profile(prof, prof_wall, fam.RTDETR_KERNELS)
        profile["forwards"] = -(-n_img // tr["batch"]) * n_pass
        del prof
        captured.pop()
        record["profile"] = profile
        record["flops"] = window_flops(cfg, tr, fam, len(outs),
                                       len(samples), passes)

    kept = {"det": det.kept, "unet": unet.kept if unet is not None else [],
            "rows": rows,
            "dets": [tuple(t[rows] for t in o)
                     for o in captured[0][j * n_pass:(j + 1) * n_pass]]}
    # the program's models go before the reference runs
    del det, unet, inner
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    k = int(rng.integers(len(outs)))
    scored = (("corrupted", "restored")[int(rng.integers(n_pass // 4))],
              VARIANTS[int(rng.integers(4))])
    t_ref = time.perf_counter()
    numbers = check_batch(ctx, images, samples, base, j, kept)
    numbers["summary_gap"] = check_summary(
        tr, samples, captured[k], n_pass, scored, cfg["imgsz"], cfg["nc"],
        outs[k][scored[0]][scored[1]])
    ctx.log(f"[sweep] {len(outs)} calls, {passes} image-passes; reference "
            f"on call 0 batch {j} rows {rows}, scored call {k} {scored}: "
            f"{time.perf_counter() - t_ref:.1f} s")
    return {"attempted": passes, "failed": failed, "end_to_end": e2e,
            "record": record, "numbers": numbers, "peak_bytes": peak,
            "profile": profile}


def window_flops(cfg, tr, fam, calls: int, images: int, passes: int):
    """{precision: FLOPs} of the window's work: the detector's forward an
    image-pass, the U-Net's forward a restored image (3 an image a call)
    at its padded size."""
    flops = {cfg["precision"]["detector"]:
             fam.flops(cfg, 1, train=False) * passes}
    restore = tr.get("restore")
    if restore:
        h, w = tr["native_hw"]
        with torch.device("meta"):
            model = ref_unet.RestorationUNet(restore["channels"])
        unet = ref_unet.count_flops(model, -(-h // 16) * 16,
                                    -(-w // 16) * 16)
        flops[restore["precision"]] = (flops.get(restore["precision"], 0.0)
                                       + unet * calls * images * 3)
    return flops


def reference_models(ctx, dev, precision: str = "exact"):
    """The plain detector and U-Net (or None) on `dev`, with the weights
    the program was given; with precision "control", in the precisions
    below the configuration's."""
    cfg, restore, fam = ctx.cell.config, ctx.cell.traffic.get("restore"), \
        ctx.family
    control = precision == "control"
    det = fam.reference_model(
        cfg, BELOW[cfg["precision"]["detector"]] if control else "exact")
    det.load_state_dict(det_weights(ctx, dev), strict=False)
    unet = None
    if restore:
        unet = ref_unet.RestorationUNet(
            restore["channels"],
            BELOW[restore["precision"]] if control else "exact")
        unet.load_state_dict(unet_weights(restore, ctx.seed, dev),
                             strict=False)
        unet = unet.to(dev).eval()
    return det.to(dev).eval(), unet


def batch_inputs(tr: dict, images, samples, call_seed: int, j: int, rows,
                 dev):
    """(clean uint8 (R, H, W, 3), the noise draw) of `rows` of batch j of a
    call: the images as the program's loader gives them, the j-th standard
    normal the call's generator draws."""
    b = tr["batch"]
    chunk = samples[j * b:(j + 1) * b]
    h, w = tr["native_hw"]
    noise_gen = torch.Generator(dev).manual_seed(call_seed)
    for _ in range(j + 1):
        noise = torch.randn((b, h, w, 3), generator=noise_gen, device=dev)
    clean = np.stack([images[chunk[r].image_id] for r in rows])
    return torch.from_numpy(clean).to(dev), noise[rows]


def variants(cfg: dict, clean: torch.Tensor, noise: torch.Tensor):
    c = cfg["corruption"]
    x = clean.float()
    return [x, sweep_ops.add_noise(x, noise, c["noise_sigma"]),
            sweep_ops.apply_motion_blur(x, c["blur_kernel"],
                                        c["blur_angle_deg"]),
            sweep_ops.apply_lowres(x, c["downscale_factor"])]


def restored(unet_out: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """The restored image the sweep detects: floor(clip(y * 255 + 0.5)),
    cropped to the native size."""
    return torch.floor(torch.clamp(unet_out * 255.0 + 0.5, 0.0, 255.0)
                       )[:, :h, :w].float()


@torch.no_grad()
def run_reference(cfg: dict, fam, det, unet, clean, noise) -> dict:
    """What a sweep computes for some images, by the plain models: the
    U-Net's outputs on the three corrupted variants, the head's raw
    outputs of each pass, and its selected detections."""
    imgs = variants(cfg, clean, noise)
    out = {"unet": [], "det": [], "dets": []}
    if unet is not None:
        h, w = clean.shape[1:3]
        out["unet"] = [unet(sweep_ops.pad_to_multiple(v, 16) / 255.0)
                       for v in imgs[1:]]
        imgs = imgs + [imgs[0]] + [restored(y, h, w) for y in out["unet"]]
    for img in imgs:
        canvas, _, _ = sweep_ops.letterbox(img, cfg["imgsz"])
        raw = fam.reference_forward(det, canvas)
        out["det"].append(raw)
        out["dets"].append(fam.reference_select(
            *fam.reference_decode(raw, cfg["imgsz"])))
    return out


@torch.no_grad()
def check_batch(ctx, images, samples, call_seed: int, j: int,
                kept: dict) -> dict:
    """The stage checks of some rows of batch j of a call (``kept``: what
    the program returned for them):

    restore_gap: the largest gap, in grey levels, of a restored pixel;
    anchor_gap_median: the median over every anchor of every pass of
        max(largest class-score gap, largest corner gap / canvas), the
        restored passes detected from the program's restorations (its
        tail is set by the anchors whose box logits are far out of their
        range, the padding rows among them, in any precision: the median
        is the steady number);
    select_gap: the reference's decode and selection redone on the
        program's head outputs, against the detections it returned: the
        largest max(score gap, corner gap / canvas) slot by slot, 1 for a
        slot whose class or validity differs."""
    cfg, tr, dev, fam = ctx.cell.config, ctx.cell.traffic, ctx.device, \
        ctx.family
    size = cfg["imgsz"]
    clean, noise = batch_inputs(tr, images, samples, call_seed, j,
                                kept["rows"], dev)
    det, unet = reference_models(ctx, dev)
    h, w = clean.shape[1:3]
    imgs = variants(cfg, clean, noise)
    restore_gap = 0.0
    with exact_float32():
        if unet is not None:
            for v, y in zip(imgs[1:], kept["unet"]):
                ref = restored(unet(sweep_ops.pad_to_multiple(v, 16)
                                    / 255.0), h, w)
                restore_gap = max(restore_gap, float(
                    (restored(y.float(), h, w) - ref).abs().max()))
            imgs = imgs + [imgs[0]] + [restored(y.float(), h, w)
                                       for y in kept["unet"]]
        gaps, select_gap = [], 0.0
        for img, raw, dets in zip(imgs, kept["det"], kept["dets"]):
            canvas, _, _ = sweep_ops.letterbox(img, size)
            rb, rs = fam.reference_decode(fam.reference_forward(det, canvas),
                                          size)
            pb, ps = fam.reference_decode(raw, size)
            gaps.append(torch.maximum((ps - rs).abs().amax(-1),
                                      (pb - rb).abs().amax(-1) / size
                                      ).flatten())
            select_gap = max(select_gap, checks.selection_gap(
                fam.reference_select(pb, ps), dets, size))
    gaps = torch.cat(gaps)
    sample = gaps[torch.randperm(gaps.numel(), device=gaps.device)[:1 << 22]]
    q = torch.quantile(sample, torch.tensor([0.5, 0.9, 0.99],
                                            device=gaps.device)).tolist()
    ctx.log(f"[sweep] anchor gaps of {gaps.numel()}: q50 {q[0]} q90 {q[1]} "
            f"q99 {q[2]} max {float(gaps.max())}")
    return {"restore_gap": restore_gap, "anchor_gap_median": q[0],
            "select_gap": select_gap}


@torch.no_grad()
def control(ctx) -> dict:
    """The stage checks of the control: the reference computed in the
    precisions below the configuration's (detector and U-Net), put in the
    program's place for some rows of the first batch of a call of
    `ctx.seed`. Its host scorer is the reference's, so summary_gap does
    not apply."""
    cfg, tr, dev, fam = ctx.cell.config, ctx.cell.traffic, ctx.device, \
        ctx.family
    images, samples = gen.sweep_split(tr, cfg["nc"], ctx.seed)
    call_seed = gen.sub_seed(ctx.seed, "steps")
    rows = list(range(tr["check_images"]))
    clean, noise = batch_inputs(tr, images, samples, call_seed, 0, rows, dev)
    low_det, low_unet = reference_models(ctx, dev, "control")
    with exact_float32():
        low = run_reference(cfg, fam, low_det, low_unet, clean, noise)
    del low_det, low_unet
    kept = {"det": low["det"], "unet": low["unet"], "rows": rows,
            "dets": low["dets"]}
    return check_batch(ctx, images, samples, call_seed, 0, kept)


def check_summary(tr, samples, call_outs, n_pass, scored, img_size, nc,
                  prog_summary) -> float:
    """The largest gap between the program's summary of one (strategy,
    variant) and the reference scorer's on the detections the program
    returned for it."""
    h, w = tr["native_hw"]
    scale = min(img_size / h, img_size / w)
    p = ("corrupted", "restored").index(scored[0]) * 4 \
        + VARIANTS.index(scored[1])
    b = tr["batch"]
    dets, gts = {}, {}
    for j, start in enumerate(range(0, len(samples), b)):
        boxes, scores, classes, valid = (
            t.cpu().numpy() for t in call_outs[j * n_pass + p])
        for i, s in enumerate(samples[start:start + b]):
            v = valid[i]
            bx = boxes[i][v] / scale
            bx[:, 0::2] = bx[:, 0::2].clip(0, s.width)
            bx[:, 1::2] = bx[:, 1::2].clip(0, s.height)
            dets[s.image_id] = coco_map.Detections(
                np.concatenate([bx[:, :2], bx[:, 2:] - bx[:, :2]], 1),
                scores[i][v], classes[i][v].astype(np.int64) + 1)
            gb = s.boxes_xyxy
            gts[s.image_id] = coco_map.GroundTruth(
                np.concatenate([gb[:, :2], gb[:, 2:] - gb[:, :2]], 1),
                s.classes.astype(np.int64) + 1)
    ref = coco_map.evaluate(dets, gts, categories=list(range(1, nc + 1)))
    want = coco_map.summarize(ref)
    gaps = [abs(prog_summary[k] - v) for k, v in want.items()]
    gaps += [abs(a - b) for a, b in zip(
        prog_summary["per_class_ap50"].values(),
        ref.per_class_ap50.values())]
    return max(gaps)
