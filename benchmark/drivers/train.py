"""The train driver: one training job's steps, closed loop.

Set-up builds the program's train state and step once, with weights made
from the seed, and drives it through its first steps (the reference
follows them later); those steps warm every shape the window uses. The
window then calls the same step on the same state, dispatched ahead with
no synchronisation between steps, cycling a pool of distinct batches made
from the seed, until `seconds` have passed; it ends in one synchronise.
With --trace 1 a few more steps run under the profiler after the window.
Once the program's state is freed, the reference repeats the first steps
and the gaps between the two decide ``correct``.
"""

from __future__ import annotations

import gc
import statistics
import time

import torch

from benchmark.harness import checks, timing, traffic as gen
from benchmark.harness.trace import device_profile, reduce_profile
from benchmark.reference.precision import BELOW, exact_float32


def _host(tensors):
    """Copies on the host (a copy even of a host tensor: the live state
    moves on)."""
    return {n: t.detach().to("cpu", torch.float32, copy=True)
            for n, t in tensors.items()}


def run(ctx) -> dict:
    cfg, tr, dev = ctx.cell.config, ctx.cell.traffic, ctx.device
    fam = ctx.family
    pool = gen.detection_pool(tr, cfg["imgsz"], cfg["nc"], ctx.seed, dev)
    w = fam.weights(cfg, ctx.seed, dev)
    p0 = _host(w)
    state, step = fam.program_train(cfg, dev, w)
    del w
    step_gen = torch.Generator(dev).manual_seed(gen.sub_seed(ctx.seed,
                                                             "steps"))
    n_check = tr["checked_steps"]
    prog = {"loss": []}
    for k in range(n_check):
        m = step(state, *pool[k], step_gen)
        prog["loss"].append(float(m["loss"]))
        if k == 0:
            prog["grad"] = _host(fam.first_grad(state, p0))
            prog["stats"] = _host(fam.batch_stats(
                state, cfg["batchnorm"]["momentum"]))
    prog["params"] = _host(fam.params(state))
    prog["ema"] = _host(fam.ema(state))

    # the window
    timing.synchronize(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    clock = timing.StepClock(dev)
    host_ms, outs = [], []
    t0 = time.perf_counter()
    clock.mark()
    i = n_check
    # two steps at least: the p90 needs two step times
    while i < n_check + 2 or time.perf_counter() - t0 < ctx.seconds:
        h0 = time.perf_counter()
        outs.append(step(state, *pool[i % len(pool)], step_gen))
        host_ms.append((time.perf_counter() - h0) * 1e3)
        clock.mark()
        i += 1
    t_sent = time.perf_counter()
    timing.synchronize(dev)
    window_s = time.perf_counter() - t0
    setup_s = t0 - ctx.t_process
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    step_ms = timing.gaps_ms(clock.stamps_ms())
    losses = torch.stack([o["loss"].float() for o in outs]).cpu()
    failed = int((~torch.isfinite(losses)).sum())
    steps = len(outs)
    batch = tr["batch"]
    ctx.log(f"[train] window: {steps} steps in {window_s:.4f} s; the card "
            f"ran {(t0 + window_s - t_sent) * 1e3:.1f} ms past the last "
            f"dispatch; step ms median {statistics.median(step_ms):.2f}, "
            f"min {min(step_ms):.2f}, slowest "
            f"{[round(v, 2) for v in sorted(step_ms)[-6:]]}; host ms a "
            f"step median {statistics.median(host_ms):.2f}")
    e2e = {"train_images_per_s": timing.rate(steps * batch, window_s),
           "train_step_ms_p90": timing.percentile(step_ms, 90),
           "peak_mem_gib": peak / 2 ** 30, "setup_s": setup_s}
    record = {"kind": "train", "steps": steps, "batch": batch,
              "window_s": window_s, "host_ms": host_ms,
              "step_ms": step_ms, "config": cfg,
              "family": fam}
    profile = None
    if ctx.trace:
        n_prof = tr["trace_steps"]
        timing.synchronize(dev)
        with device_profile(dev) as prof:
            p0_t = time.perf_counter()
            for k in range(n_prof):
                step(state, *pool[(i + k) % len(pool)], step_gen)
            timing.synchronize(dev)
            prof_wall = time.perf_counter() - p0_t
        profile = reduce_profile(prof, prof_wall, fam.RTDETR_KERNELS)
        profile["steps"] = n_prof
        del prof
        record["profile"] = profile
        record["flops"] = {cfg["precision"]["detector"]:
                           fam.flops(cfg, batch, train=True) * steps}

    # the program's state goes before the reference runs
    del state, step, outs
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    ref_w = fam.weights(cfg, ctx.seed, dev)
    t_ref = time.perf_counter()
    with exact_float32():
        ref = fam.reference_train(cfg, ref_w, pool[:n_check],
                                  gen.sub_seed(ctx.seed, "steps"))
    numbers = compare(prog, ref, p0, ctx.log)
    ctx.log(f"[train] reference {time.perf_counter() - t_ref:.1f} s; "
            f"losses program {prog['loss']} reference {ref['loss']}")
    return {"attempted": steps, "failed": failed, "end_to_end": e2e,
            "record": record, "numbers": numbers, "peak_bytes": peak,
            "profile": profile}


def compare(prog: dict, ref: dict, p0: dict, log=None) -> dict:
    """The numbers of a train cell:

    loss_gap: the largest relative gap of a checked step's loss;
    grad_gap_median: the median leaf's gap of the first step's gradient
        norm (``checks.leaf_gaps``);
    change_gap_median, ema_gap_median: the median leaf's gap of the norm
        of the parameters' change over the checked steps, and of the
        EMA's, leaving out the leaves whose reference gradient is under a
        thousandth of the median leaf's;
    bn_gap_median: the median BatchNorm layer's gap of the first step's
        batch statistics: the larger of the norms of the mean's and the
        standard deviation's differences, over the norm of the reference's
        standard deviation.

    The worst leaf's gaps are logged beside them."""
    ref_g = checks.leaf_norms({n: g.cpu() for n, g in ref["grad"].items()})
    moved = checks.moved_leaves(ref_g)

    def change(after, names):
        return checks.leaf_norms({n: after[n].float().cpu() - p0[n]
                                  for n in names})
    pairs = {"grad": (checks.leaf_norms(prog["grad"]), ref_g),
             "change": (change(prog["params"], moved),
                        change(ref["params"], moved)),
             "ema": (change(prog["ema"], moved), change(ref["ema"], moved))}
    out = {"loss_gap": checks.loss_gap(prog["loss"], ref["loss"])}
    for what, (p, r) in pairs.items():
        gaps = checks.leaf_gaps(p, r)
        out[f"{what}_gap_median"] = gaps[len(gaps) // 2][1]
        if log is not None:
            log(f"[train] {what}: worst leaves {gaps[:4]}; median leaf gap "
                f"{gaps[len(gaps) // 2][1]}")
    bn = sorted(checks.bn_stat_gaps(prog["stats"], ref["stats"]),
                reverse=True)
    out["bn_gap_median"] = bn[len(bn) // 2][0]
    if log is not None:
        log(f"[train] first step's BatchNorm statistics, by layer: worst "
            f"{bn[:4]}; median {bn[len(bn) // 2][0]}; "
            f"{len(ref_g) - len(moved)} leaves left out of the change")
    return out


def control(ctx) -> dict:
    """The numbers of the control: the reference computed in the precision
    below the configuration's, put in the program's place, against the
    reference, on the inputs and weights of a run of `ctx.seed`."""
    cfg, tr, dev, fam = ctx.cell.config, ctx.cell.traffic, ctx.device, \
        ctx.family
    pool = gen.detection_pool(tr, cfg["imgsz"], cfg["nc"], ctx.seed, dev)
    n_check = tr["checked_steps"]
    w = fam.weights(cfg, ctx.seed, dev)
    p0 = _host(w)
    seed = gen.sub_seed(ctx.seed, "steps")
    with exact_float32():
        low = fam.reference_train(cfg, w, pool[:n_check], seed,
                                  BELOW[cfg["precision"]["detector"]])
        low = {"loss": low["loss"], "grad": _host(low["grad"]),
               "stats": _host(low["stats"]), "params": _host(low["params"]),
               "ema": _host(low["ema"])}
        ref = fam.reference_train(cfg, w, pool[:n_check], seed, "exact")
    return compare(low, ref, p0, ctx.log)
