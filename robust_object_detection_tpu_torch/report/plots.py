"""Figure generation from eval result JSONs (counterpart of
robust_object_detection_tpu/report/plots.py; host only, matplotlib imported
at the call).

Reference counterparts (all matplotlib, consuming eval_results.json):
  * plot_results.py — 5 DET figures: grouped mAP@50 bars (:80-112),
    degradation-% bars (:118-159), Aug-Base improvement bars (:165-204),
    per-class Blur heatmap (:210-238), 3-panel radar (:244-282),
  * plot_three_strategies.py — merges eval_results.json +
    eval_restored_results.json (:51-65): per-model strategy bars,
    improvement bars, radar, best-strategy heatmap,
  * plot_vid_results.py — the DET figure set for the 4 VID models.

The result dict shape is ours: {model: {variant: {mAP50, mAP50_95,
per_class_ap50: {class: ap}}}}. Figures are written as PNG under
``<out>/figures`` with the reference's filenames so downstream consumers
are drop-in.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Sequence

import numpy as np

VARIANTS = ("Test_Clean", "Test_Noise", "Test_Blur", "Test_LowRes")
VARIANT_LABELS = ("Clean", "Noise", "Blur", "LowRes")


def _plt():
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def _save(fig, out_dir: Path, name: str) -> Path:
    out_dir.mkdir(parents=True, exist_ok=True)
    path = out_dir / name
    fig.savefig(path, dpi=120, bbox_inches="tight")
    import matplotlib.pyplot as plt
    plt.close(fig)
    return path


def _map50(results: Dict, model: str, variant: str) -> float:
    return results.get(model, {}).get(variant, {}).get("mAP50", 0.0)


def grouped_map_bars(results: Dict, out_dir: Path,
                     name: str = "map50_by_testset.png",
                     metric: str = "mAP50") -> Path:
    plt = _plt()
    models = list(results)
    x = np.arange(len(VARIANTS))
    width = 0.8 / max(len(models), 1)
    fig, ax = plt.subplots(figsize=(10, 5))
    for i, m in enumerate(models):
        vals = [results[m].get(v, {}).get(metric, 0.0) for v in VARIANTS]
        ax.bar(x + i * width, vals, width, label=m)
    ax.set_xticks(x + width * (len(models) - 1) / 2)
    ax.set_xticklabels(VARIANT_LABELS)
    ax.set_ylabel(metric)
    ax.set_title(f"{metric} by test set")
    ax.legend(fontsize=8)
    ax.grid(axis="y", alpha=0.3)
    return _save(fig, out_dir, name)


def degradation_bars(results: Dict, out_dir: Path,
                     name: str = "degradation_pct.png") -> Path:
    plt = _plt()
    models = list(results)
    corr = VARIANTS[1:]
    x = np.arange(len(corr))
    width = 0.8 / max(len(models), 1)
    fig, ax = plt.subplots(figsize=(10, 5))
    for i, m in enumerate(models):
        clean = _map50(results, m, "Test_Clean")
        vals = [100.0 * (clean - _map50(results, m, v)) / clean
                if clean > 0 else 0.0 for v in corr]
        ax.bar(x + i * width, vals, width, label=m)
    ax.set_xticks(x + width * (len(models) - 1) / 2)
    ax.set_xticklabels(VARIANT_LABELS[1:])
    ax.set_ylabel("mAP@50 drop vs Clean (%)")
    ax.set_title("Robustness degradation")
    ax.legend(fontsize=8)
    ax.grid(axis="y", alpha=0.3)
    return _save(fig, out_dir, name)


def improvement_bars(results: Dict, out_dir: Path,
                     base_suffix: str = "_baseline",
                     aug_suffix: str = "_augmented",
                     name: str = "aug_improvement.png") -> Path:
    plt = _plt()
    stems = [m[: -len(base_suffix)] for m in results
             if m.endswith(base_suffix)
             and m[: -len(base_suffix)] + aug_suffix in results]
    x = np.arange(len(VARIANTS))
    width = 0.8 / max(len(stems), 1)
    fig, ax = plt.subplots(figsize=(10, 5))
    for i, s in enumerate(stems):
        vals = [_map50(results, s + aug_suffix, v)
                - _map50(results, s + base_suffix, v) for v in VARIANTS]
        ax.bar(x + i * width, vals, width, label=s)
    ax.axhline(0, color="k", lw=0.8)
    ax.set_xticks(x + width * (len(stems) - 1) / 2)
    ax.set_xticklabels(VARIANT_LABELS)
    ax.set_ylabel("Aug − Base mAP@50")
    ax.set_title("Augmented-training improvement")
    ax.legend(fontsize=8)
    ax.grid(axis="y", alpha=0.3)
    return _save(fig, out_dir, name)


def per_class_heatmap(results: Dict, out_dir: Path,
                      variant: str = "Test_Blur",
                      name: str = "per_class_blur_heatmap.png") -> Path:
    plt = _plt()
    models = [m for m in results
              if "per_class_ap50" in results[m].get(variant, {})]
    if not models:
        models = list(results)
    classes: List[str] = []
    grid = []
    for m in models:
        pc = results[m].get(variant, {}).get("per_class_ap50", {})
        if not classes:
            classes = list(pc)
        grid.append([pc.get(c, 0.0) for c in classes])
    grid = np.asarray(grid) if grid else np.zeros((1, 1))
    fig, ax = plt.subplots(figsize=(8, 0.6 * max(len(models), 2) + 2))
    im = ax.imshow(grid, cmap="viridis", aspect="auto", vmin=0)
    ax.set_xticks(range(len(classes)))
    ax.set_xticklabels(classes, rotation=30, ha="right")
    ax.set_yticks(range(len(models)))
    ax.set_yticklabels(models)
    for i in range(grid.shape[0]):
        for j in range(grid.shape[1]):
            ax.text(j, i, f"{grid[i, j]:.2f}", ha="center", va="center",
                    color="w", fontsize=7)
    ax.set_title(f"Per-class AP@50 — {variant}")
    fig.colorbar(im, ax=ax, shrink=0.8)
    return _save(fig, out_dir, name)


def radar(results: Dict, out_dir: Path, groups: Sequence[Sequence[str]],
          name: str = "radar.png") -> Path:
    """N-panel radar over the 4 test sets, one panel per model group."""
    plt = _plt()
    angles = np.linspace(0, 2 * np.pi, len(VARIANTS), endpoint=False)
    angles = np.concatenate([angles, angles[:1]])
    fig, axes = plt.subplots(1, max(len(groups), 1), figsize=(
        5 * max(len(groups), 1), 5), subplot_kw={"projection": "polar"})
    if len(groups) == 1:
        axes = [axes]
    for ax, group in zip(np.ravel(axes), groups):
        for m in group:
            if m not in results:
                continue
            vals = [_map50(results, m, v) for v in VARIANTS]
            vals = vals + vals[:1]
            ax.plot(angles, vals, label=m, lw=1.5)
            ax.fill(angles, vals, alpha=0.1)
        ax.set_xticks(angles[:-1])
        ax.set_xticklabels(VARIANT_LABELS, fontsize=8)
        ax.set_ylim(0, 1)
        ax.legend(fontsize=7, loc="lower right")
    return _save(fig, out_dir, name)


def det_figure_suite(results: Dict, out_dir: str | Path,
                     prefix: str = "") -> List[Path]:
    """The reference's 5-figure DET set (plot_results.py)."""
    out_dir = Path(out_dir)
    stems = sorted({m.rsplit("_", 1)[0] for m in results})
    paths = [
        grouped_map_bars(results, out_dir, f"{prefix}map50_by_testset.png"),
        grouped_map_bars(results, out_dir, f"{prefix}map5095_by_testset.png",
                         metric="mAP50_95"),
        degradation_bars(results, out_dir, f"{prefix}degradation_pct.png"),
        improvement_bars(results, out_dir, f"{prefix}aug_improvement.png"),
        per_class_heatmap(results, out_dir,
                          name=f"{prefix}per_class_blur_heatmap.png"),
        radar(results, out_dir,
              groups=[[f"{s}_baseline", f"{s}_augmented"] for s in stems],
              name=f"{prefix}radar.png"),
    ]
    return paths


def three_strategy_suite(results: Dict, restored: Dict,
                         out_dir: str | Path) -> List[Path]:
    """plot_three_strategies.py: merge Baseline/Augmented/Restored."""
    plt = _plt()
    out_dir = Path(out_dir)
    paths = []
    stems = sorted({m[: -len("_baseline")] for m in results
                    if m.endswith("_baseline")})
    # per-model 3-strategy bars
    for stem in stems:
        strategies = {
            "Baseline": results.get(f"{stem}_baseline", {}),
            "Augmented": results.get(f"{stem}_augmented", {}),
            "Restored": restored.get(f"{stem}_baseline", {}),
        }
        x = np.arange(len(VARIANTS))
        width = 0.25
        fig, ax = plt.subplots(figsize=(8, 4.5))
        for i, (label, per_variant) in enumerate(strategies.items()):
            vals = [per_variant.get(v, {}).get("mAP50", 0.0)
                    for v in VARIANTS]
            ax.bar(x + i * width, vals, width, label=label)
        ax.set_xticks(x + width)
        ax.set_xticklabels(VARIANT_LABELS)
        ax.set_ylabel("mAP@50")
        ax.set_title(f"{stem}: three strategies")
        ax.legend(fontsize=8)
        ax.grid(axis="y", alpha=0.3)
        paths.append(_save(fig, out_dir, f"three_strategies_{stem}.png"))

    def strat_map50(stem: str, strat: str, v: str) -> float:
        if strat == "Baseline":
            return _map50(results, f"{stem}_baseline", v)
        if strat == "Augmented":
            return _map50(results, f"{stem}_augmented", v)
        return restored.get(f"{stem}_baseline", {}).get(v, {}).get(
            "mAP50", 0.0)

    # strategy-effectiveness bars: per model, (strategy − baseline) per
    # corruption variant (plot_three_strategies.py:115-158)
    corr = VARIANTS[1:]
    x = np.arange(len(corr))
    width = 0.3
    fig, axes = plt.subplots(1, max(len(stems), 1),
                             figsize=(5 * max(len(stems), 1), 5.5),
                             sharey=True, squeeze=False)
    for idx, stem in enumerate(stems):
        ax = axes[0][idx]
        for j, strat in enumerate(("Augmented", "Restored")):
            diffs = [strat_map50(stem, strat, v)
                     - strat_map50(stem, "Baseline", v) for v in corr]
            bars = ax.bar(x + (j - 0.5) * width, diffs, width * 0.85,
                          label=strat)
            for bar, val in zip(bars, diffs):
                ax.text(bar.get_x() + bar.get_width() / 2,
                        bar.get_height() + (0.005 if val >= 0 else -0.005),
                        f"{val:+.3f}", ha="center",
                        va="bottom" if val >= 0 else "top", fontsize=8)
        ax.set_title(stem)
        ax.set_xticks(x)
        ax.set_xticklabels(VARIANT_LABELS[1:])
        ax.axhline(0, color="k", lw=0.8)
        ax.grid(axis="y", alpha=0.3)
        if idx == 0:
            ax.set_ylabel("mAP@50 change from Baseline")
    if stems:
        axes[0][0].legend(fontsize=8)
    fig.suptitle("Strategy effectiveness: improvement over Baseline")
    paths.append(_save(fig, out_dir, "strategy_improvement.png"))

    # 3-strategy radar: one polar panel per model, Baseline/Augmented/
    # Restored profiles over the 4 test sets (plot_three_strategies.py:
    # 164-197)
    angles = np.linspace(0, 2 * np.pi, len(VARIANTS), endpoint=False)
    angles = np.concatenate([angles, angles[:1]])
    fig, axes = plt.subplots(1, max(len(stems), 1),
                             figsize=(5 * max(len(stems), 1), 5.5),
                             subplot_kw={"projection": "polar"},
                             squeeze=False)
    for idx, stem in enumerate(stems):
        ax = axes[0][idx]
        for strat in ("Baseline", "Augmented", "Restored"):
            vals = [strat_map50(stem, strat, v) for v in VARIANTS]
            vals = vals + vals[:1]
            ax.plot(angles, vals, lw=2, marker="o", ms=4, label=strat)
            ax.fill(angles, vals, alpha=0.1)
        ax.set_xticks(angles[:-1])
        ax.set_xticklabels(VARIANT_LABELS, fontsize=9)
        ax.set_ylim(0, 0.75)
        ax.set_title(stem, pad=18)
    if stems:
        axes[0][0].legend(fontsize=8, loc="lower center",
                          bbox_to_anchor=(0.5, -0.3), ncol=3)
    fig.suptitle("Robustness profile: 3 strategies (mAP@50)")
    paths.append(_save(fig, out_dir, "three_strategy_radar.png"))

    # best-strategy heatmap: which strategy wins per (model, variant)
    grid = np.zeros((len(stems), len(VARIANTS)))
    annot = []
    for i, stem in enumerate(stems):
        row = []
        for j, v in enumerate(VARIANTS):
            base = results.get(f"{stem}_baseline", {}).get(v, {}).get(
                "mAP50", 0.0)
            aug = results.get(f"{stem}_augmented", {}).get(v, {}).get(
                "mAP50", 0.0)
            rest = restored.get(f"{stem}_baseline", {}).get(v, {}).get(
                "mAP50", 0.0)
            best = max(aug, rest)
            grid[i, j] = best - base
            row.append(("A" if aug >= rest else "R") +
                       f" +{best - base:.3f}")
        annot.append(row)
    fig, ax = plt.subplots(figsize=(8, 1 + 0.6 * len(stems)))
    im = ax.imshow(grid, cmap="RdYlGn", aspect="auto")
    ax.set_xticks(range(len(VARIANTS)))
    ax.set_xticklabels(VARIANT_LABELS)
    ax.set_yticks(range(len(stems)))
    ax.set_yticklabels(stems)
    for i in range(len(stems)):
        for j in range(len(VARIANTS)):
            ax.text(j, i, annot[i][j], ha="center", va="center", fontsize=8)
    ax.set_title("Best strategy vs baseline (A=Augmented, R=Restored)")
    fig.colorbar(im, ax=ax, shrink=0.8)
    paths.append(_save(fig, out_dir, "best_strategy_heatmap.png"))
    return paths


def training_curves(history: List[dict], out_dir: str | Path,
                    name: str = "training_curve.png") -> Path:
    """Loss/metric curves from a history.jsonl record list."""
    plt = _plt()
    out_dir = Path(out_dir)
    fig, ax = plt.subplots(figsize=(8, 4.5))
    epochs = [h.get("epoch", i) for i, h in enumerate(history)]
    ax.plot(epochs, [h.get("train_loss", np.nan) for h in history],
            label="train loss")
    ax2 = ax.twinx()
    val_key = next((k for k in ("val_psnr", "mAP50") if any(
        k in h for h in history)), None)
    if val_key:
        pts = [(e, h[val_key]) for e, h in zip(epochs, history)
               if val_key in h]
        if pts:
            ax2.plot(*zip(*pts), "g.-", label=val_key)
            ax2.set_ylabel(val_key)
    ax.set_xlabel("epoch")
    ax.set_ylabel("loss")
    ax.grid(alpha=0.3)
    return _save(fig, out_dir, name)
