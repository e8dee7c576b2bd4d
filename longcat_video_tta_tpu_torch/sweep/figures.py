"""Paper-figure generation from all_results.json + loss_curves.json (the
PyTorch port's copy of ``longcat_video_tta_tpu/sweep/figures.py``, host
only, matplotlib's Agg backend): it reads what the port's
``sweep/export_results.py`` and ``sweep/export_loss_curves.py`` write.

    python -m longcat_video_tta_tpu_torch.sweep.figures \
        --all-results all_results.json [--loss-curves loss_curves.json] \
        --output-dir figures/

Rebuild of paper_figures/generate_figures.py (SURVEY.md §2.6/L5; the
reference ships 23 fig_* builders, generate_figures.py:417-2092).
All 23 families are covered: method comparison, quality-vs-params
Pareto, LR / step-count sweeps, cond-frames / gen-horizon ablations,
AdaSteer groups + ratio + extended-data, LoRA analysis, cross-dataset,
batch-K, naive-methods, all-runs scatter, ES time savings, time-cost,
CLIP-gate summary + threshold calibration, summary table, and four
loss-curve variants. Each builder is skipped gracefully when its data
slice is absent.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Any, Dict, List

import numpy as np

import matplotlib

matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402


def _complete(runs: List[Dict]) -> List[Dict]:
    return [r for r in runs if r.get("status") == "complete"
            and r.get("psnr_mean") is not None]


def _save(fig, out_dir: str, name: str) -> str:
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"{name}.png")
    fig.savefig(path, dpi=150, bbox_inches="tight")
    plt.close(fig)
    print(f"[figures] {path}")
    return path


_METRIC_PANELS = (("psnr", "PSNR (dB)", False),
                  ("ssim", "SSIM", False),
                  ("lpips", "LPIPS (lower is better)", True))


def _best_per_method(rows, key="delta_psnr"):
    best: Dict[str, Dict] = {}

    def val(r):
        # `is not None`, not truthiness: a legitimate 0.0 metric must
        # not be treated as missing
        v = r.get(key)
        return v if v is not None else -1e9

    for r in rows:
        m = r["method"]
        if m not in best or val(r) > val(best[m]):
            best[m] = r
    return best


def _metric_bars(ax, best, methods, metric, label):
    means = [best[m].get(f"{metric}_mean") for m in methods]
    stds = [best[m].get(f"{metric}_std") or 0.0 for m in methods]
    ok = [i for i, v in enumerate(means) if v is not None]
    ax.bar([methods[i] for i in ok], [means[i] for i in ok],
           yerr=[stds[i] for i in ok], capsize=3, color="#2a9d8f",
           alpha=0.85)
    ax.set_ylabel(label)
    ax.tick_params(axis="x", labelsize=8, rotation=30)


def fig_method_comparison(runs, out_dir):
    """Best run per method: ΔPSNR ranking + per-metric absolute bars +
    combined 3-panel (reference fig_method_comparison emits the full
    chart set, generate_figures.py:417-449)."""
    rows = [r for r in _complete(runs) if r.get("delta_psnr") is not None]
    if not rows:
        return None
    best = _best_per_method(rows)
    methods = sorted(best, key=lambda m: best[m]["delta_psnr"])
    deltas = [best[m]["delta_psnr"] for m in methods]
    fig, ax = plt.subplots(figsize=(7, 4))
    colors = ["#2a9d8f" if d >= 0 else "#e76f51" for d in deltas]
    ax.barh(methods, deltas, color=colors)
    ax.axvline(0, color="k", lw=0.8)
    ax.set_xlabel("best ΔPSNR vs matched no-TTA baseline (dB)")
    ax.set_title("TTA method comparison")
    made = [_save(fig, out_dir, "method_comparison")]

    # per-metric absolute charts + combined panel
    for metric, label, _lower in _METRIC_PANELS:
        if not any(best[m].get(f"{metric}_mean") is not None
                   for m in methods):
            continue
        fig, ax = plt.subplots(figsize=(7, 4))
        _metric_bars(ax, best, methods, metric, label)
        ax.set_title(f"Method comparison — {metric.upper()}")
        made.append(_save(fig, out_dir, f"method_comparison_{metric}"))
    fig, axes = plt.subplots(1, 3, figsize=(15, 4))
    for ax, (metric, label, _lower) in zip(axes, _METRIC_PANELS):
        _metric_bars(ax, best, methods, metric, label)
        ax.set_title(metric.upper())
    fig.suptitle("Method comparison — all metrics", fontweight="bold")
    fig.tight_layout()
    made.append(_save(fig, out_dir, "method_comparison_all_metrics"))
    return made


def fig_pareto_quality_vs_params(runs, out_dir):
    """PSNR delta vs trainable params (reference: Pareto figure)."""
    rows = [r for r in _complete(runs)
            if r.get("delta_psnr") is not None and r.get("trainable_params")]
    if not rows:
        return None
    fig, ax = plt.subplots(figsize=(7, 4.5))
    by_m: Dict[str, List[Dict]] = {}
    for r in rows:
        by_m.setdefault(r["method"], []).append(r)
    for m, rs in sorted(by_m.items()):
        ax.scatter([r["trainable_params"] for r in rs],
                   [r["delta_psnr"] for r in rs], label=m, s=36, alpha=0.8)
    ax.set_xscale("log")
    ax.axhline(0, color="k", lw=0.8)
    ax.set_xlabel("trainable parameters")
    ax.set_ylabel("ΔPSNR (dB)")
    ax.set_title("Quality vs adapted parameter count")
    ax.legend(fontsize=8)
    made = [_save(fig, out_dir, "pareto_quality_vs_params")]

    # time-vs-PSNR panel (reference emits pareto_time_vs_psnr too,
    # generate_figures.py:505-544)
    trows = [r for r in rows if r.get("avg_train_time")]
    if trows:
        best = _best_per_method(trows)
        fig, ax = plt.subplots(figsize=(7, 4.5))
        for m, r in sorted(best.items()):
            ax.scatter(r["avg_train_time"], r["psnr_mean"], s=60,
                       edgecolors="white", zorder=10)
            ax.annotate(m, (r["avg_train_time"], r["psnr_mean"]),
                        textcoords="offset points", xytext=(8, 4),
                        fontsize=8)
        ax.set_xlabel("mean TTA train time per video (s)")
        ax.set_ylabel("PSNR (dB)")
        ax.set_title("Quality vs TTA time cost")
        made.append(_save(fig, out_dir, "pareto_time_vs_psnr"))
    return made


def _sweep_line(runs, out_dir, xkey: str, name: str, xlabel: str,
                logx=False):
    rows = [r for r in _complete(runs) if r.get(xkey) is not None]
    if len({r[xkey] for r in rows}) < 2:
        return None
    fig, ax = plt.subplots(figsize=(6.5, 4))
    by_m: Dict[str, List[Dict]] = {}
    for r in rows:
        by_m.setdefault(r["method"], []).append(r)
    for m, rs in sorted(by_m.items()):
        pts: Dict[Any, List[float]] = {}
        for r in rs:
            pts.setdefault(r[xkey], []).append(r["psnr_mean"])
        xs = sorted(pts)
        ys = [np.mean(pts[x]) for x in xs]
        ax.plot(xs, ys, marker="o", label=m)
    if logx:
        ax.set_xscale("log")
    ax.set_xlabel(xlabel)
    ax.set_ylabel("PSNR (dB)")
    ax.set_title(f"{xlabel} sweep")
    ax.legend(fontsize=8)
    return _save(fig, out_dir, name)


def _best_line(rows, out_dir, xkey, name, title, xlabel, *, logx=False,
               color="#2a9d8f", marker="D"):
    """Best-PSNR-per-x single-series line (shared by the AdaSteer LR
    detail and the delta_c iteration sweep)."""
    if len({r[xkey] for r in rows}) < 2:
        return None
    pts: Dict[Any, float] = {}
    for r in rows:
        pts[r[xkey]] = max(pts.get(r[xkey], -1e9), r["psnr_mean"])
    xs = sorted(pts)
    fig, ax = plt.subplots(figsize=(7, 5))
    ax.plot(xs, [pts[x] for x in xs], ls="-", marker=marker, color=color,
            markersize=6, markeredgecolor="white", lw=1.8)
    if logx:
        ax.set_xscale("log")
    ax.set_xlabel(xlabel)
    ax.set_ylabel("PSNR (dB)")
    ax.set_title(title, fontweight="bold")
    return _save(fig, out_dir, name)


def fig_lr_sweep(runs, out_dir):
    made = [_sweep_line(runs, out_dir, "lr", "lr_sweep", "learning rate",
                        logx=True)]
    # AdaSteer LR-sensitivity detail: best PSNR per lr over every
    # delta_b row (reference lr_sweep_adasteer_detail combines the main
    # sweep with the low-lr series, generate_figures.py:590-614)
    db = [r for r in _complete(runs)
          if r.get("method") == "delta_b" and r.get("lr")]
    made.append(_best_line(db, out_dir, "lr", "lr_sweep_adasteer_detail",
                           "AdaSteer learning-rate sensitivity",
                           "learning rate", logx=True))
    return [m for m in made if m] or None


def fig_steps_sweep(runs, out_dir):
    return _sweep_line(runs, out_dir, "steps", "steps_sweep", "TTA steps")


def fig_cond_frames(runs, out_dir):
    return _sweep_line(runs, out_dir, "cond", "cond_frames",
                       "conditioning frames")


def fig_gen_horizon(runs, out_dir):
    return _sweep_line(runs, out_dir, "gen", "gen_horizon",
                       "generated frames")


def fig_time_cost(runs, out_dir):
    """PSNR delta vs per-video train time (reference: time-cost figs,
    generate_figures.py:1525-1584)."""
    rows = [r for r in _complete(runs)
            if r.get("delta_psnr") is not None and r.get("avg_train_time")]
    if not rows:
        return None
    fig, ax = plt.subplots(figsize=(6.5, 4))
    by_m: Dict[str, List[Dict]] = {}
    for r in rows:
        by_m.setdefault(r["method"], []).append(r)
    for m, rs in sorted(by_m.items()):
        ax.scatter([r["avg_train_time"] for r in rs],
                   [r["delta_psnr"] for r in rs], label=m, s=36, alpha=0.8)
    ax.axhline(0, color="k", lw=0.8)
    ax.set_xlabel("per-video TTA time (s)")
    ax.set_ylabel("ΔPSNR (dB)")
    ax.set_title("Quality vs adaptation cost")
    ax.legend(fontsize=8)
    made = [_save(fig, out_dir, "time_cost")]

    # reference emits two bar charts besides the scatter
    # (generate_figures.py:1525-1584): per-method train time and the
    # train/generation-time ratio
    best = _best_per_method(rows)
    methods = sorted(best, key=lambda m: best[m]["avg_train_time"])
    fig, ax = plt.subplots(figsize=(5.5, 4.5))
    for i, m in enumerate(methods):
        tt = best[m]["avg_train_time"]
        ax.bar(i, tt, 0.82, color="#2a9d8f", zorder=3)
        ax.text(i, tt * 1.02, f"{tt:.0f}s", ha="center", fontsize=9)
    ax.set_xticks(range(len(methods)))
    ax.set_xticklabels(methods, fontsize=9, rotation=20)
    ax.set_ylabel("training time per video (s)")
    ax.set_title("TTA training cost per video", fontweight="bold")
    made.append(_save(fig, out_dir, "train_time"))

    ratio_rows = [m for m in methods if best[m].get("avg_gen_time")]
    if ratio_rows:
        fig, ax = plt.subplots(figsize=(5.5, 4.5))
        for i, m in enumerate(ratio_rows):
            ratio = best[m]["avg_train_time"] / best[m]["avg_gen_time"]
            ax.bar(i, ratio, 0.82, color="#2a9d8f", zorder=3)
            ax.text(i, ratio * 1.02, f"{ratio:.2f}x", ha="center",
                    fontsize=9)
        ax.axhline(1.0, color="#888888", ls="--", lw=1.0, alpha=0.55,
                   zorder=0)
        ax.set_xticks(range(len(ratio_rows)))
        ax.set_xticklabels(ratio_rows, fontsize=9, rotation=20)
        ax.set_ylabel("train time / generation time")
        ax.set_title("Training overhead relative to generation",
                     fontweight="bold")
        made.append(_save(fig, out_dir, "train_gen_ratio"))
    return made


_ES_METRIC_PANELS = (("psnr_mean", "PSNR (dB)"), ("ssim_mean", "SSIM"),
                     ("lpips_mean", "LPIPS"))


def _es_series_colors(rows):
    palette = ["#264653", "#2a9d8f", "#e9c46a", "#f4a261", "#e76f51",
               "#8ab17d", "#6d597a"]
    series = sorted({r.get("series", "") for r in rows})
    cmap = {s: palette[i % len(palette)] for i, s in enumerate(series)}
    return series, cmap


def _es_metric_scatter(ax, rows, xs, key, label, colors, ref_val=None):
    ax.scatter(xs, [r.get(key) for r in rows], c=colors, s=64,
               edgecolors="white", linewidths=0.8, zorder=5)
    ax.set_ylabel(label, fontsize=10)
    if ref_val is not None:
        ax.axhline(ref_val, color="#888888", ls=":", lw=1.0, alpha=0.6,
                   zorder=0)


def fig_es_time_savings(runs, out_dir):
    """The reference's 5-chart ES time-savings family
    (fig_early_stopping_time_savings, generate_figures.py:1241-1373):
    train time vs videos-stopped-early, per-metric stability panels, the
    combined two-panel, time-saved, and train-time-vs-metric charts."""
    def _stopped_count(r):
        # pre-r3 exports carry only es_stopped_ratio; derive the count
        # so old all_results.json files still render the full family
        if r.get("es_stopped_count") is not None:
            return r["es_stopped_count"]
        ratio = r.get("es_stopped_ratio")
        n = r.get("es_total_count") or r.get("num_success") \
            or r.get("num_videos")
        if ratio is not None and n:
            return int(round(ratio * n))
        return None

    rows = [r for r in _complete(runs)
            if _stopped_count(r) is not None and r.get("avg_train_time")]
    if not rows:
        return None
    # no-ES reference time: es-disabled rows if present, else the
    # slowest row (the reference pins series es_ablation_disable)
    def _es_off(r):
        return bool((r.get("config") or {}).get("es_disable")) \
            or "disable" in str(r.get("series", ""))
    no_es = [r for r in rows if _es_off(r)]
    no_es_time = (np.mean([r["avg_train_time"] for r in no_es])
                  if no_es else max(r["avg_train_time"] for r in rows))

    def _es_ref(key):
        # per-metric no-ES reference: mean over ALL es-disabled rows
        # (not an arbitrary first row)
        vals = [r[key] for r in no_es if r.get(key) is not None]
        return float(np.mean(vals)) if vals else None

    n_early = [_stopped_count(r) for r in rows]
    train_t = [r["avg_train_time"] for r in rows]
    series, cmap = _es_series_colors(rows)
    colors = [cmap[r.get("series", "")] for r in rows]

    def _legend(ax, with_no_es=False):
        from matplotlib.lines import Line2D
        handles = [Line2D([0], [0], marker="o", color="w",
                          markerfacecolor=cmap[s], markersize=8, label=s)
                   for s in series]
        if with_no_es:
            handles.insert(0, Line2D(
                [0], [0], color="#888888", ls="--", lw=1.2,
                label="no early stopping"))
        ax.legend(handles=handles, frameon=False, fontsize=7)

    # 1. train time vs # early
    fig, ax = plt.subplots(figsize=(6.5, 4.5))
    ax.axhline(no_es_time, color="#888888", ls="--", lw=1.2, alpha=0.7,
               zorder=0, label="no early stopping")
    ax.scatter(n_early, train_t, c=colors, s=72, edgecolors="white",
               linewidths=1.0, zorder=5)
    ax.set_xlabel("videos stopped early")
    ax.set_ylabel("mean training time per video (s)")
    ax.set_title("Early stopping reduces training time",
                 fontweight="bold")
    _legend(ax, with_no_es=True)
    made = [_save(fig, out_dir, "es_time_vs_early")]

    # 2. metric stability vs # early (3 stacked panels)
    fig, axes = plt.subplots(3, 1, figsize=(6.5, 8), sharex=True)
    for ax, (key, label) in zip(axes, _ES_METRIC_PANELS):
        _es_metric_scatter(ax, rows, n_early, key, label, colors,
                           _es_ref(key))
    axes[2].set_xlabel("videos stopped early")
    axes[0].set_title("Performance unchanged across ES settings",
                      fontweight="bold")
    fig.tight_layout()
    made.append(_save(fig, out_dir, "es_metrics_vs_early"))

    # 3. two-panel: time + metric row
    fig = plt.figure(figsize=(12, 5))
    gs = fig.add_gridspec(1, 2, width_ratios=[1, 1.2])
    ax_time = fig.add_subplot(gs[0])
    ax_time.axhline(no_es_time, color="#888888", ls="--", lw=1.2,
                    alpha=0.7, zorder=0)
    ax_time.scatter(n_early, train_t, c=colors, s=64,
                    edgecolors="white", linewidths=1.0, zorder=5)
    ax_time.set_xlabel("videos stopped early")
    ax_time.set_ylabel("mean training time (s)")
    ax_time.set_title("Training time", fontweight="bold")
    gs_right = gs[1].subgridspec(1, 3)
    for i, (key, label) in enumerate(_ES_METRIC_PANELS):
        ax = fig.add_subplot(gs_right[0, i])
        _es_metric_scatter(ax, rows, n_early, key, label, colors,
                           _es_ref(key))
        ax.set_xlabel("# early", fontsize=9)
    fig.suptitle("Early stopping: time savings without quality loss",
                 fontweight="bold")
    fig.tight_layout()
    made.append(_save(fig, out_dir, "es_time_savings_two_panel"))

    # 4. time saved vs # early
    saved = [no_es_time - t for t in train_t]
    fig, ax = plt.subplots(figsize=(6.5, 4.5))
    ax.scatter(n_early, saved, c=colors, s=72, edgecolors="white",
               linewidths=1.0, zorder=5)
    ax.axhline(0, color="#888888", ls="--", lw=1.0, alpha=0.5, zorder=0)
    ax.set_xlabel("videos stopped early")
    ax.set_ylabel("time saved per video (s)")
    ax.set_title("Time saved vs videos stopped early", fontweight="bold")
    _legend(ax, with_no_es=True)
    made.append(_save(fig, out_dir, "es_time_saved_vs_early"))

    # 5. train time vs metrics (1x3)
    fig, axes = plt.subplots(1, 3, figsize=(11, 4), sharex=True)
    for ax, (key, label) in zip(axes, _ES_METRIC_PANELS):
        _es_metric_scatter(ax, rows, train_t, key, label, colors,
                           _es_ref(key))
        ax.set_xlabel("mean TTA train time (s)")
    fig.suptitle("Metrics vs mean TTA train time (ES ablations)",
                 fontweight="bold")
    fig.tight_layout()
    made.append(_save(fig, out_dir, "es_train_time_vs_metrics"))
    # legacy single-chart name kept for downstream links
    fig, ax = plt.subplots(figsize=(6.5, 4))
    ratios = [r["es_stopped_ratio"] if r.get("es_stopped_ratio")
              is not None
              else _stopped_count(r) / max(r.get("es_total_count")
                                           or r.get("num_success") or 1, 1)
              for r in rows]
    ax.scatter(ratios, train_t, c=colors, s=36, alpha=0.8)
    ax.set_xlabel("fraction of videos stopped early")
    ax.set_ylabel("per-video TTA time (s)")
    ax.set_title("Early stopping time savings")
    made.append(_save(fig, out_dir, "es_time_savings"))
    return made


def fig_early_stopping(runs, out_dir):
    """ES-ablation comparison (reference fig_early_stopping,
    generate_figures.py:1423): PSNR line over the swept ES knob with a
    %-videos-stopped twin bar axis, one panel per ablation series
    (patience + check frequency)."""
    panels = []
    for series, cfg_key, xlabel in (
            ("es_ablation_patience", "es_patience", "Patience"),
            ("es_ablation_check_freq", "es_check_every",
             "Check every N steps")):
        rows = [r for r in _complete(runs)
                if r.get("series") == series
                and (r.get("config") or {}).get(cfg_key) is not None]
        rows.sort(key=lambda r: r["config"][cfg_key])
        if rows:
            panels.append((rows, cfg_key, xlabel))
    if not panels:
        return None
    fig, axes = plt.subplots(1, len(panels), figsize=(6 * len(panels), 5),
                             squeeze=False)
    for ax, (rows, cfg_key, xlabel) in zip(axes[0], panels):
        xs = [r["config"][cfg_key] for r in rows]
        psnrs = [r["psnr_mean"] for r in rows]
        stopped = [100.0 * (r.get("es_stopped_ratio") or 0.0)
                   for r in rows]
        ax2 = ax.twinx()
        ax2.bar(xs, stopped, 0.6, color="#bcd4d0", alpha=0.5, zorder=1)
        ax2.set_ylabel("% videos stopped early", color="#666666")
        ax2.set_ylim(0, 105)
        ax.set_zorder(ax2.get_zorder() + 1)
        ax.patch.set_visible(False)
        ax.plot(xs, psnrs, "-o", color="#2a9d8f", markersize=6,
                markeredgecolor="white", lw=1.8, zorder=10)
        ax.set_xlabel(xlabel)
        ax.set_ylabel("PSNR (dB)", color="#2a9d8f")
        ax.set_title(f"Early stopping: {xlabel}", fontweight="bold")
    fig.tight_layout()
    made = [_save(fig, out_dir, "es_ablation")]

    # patience vs train time vs PSNR (reference
    # _fig_es_patience_train_time_psnr: PSNR-colored scatter with the
    # mean generation time as a cost-context line)
    prows = [r for r in _complete(runs)
             if r.get("series") == "es_ablation_patience"
             and (r.get("config") or {}).get("es_patience") is not None
             and r.get("avg_train_time")]
    if len(prows) >= 2:
        pat = [r["config"]["es_patience"] for r in prows]
        tt = [r["avg_train_time"] for r in prows]
        ps = [r["psnr_mean"] for r in prows]
        fig, ax = plt.subplots(figsize=(7, 5))
        sc = ax.scatter(pat, tt, c=ps, s=120, cmap="viridis",
                        edgecolors="white", linewidths=2, zorder=5)
        fig.colorbar(sc, ax=ax, shrink=0.7).set_label("PSNR (dB)")
        gen_ts = [r["avg_gen_time"] for r in prows
                  if r.get("avg_gen_time")]
        if gen_ts:
            ax.axhline(np.mean(gen_ts), color="#888888", ls="--",
                       lw=1.2, alpha=0.85, label="avg inference time")
            ax.legend(frameon=False, fontsize=9)
        for p_, t_, v_ in zip(pat, tt, ps):
            ax.annotate(f"{v_:.2f}", (p_, t_),
                        textcoords="offset points", xytext=(0, 8),
                        ha="center", fontsize=9)
        ax.set_xlabel("patience")
        ax.set_ylabel("mean TTA training time per video (s)")
        ax.set_title("Patience vs training time vs PSNR",
                     fontweight="bold")
        made.append(_save(fig, out_dir, "es_patience_train_time_psnr"))

    # long-train ES overview (reference long_train_es barh: total steps
    # vs average best step, with the stopped-early count)
    lrows = sorted(
        [r for r in _complete(runs)
         if "long_train" in str(r.get("series", ""))
         and r.get("es_best_step_mean") is not None and r.get("steps")],
        key=lambda r: r["steps"])
    if lrows:
        fig, ax = plt.subplots(figsize=(8, 4))
        labels = []
        for i, r in enumerate(lrows):
            total = r["steps"]
            best = r["es_best_step_mean"]
            labels.append(f"{r.get('method', '?')}\n({total} steps)")
            ax.barh(i, total, color="#f1e4c0", edgecolor="#cccccc",
                    height=0.55, zorder=1)
            ax.barh(i, best, color="#2a9d8f", height=0.55, zorder=2)
            ax.text(best + total * 0.02, i,
                    f"avg best = step {best:.0f}  "
                    f"({r.get('es_stopped_count', 0)} stopped early)",
                    va="center", fontsize=9, zorder=3)
        ax.set_yticks(range(len(labels)))
        ax.set_yticklabels(labels)
        ax.set_xlabel("training steps")
        ax.set_title("Early stopping on long training runs",
                     fontweight="bold")
        ax.invert_yaxis()
        made.append(_save(fig, out_dir, "long_train_es"))
    return made


def fig_loss_curves(curves: List[Dict], out_dir):
    """Mean±std anchor-loss curves (reference: 4 loss-curve figures)."""
    if not curves:
        return None
    fig, ax = plt.subplots(figsize=(6.5, 4))
    for c in curves[:8]:
        steps = np.asarray(c["steps"])
        mean = np.asarray(c["mean"])
        std = np.asarray(c["std"])
        label = f"{c['series']}/{c['run_id']}"
        ax.plot(steps, mean, marker="o", ms=3, label=label)
        ax.fill_between(steps, mean - std, mean + std, alpha=0.15)
    ax.set_xlabel("TTA step")
    ax.set_ylabel("anchor loss")
    ax.set_title("Anchored ES loss curves (mean ± std over videos)")
    ax.legend(fontsize=7)
    return _save(fig, out_dir, "loss_curves")


def fig_summary_table(runs, out_dir):
    """Rendered summary table (reference: fig_summary_table)."""
    rows = _complete(runs)
    if not rows:
        return None
    cols = ["series", "run_id", "method", "psnr_mean", "delta_psnr",
            "ssim_mean", "avg_train_time"]
    cell_rows = []
    for r in sorted(rows, key=lambda x: -(x.get("delta_psnr") or -1e9))[:20]:
        cell_rows.append([
            str(r.get("series", ""))[:18], str(r.get("run_id", ""))[:16],
            str(r.get("method", "")),
            f"{r.get('psnr_mean', float('nan')):.3f}",
            f"{r.get('delta_psnr', float('nan')):.3f}"
            if r.get("delta_psnr") is not None else "—",
            f"{r.get('ssim_mean', float('nan')):.3f}",
            f"{r.get('avg_train_time') or 0:.1f}",
        ])
    fig, ax = plt.subplots(figsize=(10, 0.4 * len(cell_rows) + 1))
    ax.axis("off")
    table = ax.table(cellText=cell_rows, colLabels=cols, loc="center")
    table.auto_set_font_size(False)
    table.set_fontsize(8)
    ax.set_title("Top runs by ΔPSNR")
    return _save(fig, out_dir, "summary_table")


def fig_batch_k(runs, out_dir):
    """Retrieval batch-TTA K sweep (reference: exp5 figures — PSNR
    degrades as the shared adapter spreads over more neighbours)."""
    return _sweep_line(runs, out_dir, "batch_videos", "batch_k",
                       "batch videos K")


def fig_clip_gate_summary(runs, out_dir):
    """Gate skip ratio vs PSNR delta (reference: CLIP-gate summary)."""
    rows = [r for r in _complete(runs)
            if r.get("clip_gate_skip_ratio") is not None
            and r.get("delta_psnr") is not None]
    if not rows:
        return None
    fig, ax = plt.subplots(figsize=(6.5, 4))
    ax.scatter([r["clip_gate_skip_ratio"] for r in rows],
               [r["delta_psnr"] for r in rows], s=36, alpha=0.8)
    ax.set_xlabel("gate skip ratio")
    ax.set_ylabel("ΔPSNR (dB)")
    ax.set_title("CLIP gate: skipping vs quality")
    return _save(fig, out_dir, "clip_gate_summary")


def fig_adasteer_groups(runs, out_dir):
    """PSNR vs AdaSteer group count (reference: fig_adasteer_groups)."""
    rows = [r for r in _complete(runs)
            if r.get("method") == "delta_b" and r.get("num_groups")]
    if len({r["num_groups"] for r in rows}) < 2:
        return None
    fig, ax = plt.subplots(figsize=(6.5, 4))
    by_lr: Dict[Any, List[Dict]] = {}
    for r in rows:
        by_lr.setdefault(r.get("lr"), []).append(r)
    for lr, rs in sorted(by_lr.items(), key=lambda kv: kv[0] or 0):
        pts: Dict[Any, List[float]] = {}
        for r in rs:
            pts.setdefault(r["num_groups"], []).append(r["psnr_mean"])
        xs = sorted(pts)
        ax.plot(xs, [np.mean(pts[x]) for x in xs], marker="o",
                label=f"lr={lr:g}" if lr else "lr=?")
    ax.set_xscale("log", base=2)
    ax.set_xlabel("AdaSteer groups G")
    ax.set_ylabel("PSNR (dB)")
    ax.set_title("AdaSteer group-count sweep")
    ax.legend(fontsize=8)
    return _save(fig, out_dir, "adasteer_groups")


def fig_lora_analysis(runs, out_dir):
    """PSNR vs LoRA rank/alpha (reference: fig_lora_analysis, incl. the
    rank-collapse regime)."""
    rows = [r for r in _complete(runs)
            if r.get("method") == "lora" and r.get("lora_rank")]
    if len(rows) < 2:
        return None
    fig, axes = plt.subplots(1, 2, figsize=(10, 4))
    pts: Dict[Any, List[float]] = {}
    for r in rows:
        pts.setdefault(r["lora_rank"], []).append(r["psnr_mean"])
    xs = sorted(pts)
    axes[0].plot(xs, [np.mean(pts[x]) for x in xs], marker="o")
    axes[0].set_xscale("log", base=2)
    axes[0].set_xlabel("LoRA rank")
    axes[0].set_ylabel("PSNR (dB)")
    axes[0].set_title("rank")
    alphas = [r.get("lora_alpha") for r in rows]
    axes[1].scatter(alphas, [r["psnr_mean"] for r in rows], s=30,
                    alpha=0.8)
    axes[1].set_xscale("log")
    axes[1].set_xlabel("LoRA alpha")
    axes[1].set_title("alpha")
    fig.suptitle("LoRA analysis")
    return _save(fig, out_dir, "lora_analysis")


def fig_cross_dataset(runs, out_dir):
    """Best ΔPSNR per method per dataset (reference: fig_cross_dataset)."""
    rows = [r for r in _complete(runs)
            if r.get("delta_psnr") is not None and r.get("dataset")]
    datasets = sorted({r["dataset"] for r in rows})
    if len(datasets) < 2:
        return None
    methods = sorted({r["method"] for r in rows})
    fig, ax = plt.subplots(figsize=(7.5, 4))
    width = 0.8 / len(datasets)
    for di, ds in enumerate(datasets):
        ys = []
        for m in methods:
            cand = [r["delta_psnr"] for r in rows
                    if r["dataset"] == ds and r["method"] == m]
            ys.append(max(cand) if cand else 0.0)
        ax.bar(np.arange(len(methods)) + di * width, ys, width, label=ds)
    ax.set_xticks(np.arange(len(methods)) + 0.4 - width / 2)
    ax.set_xticklabels(methods, fontsize=8)
    ax.axhline(0, color="k", lw=0.8)
    ax.set_ylabel("best ΔPSNR (dB)")
    ax.set_title("Cross-dataset generalization")
    ax.legend(fontsize=8)
    made = [_save(fig, out_dir, "cross_dataset")]

    # per-dataset per-metric charts (reference fig_cross_dataset emits
    # {dataset}_{metric}.png files, generate_figures.py:895-965)
    for ds in datasets:
        ds_rows = [r for r in rows if r["dataset"] == ds]
        best = _best_per_method(ds_rows)
        ms = sorted(best)
        for metric, label, _lower in _METRIC_PANELS:
            if not any(best[m].get(f"{metric}_mean") is not None
                       for m in ms):
                continue
            fig, ax = plt.subplots(figsize=(7, 4))
            _metric_bars(ax, best, ms, metric, label)
            ax.set_title(f"{ds} — {metric.upper()}")
            made.append(_save(fig, out_dir,
                              f"cross_dataset_{ds}_{metric}"))
    return made


def fig_extended_data(runs, out_dir):
    """PSNR vs TTA window length (reference: fig_extended_data)."""
    return _sweep_line(runs, out_dir, "tta_total_frames", "extended_data",
                       "TTA window frames")


def fig_ratio_sweep(runs, out_dir):
    """Cond-frames x groups grid (reference: fig_ratio_sweep)."""
    rows = [r for r in _complete(runs)
            if r.get("method") == "delta_b" and r.get("num_groups")
            and r.get("cond") is not None]
    if len({(r["cond"], r["num_groups"]) for r in rows}) < 4:
        return None
    fig, ax = plt.subplots(figsize=(6.5, 4))
    by_g: Dict[Any, List[Dict]] = {}
    for r in rows:
        by_g.setdefault(r["num_groups"], []).append(r)
    for g, rs in sorted(by_g.items()):
        pts: Dict[Any, List[float]] = {}
        for r in rs:
            pts.setdefault(r["cond"], []).append(r["psnr_mean"])
        xs = sorted(pts)
        ax.plot(xs, [np.mean(pts[x]) for x in xs], marker="o",
                label=f"G={g}")
    ax.set_xlabel("conditioning frames")
    ax.set_ylabel("PSNR (dB)")
    ax.set_title("Cond-frames × groups ratio sweep")
    ax.legend(fontsize=8)
    return _save(fig, out_dir, "ratio_sweep")


def fig_all_runs_scatter(runs, out_dir):
    """Every completed run: cost vs quality (reference:
    fig_all_runs_scatter)."""
    rows = [r for r in _complete(runs)
            if r.get("delta_psnr") is not None]
    if len(rows) < 3:
        return None
    fig, ax = plt.subplots(figsize=(7, 4.5))
    by_m: Dict[str, List[Dict]] = {}
    for r in rows:
        by_m.setdefault(r["method"], []).append(r)
    for m, rs in sorted(by_m.items()):
        ax.scatter([(r.get("avg_train_time") or 0)
                    + (r.get("avg_gen_time") or 0) for r in rs],
                   [r["delta_psnr"] for r in rs], label=m, s=24, alpha=0.7)
    ax.axhline(0, color="k", lw=0.8)
    ax.set_xlabel("per-video wall time (s)")
    ax.set_ylabel("ΔPSNR (dB)")
    ax.set_title("All runs: cost vs quality")
    ax.legend(fontsize=8)
    return _save(fig, out_dir, "all_runs_scatter")


def fig_naive_methods(runs, out_dir):
    """The 'naive adapters' family (delta_c / film / norm_tune) vs the
    strong methods (reference: fig_naive_methods)."""
    naive = ("delta_c", "film", "norm_tune")
    rows = [r for r in _complete(runs) if r.get("delta_psnr") is not None]
    if not any(r["method"] in naive for r in rows):
        return None
    fig, ax = plt.subplots(figsize=(7, 4))
    best: Dict[str, float] = {}
    for r in rows:
        m = r["method"]
        best[m] = max(best.get(m, -1e9), r["delta_psnr"])
    ms = sorted(best, key=best.get)
    colors = ["#e76f51" if m in naive else "#2a9d8f" for m in ms]
    ax.barh(ms, [best[m] for m in ms], color=colors)
    ax.axvline(0, color="k", lw=0.8)
    ax.set_xlabel("best ΔPSNR (dB)")
    ax.set_title("Naive output/modulation adapters vs input-side methods")
    made = [_save(fig, out_dir, "naive_methods")]

    # per-method sweep details (reference normtune_sweep / film_sweep /
    # delta_c_iter_sweep, generate_figures.py:1753-1806)
    def _lr_detail(method, name, title):
        rs = [r for r in rows if r["method"] == method and r.get("lr")]
        if len(rs) < 2:
            return None
        fig, ax = plt.subplots(figsize=(6, 4.5))
        for r in rs:
            ax.scatter(r["lr"], r["psnr_mean"], c="#e76f51", s=65,
                       zorder=5, edgecolors="white", lw=0.8)
            if r.get("trainable_params"):
                ax.annotate(f"{r['trainable_params'] / 1e3:.0f}K",
                            (r["lr"], r["psnr_mean"]),
                            textcoords="offset points", xytext=(6, 6),
                            fontsize=7, color="#555555")
        ax.set_xscale("log")
        ax.set_xlabel("learning rate")
        ax.set_ylabel("PSNR (dB)")
        ax.set_title(title, fontweight="bold")
        return _save(fig, out_dir, name)

    made.append(_lr_detail("norm_tune", "normtune_sweep",
                           "NormTune sweep"))
    made.append(_lr_detail("film", "film_sweep", "FiLM adapter sweep"))

    dc = [r for r in rows if r["method"] == "delta_c" and r.get("steps")]
    made.append(_best_line(dc, out_dir, "steps", "delta_c_iter_sweep",
                           "Delta-C (output residual) iteration sweep",
                           "training steps", color="#e76f51", marker="o"))
    return [m for m in made if m]


def fig_clip_threshold_curves(runs, out_dir):
    """Simulated gate thresholds: retained fraction + mean PSNR of the
    retained set (reference: fig_clip_threshold_curves /
    analyze_clip_gate_calibration.py)."""
    pairs = []
    for r in _complete(runs):
        pairs.extend(r.get("clip_scores_psnr") or [])
    if len(pairs) < 4:
        return None
    scores = np.asarray([p[0] for p in pairs], np.float64)
    psnrs = np.asarray([p[1] for p in pairs], np.float64)
    ths = np.quantile(scores, np.linspace(0.0, 0.95, 24))
    frac, mean_psnr = [], []
    for t in ths:
        keep = scores >= t
        frac.append(float(keep.mean()))
        mean_psnr.append(float(psnrs[keep].mean()) if keep.any()
                         else np.nan)
    fig, ax1 = plt.subplots(figsize=(6.5, 4))
    ax1.plot(ths, frac, marker="o", ms=3, color="#264653",
             label="retained fraction")
    ax1.set_xlabel("gate threshold")
    ax1.set_ylabel("retained fraction", color="#264653")
    ax2 = ax1.twinx()
    ax2.plot(ths, mean_psnr, marker="s", ms=3, color="#e76f51",
             label="mean PSNR of retained")
    ax2.set_ylabel("PSNR (dB)", color="#e76f51")
    ax1.set_title("CLIP-gate threshold calibration")
    return _save(fig, out_dir, "clip_threshold_curves")


def _loss_curve_variant(curves, out_dir, name, title, series_match):
    sel = [c for c in curves if series_match(str(c.get("series", "")))]
    if not sel:
        return None
    fig, ax = plt.subplots(figsize=(6.5, 4))
    for c in sel[:8]:
        steps = np.asarray(c["steps"])
        mean = np.asarray(c["mean"])
        std = np.asarray(c["std"])
        ax.plot(steps, mean, marker="o", ms=3,
                label=f"{c['series']}/{c['run_id']}")
        ax.fill_between(steps, mean - std, mean + std, alpha=0.15)
    ax.set_xlabel("TTA step")
    ax.set_ylabel("anchor loss")
    ax.set_title(title)
    ax.legend(fontsize=7)
    return _save(fig, out_dir, name)


def fig_loss_curves_es_check_freq(curves, out_dir):
    return _loss_curve_variant(
        curves, out_dir, "loss_curves_es_check_freq",
        "Anchor loss vs ES check frequency",
        lambda s: "check_freq" in s or "es_ablation" in s)


def fig_loss_curves_iter_sweep(curves, out_dir):
    return _loss_curve_variant(
        curves, out_dir, "loss_curves_iter_sweep",
        "Anchor loss across step-count sweeps",
        lambda s: "iter" in s)


def fig_loss_curves_long_train(curves, out_dir):
    return _loss_curve_variant(
        curves, out_dir, "loss_curves_long_train",
        "Anchor loss: long-train runs",
        lambda s: "long_train" in s)


ALL_FIGURES = [
    fig_method_comparison, fig_pareto_quality_vs_params, fig_lr_sweep,
    fig_steps_sweep, fig_cond_frames, fig_gen_horizon, fig_time_cost,
    fig_es_time_savings, fig_early_stopping, fig_summary_table,
    fig_batch_k,
    fig_clip_gate_summary, fig_adasteer_groups, fig_lora_analysis,
    fig_cross_dataset, fig_extended_data, fig_ratio_sweep,
    fig_all_runs_scatter, fig_naive_methods, fig_clip_threshold_curves,
]

LOSS_CURVE_FIGURES = [
    fig_loss_curves, fig_loss_curves_es_check_freq,
    fig_loss_curves_iter_sweep, fig_loss_curves_long_train,
]


def main(argv=None):
    p = argparse.ArgumentParser(description="Generate paper figures")
    p.add_argument("--all-results", default="all_results.json")
    p.add_argument("--loss-curves", default="loss_curves.json")
    p.add_argument("--output-dir", default="paper_figures/output")
    args = p.parse_args(argv)

    with open(args.all_results) as f:
        runs = json.load(f)["runs"]
    made = []
    for fn in ALL_FIGURES:
        path = fn(runs, args.output_dir)
        if path:
            made.extend(path if isinstance(path, list) else [path])
    if os.path.exists(args.loss_curves):
        with open(args.loss_curves) as f:
            curves = json.load(f)["curves"]
        for fn in LOSS_CURVE_FIGURES:
            path = fn(curves, args.output_dir)
            if path:
                made.extend(path if isinstance(path, list) else [path])
    print(f"[figures] generated {len(made)} figures in {args.output_dir}")
    return made


if __name__ == "__main__":
    main()
