"""Results aggregation of the PyTorch port (counterpart of
``longcat_video_tta_tpu/sweep/export_results.py``, same output): walk run
dirs, extract metrics, match each TTA run to its cond/gen-matched no-TTA
baseline, emit all_results.json + console tables.

Behavior-compatible rebuild of export_all_results.py (SURVEY.md §2.6):
Phase 1 collect (``extract_run``: summary/config/checkpoint ->
mean/std/median metrics, timing, final-loss, ES stop stats, trainable
params), Phase 2 baseline matching on (dataset, cond, gen), Phase 3
series metadata from the sweep YAMLs, Phase 4 JSON + console tables with
delta-vs-baseline columns.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
from typing import Any, Dict, List, Optional

import numpy as np


def extract_run(run_dir: str) -> Optional[Dict[str, Any]]:
    """One run dir -> flat record (reference: extract_run,
    export_all_results.py:104-267)."""
    summary_path = os.path.join(run_dir, "summary.json")
    ckpt_path = os.path.join(run_dir, "checkpoint.json")
    status = "complete" if os.path.exists(summary_path) else (
        "in_progress" if os.path.exists(ckpt_path) else "failed_empty")
    rec: Dict[str, Any] = {
        "run_dir": run_dir,
        "run_id": os.path.basename(run_dir),
        "series": os.path.basename(os.path.dirname(run_dir)),
        "status": status,
    }
    if status != "complete":
        return rec

    with open(summary_path) as f:
        summary = json.load(f)
    cfg = summary.get("config", {})
    results = [r for r in summary.get("results", [])
               if r.get("success") and "psnr" in r]
    rec.update({
        "method": summary.get("method"),
        "num_videos": summary.get("num_videos"),
        "num_success": summary.get("num_success"),
        "dataset": os.path.basename(str(cfg.get("data_dir") or
                                        ("synthetic" if cfg.get("synthetic")
                                         else ""))),
        "cond": cfg.get("num_cond_frames"),
        "gen": cfg.get("num_frames"),
        "lr": cfg.get("lr"),
        "steps": cfg.get("steps"),
        "seed": cfg.get("seed"),
    })
    for key in ("psnr", "ssim", "lpips"):
        vals = [r[key] for r in results if np.isfinite(r.get(key, np.nan))]
        if vals:
            rec[f"{key}_mean"] = float(np.mean(vals))
            rec[f"{key}_std"] = float(np.std(vals))
            rec[f"{key}_median"] = float(np.median(vals))
    rec["avg_train_time"] = summary.get("avg_train_time")
    rec["avg_gen_time"] = summary.get("avg_gen_time")
    rec["avg_es_check_time"] = summary.get("avg_es_check_time")
    # final-loss + ES stop stats
    final_losses, stopped, best_steps = [], 0, []
    trainable = None
    for r in results:
        if r.get("losses"):
            final_losses.append(r["losses"][-1])
        es = r.get("early_stopping_info") or {}
        if es.get("stopped_early"):
            stopped += 1
        if es.get("best_step") is not None:
            best_steps.append(es["best_step"])
        trainable = r.get("trainable_params", trainable)
    if final_losses:
        rec["final_loss_mean"] = float(np.mean(final_losses))
    rec["es_stopped_ratio"] = (stopped / len(results)) if results else None
    rec["es_stopped_count"] = stopped
    rec["es_total_count"] = len(results)
    if best_steps:
        rec["es_best_step_mean"] = float(np.mean(best_steps))
    # full config dict: the ES-ablation / sweep-knob figures read swept
    # keys straight from it (reference extract_run keeps the whole
    # config, export_all_results.py:104-267)
    rec["config"] = dict(cfg)
    rec["trainable_params"] = trainable
    fvd = (summary.get("online_eval") or {}).get("fvd")
    if fvd is not None:
        rec["fvd"] = fvd
    rec["batch_videos"] = cfg.get("batch_videos")
    for k in ("num_groups", "lora_rank", "lora_alpha", "tta_total_frames",
              "norm_target", "film_mode", "target_blocks"):
        rec[k] = cfg.get(k)
    # per-video (clip score, psnr) pairs feed the gate threshold-curve
    # figure (reference: analyze_clip_gate_calibration.py)
    pairs = [[r.get("clip_gate_score"), r.get("psnr")] for r in results
             if r.get("clip_gate_score") is not None
             and r.get("psnr") is not None]
    if pairs:
        rec["clip_scores_psnr"] = pairs
    gate = summary.get("clip_gate_stats") or {}
    if gate.get("clip_gate_enabled"):
        rec["clip_gate_skip_ratio"] = gate.get("skip_ratio")
        rec["clip_gate_score_mean"] = gate.get("score_mean")
    return rec


def collect_all_runs(results_roots: List[str]) -> List[Dict[str, Any]]:
    """Walk results*/<series>/<run_id> (export_all_results.py:269)."""
    runs = []
    for root in results_roots:
        for summary in glob.glob(os.path.join(root, "*", "*", "summary.json")):
            rec = extract_run(os.path.dirname(summary))
            if rec:
                runs.append(rec)
        # also pick up in-progress/failed dirs
        for d in glob.glob(os.path.join(root, "*", "*")):
            if os.path.isdir(d) and not os.path.exists(
                    os.path.join(d, "summary.json")):
                rec = extract_run(d)
                if rec:
                    runs.append(rec)
    return runs


def build_baseline_index(runs: List[Dict]) -> Dict[tuple, Dict]:
    """(dataset, cond, gen) -> baseline record
    (export_all_results.py:376-415)."""
    index = {}
    for r in runs:
        if r.get("status") == "complete" and r.get("method") == "none":
            index[(r.get("dataset"), r.get("cond"), r.get("gen"))] = r
    return index


def match_baselines(runs: List[Dict]) -> None:
    """Attach baseline deltas in place (export_all_results.py:436-509)."""
    index = build_baseline_index(runs)
    for r in runs:
        if r.get("status") != "complete" or r.get("method") in (None, "none"):
            continue
        base = index.get((r.get("dataset"), r.get("cond"), r.get("gen")))
        if base is None:
            r["baseline_matched"] = False
            continue
        r["baseline_matched"] = True
        r["baseline_run_id"] = base["run_id"]
        for key in ("psnr", "ssim", "lpips"):
            if f"{key}_mean" in r and f"{key}_mean" in base:
                r[f"delta_{key}"] = r[f"{key}_mean"] - base[f"{key}_mean"]


def print_report(runs: List[Dict]) -> str:
    lines = []
    complete = [r for r in runs if r.get("status") == "complete"]
    lines.append(f"{'series':<24} {'run_id':<20} {'method':<10} "
                 f"{'PSNR':>7} {'ΔPSNR':>7} {'SSIM':>6} {'train_s':>8}")
    lines.append("-" * 90)
    for r in sorted(complete, key=lambda x: (x["series"], x["run_id"])):
        lines.append(
            f"{r['series']:<24} {r['run_id']:<20} "
            f"{str(r.get('method')):<10} "
            f"{r.get('psnr_mean', float('nan')):>7.3f} "
            f"{r.get('delta_psnr', float('nan')):>7.3f} "
            f"{r.get('ssim_mean', float('nan')):>6.3f} "
            f"{r.get('avg_train_time') or 0:>8.1f}"
        )
    n_total = len(runs)
    lines.append("-" * 90)
    lines.append(f"{len(complete)} complete / {n_total} total runs")
    report = "\n".join(lines)
    print(report)
    return report


def compare_method_dirs(labeled_dirs: List[tuple],
                        output_dir: Optional[str] = None) -> Dict[str, Any]:
    """Cross-method comparison table from per-method run dirs —
    the reference's compare_methods.py (delta_experiment/scripts/
    compare_methods.py:1-205): each dir holds a summary.json (or
    eval_summary.json from run_eval_adapters); emits a table + JSON."""
    rows = []
    for label, d in labeled_dirs:
        doc = None
        for name in ("summary.json", "eval_summary.json"):
            path = os.path.join(d, name)
            if os.path.exists(path):
                with open(path) as f:
                    doc = json.load(f)
                break
        if doc is None:
            rows.append({"label": label, "dir": d, "missing": True})
            continue
        ok = [r for r in doc.get("results", []) if r.get("success")]

        def _mean(key):
            vals = [r[key] for r in ok
                    if isinstance(r.get(key), (int, float))
                    and np.isfinite(r[key])]
            return float(np.mean(vals)) if vals else None

        rows.append({
            "label": label, "dir": d,
            "method": doc.get("method") or doc.get("mode"),
            "n": len(ok),
            "psnr": _mean("psnr"), "ssim": _mean("ssim"),
            "lpips": _mean("lpips"),
            "avg_train_s": doc.get("avg_train_time"),
            "avg_gen_s": (doc.get("avg_gen_time")
                          or _mean("gen_time")),
        })
    hdr = (f"{'label':<20} {'method':<10} {'n':>4} {'PSNR':>7} "
           f"{'SSIM':>6} {'LPIPS':>6} {'train_s':>8} {'gen_s':>7}")
    print(hdr)
    print("-" * len(hdr))
    for r in rows:
        if r.get("missing"):
            print(f"{r['label']:<20} (no summary in {r['dir']})")
            continue

        def fmt(v, w, nd=3):
            return f"{v:>{w}.{nd}f}" if isinstance(v, float) else " " * w

        print(f"{r['label']:<20} {str(r.get('method')):<10} "
              f"{r['n']:>4} {fmt(r['psnr'], 7)} {fmt(r['ssim'], 6)} "
              f"{fmt(r['lpips'], 6)} {fmt(r['avg_train_s'], 8, 1)} "
              f"{fmt(r['avg_gen_s'], 7, 1)}")
    out = {"comparison": rows}
    if output_dir:
        os.makedirs(output_dir, exist_ok=True)
        with open(os.path.join(output_dir, "method_comparison.json"),
                  "w") as f:
            json.dump(out, f, indent=2)
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description="Aggregate sweep results")
    p.add_argument("--results-roots", nargs="+", default=["results"])
    p.add_argument("--output", default="all_results.json")
    p.add_argument("--compare", nargs="+", metavar="LABEL=DIR",
                   help="cross-method comparison mode "
                        "(compare_methods.py): labeled run dirs")
    p.add_argument("--compare-output-dir")
    args = p.parse_args(argv)
    if args.compare:
        pairs = [tuple(s.split("=", 1)) for s in args.compare]
        return compare_method_dirs(pairs, args.compare_output_dir)
    runs = collect_all_runs(args.results_roots)
    match_baselines(runs)
    with open(args.output, "w") as f:
        json.dump({"runs": runs}, f, indent=2)
    print_report(runs)
    print(f"\nwrote {args.output} ({len(runs)} runs)")
    return runs


if __name__ == "__main__":
    main()
