"""Fleet ops + post-hoc diagnostics (the PyTorch port's copy of
``longcat_video_tta_tpu/sweep/diagnostics.py``, host only): it reads the
run folders the port's runner and sweep write (summary.json,
checkpoint.json, config.json, per-video ``error`` strings).

    python -m longcat_video_tta_tpu_torch.sweep.diagnostics status \
        --results-roots RESULTS

Rebuilds the reference's triage layer (SURVEY.md §2.5/2.6, §5):
- ``check_status``: classify run dirs into complete / in_progress /
  failed_empty (check_job_status.sh, EXPERIMENT_STATUS.md:13-31)
- ``audit_run_pair``: old-vs-new per-video metric diff + config-subset
  diff (audit_regression_run_pair.py)
- ``per_video_regressions``: per-video lookup of the worst regressions
  vs the matched baseline run (phase1_diagnostics.py)
- ``clip_gate_calibration``: threshold simulation over per-video CLIP
  scores vs metric deltas (analyze_clip_gate_calibration.py)
- ``check_stalled_runs``: in-progress runs whose checkpoint.json has
  not advanced within a staleness window (check_stalled_runs.sh)
- ``investigate_failures``: classify failed runs by per-video error
  strings + log-file scan (investigate_failed_jobs.sh)
- ``xclip_threshold_rows``: per-threshold CSV rows for X-CLIP-gated
  sweeps (extract_xclip_sweep_results.py:1-140)
"""

from __future__ import annotations

import argparse
import glob
import json
import os
from typing import Any, Dict, List, Optional

import numpy as np


def _load_summary(run_dir: str) -> Optional[Dict]:
    path = os.path.join(run_dir, "summary.json")
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


def check_status(results_roots: List[str]) -> Dict[str, List[str]]:
    out = {"complete": [], "in_progress": [], "failed_empty": []}
    for root in results_roots:
        for d in sorted(glob.glob(os.path.join(root, "*", "*"))):
            if not os.path.isdir(d):
                continue
            if os.path.exists(os.path.join(d, "summary.json")):
                out["complete"].append(d)
            elif os.path.exists(os.path.join(d, "checkpoint.json")):
                out["in_progress"].append(d)
            else:
                out["failed_empty"].append(d)
    for k, v in out.items():
        print(f"{k}: {len(v)}")
        for d in v:
            print(f"  {d}")
    return out


def _per_video(summary: Dict) -> Dict[str, Dict]:
    return {r["video"]: r for r in summary.get("results", [])
            if r.get("success")}


def audit_run_pair(old_dir: str, new_dir: str,
                   metric: str = "psnr") -> Dict[str, Any]:
    """Per-video diff between two runs + config diff
    (audit_regression_run_pair.py)."""
    old_s, new_s = _load_summary(old_dir), _load_summary(new_dir)
    if old_s is None or new_s is None:
        raise FileNotFoundError("both runs need summary.json")
    old_v, new_v = _per_video(old_s), _per_video(new_s)
    shared = sorted(set(old_v) & set(new_v))
    diffs = []
    for vid in shared:
        a, b = old_v[vid].get(metric), new_v[vid].get(metric)
        if a is not None and b is not None:
            diffs.append({"video": vid, "old": a, "new": b,
                          "delta": b - a})
    diffs.sort(key=lambda d: d["delta"])

    cfg_old = old_s.get("config", {})
    cfg_new = new_s.get("config", {})
    cfg_diff = {
        k: {"old": cfg_old.get(k), "new": cfg_new.get(k)}
        for k in sorted(set(cfg_old) | set(cfg_new))
        if cfg_old.get(k) != cfg_new.get(k)
        and k not in ("output_dir",)
    }
    report = {
        "num_shared_videos": len(shared),
        f"mean_delta_{metric}": float(np.mean([d["delta"] for d in diffs]))
        if diffs else None,
        "worst_regressions": diffs[:5],
        "best_improvements": diffs[-5:][::-1],
        "config_diff": cfg_diff,
    }
    print(json.dumps(report, indent=2, default=str))
    return report


def per_video_regressions(run_dir: str, baseline_dir: str,
                          metric: str = "psnr",
                          top_k: int = 10) -> List[Dict]:
    """Worst per-video deltas vs the matched baseline
    (phase1_diagnostics.py)."""
    run_s, base_s = _load_summary(run_dir), _load_summary(baseline_dir)
    run_v, base_v = _per_video(run_s), _per_video(base_s)
    rows = []
    for vid in sorted(set(run_v) & set(base_v)):
        a, b = base_v[vid].get(metric), run_v[vid].get(metric)
        if a is not None and b is not None:
            rows.append({"video": vid, "baseline": a, "tta": b,
                         "delta": b - a})
    rows.sort(key=lambda r: r["delta"])
    for r in rows[:top_k]:
        print(f"{r['video']:<40} base={r['baseline']:.3f} "
              f"tta={r['tta']:.3f} Δ={r['delta']:+.3f}")
    return rows


def clip_gate_calibration(run_dir: str, baseline_dir: str,
                          metric: str = "psnr",
                          thresholds: Optional[List[float]] = None
                          ) -> List[Dict]:
    """Simulate gate thresholds: for each candidate threshold, compute the
    mean metric if TTA were skipped below it (taking the baseline value
    instead) — analyze_clip_gate_calibration.py."""
    run_s, base_s = _load_summary(run_dir), _load_summary(baseline_dir)
    run_v, base_v = _per_video(run_s), _per_video(base_s)
    pairs = []
    for vid in sorted(set(run_v) & set(base_v)):
        score = run_v[vid].get("clip_gate_score")
        a, b = base_v[vid].get(metric), run_v[vid].get(metric)
        if score is not None and a is not None and b is not None:
            pairs.append((score, a, b))
    if not pairs:
        print("[calibration] no per-video CLIP scores recorded")
        return []
    scores = sorted({p[0] for p in pairs})
    thresholds = thresholds or [float(s) for s in
                                np.quantile(scores, np.linspace(0, 1, 11))]
    rows = []
    for th in thresholds:
        vals = [(base if score < th else tta)
                for score, base, tta in pairs]
        skipped = sum(1 for score, _, _ in pairs if score < th)
        rows.append({"threshold": th, "mean_metric": float(np.mean(vals)),
                     "skip_ratio": skipped / len(pairs)})
    for r in rows:
        print(f"th={r['threshold']:.4f} mean_{metric}="
              f"{r['mean_metric']:.3f} skip={r['skip_ratio']:.2f}")
    return rows


def check_stalled_runs(results_roots: List[str],
                       stale_minutes: float = 90.0) -> List[Dict[str, Any]]:
    """In-progress runs (checkpoint.json, no summary.json) whose
    checkpoint mtime is older than ``stale_minutes`` — the reference's
    check_stalled_runs.sh heuristic, on file mtimes instead of squeue."""
    import time

    now = time.time()
    stalled = []
    status = {k: v for k, v in check_status(results_roots).items()}
    for d in status["in_progress"]:
        ck = os.path.join(d, "checkpoint.json")
        age_min = (now - os.path.getmtime(ck)) / 60.0
        if age_min >= stale_minutes:
            with open(ck) as f:
                next_idx = json.load(f).get("next_idx")
            stalled.append({"run_dir": d, "stale_minutes": round(age_min, 1),
                            "next_idx": next_idx})
    for r in stalled:
        print(f"STALLED {r['run_dir']} (idle {r['stale_minutes']} min, "
              f"next video {r['next_idx']})")
    if not stalled:
        print("no stalled runs")
    return stalled


_ERROR_CLASSES = [
    ("oom", ("RESOURCE_EXHAUSTED", "out of memory", "OOM")),
    ("nan", ("nan", "NaN", "FloatingPointError")),
    ("decode", ("decode", "cv2", "Undecodable", "corrupt")),
    ("shape", ("shape", "dimension", "broadcast")),
    ("io", ("No such file", "FileNotFound", "Permission")),
]


def investigate_failures(results_roots: List[str],
                         log_glob: Optional[str] = None
                         ) -> Dict[str, List[Dict[str, Any]]]:
    """Classify failures by error text — per-video ``error`` fields in
    checkpoints/summaries plus optional log files — into coarse classes
    (oom/nan/decode/shape/io/other), the investigate_failed_jobs.sh
    workflow."""
    def classify(msg: str) -> str:
        for cls, needles in _ERROR_CLASSES:
            if any(n in msg for n in needles):
                return cls
        return "other"

    buckets: Dict[str, List[Dict[str, Any]]] = {}
    for root in results_roots:
        for path in sorted(
                glob.glob(os.path.join(root, "*", "*", "checkpoint.json"))
                + glob.glob(os.path.join(root, "*", "*", "summary.json"))):
            with open(path) as f:
                try:
                    doc = json.load(f)
                except json.JSONDecodeError:
                    buckets.setdefault("corrupt_json", []).append(
                        {"path": path})
                    continue
            for r in doc.get("results", []):
                if r.get("success") is False and r.get("error"):
                    buckets.setdefault(classify(str(r["error"])), []).append(
                        {"path": os.path.dirname(path),
                         "video": r.get("video"),
                         "error": str(r["error"])[:200]})
    for lp in sorted(glob.glob(log_glob)) if log_glob else []:
        with open(lp, errors="replace") as f:
            text = f.read()
        for needle in ("Traceback (most recent call last)",):
            if needle in text:
                tail = text[text.rindex(needle):][:400]
                buckets.setdefault(classify(tail), []).append(
                    {"path": lp, "error": tail.splitlines()[-1][:200]})
    for cls, rows in sorted(buckets.items()):
        print(f"{cls}: {len(rows)}")
        for r in rows[:5]:
            print(f"  {r.get('path')} {r.get('video', '')}: "
                  f"{r.get('error', '')[:120]}")
    if not buckets:
        print("no recorded failures")
    return buckets


def xclip_threshold_rows(
    root: str,
    patterns: Optional[List[str]] = None,
) -> List[Dict[str, Any]]:
    """One CSV-able row per gate-threshold sweep summary:
    series,run,thr,backend,n_ok,psnr,ssim,lpips,skip_rate,num_skipped,
    num_scored (extract_xclip_sweep_results.py). Threshold and backend
    come from the run config; the directory pattern captures the
    reference's results_xclip_gate_thr_* layout by default."""
    patterns = patterns or ["results_*gate*thr*/*/*/summary.json",
                            "results_*gate*/*/*/summary.json"]
    rows: List[Dict[str, Any]] = []
    seen = set()
    for pat in patterns:
        for sp in sorted(glob.glob(os.path.join(root, pat))):
            if sp in seen:
                continue
            seen.add(sp)
            with open(sp) as f:
                doc = json.load(f)
            cfg = doc.get("config", {})
            ok = [r for r in doc.get("results", []) if r.get("success")]
            scored = [r for r in ok if not r.get("skip_tta")]
            skipped = [r for r in ok if r.get("skip_tta")]

            def _mean(key):
                vals = [r[key] for r in scored
                        if isinstance(r.get(key), (int, float))
                        and np.isfinite(r[key])]
                return float(np.mean(vals)) if vals else None

            run_dir = os.path.dirname(sp)
            rows.append({
                "series": os.path.basename(os.path.dirname(run_dir)),
                "run": os.path.basename(run_dir),
                "thr": cfg.get("clip_gate_threshold"),
                "backend": cfg.get("clip_gate_backend", "clip"),
                "n_ok": len(ok),
                "psnr": _mean("psnr"), "ssim": _mean("ssim"),
                "lpips": _mean("lpips"),
                "skip_rate": (len(skipped) / len(ok)) if ok else None,
                "num_skipped": len(skipped),
                "num_scored": len(scored),
            })
    hdr = ("series,run,thr,backend,n_ok,psnr,ssim,lpips,skip_rate,"
           "num_skipped,num_scored")
    print(hdr)
    for r in rows:
        print(",".join("nan" if r[k] is None
                       else (f"{r[k]:.6f}" if isinstance(r[k], float)
                             else str(r[k]))
                       for k in hdr.split(",")))
    return rows


def check_expected_matrix(config_paths: List[str], output_base: str,
                          baseline_dir: Optional[str] = None,
                          report_path: Optional[str] = None
                          ) -> Dict[str, Any]:
    """Phase-completeness check: diff the results tree against the
    EXPECTED run matrix derived from the sweep YAML(s) themselves —
    the analogue of the reference's hand-maintained EXPECTED_RUNS table
    (check_phase2.py:1-120), except the expectation comes from the same
    configs the dispatcher executes, so it can never drift.

    Classifies every expected (series, run_id) as ok / in_progress /
    missing, prints the reference's status table (PSNR, dPSNR vs the
    optional no-TTA baseline, SSIM, LPIPS, avg train, avg executed
    steps, ES early-stop %), and returns the classification.
    """
    from .run_sweep import load_config

    base = _load_summary(baseline_dir) if baseline_dir else None
    base_psnr = (base["metrics"]["psnr"]["mean"]
                 if base and base.get("metrics", {}).get("psnr") else None)

    lines: List[str] = []

    def pr(msg: str = ""):
        print(msg)
        lines.append(msg)

    if baseline_dir:
        if base is None:
            pr(f"baseline: NOT FOUND at {baseline_dir}")
        else:
            pr(f"baseline (no-TTA): PSNR={base_psnr:.4f} "
               f"n={base.get('num_success')}")
        pr()
    pr(f"{'run_id':<24s} {'status':<12s} {'n_ok':>5s} {'PSNR':>8s} "
       f"{'dPSNR':>8s} {'SSIM':>7s} {'LPIPS':>7s} {'train':>7s} "
       f"{'steps':>6s} {'ES%':>5s}")
    pr("-" * 100)

    out: Dict[str, Any] = {"ok": [], "in_progress": [], "missing": []}
    for cfg_path in config_paths:
        cfg = load_config(cfg_path)
        series = cfg.get("series", os.path.splitext(
            os.path.basename(cfg_path))[0])
        for row in cfg["sweep"]:
            run_id = str(row["run_id"])
            run_dir = os.path.join(output_base, series, run_id)
            s = _load_summary(run_dir)
            if s is None:
                ck = os.path.join(run_dir, "checkpoint.json")
                if os.path.exists(ck):
                    with open(ck) as f:
                        n_done = json.load(f).get("next_idx", 0)
                    out["in_progress"].append(run_dir)
                    pr(f"{run_id:<24s} {'IN_PROGRESS':<12s} {n_done:>5d}")
                else:
                    out["missing"].append(run_dir)
                    pr(f"{run_id:<24s} {'MISSING':<12s}")
                continue
            out["ok"].append(run_dir)
            m = s.get("metrics", {})

            def _mean(key):
                v = m.get(key)
                return v["mean"] if v else float("nan")

            okr = [r for r in s.get("results", []) if r.get("success")]
            es_n = sum(1 for r in okr
                       if (r.get("early_stopping_info") or {}
                           ).get("stopped_early"))
            steps = [len(r["losses"]) for r in okr if r.get("losses")]
            psnr = _mean("psnr")
            dpsnr = (f"{psnr - base_psnr:+8.4f}" if base_psnr is not None
                     else f"{'?':>8s}")
            pr(f"{run_id:<24s} {'OK':<12s} {s.get('num_success', 0):>5d} "
               f"{psnr:>8.4f} {dpsnr} {_mean('ssim'):>7.4f} "
               f"{_mean('lpips'):>7.4f} "
               f"{s.get('avg_train_time') or 0:>6.1f}s "
               f"{(np.mean(steps) if steps else float('nan')):>6.1f} "
               f"{(100 * es_n / len(okr) if okr else 0):>4.0f}%")
    pr()
    pr(f"expected={sum(len(v) for v in out.values())} ok={len(out['ok'])} "
       f"in_progress={len(out['in_progress'])} "
       f"missing={len(out['missing'])}")
    if report_path:
        with open(report_path, "w") as f:
            f.write("\n".join(lines) + "\n")
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description="Run diagnostics (PyTorch port)")
    sub = p.add_subparsers(dest="cmd", required=True)
    s = sub.add_parser("status")
    s.add_argument("--results-roots", nargs="+", default=["results"])
    a = sub.add_parser("audit")
    a.add_argument("old_dir")
    a.add_argument("new_dir")
    a.add_argument("--metric", default="psnr")
    r = sub.add_parser("regressions")
    r.add_argument("run_dir")
    r.add_argument("baseline_dir")
    r.add_argument("--metric", default="psnr")
    c = sub.add_parser("calibration")
    c.add_argument("run_dir")
    c.add_argument("baseline_dir")
    c.add_argument("--metric", default="psnr")
    st = sub.add_parser("stalled")
    st.add_argument("--results-roots", nargs="+", default=["results"])
    st.add_argument("--stale-minutes", type=float, default=90.0)
    iv = sub.add_parser("failures")
    iv.add_argument("--results-roots", nargs="+", default=["results"])
    iv.add_argument("--log-glob")
    xc = sub.add_parser("xclip")
    xc.add_argument("--root", default=".")
    xc.add_argument("--patterns", nargs="*")
    cm = sub.add_parser("check-matrix")
    cm.add_argument("configs", nargs="+",
                    help="sweep YAML(s) defining the expected run matrix")
    cm.add_argument("--output-base", required=True)
    cm.add_argument("--baseline-dir")
    cm.add_argument("--report")
    args = p.parse_args(argv)
    if args.cmd == "check-matrix":
        return check_expected_matrix(args.configs, args.output_base,
                                     args.baseline_dir, args.report)
    if args.cmd == "status":
        return check_status(args.results_roots)
    if args.cmd == "stalled":
        return check_stalled_runs(args.results_roots, args.stale_minutes)
    if args.cmd == "failures":
        return investigate_failures(args.results_roots, args.log_glob)
    if args.cmd == "xclip":
        return xclip_threshold_rows(args.root, args.patterns or None)
    if args.cmd == "audit":
        return audit_run_pair(args.old_dir, args.new_dir, args.metric)
    if args.cmd == "regressions":
        return per_video_regressions(args.run_dir, args.baseline_dir,
                                     args.metric)
    if args.cmd == "calibration":
        return clip_gate_calibration(args.run_dir, args.baseline_dir,
                                     args.metric)


if __name__ == "__main__":
    main()
