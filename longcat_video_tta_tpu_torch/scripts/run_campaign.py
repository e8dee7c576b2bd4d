"""The campaign protocol at bench scale on the port (counterpart of the
repository's ``scripts/run_campaign.py``): one shared synthetic dataset
-> the method rows of ``configs/campaign_bench_*.yaml`` through the
port's ``sweep/run_sweep.py`` (resume per row) -> the expected-matrix
check -> ``export_results`` (+ the NOTTA comparison) -> loss curves ->
figures (where matplotlib is installed) -> a per-row timing table.

Usage:
    python3 -m longcat_video_tta_tpu_torch.scripts.run_campaign \\
        --output-base campaign/results_torch [--rows baseline,delta_a,...] \\
        [--max-videos 100] [--dry-run] [--device cuda]

Re-running resumes: completed rows are skipped by run_sweep, partial rows
resume from their checkpoint.json.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

ROWS = ("baseline", "delta_a", "delta_b", "lora", "dno")


def timing_table(results_base: str, series: str = "campaign_bench") -> str:
    """Per-row timing distributions (mean/p50/p90 train/gen/total) in
    the BASELINE.md column style. gen s is the method's generation only;
    --fast-decode-verify dense re-generations have their own column."""
    import numpy as np

    lines = ["| run | n_ok | train s (mean/p50/p90) | "
             "gen s (mean/p50/p90) | total s (mean/p50/p90) | "
             "dense-verify s (mean x n) | PSNR |",
             "|---|---|---|---|---|---|---|"]
    for run_dir in sorted(glob.glob(os.path.join(results_base, series, "*"))):
        # the finalized summary, else the live checkpoint (labeled partial)
        sp = os.path.join(run_dir, "summary.json")
        partial = not os.path.exists(sp)
        if partial:
            sp = os.path.join(run_dir, "checkpoint.json")
            if not os.path.exists(sp):
                continue
        with open(sp) as f:
            s = json.load(f)
        ok = [r for r in s["results"] if r.get("success")]
        label = os.path.basename(run_dir) + (" (partial)" if partial else "")
        if not ok:  # a row without a successful video still gets its line
            lines.append(f"| {label} | 0 | - | - | - | - | - |")
            continue

        def dist(key):
            v = [r.get(key, 0.0) for r in ok]
            return (f"{np.mean(v):.1f}/{np.percentile(v, 50):.1f}/"
                    f"{np.percentile(v, 90):.1f}")

        psnr_v = [r["psnr"] for r in ok if np.isfinite(r.get("psnr", float("nan")))]
        psnr_cell = (f"{np.mean(psnr_v):.3f}±{np.std(psnr_v):.3f}" if psnr_v else "-")
        dense = [r["fast_decode_verify"]["dense_gen_time"] for r in ok
                 if "fast_decode_verify" in r]
        dense_cell = f"{np.mean(dense):.1f} x {len(dense)}" if dense else "-"
        lines.append(
            f"| {label} | {len(ok)} | {dist('train_time')} | "
            f"{dist('gen_time')} | {dist('total_time')} | {dense_cell} | "
            f"{psnr_cell} |")
    return "\n".join(lines)


def aggregate(configs, output_base: str, series: str) -> None:
    """The matrix check, export (with the NOTTA comparison when the row
    exists), loss curves and figures over a campaign's run folders."""
    from ..sweep import export_loss_curves, export_results
    from ..sweep.diagnostics import check_expected_matrix

    series_dir = os.path.join(output_base, series)
    base_dir = os.path.join(series_dir, "NOTTA")
    check_expected_matrix(
        configs, output_base,
        baseline_dir=base_dir if os.path.exists(base_dir) else None,
        report_path=os.path.join(output_base, "matrix_report.txt"))
    all_results = os.path.join(output_base, "all_results.json")
    export_results.main(["--results-roots", output_base, "--output", all_results])
    if os.path.exists(os.path.join(base_dir, "summary.json")):
        # --compare is the exporter's cross-method mode: a second call
        rows_dirs = [f"NOTTA={base_dir}"]
        for sp in sorted(glob.glob(os.path.join(series_dir, "*", "summary.json"))):
            d = os.path.dirname(sp)
            if d != base_dir:
                rows_dirs.append(f"{os.path.basename(d)}={d}")
        export_results.main(["--compare", *rows_dirs, "--compare-output-dir",
                             os.path.join(output_base, "compare")])
    curves = os.path.join(output_base, "loss_curves.json")
    export_loss_curves.main(["--results-roots", output_base, "--output", curves])
    try:
        from ..sweep import figures
    except ImportError as e:  # matplotlib is optional
        print(f"[campaign] figures skipped: {e}")
    else:
        figures.main(["--all-results", all_results, "--loss-curves", curves,
                      "--output-dir", os.path.join(output_base, "figures")])


def write_timing_table(output_base: str, series: str) -> str:
    table = timing_table(output_base, series=series)
    with open(os.path.join(output_base, "timing_table.md"), "w") as f:
        f.write(table + "\n")
    print(table)
    return table


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="the bench-scale campaign on the port")
    p.add_argument("--output-base", default="campaign/results_torch")
    p.add_argument("--rows", default=",".join(ROWS))
    p.add_argument("--max-videos", type=int, default=0,
                   help="override the YAMLs' max_videos (smoke runs)")
    p.add_argument("--smoke", action="store_true",
                   help="tiny-preset CPU smoke of the whole protocol "
                        "(rows -> matrix -> export -> figures)")
    p.add_argument("--dry-run", action="store_true")
    p.add_argument("--device", default="cuda", help="the runner's --device for every row")
    args = p.parse_args(argv)

    import yaml

    from ..runners.run_tta import make_synthetic_dataset
    from ..sweep.run_sweep import run_sweep
    from ..utils.device import resolve_device

    resolve_device(args.device)  # no GPU: raise before any data is made
    smoke_fixed = {
        "preset": "longcat_tiny", "height": 16, "width": 32,
        "num_cond_frames": 5, "num_frames": 5, "gen_start_frame": 16,
        "tta_total_frames": 13, "tta_context_frames": 5,
        "steps": 2, "num_inference_steps": 2, "attn_impl": "xla",
        "es_check_every": 1, "es_noise_draws": 1, "es_anchor_sigmas": "0.5",
        # tiny-preset smoke: no decode-lever stack
        "fast_decode": False, "fast_decode_verify": 0,
        "gen_segment_steps": 0, "compile_cache_dir": None,
    }

    os.makedirs(args.output_base, exist_ok=True)
    rows = [r for r in args.rows.split(",") if r]
    unknown = set(rows) - set(ROWS)
    if unknown:
        raise SystemExit(f"unknown rows: {sorted(unknown)}")

    # one shared dataset for every row
    n_videos = args.max_videos or 100
    h, w = (16, 32) if args.smoke else (480, 832)
    data_dir = os.path.join(args.output_base, "data")
    if not os.path.exists(os.path.join(data_dir, "metadata.csv")):
        print(f"[campaign] generating {n_videos} synthetic {h}x{w} clips")
        make_synthetic_dataset(data_dir, n_videos, h, w, seed=7)

    t0 = time.time()
    launched, configs = [], []
    for row in rows:
        cfg_path = os.path.join(REPO, "configs", f"campaign_bench_{row}.yaml")
        if args.max_videos or args.smoke:
            with open(cfg_path) as f:
                cfg = yaml.safe_load(f)
            if args.max_videos:
                cfg["fixed"]["max_videos"] = args.max_videos
            if args.smoke:
                cfg["fixed"].update(smoke_fixed)
                cfg["fixed"] = {k: v for k, v in cfg["fixed"].items()
                                if v not in (None, False, 0) or k in ("max_videos",)}
                cfg["fixed"]["height"], cfg["fixed"]["width"] = 16, 32
            cfg_path = os.path.join(args.output_base, f"_{row}.yaml")
            with open(cfg_path, "w") as f:
                yaml.safe_dump(cfg, f)
        configs.append(cfg_path)
        print(f"[campaign] row {row}: {cfg_path}")
        launched += run_sweep(cfg_path, args.output_base, data_dir=data_dir,
                              dry_run=args.dry_run, device=args.device)
    if args.dry_run:
        print(json.dumps(launched, indent=2, default=str))
        return 0

    aggregate(configs, args.output_base, "campaign_bench")
    write_timing_table(args.output_base, "campaign_bench")
    print(f"[campaign] done in {(time.time() - t0) / 60:.1f} min -> {args.output_base}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
