"""In-process TTA hyperparameter probe on the port (counterpart of the
repository's ``scripts/probe_tta_grid.py``): a small method x lr x steps
grid on the first K distribution-B videos, each video's PSNR paired by
name against a NOTTA summary measured under the same weights (by default
the port's demo campaign's NOTTA row), reported as the mean dPSNR and the
wins. In one process, so the kernels and the towers load once.

Usage:
    python3 -m longcat_video_tta_tpu_torch.scripts.probe_tta_grid \\
        [--n 6] [--out campaign/demo_torch/probe] [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

# the reference's BASE with the port's checkpoint and data folders; its
# --compile-cache-dir (XLA's cache) is left to the runner's default build
# folder
BASE = [
    "--preset", "longcat_demo", "--checkpoint-dir", "campaign/demo_ckpt_torch",
    "--data-dir", "campaign/demo_torch/data_b", "--caption-guard-mode", "off",
    "--height", "192", "--width", "320", "--num-cond-frames", "14",
    "--num-frames", "28", "--gen-start-frame", "32",
    "--num-inference-steps", "50", "--guidance-scale", "1.0",
    "--tta-total-frames", "29", "--seed", "42",
]

# (tag, method, lr, steps)
GRID = [
    ("full_lr1e-4_s40", "full", 1e-4, 40),
    ("full_lr3e-4_s40", "full", 3e-4, 40),
    ("delta_a_lr1e-3_s40", "delta_a", 1e-3, 40),
    ("lora_lr1e-3_s40", "lora", 1e-3, 40),
]


def paired_report(tag, method, lr, steps, summary: dict, base_psnr: dict) -> dict:
    """The grid row of one run against the NOTTA PSNR of each video."""
    diffs = [(r["video"], r["psnr"] - base_psnr[r["video"]])
             for r in summary["results"] if r["video"] in base_psnr]
    mean_d = sum(d for _, d in diffs) / max(len(diffs), 1)
    return {"tag": tag, "method": method, "lr": lr, "steps": steps,
            "n": len(diffs), "mean_dpsnr": round(mean_d, 4),
            "wins": sum(d > 0 for _, d in diffs),
            "train_s": round(summary["avg_train_time"], 2)}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="the TTA hyperparameter probe on the port")
    p.add_argument("--n", type=int, default=6)
    p.add_argument("--out", default="campaign/demo_torch/probe")
    p.add_argument("--grid", default=None, help="comma list of tag filters (substring match)")
    p.add_argument("--baseline", default="campaign/demo_torch/campaign_demo/NOTTA/summary.json",
                   help="a NOTTA summary measured under the same weights")
    p.add_argument("--device", default="cuda", help="the runner's --device")
    args = p.parse_args(argv)

    from ..runners.run_tta import main as run_main
    from ..utils.device import resolve_device

    resolve_device(args.device)
    with open(args.baseline) as f:
        base_psnr = {r["video"]: r["psnr"] for r in json.load(f)["results"]}
    grid = GRID
    if args.grid:
        keys = args.grid.split(",")
        grid = [g for g in GRID if any(k in g[0] for k in keys)]

    report = []
    for tag, method, lr, steps in grid:
        out_dir = os.path.join(args.out, tag)
        argv_run = BASE + [
            "--method", method, "--lr", str(lr), "--steps", str(steps),
            "--es-disable", "--max-videos", str(args.n),
            "--output-dir", out_dir, "--device", args.device,
        ]
        print(f"[probe] {tag} ...", flush=True)
        try:
            run_main(argv_run)
        except SystemExit as e:
            if e.code not in (0, None):
                print(f"[probe] {tag} FAILED rc={e.code}", flush=True)
                continue
        with open(os.path.join(out_dir, "summary.json")) as f:
            row = paired_report(tag, method, lr, steps, json.load(f), base_psnr)
        print(f"[probe] {tag}: dPSNR={row['mean_dpsnr']:+.4f} wins={row['wins']}/{row['n']}",
              flush=True)
        report.append(row)

    report.sort(key=lambda r: -r["mean_dpsnr"])
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "grid_report.json"), "w") as f:
        json.dump(report, f, indent=1)
    print(json.dumps(report, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
