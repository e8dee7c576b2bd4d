"""The distribution-shift science campaign on the port (counterpart of
the repository's ``scripts/run_demo_campaign.py``, step for step):
  1. synthetic-weight metric towers (``make_synth_towers``), so LPIPS,
     online FVD / FID, the CLIP gate and the native VBench dimensions are
     alive in every row;
  2. the pretrained demo stack (``pretrain_demo``, distribution A), with
     ``--pretrain`` when the checkpoint folder is missing;
  3. the evaluation data B (fast reversed motion, ``DIST_B``) and a
     held-out distribution-A set for the in-distribution control row;
  4. rows from ``configs/campaign_demo_*.yaml`` through the port's
     ``sweep/run_sweep.py``;
  5. matrix check -> export (+ NOTTA matching) -> compare -> loss curves
     -> figures -> the CLIP-gate calibration -> the timing table.

Each row's YAML is rewritten as the reference driver rewrites it
(checkpoint_dir, the tower paths, vbench_towers_dir, max_videos; the
smoke geometry under ``--smoke``), with two differences of the port:
``compile_cache_dir`` (the reference's XLA cache folder) becomes
``--compile-cache-dir``, the folder the port's runner builds its
kernels in (default "auto": the package's build folder, shared by every
row); and every row runs on ``--device``.

Usage:
    python3 -m longcat_video_tta_tpu_torch.scripts.run_demo_campaign \\
        --output-base campaign/demo_torch [--rows baseline,full,...] \\
        [--max-videos N] [--pretrain] [--smoke] [--dry-run] [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

from .pretrain_demo import DIST_A
from .run_campaign import REPO, aggregate, write_timing_table

# priority order: baseline first (export matches against it), then the
# headline methods, then the long tail
ROWS = ("baseline", "delta_a", "full", "lora", "delta_b", "norm_tune",
        "delta_c", "film", "dno")

# distribution B (evaluation): fast reversed motion against DIST_A
# (speed 0.02-0.05, +x)
DIST_B = {"speed_range": (0.09, 0.16), "freq_range": (2.0, 5.0),
          "direction": -1.0}

TOWER_KEYS = ("lpips_model_path", "clip_gate_model_path", "i3d_model_path",
              "inception_model_path")


def checkpoint_ready(ckpt_dir: str) -> bool:
    """A checkpoint folder as ``save_checkpoint_dir`` writes it."""
    return (all(os.path.isdir(os.path.join(ckpt_dir, c))
                for c in ("dit", "vae", "text_encoder"))
            and os.path.exists(os.path.join(ckpt_dir, "vae", "config.json")))


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="the distribution-shift campaign on the port")
    p.add_argument("--output-base", default="campaign/demo_torch")
    p.add_argument("--rows", default=",".join(ROWS))
    p.add_argument("--max-videos", type=int, default=0)
    p.add_argument("--towers-dir", default="campaign/towers_torch")
    p.add_argument("--ckpt-dir", default="campaign/demo_ckpt_torch")
    p.add_argument("--pretrain", action="store_true",
                   help="run pretrain_demo first if the checkpoint folder is missing")
    p.add_argument("--smoke", action="store_true",
                   help="tiny-preset CPU smoke of the whole protocol")
    p.add_argument("--dry-run", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a GPU) or cpu, for the towers, "
                        "the pretraining and every row")
    p.add_argument("--compile-cache-dir", default="auto",
                   help="the rows' kernel build folder (the YAMLs' compile_cache_dir)")
    return p.parse_args(argv)


def row_config(row: str, args, data_a: str, data_b: str, n_videos: int) -> dict:
    """``configs/campaign_demo_<row>.yaml`` rewritten for this campaign."""
    import yaml

    smoke_fixed = {
        "preset": "longcat_tiny", "checkpoint_dir": args.ckpt_dir,
        "height": 16, "width": 32,
        "num_cond_frames": 5, "num_frames": 5, "gen_start_frame": 16,
        "tta_total_frames": 13, "steps": 2, "num_inference_steps": 2,
        "attn_impl": "xla", "es_check_every": 1, "es_noise_draws": 1,
        "es_anchor_sigmas": "0.5", "compile_cache_dir": None,
        "compute_vbench": False, "guidance_scale": 1.0,
    }
    with open(os.path.join(REPO, "configs", f"campaign_demo_{row}.yaml")) as f:
        cfg = yaml.safe_load(f.read().replace("__DATA_B__", data_b)
                             .replace("__DATA_A__", data_a))
    fixed = cfg["fixed"]
    fixed["checkpoint_dir"] = args.ckpt_dir
    fixed["vbench_towers_dir"] = args.towers_dir
    if "compile_cache_dir" in fixed:
        fixed["compile_cache_dir"] = args.compile_cache_dir
    for key in TOWER_KEYS:
        base = os.path.basename(str(fixed.get(key, "")))
        if base:
            fixed[key] = os.path.join(args.towers_dir, base)
    if args.max_videos:
        fixed["max_videos"] = args.max_videos
        for r in cfg["sweep"]:
            r.pop("max_videos", None)
    if args.smoke:
        fixed.update(smoke_fixed)
        cfg["fixed"] = {k: v for k, v in fixed.items()
                        if v not in (None, False) or k == "max_videos"}
        # batch-K retrieval needs >= K pool entries; keep the smoke tiny
        cfg["sweep"] = [r for r in cfg["sweep"] if r.get("batch_videos", 1) <= n_videos]
    return cfg


def main(argv=None, run_ids=None) -> int:
    """The campaign; ``run_ids``: only these entries of the rows' sweeps
    (every entry when None)."""
    args = parse_args(argv)

    import yaml

    from ..runners.run_tta import make_synthetic_dataset
    from ..sweep.run_sweep import run_sweep
    from ..utils.device import resolve_device

    resolve_device(args.device)  # no GPU: raise before any file is made
    os.makedirs(args.output_base, exist_ok=True)
    rows = [r for r in args.rows.split(",") if r]
    unknown = set(rows) - set(ROWS)
    if unknown:
        raise SystemExit(f"unknown rows: {sorted(unknown)}")

    # ---- towers ------------------------------------------------------
    if not os.path.exists(os.path.join(args.towers_dir, "lpips_alex.pth")):
        from .make_synth_towers import main as towers_main

        print(f"[demo] generating synthetic towers -> {args.towers_dir}")
        towers_main(["--out-dir", args.towers_dir, "--device", args.device])

    # ---- pretrained checkpoint ----------------------------------------
    if not checkpoint_ready(args.ckpt_dir):
        if not args.pretrain:
            raise SystemExit(
                f"no pretrained checkpoint at {args.ckpt_dir}: run "
                "python3 -m longcat_video_tta_tpu_torch.scripts.pretrain_demo first "
                "(or pass --pretrain)")
        from .pretrain_demo import main as pretrain_main

        pargs = ["--out-dir", args.ckpt_dir, "--device", args.device]
        if args.smoke:
            pargs.append("--smoke")
        pretrain_main(pargs)

    # ---- datasets ------------------------------------------------------
    n_videos = args.max_videos or 100
    h, w = (16, 32) if args.smoke else (192, 320)
    data_b = os.path.join(args.output_base, "data_b")
    data_a = os.path.join(args.output_base, "data_a")
    if not os.path.exists(os.path.join(data_b, "metadata.csv")):
        print(f"[demo] generating {n_videos} distribution-B clips")
        make_synthetic_dataset(data_b, n_videos, h, w, seed=11, **DIST_B)
    if not os.path.exists(os.path.join(data_a, "metadata.csv")):
        # a seed other than pretraining's: a held-out sample of A
        print(f"[demo] generating {n_videos} distribution-A eval clips")
        make_synthetic_dataset(data_a, n_videos, h, w, seed=13, **DIST_A)

    t0 = time.time()
    launched, configs = [], []
    for row in rows:
        cfg = row_config(row, args, data_a, data_b, n_videos)
        out_cfg = os.path.join(args.output_base, f"_{row}.yaml")
        with open(out_cfg, "w") as f:
            yaml.safe_dump(cfg, f)
        configs.append(out_cfg)
        print(f"[demo] row {row}: {out_cfg}")
        launched += run_sweep(out_cfg, args.output_base, data_dir=data_b, run_ids=run_ids,
                              dry_run=args.dry_run, device=args.device)
    if args.dry_run:
        print(json.dumps(launched, indent=2, default=str))
        return 0

    # fail loud: rows that died at preflight or launch must not end in an
    # empty aggregation and exit 0
    ok_statuses = ("ok", "drained", "skipped (summary.json exists)")
    bad = [r for r in launched if r.get("status") not in ok_statuses]
    for r in bad:
        print(f"[demo] ROW FAILED {r.get('run_id')}: {r.get('status')}", file=sys.stderr)
    if not any(r.get("status") in ok_statuses for r in launched):
        print("[demo] no row completed: aborting before aggregation", file=sys.stderr)
        return 1

    # ---- completeness + aggregation + figures -------------------------
    series_dir = os.path.join(args.output_base, "campaign_demo")
    base_dir = os.path.join(series_dir, "NOTTA")
    aggregate(configs, args.output_base, "campaign_demo")

    # the CLIP-gate calibration over the headline row's per-video scores
    delta_dir = os.path.join(series_dir, "DELTA_A")
    if (os.path.exists(os.path.join(delta_dir, "summary.json"))
            and os.path.exists(os.path.join(base_dir, "summary.json"))):
        from ..sweep.diagnostics import clip_gate_calibration

        cal = clip_gate_calibration(delta_dir, base_dir)
        with open(os.path.join(args.output_base, "clip_gate_calibration.json"), "w") as f:
            json.dump(cal, f, indent=2)

    write_timing_table(args.output_base, "campaign_demo")
    print(f"[demo] done in {(time.time() - t0) / 60:.1f} min -> {args.output_base}"
          + (f" ({len(bad)} row(s) FAILED)" if bad else ""))
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
