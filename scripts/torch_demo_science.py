#!/usr/bin/env python3
"""The demo science run on one GPU through the port, in one process, with
each phase timed and its B1-B3 kernel launches counted:

  1. ``pretrain_demo`` at its defaults (longcat_demo, 192x320, VAE 1200 and
     DiT 4000 steps, batch 2, seed 0) into ``--ckpt-dir``;
  2. ``run_demo_campaign`` on that checkpoint (the rows of ``--rows``, the
     YAMLs' video counts unless ``--max-videos``), with the synthetic towers;
  3. ``probe_tta_grid`` (its grid, ``--probe-n`` videos) against the
     campaign's NOTTA row.

``run_demo_campaign --pretrain`` does 1 and 2 in one call; they are split
here only to count each one's launches. The small outputs (matrix report,
timing table, all_results.json, loss curves, the CLIP-gate calibration,
the probe's grid report, PROVENANCE.json and each row's summary.json) are
copied under ``--copy-to``; the last line is a JSON record of the phases.

    python3 scripts/torch_demo_science.py --copy-to out/science
"""

import argparse
import glob
import json
import os
import shutil
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--rows", default="baseline,full,lora,delta_a")
    p.add_argument("--max-videos", type=int, default=0)
    p.add_argument("--probe-n", type=int, default=6)
    p.add_argument("--output-base", default="campaign/demo_torch")
    p.add_argument("--ckpt-dir", default="campaign/demo_ckpt_torch")
    p.add_argument("--towers-dir", default="campaign/towers_torch")
    p.add_argument("--copy-to", default=None)
    args = p.parse_args(argv)

    import torch

    from longcat_video_tta_tpu_torch.ops import flash_attention as fa
    from longcat_video_tta_tpu_torch.scripts import (
        pretrain_demo,
        probe_tta_grid,
        run_demo_campaign,
    )

    if not torch.cuda.is_available():
        print("torch_demo_science: no CUDA GPU available", file=sys.stderr)
        return 2
    smi = pretrain_demo.card_name(torch.device("cuda"))
    print(smi, flush=True)
    record = {"device": smi, "phases": {}}

    def phase(name, fn, *a):
        fa.reset_launches()
        t0 = time.time()
        out = fn(*a)
        torch.cuda.synchronize()
        record["phases"][name] = {
            "seconds": round(time.time() - t0, 1), "flash_fwd": fa.launches,
            "flash_bwd_dq": fa.bwd_dq_launches, "flash_bwd_dkv": fa.bwd_dkv_launches}
        print(f"[science] {name}: {json.dumps(record['phases'][name])}", flush=True)
        return out

    if not run_demo_campaign.checkpoint_ready(args.ckpt_dir):
        phase("pretrain", pretrain_demo.main, ["--out-dir", args.ckpt_dir])
    camp = ["--output-base", args.output_base, "--rows", args.rows,
            "--towers-dir", args.towers_dir, "--ckpt-dir", args.ckpt_dir]
    if args.max_videos:
        camp += ["--max-videos", str(args.max_videos)]
    record["campaign_rc"] = phase("campaign", run_demo_campaign.main, camp)
    probe_out = os.path.join(args.output_base, "probe")
    record["probe_rc"] = phase("probe", probe_tta_grid.main, [
        "--n", str(args.probe_n), "--out", probe_out,
        "--baseline", os.path.join(args.output_base, "campaign_demo", "NOTTA",
                                   "summary.json")])
    if args.copy_to:
        os.makedirs(args.copy_to, exist_ok=True)
        keep = [os.path.join(args.output_base, f) for f in (
            "matrix_report.txt", "timing_table.md", "all_results.json", "loss_curves.json",
            "clip_gate_calibration.json")]
        keep += [os.path.join(probe_out, "grid_report.json"),
                 os.path.join(args.ckpt_dir, "PROVENANCE.json")]
        for path in keep:
            if os.path.exists(path):
                shutil.copy(path, args.copy_to)
        for sp in glob.glob(os.path.join(args.output_base, "campaign_demo", "*",
                                         "summary.json")):
            row = os.path.basename(os.path.dirname(sp))
            shutil.copy(sp, os.path.join(args.copy_to, f"summary_{row}.json"))
    print(json.dumps(record))
    return 0 if record["campaign_rc"] == 0 and record["probe_rc"] == 0 else 1


if __name__ == "__main__":
    sys.exit(main())
