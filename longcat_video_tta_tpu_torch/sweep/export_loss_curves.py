"""Export anchored-ES loss curves aggregated across videos (counterpart of
``longcat_video_tta_tpu/sweep/export_loss_curves.py``, same output).

Behavior-compatible rebuild of export_loss_curves.py (SURVEY.md §2.6):
pulls ``early_stopping_info.loss_history`` ([(step, loss)]) from each
per-video result in the selected runs, aggregates mean±std per step
across videos, writes loss_curves.json in the reference's format."""

from __future__ import annotations

import argparse
import glob
import json
import os
from collections import defaultdict
from typing import Any, Dict, List, Optional

import numpy as np


def extract_curves(run_dir: str) -> Optional[Dict[str, Any]]:
    summary_path = os.path.join(run_dir, "summary.json")
    if not os.path.exists(summary_path):
        return None
    with open(summary_path) as f:
        summary = json.load(f)
    per_step: Dict[int, List[float]] = defaultdict(list)
    n_videos = 0
    for r in summary.get("results", []):
        es = r.get("early_stopping_info") or {}
        hist = es.get("loss_history") or []
        if not hist:
            continue
        n_videos += 1
        for step, loss in hist:
            per_step[int(step)].append(float(loss))
    if not per_step:
        return None
    steps = sorted(per_step)
    return {
        "run_id": os.path.basename(run_dir),
        "series": os.path.basename(os.path.dirname(run_dir)),
        "method": summary.get("method"),
        "num_videos": n_videos,
        "steps": steps,
        "mean": [float(np.mean(per_step[s])) for s in steps],
        "std": [float(np.std(per_step[s])) for s in steps],
        "n_at_step": [len(per_step[s]) for s in steps],
    }


def main(argv=None):
    p = argparse.ArgumentParser(description="Export ES loss curves")
    p.add_argument("--results-roots", nargs="+", default=["results"])
    p.add_argument("--run-dirs", nargs="*", default=None,
                   help="explicit run dirs (reference used a hand-picked "
                        "list, export_loss_curves.py:32-76)")
    p.add_argument("--output", default="loss_curves.json")
    args = p.parse_args(argv)

    run_dirs = args.run_dirs or [
        os.path.dirname(s)
        for root in args.results_roots
        for s in glob.glob(os.path.join(root, "*", "*", "summary.json"))
    ]
    curves = [c for c in (extract_curves(d) for d in run_dirs) if c]
    with open(args.output, "w") as f:
        json.dump({"curves": curves}, f, indent=2)
    print(f"wrote {args.output} ({len(curves)} curves)")
    return curves


if __name__ == "__main__":
    main()
