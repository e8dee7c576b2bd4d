"""Evaluation dispatcher of the PyTorch port (counterpart of
``longcat_video_tta_tpu/sweep/run_eval.py``): ``fvd`` (offline FVD/FID
over two folders of ``.npy`` clips, ``eval/offline.py``), ``vbench`` (the
VBench dimensions over a folder of saved clips, ``eval/vbench.py``) or
``best_configs`` (each series' best run by baseline-matched metric delta,
from the collected summaries).

CLI:
  python -m longcat_video_tta_tpu_torch.sweep.run_eval --mode best_configs \\
      --results-roots results
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Any, Dict, List, Optional, Sequence

from .export_results import collect_all_runs, match_baselines


def find_best_configs(results_roots: List[str],
                      metric: str = "psnr") -> Dict[str, Any]:
    """Best run per series by Δmetric vs the matched baseline (falling
    back to the raw metric when no baseline pairs)."""
    runs = collect_all_runs(results_roots)
    match_baselines(runs)
    best: Dict[str, Dict[str, Any]] = {}
    higher_better = metric != "lpips"
    for r in runs:
        series = r.get("series") or "unknown"
        val = r.get(f"delta_{metric}")
        raw = r.get(f"{metric}_mean")
        score = val if val is not None else raw
        if score is None:
            continue
        if not higher_better:
            score = -score
        cur = best.get(series)
        if cur is None or score > cur["_score"]:
            best[series] = {
                "_score": score,
                "run_id": r.get("run_id"),
                "run_dir": r.get("run_dir"),
                f"{metric}_mean": raw,
                f"delta_{metric}": val,
                "method": r.get("method"),
                "hyperparams": {k: r.get(k) for k in
                                ("lr", "steps", "num_groups", "lora_rank",
                                 "lora_alpha", "tta_total_frames")
                                if r.get(k) is not None},
            }
    for rec in best.values():
        rec.pop("_score", None)
    return best


def main(argv: Optional[Sequence[str]] = None) -> int:
    p = argparse.ArgumentParser(description="fvd | vbench | best_configs")
    p.add_argument("--mode", required=True, choices=["fvd", "vbench", "best_configs"])
    p.add_argument("--gen-dir")
    p.add_argument("--ref-dir")
    p.add_argument("--output")
    p.add_argument("--i3d-model-path")
    p.add_argument("--inception-model-path")
    p.add_argument("--vbench-towers-dir",
                   help="native-dimension towers (dino_vits16.pth, aesthetic_l14.pth + "
                        "clip_l14/, musiq_spaq.pth)")
    p.add_argument("--results-roots", nargs="+", default=["results"])
    p.add_argument("--metric", default="psnr")
    p.add_argument("--device", default="cuda",
                   help="torch device of the towers; 'cpu' runs the plain path")
    a = p.parse_args(argv)

    if a.mode == "fvd":
        if not (a.gen_dir and a.ref_dir):
            p.error("--gen-dir and --ref-dir required for fvd")
        from ..eval.offline import evaluate_fvd_dirs
        out = evaluate_fvd_dirs(a.gen_dir, a.ref_dir, a.i3d_model_path,
                                inception_model_path=a.inception_model_path,
                                device=a.device)
        dest = a.output or os.path.join(a.gen_dir, "fvd_score.json")
    elif a.mode == "vbench":
        if not a.gen_dir:
            p.error("--gen-dir required for vbench")
        from ..eval.vbench import run_vbench
        out = run_vbench(a.gen_dir, towers_dir=a.vbench_towers_dir, device=a.device)
        dest = a.output or os.path.join(a.gen_dir, "vbench_score.json")
    else:
        out = find_best_configs(a.results_roots, a.metric)
        dest = a.output or os.path.join(a.results_roots[0], "best_configs.json")
    os.makedirs(os.path.dirname(dest) or ".", exist_ok=True)
    with open(dest, "w") as f:
        json.dump(out, f, indent=2, default=str)
    print(f"[run_eval:{a.mode}] wrote {dest}")
    print(json.dumps(out, indent=2, default=str)[:2000])
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
