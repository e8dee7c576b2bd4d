"""Unified comparison table across methods and external baselines (the
PyTorch port's copy of ``longcat_video_tta_tpu/comparisons/compare_all.py``):
read any number of run summaries (the runner's summary.json) and
external-prediction eval JSONs (``eval_external``), print one table.

    python -m longcat_video_tta_tpu_torch.comparisons.compare_all \
        ours=RUN/summary.json ext=ext.json [--output table.json]
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Dict, List


def load_row(path: str, label: str = None) -> Dict:
    with open(path) as f:
        s = json.load(f)
    row = {"label": label or os.path.basename(os.path.dirname(path))}
    if "metrics" in s:   # our summary.json
        m = s["metrics"]
        row.update({
            "psnr": (m.get("psnr") or {}).get("mean"),
            "ssim": (m.get("ssim") or {}).get("mean"),
            "lpips": (m.get("lpips") or {}).get("mean"),
            "fvd": (s.get("online_eval") or {}).get("fvd"),
            "train_s": s.get("avg_train_time"),
            "n": s.get("num_success"),
        })
    else:                # external eval json (eval_external / offline fvd)
        row.update({k: s.get(k) for k in
                    ("psnr", "ssim", "lpips", "fvd", "n")})
    return row


def print_table(rows: List[Dict]) -> str:
    cols = ["label", "psnr", "ssim", "lpips", "fvd", "train_s", "n"]
    lines = ["  ".join(f"{c:>10}" for c in cols), "-" * 80]
    for r in rows:
        cells = []
        for c in cols:
            v = r.get(c)
            if isinstance(v, float):
                cells.append(f"{v:>10.3f}")
            else:
                cells.append(f"{str(v) if v is not None else '—':>10}")
        lines.append("  ".join(cells))
    out = "\n".join(lines)
    print(out)
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description="Unified comparison table")
    p.add_argument("summaries", nargs="+",
                   help="summary.json / eval json paths, optionally "
                        "label=path")
    p.add_argument("--output", default=None)
    args = p.parse_args(argv)
    rows = []
    for spec in args.summaries:
        label, _, path = spec.rpartition("=")
        rows.append(load_row(path, label or None))
    table = print_table(rows)
    if args.output:
        with open(args.output, "w") as f:
            json.dump({"rows": rows, "table": table}, f, indent=2)
    return rows


if __name__ == "__main__":
    main()
