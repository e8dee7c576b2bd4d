"""No-TTA baseline runner of the PyTorch port (counterpart of
``longcat_video_tta_tpu/runners/run_baseline.py``): the port's runner
with ``--method none``, plus ``per_video_metrics.csv`` with the
reference's columns."""

from __future__ import annotations

import csv
import os
import sys
from typing import List, Optional

from .run_tta import main as tta_main

CSV_COLUMNS = ["index", "video", "caption", "psnr", "ssim", "lpips", "gen_time"]


def main(argv: Optional[List[str]] = None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if "--method" not in argv:
        argv = ["--method", "none"] + argv
    summary = tta_main(argv)

    out_dir = summary["config"]["output_dir"]
    csv_path = os.path.join(out_dir, "per_video_metrics.csv")
    rows = [r for r in summary["results"] if r.get("success")]
    if rows:
        with open(csv_path, "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=CSV_COLUMNS, extrasaction="ignore")
            w.writeheader()
            w.writerows(rows)
        print(f"baseline CSV: {csv_path}")
    return summary


if __name__ == "__main__":
    main()
