"""The readings a cell's correctness limits are set from, on the card:
for each seed, the program's compared numbers (a sound run), and with
``--control 1`` the control's (the plain reference in float8 put in the
program's place), and with ``--faults`` a planted fault's. All seeds run
in one process; no end-to-end metric is taken.

    python3 -m benchmark.tools.readings --workload <cell> --seeds 11,12,13 \
        [--control 1] [--faults half] [--seconds 30]

A TTA cell needs no window (its readings come from set-up's steps); a
continuation cell runs a window of ``--seconds`` so that its first
continuation finishes. Prints one JSON line per seed and reading.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time

import torch


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control", type=int, default=0)
    ap.add_argument("--faults", default="")
    ap.add_argument("--seconds", type=float, default=30.0)
    args = ap.parse_args(argv)

    from longcat_video_tta_tpu_torch.ops.flash_attention import kernel_build_dir

    from ..core import BUILD_DIR, load_cell, module_for
    from ..trace import Spans

    cell = load_cell(args.workload)
    device = torch.device("cuda", 0)
    backbone = module_for("backbones", cell.backbone)
    driver = module_for("drivers", cell.traffic["driver"])
    faults = [f for f in args.faults.split(",") if f]
    with kernel_build_dir(BUILD_DIR):
        for seed in (int(s) for s in args.seeds.split(",")):
            t0 = time.perf_counter()
            drv = driver.Driver(cell, backbone.build(cell.config, seed, device), seed, device)
            drv.setup()
            if cell.traffic["driver"] != "tta":
                drv.window(time.perf_counter() + args.seconds, Spans(False, device))
            torch.cuda.empty_cache()
            every = {"every": True} if cell.traffic["driver"] == "tta" else {}
            for kind, kw in ([("program", {})] + ([("control", {"lowp": True})]
                                                  if args.control else [])
                             + [(f"fault:{f}", {"fault": f}) for f in faults]):
                drv.check(**kw, **every)
                print(json.dumps({"workload": cell.name, "seed": seed, "reading": kind,
                                  "numbers": drv.numbers,
                                  "seconds": time.perf_counter() - t0}), flush=True)
            del drv
            gc.collect()
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
