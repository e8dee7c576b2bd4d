#!/usr/bin/env python3
"""How much the flash_fwd output gates catch: the kernel, and any variant
of its source, against the plain version at the main path's shapes.

    python3 scripts/torch_kernel_tolerance.py [--source FILE ...]

Builds each source (default: the package's csrc/flash_fwd.cu), runs it on
the attention shapes of chip_smoke.py's main path (decode
self-attention, cross-attention, the prefix-masked no-cache
self-attention, and the decode at the runner's default geometry) on
seeded bf16 inputs, and prints one JSON line per (source, case): the
errors against ``attention_reference``, chip_smoke's gates and whether
they hold (``ok``), and whether a fixed absolute gate on o
(max|o err| <= 1e-2, for comparison) holds. A variant with a planted fault,
such as a dropped PV term, shows which faults each gate catches. The
plain version runs once per case and every source is held to it. Needs
a CUDA GPU; imports only the port. Prints the card's name and power
limit first.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEFAULT_SOURCE = os.path.join(ROOT, "longcat_video_tta_tpu_torch", "csrc", "flash_fwd.cu")
FIXED_TOL = 1e-2


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--source", action="append",
                    help="kernel source to hold to the plain version (repeatable)")
    args = ap.parse_args()
    sources = [os.path.abspath(s) for s in (args.source or [DEFAULT_SOURCE])]

    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from longcat_video_tta_tpu_torch.config import longcat_13b
    from longcat_video_tta_tpu_torch.ops import flash_attention as fa

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    for src in sources:
        _, _, seconds = fa.build_library(src)
        print(f"[build] {src} in {seconds:.1f} s")

    cfg = longcat_13b()
    sf = cfg.vae.spatial_factor * cfg.dit.patch_size[1]
    tokens_per_frame = (cs.MAIN["height"] // sf) * (cs.MAIN["width"] // sf)
    for name, shape, opts in cs.main_path_cases(cfg.dit, tokens_per_frame):
        opts = dict(opts)
        ncond = opts.pop("ncond", 0)
        q, k, v = cs.case_inputs(*shape, **opts)
        o_ref, lse_ref = cs.reference(fa, q, k, v, ncond, None)
        for src in sources:
            fa.load_library(src)
            o, lse = fa.flash_attention(q, k, v, num_cond_tokens=ncond)
            e = cs.kernel_errors(o, lse, o_ref, lse_ref, "bfloat16")
            e["fixed_tol"] = FIXED_TOL
            e["fixed_gate_ok"] = (e["max_abs_err"] <= FIXED_TOL
                                  and e["max_abs_err_lse"] <= cs.LSE_TOL)
            print(json.dumps({"source": os.path.relpath(src, ROOT), "case": name,
                              "shape": shape, **e}))
            del o, lse
        del q, k, v, o_ref, lse_ref
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
