"""Score externally generated predictions against the ground truth (the
PyTorch port's counterpart of
``longcat_video_tta_tpu/comparisons/eval_external.py``): an external
model (DFoT, PVDM, ...) writes a folder of predicted clips, and they are
scored with the port's own PSNR / SSIM, LPIPS (``eval/lpips.py``, with
``--lpips-model-path``) and online I3D FVD (``eval/i3d.py``, with
``--i3d-model-path``) on ``--device``, so the numbers sit beside the
runner's in ``compare_all``. Clips are ``.npy`` uint8 [T, H, W, 3] arrays
(what the runner saves); they pair with the ground truth by stem
(``eval/offline.py``).

    python -m longcat_video_tta_tpu_torch.comparisons.eval_external \\
        --gen-dir GEN --gt-dir GT [--i3d-model-path P] \\
        [--lpips-model-path P] [--device cuda] [--output out.json]
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from ..data.video_io import count_frames, decode_frames
from ..eval.frechet import OnlineFrechetAccumulator
from ..eval.metrics import evaluate_generation_metrics
from ..eval.offline import _list_videos, _pair_by_stem


def evaluate_external(gen_dir: str, gt_dir: str, max_frames: int = 64,
                      i3d_model_path: Optional[str] = None,
                      lpips_model_path: Optional[str] = None, device="cuda") -> Dict:
    """Per-video PSNR / SSIM / LPIPS of the paired clips (the first
    ``max_frames`` frames of each, the shorter length of a pair), their
    means, and the FVD of the set when an I3D tower is given (None
    otherwise). The towers run on ``device``."""
    pairs = _pair_by_stem(_list_videos(gen_dir), _list_videos(gt_dir))
    if not pairs:
        raise SystemExit(f"no (gen, gt) pairs matched between {gen_dir} and {gt_dir}")
    i3d_fn = lpips_fn = None
    if i3d_model_path:
        from ..eval.i3d import load_i3d_params, make_i3d_feature_fn

        i3d_fn = make_i3d_feature_fn(load_i3d_params(i3d_model_path, device))
    if lpips_model_path:
        from ..eval.lpips import load_lpips_params, make_lpips_feature_fn

        lpips_fn = make_lpips_feature_fn(load_lpips_params(lpips_model_path, device))
    fvd = OnlineFrechetAccumulator(video_feature_fn=i3d_fn)
    rows: List[Dict] = []
    for g, t in pairs:
        gen = decode_frames(g, min(count_frames(g), max_frames)) / 255.0
        gt = decode_frames(t, min(count_frames(t), max_frames)) / 255.0
        n = min(len(gen), len(gt))
        m = evaluate_generation_metrics(gen[:n], gt[:n], device=device,
                                        lpips_feature_fn=lpips_fn)
        m["video"] = Path(g).name
        rows.append(m)
        if fvd.enabled:
            fvd.update(gen[:n], gt[:n])
    lpips = [r["lpips"] for r in rows]
    return {
        "n": len(rows),
        "psnr": float(np.mean([r["psnr"] for r in rows])),
        "ssim": float(np.mean([r["ssim"] for r in rows])),
        "lpips": float(np.nanmean(lpips)) if np.isfinite(lpips).any() else float("nan"),
        "fvd": fvd.compute().get("fvd"),
        "per_video": rows,
    }


def main(argv=None):
    p = argparse.ArgumentParser(description="Score external predictions (PyTorch port)")
    p.add_argument("--gen-dir", required=True)
    p.add_argument("--gt-dir", required=True)
    p.add_argument("--max-frames", type=int, default=64)
    p.add_argument("--i3d-model-path", default=None,
                   help="pytorch-i3d state dict or the DFoT TorchScript file: FVD")
    p.add_argument("--lpips-model-path", default=None,
                   help="state dict of lpips.LPIPS(net='alex'): LPIPS (NaN without)")
    p.add_argument("--device", default="cuda",
                   help="torch device of the metrics and towers; 'cpu' runs the plain path")
    p.add_argument("--output", default=None)
    args = p.parse_args(argv)
    out = evaluate_external(args.gen_dir, args.gt_dir, args.max_frames,
                            args.i3d_model_path, args.lpips_model_path,
                            device=args.device)
    print(json.dumps({k: v for k, v in out.items() if k != "per_video"}, indent=2))
    if args.output:
        with open(args.output, "w") as f:
            json.dump(out, f, indent=2)
    return out


if __name__ == "__main__":
    main()
