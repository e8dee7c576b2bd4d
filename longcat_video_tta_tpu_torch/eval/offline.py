"""Offline FVD / FID over saved video folders (counterpart of
``longcat_video_tta_tpu/eval/offline.py``): the online accumulator's
protocol run afterwards over a folder of generated clips paired with a
folder of ground-truth clips, by shared stem (the runner names its
outputs ``<idx>_<video>``, so a suffix match counts), else by sorted
order when the counts agree. Clips are the ``.npy`` arrays the port's
runner saves (``data/video_io.py::save_video``).

    python -m longcat_video_tta_tpu_torch.eval.offline --gen-dir GEN \\
        --gt-dir GT --i3d-model-path i3d.pt [--inception-model-path P] \\
        [--device cuda] [--output out.json]
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from ..data.video_io import decode_frames
from .frechet import OnlineFrechetAccumulator

VIDEO_EXTS = (".npy",)


def _list_videos(d: str) -> List[str]:
    return sorted(str(p) for p in Path(d).rglob("*") if p.suffix.lower() in VIDEO_EXTS)


def _pair_by_stem(gen: List[str], gt: List[str]) -> List[tuple]:
    gt_by_stem = {Path(p).stem: p for p in gt}
    pairs = []
    for g in gen:
        stem = Path(g).stem
        match = gt_by_stem.get(stem) or next(
            (p for s, p in gt_by_stem.items() if stem.endswith(s)), None)
        if match:
            pairs.append((g, match))
    if not pairs and len(gen) == len(gt):
        pairs = list(zip(gen, gt))
    return pairs


def _frames(path: str, max_frames: int) -> np.ndarray:
    n = min(np.load(path, mmap_mode="r").shape[0], max_frames)
    return decode_frames(path, n) / 255.0


def evaluate_fvd_dirs(gen_dir: str, gt_dir: str, i3d_model_path: Optional[str] = None,
                      max_frames: int = 64, min_videos: int = 256,
                      inception_model_path: Optional[str] = None,
                      device="cuda") -> Dict:
    """FVD (and FID with Inception weights) over the paired clips; the
    towers run on ``device``."""
    from .i3d import load_i3d_params, make_i3d_feature_fn
    from .inception import load_inception_params, make_inception_feature_fn

    feat = (make_i3d_feature_fn(load_i3d_params(i3d_model_path, device))
            if i3d_model_path else None)
    frame_feat = (make_inception_feature_fn(load_inception_params(inception_model_path,
                                                                  device))
                  if inception_model_path else None)
    if feat is None and frame_feat is None:
        return {"skipped": True,
                "reason": "no local I3D/Inception weights "
                          "(--i3d-model-path / --inception-model-path)"}
    acc = OnlineFrechetAccumulator(video_feature_fn=feat, frame_feature_fn=frame_feat,
                                   min_videos=min_videos)
    pairs = _pair_by_stem(_list_videos(gen_dir), _list_videos(gt_dir))
    for g, t in pairs:
        acc.update(_frames(g, max_frames), _frames(t, max_frames))
    out = acc.compute()
    out["num_pairs"] = len(pairs)
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description="Offline FVD/FID (PyTorch port)")
    p.add_argument("--gen-dir", required=True)
    p.add_argument("--gt-dir", required=True)
    p.add_argument("--i3d-model-path", default=None)
    p.add_argument("--inception-model-path", default=None)
    p.add_argument("--device", default="cuda",
                   help="torch device of the towers; 'cpu' runs the plain path")
    p.add_argument("--output", default=None)
    args = p.parse_args(argv)
    out = evaluate_fvd_dirs(args.gen_dir, args.gt_dir, args.i3d_model_path,
                            inception_model_path=args.inception_model_path,
                            device=args.device)
    print(json.dumps(out, indent=2))
    if args.output:
        with open(args.output, "w") as f:
            json.dump(out, f, indent=2)
    return out


if __name__ == "__main__":
    main()
