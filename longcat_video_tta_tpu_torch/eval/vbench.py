"""VBench dispatch of the PyTorch port (counterpart of
``longcat_video_tta_tpu/eval/vbench.py``): the external vbench package
when it is installed (the published protocol), else the port's native
dimensions (``eval/vbench_native.py``) over the ``.npy`` clips the port
saves."""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

VBENCH_DIMENSIONS = (
    "subject_consistency",
    "motion_smoothness",
    "temporal_flickering",
    "aesthetic_quality",
    "imaging_quality",
)


def run_vbench(video_dir: str, dimensions: Optional[List[str]] = None, mode: str = "i2v",
               towers_dir: Optional[str] = None, native: str = "fallback",
               device="cpu") -> Dict[str, object]:
    """VBench over the saved clips of ``video_dir`` on the five dimensions.

    The vbench package when installed (it gets ``device``), else the
    native dimensions: temporal_flickering and motion_smoothness always;
    subject_consistency, aesthetic_quality and imaging_quality when their
    towers are under ``towers_dir`` (loaded onto ``device``).
    ``native="force"`` skips the package even if present; ``native="off"``
    returns a skip marker without it."""
    dims = list(dimensions or VBENCH_DIMENSIONS)
    if native != "force":
        try:
            from vbench import VBench  # type: ignore
        except ImportError:
            pass
        else:
            import torch

            vb = VBench(torch.device(device), None, None)
            results = vb.evaluate(videos_path=video_dir, name="eval",
                                  dimension_list=dims, mode=mode)
            return {"skipped": False, "backend": "vbench-package",
                    "results": results, "dimensions": dims}
    if native == "off":
        return {"skipped": True, "reason": "vbench not installed in this environment",
                "dimensions": dims}
    return run_vbench_native(video_dir, dims, towers_dir, device)


def run_vbench_native(video_dir: str, dimensions: Optional[List[str]] = None,
                      towers_dir: Optional[str] = None, device="cpu") -> Dict[str, object]:
    """Score the ``*.npy`` clips of ``video_dir`` with the native
    dimensions, one clip in memory at a time, every frame it holds
    (``decode_all_frames``: no padding, which would bias the temporal
    dimensions)."""
    from pathlib import Path

    from ..data.video_io import decode_all_frames
    from ..utils.device import resolve_device
    from .vbench_native import load_native_towers, native_vbench_scores

    dims = list(dimensions or VBENCH_DIMENSIONS)
    clips = sorted(Path(video_dir).glob("*.npy"))
    if not clips:
        return {"skipped": True, "reason": f"no .npy clips in {video_dir}",
                "dimensions": dims}
    frames = {p.name: (lambda p=p: decode_all_frames(str(p)).astype(np.float32) / 255.0)
              for p in clips}
    towers = load_native_towers(towers_dir, resolve_device(device)) if towers_dir else {}
    out = native_vbench_scores(frames, towers, dims)
    return {"skipped": False, "backend": "torch-native", "dimensions": dims, **out}
