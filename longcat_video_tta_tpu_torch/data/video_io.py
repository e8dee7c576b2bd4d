"""Host-side clip loading (counterpart of the ``.npy`` branch of
``longcat_video_tta_tpu/data/video_io.py``).

Clips are ``.npy`` arrays [T, H, W, 3] (uint8, or float in [0, 1]). The
machine the port targets has no OpenCV, so an ``.mp4`` (or any other
container) raises. Resizing uses bilinear interpolation with
half-pixel centers (the reference's cv2 INTER_LINEAR convention).
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F


def decode_frames(video_path: str, num_frames: int, start_frame: int = 0,
                  target_fps: Optional[float] = None) -> np.ndarray:
    """Up to ``num_frames`` RGB frames after skipping ``start_frame``
    (padded with the last frame). Returns [T, H, W, 3] uint8.

    ``target_fps`` subsamples by stride round(24 / target) (.npy clips
    carry no fps; 24 is the reference's convention) and ``start_frame``
    counts subsampled frames."""
    if not video_path.endswith(".npy"):
        raise ValueError(f"{video_path}: only .npy clips are supported by the "
                         "PyTorch port (no video decoder on this platform); "
                         "convert the clip to a [T, H, W, 3] .npy array")
    arr = np.load(video_path)
    if arr.dtype != np.uint8:
        arr = (np.clip(arr, 0, 1) * 255).astype(np.uint8)
    stride = max(1, round(24.0 / target_fps)) if target_fps else 1
    frames = list(arr[start_frame * stride::stride][:num_frames])
    if not frames:
        raise ValueError(f"No frames decoded from {video_path}")
    while len(frames) < num_frames:
        frames.append(frames[-1])
    return np.stack(frames[:num_frames], axis=0)


def resize_frames(frames: np.ndarray, height: int, width: int) -> np.ndarray:
    """[T, H, W, 3] uint8 -> [T, height, width, 3] uint8 (bilinear)."""
    if frames.shape[1] == height and frames.shape[2] == width:
        return frames
    x = torch.from_numpy(frames).permute(0, 3, 1, 2).float()
    y = F.interpolate(x, size=(height, width), mode="bilinear", align_corners=False)
    return y.round().clamp(0, 255).to(torch.uint8).permute(0, 2, 3, 1).numpy()


def load_video_frames(video_path: str, num_frames: int, height: int = 480,
                      width: int = 832, start_frame: int = 0,
                      target_fps: Optional[float] = None) -> np.ndarray:
    """Decode + resize + scale to [-1, 1]; returns [1, 3, T, H, W] float32."""
    frames = resize_frames(decode_frames(video_path, num_frames, start_frame,
                                         target_fps=target_fps), height, width)
    x = frames.astype(np.float32) / 255.0 * 2.0 - 1.0
    return x.transpose(3, 0, 1, 2)[None]


def load_gt_frames(video_path: str, num_frames: int, height: int, width: int,
                   start_frame: int, target_fps: Optional[float] = None) -> np.ndarray:
    """Ground-truth frames for metrics: [N, H, W, 3] in [0, 1]."""
    frames = resize_frames(decode_frames(video_path, num_frames, start_frame,
                                         target_fps=target_fps), height, width)
    return frames.astype(np.float32) / 255.0


def save_video(frames: np.ndarray, path: str) -> str:
    """[N, H, W, 3] in [0, 1] -> ``<path stem>.npy`` as uint8 (no video
    encoder on this platform). Returns the written path."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    out = os.path.splitext(path)[0] + ".npy"
    np.save(out, (np.clip(frames, 0, 1) * 255).astype(np.uint8))
    return out


def annotate_borders(frames: np.ndarray, color: Tuple[int, int, int],
                     width: int = 6) -> np.ndarray:
    """Colored border annotation (green = GENERATED). [N, H, W, 3] in [0, 1]."""
    out = frames.copy()
    c = np.asarray(color, np.float32) / 255.0
    out[:, :width] = c
    out[:, -width:] = c
    out[:, :, :width] = c
    out[:, :, -width:] = c
    return out
