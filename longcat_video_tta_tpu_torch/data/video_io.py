"""Host-side clip loading (counterpart of the ``.npy`` branch of
``longcat_video_tta_tpu/data/video_io.py``).

Clips are ``.npy`` arrays [T, H, W, 3] (uint8, or float in [0, 1]). The
machine the port targets has no OpenCV, so an ``.mp4`` (or any other
container) raises. ``resize_frames`` computes what the reference's cv2
``INTER_LINEAR`` computes on uint8 frames, in integer numpy without cv2.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np


def _require_npy(video_path: str) -> None:
    if not video_path.endswith(".npy"):
        raise ValueError(f"{video_path}: only .npy clips are supported by the "
                         "PyTorch port (no video decoder on this platform); "
                         "convert the clip to a [T, H, W, 3] .npy array")


def _load_npy(video_path: str) -> np.ndarray:
    """The clip as [T, H, W, 3] uint8 (float clips in [0, 1] scaled)."""
    _require_npy(video_path)
    arr = np.load(video_path)
    if arr.dtype != np.uint8:
        arr = (np.clip(arr, 0, 1) * 255).astype(np.uint8)
    return arr


def decode_frames(video_path: str, num_frames: int, start_frame: int = 0,
                  target_fps: Optional[float] = None) -> np.ndarray:
    """Up to ``num_frames`` RGB frames after skipping ``start_frame``
    (padded with the last frame). Returns [T, H, W, 3] uint8.

    ``target_fps`` subsamples by stride round(24 / target) (.npy clips
    carry no fps; 24 is the reference's convention) and ``start_frame``
    counts subsampled frames."""
    arr = _load_npy(video_path)
    stride = max(1, round(24.0 / target_fps)) if target_fps else 1
    frames = list(arr[start_frame * stride::stride][:num_frames])
    if not frames:
        raise ValueError(f"No frames decoded from {video_path}")
    while len(frames) < num_frames:
        frames.append(frames[-1])
    return np.stack(frames[:num_frames], axis=0)


# cv2's fixed-point resize: 11-bit coefficients (INTER_RESIZE_COEF_BITS)
_COEF_BITS = 11
_COEF_SCALE = 1 << _COEF_BITS


def _linear_taps(src: int, dst: int, clamp_ends: bool):
    """(first index, second index, first weight, second weight) of cv2's
    INTER_LINEAR along one axis, as its ``resizeGeneric_`` set-up computes
    them: the source position (d + 0.5) * src / dst - 0.5 in double,
    rounded to fp32, its floor and fraction in fp32, the two weights
    ``saturate_cast<short>`` (round half to even) of (1 - f) * 2048 and f *
    2048. Along x (``clamp_ends``) a position before the first or past the
    last pixel takes that pixel whole; along y the fraction stays and both
    row indices are clamped into the image."""
    scale = 1.0 / (dst / src)
    f = ((np.arange(dst, dtype=np.float64) + 0.5) * scale - 0.5).astype(np.float32)
    s = np.floor(f).astype(np.int64)
    f = (f - s.astype(np.float32)).astype(np.float32)
    if clamp_ends:
        lo, hi = s < 0, s >= src - 1
        f[lo | hi] = 0.0
        s[lo] = 0
        s[hi] = src - 1
    w0 = np.rint((np.float32(1.0) - f) * np.float32(_COEF_SCALE)).astype(np.int64)
    w1 = np.rint(f * np.float32(_COEF_SCALE)).astype(np.int64)
    return np.clip(s, 0, src - 1), np.clip(s + 1, 0, src - 1), w0, w1


def resize_frames(frames: np.ndarray, height: int, width: int) -> np.ndarray:
    """[T, H, W, C] uint8 -> [T, height, width, C] uint8, equal to cv2
    ``resize(..., INTER_LINEAR)`` per frame. The horizontal pass keeps
    exact integer sums of two pixels times their 11-bit weights; the
    vertical pass is cv2's vector path (``VResizeLinearVec_32s8u``): each
    row sum shifted right by 4, multiplied by its 16-bit weight keeping
    the high 16 bits, the two added, then a rounding shift by 2 and a
    saturation to [0, 255]. An exact 2x downscale, which cv2 sends to
    INTER_AREA, gives the same 2 x 2 mean with these weights."""
    if frames.shape[1] == height and frames.shape[2] == width:
        return frames
    x0, x1, a0, a1 = _linear_taps(frames.shape[2], width, clamp_ends=True)
    y0, y1, b0, b1 = _linear_taps(frames.shape[1], height, clamp_ends=False)
    out = np.empty((frames.shape[0], height, width) + frames.shape[3:], np.uint8)
    a0, a1 = a0[:, None], a1[:, None]
    b0, b1 = b0[:, None, None], b1[:, None, None]
    for t, frame in enumerate(frames):
        x = frame.astype(np.int64).reshape(frame.shape[0], frame.shape[1], -1)
        rows = x[:, x0] * a0 + x[:, x1] * a1           # [H, width, C]
        v = (((rows[y0] >> 4) * b0) >> 16) + (((rows[y1] >> 4) * b1) >> 16)
        out[t] = np.clip((v + 2) >> 2, 0, 255).reshape(out.shape[1:])
    return out


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


def decode_all_frames(video_path: str, target_fps: Optional[float] = None) -> np.ndarray:
    """Every frame of a clip (stride round(24 / target) with ``target_fps``),
    without ``decode_frames``' padding: [T, H, W, 3] uint8, T the count
    the clip holds (the temporal VBench dimensions would score a padded
    duplicate pair as perfectly smooth)."""
    arr = _load_npy(video_path)
    stride = max(1, round(24.0 / target_fps)) if target_fps else 1
    frames = arr[::stride]
    if not len(frames):
        raise ValueError(f"No frames decoded from {video_path}")
    return np.ascontiguousarray(frames)


def count_frames(video_path: str) -> int:
    """The clip's frame count (read from the .npy header)."""
    _require_npy(video_path)
    return int(np.load(video_path, mmap_mode="r").shape[0])


def native_fps(video_path: str) -> float:
    """24.0: .npy clips carry no fps (the convention of ``decode_frames``'
    target_fps stride)."""
    _require_npy(video_path)
    return 24.0


def validate_decodable(video_path: str) -> bool:
    """Whether one frame of the clip can be read (False for a container
    file, which the port cannot decode)."""
    try:
        decode_frames(video_path, 1)
        return True
    except Exception:
        return False


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
