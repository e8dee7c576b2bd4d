"""Online Fréchet accumulator for FVD / FID (the port's own copy of
``longcat_video_tta_tpu/eval/frechet.py``).

float64 streaming sums and outer-product moments per (generated,
ground-truth) clip pair on the host, the Fréchet distance through
``scipy.linalg.sqrtm`` with eps * I, short clips edge-padded
symmetrically to >= 9 frames (the DFoT protocol), the 224 center crop,
and a small-sample warning below ``min_videos`` (default 256). The
feature towers are ``eval/i3d.py`` (400-d per clip, ``video_feature_fn``)
and ``eval/inception.py`` (2048-d per frame, ``frame_feature_fn``); their
features leave the card once per clip. ``save_state``/``load_state``
write the moments with the runner's checkpoint cursor, in the
reference's file layout (the same keys).
"""

from __future__ import annotations

import os
from typing import Callable, Dict, Optional

import numpy as np

I3D_FEATURE_DIM = 400
INCEPTION_FEATURE_DIM = 2048
MIN_I3D_FRAMES = 9


def pad_for_i3d(frames: np.ndarray, min_frames: int = MIN_I3D_FRAMES) -> np.ndarray:
    """Symmetric edge-pad [T, H, W, 3] to at least ``min_frames``."""
    t = frames.shape[0]
    if t >= min_frames:
        return frames
    deficit = min_frames - t
    front = deficit // 2
    back = deficit - front
    return np.concatenate(
        [np.repeat(frames[:1], front, 0), frames, np.repeat(frames[-1:], back, 0)], axis=0)


def center_crop(frames: np.ndarray, size: int = 224) -> np.ndarray:
    """[T, H, W, 3] center crop; edge-replicated first where smaller."""
    t, h, w, c = frames.shape
    if h < size or w < size:
        ph, pw = max(0, size - h), max(0, size - w)
        frames = np.pad(
            frames, ((0, 0), (ph // 2, ph - ph // 2), (pw // 2, pw - pw // 2), (0, 0)),
            mode="edge")
        t, h, w, c = frames.shape
    y0, x0 = (h - size) // 2, (w - size) // 2
    return frames[:, y0:y0 + size, x0:x0 + size]


class _Moments:
    def __init__(self, dim: int):
        self.n = 0
        self.s = np.zeros(dim, np.float64)
        self.ss = np.zeros((dim, dim), np.float64)

    def update(self, feats: np.ndarray):
        feats = np.atleast_2d(feats.astype(np.float64))
        self.n += feats.shape[0]
        self.s += feats.sum(0)
        self.ss += feats.T @ feats

    def mean_cov(self):
        mu = self.s / max(self.n, 1)
        cov = self.ss / max(self.n - 1, 1) - np.outer(mu, mu) * (
            self.n / max(self.n - 1, 1)
        )
        return mu, cov


def frechet_distance(mu1, cov1, mu2, cov2, eps: float = 1e-6) -> float:
    """d^2 = |mu1-mu2|^2 + Tr(C1 + C2 - 2 sqrt(C1 C2))
    (reference: _compute_frechet_distance, scipy sqrtm + eps*I)."""
    from scipy import linalg

    diff = mu1 - mu2
    offset = np.eye(cov1.shape[0]) * eps
    covmean = linalg.sqrtm((cov1 + offset) @ (cov2 + offset))
    if np.iscomplexobj(covmean):
        covmean = covmean.real
    return float(diff @ diff + np.trace(cov1) + np.trace(cov2)
                 - 2.0 * np.trace(covmean))


class OnlineFrechetAccumulator:
    """Streaming FVD (+ optional FID) over (generated, GT) clip pairs."""

    def __init__(
        self,
        video_feature_fn: Optional[Callable] = None,
        frame_feature_fn: Optional[Callable] = None,
        min_videos: int = 256,
    ):
        self.video_feature_fn = video_feature_fn
        self.frame_feature_fn = frame_feature_fn
        self.min_videos = min_videos
        dim_v = I3D_FEATURE_DIM
        self._gen_v = _Moments(dim_v)
        self._gt_v = _Moments(dim_v)
        self._gen_f = _Moments(INCEPTION_FEATURE_DIM)
        self._gt_f = _Moments(INCEPTION_FEATURE_DIM)
        self._num_pairs = 0  # clip pairs seen, independent of which
        # feature fns are active (I3D moments stay 0 in FID-only mode)

    @property
    def enabled(self) -> bool:
        return (self.video_feature_fn is not None
                or self.frame_feature_fn is not None)

    def update(self, generated: np.ndarray, ground_truth: np.ndarray):
        """Both [T, H, W, 3] in [0, 1]."""
        self._num_pairs += 1
        if self.video_feature_fn is not None:
            self._gen_v.update(self.video_feature_fn(generated))
            self._gt_v.update(self.video_feature_fn(ground_truth))
        if self.frame_feature_fn is not None:
            self._gen_f.update(self.frame_feature_fn(generated))
            self._gt_f.update(self.frame_feature_fn(ground_truth))

    def save_state(self, path: str, next_idx: int = 0):
        """Persist the running moments so a resumed run's FVD/FID covers
        ALL videos, not just the post-resume tail (the per-video JSON
        checkpoint can't carry the 2048^2 float64 inception moments).

        ``next_idx``: the runner's checkpoint cursor AT SAVE TIME.
        Written after checkpoint.json so a crash between the two writes
        leaves this file one video BEHIND the checkpoint — the resumed
        run detects the gap from the stored cursor and reports how many
        pairs the restored moments miss, instead of ever double-counting
        a re-run video."""
        blobs = {"num_pairs": np.int64(self._num_pairs),
                 "next_idx": np.int64(next_idx)}
        for name, m in (("gen_v", self._gen_v), ("gt_v", self._gt_v),
                        ("gen_f", self._gen_f), ("gt_f", self._gt_f)):
            blobs[f"{name}_n"] = np.int64(m.n)
            blobs[f"{name}_s"] = m.s
            blobs[f"{name}_ss"] = m.ss
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            np.savez(f, **blobs)
        os.replace(tmp, path)

    def load_state(self, path: str) -> Optional[int]:
        """Restore the moments; returns the saved ``next_idx`` cursor
        (None when the file is absent)."""
        if not os.path.exists(path):
            return None
        with np.load(path) as z:
            self._num_pairs = int(z["num_pairs"])
            # legacy states (pre-cursor format) saved per video BEFORE
            # the checkpoint: coverage unknown, signalled as -1
            cursor = int(z["next_idx"]) if "next_idx" in z else -1
            for name, m in (("gen_v", self._gen_v), ("gt_v", self._gt_v),
                            ("gen_f", self._gen_f), ("gt_f", self._gt_f)):
                m.n = int(z[f"{name}_n"])
                m.s = z[f"{name}_s"]
                m.ss = z[f"{name}_ss"]
        return cursor

    def compute(self) -> Dict[str, Optional[float]]:
        out: Dict[str, Optional[float]] = {
            "fvd": None, "fid": None, "num_videos": self._num_pairs,
        }
        if self.video_feature_fn is not None and self._gen_v.n >= 2:
            if self._gen_v.n < self.min_videos:
                print(
                    f"[fvd] WARNING: only {self._gen_v.n} videos "
                    f"(< {self.min_videos}); FVD estimate is noisy."
                )
            out["fvd"] = frechet_distance(
                *self._gen_v.mean_cov(), *self._gt_v.mean_cov()
            )
        if self.frame_feature_fn is not None and self._gen_f.n >= 2:
            out["fid"] = frechet_distance(
                *self._gen_f.mean_cov(), *self._gt_f.mean_cov()
            )
        return out
