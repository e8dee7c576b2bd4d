"""Augmentation of the TTA clip (counterpart of
``longcat_video_tta_tpu/data/augment.py``): pixel-space horizontal flip,
rotation with zoom-to-fill, temporal speed-up (stride) and slow-down
(frame repeat); the latent variants re-encode each pixel variant through
the VAE and split it as the original.

The reference rotates with ``cv2.warpAffine`` (INTER_LINEAR,
BORDER_REFLECT). The port has its own warp (``warp_affine``): the same
inverse map and the same border rule (``fedcba|abcdef``, the edge pixel
repeated, not reflect-101), with exact bilinear weights in float64. cv2's
fixed-point warp rounds each source coordinate to 1/32 of a pixel (its
bilinear weight table), which moves a coordinate by at most 1/64 + 1/1024
of a pixel, so the two warps differ by at most (1/64 + 1/1024) times the
sum of the two neighbour differences around the sample: for frames in
[0, 1], at most 2 * (1/64 + 1/1024) = 0.0332 per element. (cv2 5.0 warps
float32 frames at unrounded coordinates; the two then agree within 1e-5.)
"""

from __future__ import annotations

import math
import random
from typing import Dict, List

import numpy as np
import torch

from ..config import AugmentationConfig


def _rotation_scale(deg: float, h: int, w: int) -> float:
    """Zoom factor so a rotated frame still covers the whole canvas."""
    rad = abs(math.radians(deg))
    return math.cos(rad) + max(h / w, w / h) * math.sin(rad)


def rotation_matrix(center, deg: float, scale: float) -> np.ndarray:
    """cv2.getRotationMatrix2D: [2, 3], counter-clockwise ``deg`` about
    ``center`` (x, y) with ``scale``."""
    a = scale * math.cos(math.radians(deg))
    b = scale * math.sin(math.radians(deg))
    cx, cy = center
    return np.array([[a, b, (1 - a) * cx - b * cy],
                     [-b, a, b * cx + (1 - a) * cy]], np.float64)


def _reflect(i: np.ndarray, n: int) -> np.ndarray:
    """BORDER_REFLECT indices: fedcba|abcdef|fedcba."""
    period = 2 * n
    i = np.mod(i, period)
    return np.where(i < n, i, period - 1 - i)


def warp_affine(frames: np.ndarray, m: np.ndarray) -> np.ndarray:
    """cv2.warpAffine(f, m, (W, H), INTER_LINEAR, BORDER_REFLECT) of each
    [H, W, C] frame of ``frames`` [T, H, W, C]: dst(x, y) = src(m^-1 (x,
    y)) with pixel centres at integer coordinates, bilinear, in the
    frames' dtype."""
    t, h, w, c = frames.shape
    inv = np.linalg.inv(np.vstack([m, [0.0, 0.0, 1.0]]))[:2]
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float64)
    sx = inv[0, 0] * xs + inv[0, 1] * ys + inv[0, 2]
    sy = inv[1, 0] * xs + inv[1, 1] * ys + inv[1, 2]
    x0, y0 = np.floor(sx), np.floor(sy)
    fx, fy = (sx - x0)[..., None], (sy - y0)[..., None]
    x0, y0 = x0.astype(np.int64), y0.astype(np.int64)
    xa, xb = _reflect(x0, w), _reflect(x0 + 1, w)
    ya, yb = _reflect(y0, h), _reflect(y0 + 1, h)
    f = frames.astype(np.float64)
    top = f[:, ya, xa] * (1 - fx) + f[:, ya, xb] * fx
    bot = f[:, yb, xa] * (1 - fx) + f[:, yb, xb] * fx
    out = top * (1 - fy) + bot * fy
    if np.issubdtype(frames.dtype, np.integer):
        out = np.clip(np.rint(out), np.iinfo(frames.dtype).min, np.iinfo(frames.dtype).max)
    return out.astype(frames.dtype)


def rotate_clip(frames: np.ndarray, deg: float) -> np.ndarray:
    """Rotate [T, H, W, 3] by ``deg`` about the centre with zoom-to-fill
    (the reference's ``rotate_clip``)."""
    _, h, w, _ = frames.shape
    return warp_affine(frames, rotation_matrix((w / 2, h / 2), deg,
                                               _rotation_scale(deg, h, w)))


def speed_clip(frames: np.ndarray, factor: float) -> np.ndarray:
    """factor >= 1: stride subsample (speed-up); factor < 1: repeat frames
    (slow-down). Padded with the last frame or truncated to the input
    length."""
    t = frames.shape[0]
    if factor >= 1.0:
        out = frames[::max(1, int(round(factor)))]
    else:
        out = np.repeat(frames, max(1, int(round(1.0 / factor))), axis=0)
    if out.shape[0] < t:
        out = np.concatenate([out, np.repeat(out[-1:], t - out.shape[0], 0)], axis=0)
    return out[:t]


def parse_speed_factors(spec: str) -> List[float]:
    """"2,0.5" -> [2.0, 0.5]."""
    return [float(x) for x in spec.split(",") if x.strip()]


def build_augmented_pixel_variants(frames: np.ndarray, cfg: AugmentationConfig,
                                   seed: int = 0) -> List[Dict]:
    """[{"frames", "name"}, ...] of [T, H, W, 3] frames, the original
    first, then hflip, the fixed rotations, the random rotations (drawn
    from ``random.Random(seed)``) and the speed variants."""
    variants = [{"frames": frames, "name": "orig"}]
    if not cfg.enabled:
        return variants
    if cfg.hflip:
        variants.append({"frames": frames[:, :, ::-1].copy(), "name": "hflip"})
    for deg in cfg.rotate_degrees:
        variants.append({"frames": rotate_clip(frames, deg), "name": f"rot{deg:+g}"})
    if cfg.random_rotate and cfg.num_random_rotations > 0:
        rng = random.Random(seed)
        for i in range(cfg.num_random_rotations):
            deg = rng.uniform(-cfg.random_rotate_max_deg, cfg.random_rotate_max_deg)
            variants.append({"frames": rotate_clip(frames, deg),
                             "name": f"randrot{i}_{deg:+.1f}"})
    for f in cfg.speed_factors:
        variants.append({"frames": speed_clip(frames, f), "name": f"speed{f:g}"})
    return variants


def build_augmented_latent_variants(bundle, frames: np.ndarray, cfg: AugmentationConfig,
                                    num_context_latents: int, holdout_fraction: float,
                                    seed: int = 0) -> List[Dict]:
    """Encode each pixel variant of ``frames`` ([T, H, W, 3] in [0, 1])
    through the bundle's VAE and split it -> [{"cond", "train", "val",
    "name"}, ...]."""
    from ..tta.split import split_tta_latents

    out = []
    for v in build_augmented_pixel_variants(frames, cfg, seed):
        px = v["frames"].astype(np.float32)
        x = torch.from_numpy(np.ascontiguousarray(px.transpose(3, 0, 1, 2)[None])) * 2.0 - 1.0
        with torch.no_grad():
            lat = bundle.encode_video(x)
        cond, train, val = split_tta_latents(lat, num_context_latents, holdout_fraction)
        out.append({"cond": cond, "train": train, "val": val, "name": v["name"]})
    return out
