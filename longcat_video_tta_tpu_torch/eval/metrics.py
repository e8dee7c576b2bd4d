"""Per-frame generation quality metrics: PSNR / SSIM / LPIPS
(counterpart of ``longcat_video_tta_tpu/eval/metrics.py``).

- PSNR per frame, mean over frames, clamped at 50 dB.
- SSIM with an 11x11 gaussian window (sigma 1.5), the reference's
  formula exactly (no variance clamp, so flat frames can leave [-1, 1]).
- LPIPS through the AlexNet tower of ``eval/lpips.py`` (a hook made by
  ``make_lpips_feature_fn(load_lpips_params(path))``); NaN when no hook
  is given, as the reference returns without its weights.

Inputs are [T, H, W, 3] float in [0, 1].
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..utils.device import full_fp32


def psnr_per_frame(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """[T, H, W, 3] x2 -> [T] PSNR (50 dB clamp)."""
    mse = torch.mean((pred - target) ** 2, dim=(1, 2, 3))
    psnr = -10.0 * torch.log10(torch.clamp(mse, min=1e-10))
    return torch.clamp(psnr, max=50.0)


def _gaussian_kernel(size: int = 11, sigma: float = 1.5, device=None) -> torch.Tensor:
    x = torch.arange(size, dtype=torch.float32, device=device) - (size - 1) / 2.0
    g = torch.exp(-(x ** 2) / (2 * sigma ** 2))
    g = g / torch.sum(g)
    return torch.outer(g, g)


def ssim_per_frame(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Standard SSIM, 11x11 gaussian window, per frame -> [T]."""
    C1, C2 = 0.01 ** 2, 0.03 ** 2
    win = _gaussian_kernel(device=pred.device)[None, None]  # [1, 1, 11, 11]

    def filt(x):
        T, H, W, C = x.shape
        xr = x.permute(0, 3, 1, 2).reshape(T * C, 1, H, W)
        with full_fp32():  # cuDNN convolutions default to TF32
            y = F.conv2d(xr, win)
        return y.reshape(T, C, y.shape[2], y.shape[3]).permute(0, 2, 3, 1)

    mu_p, mu_t = filt(pred), filt(target)
    mu_pp, mu_tt, mu_pt = mu_p * mu_p, mu_t * mu_t, mu_p * mu_t
    sig_p = filt(pred * pred) - mu_pp
    sig_t = filt(target * target) - mu_tt
    sig_pt = filt(pred * target) - mu_pt
    ssim_map = ((2 * mu_pt + C1) * (2 * sig_pt + C2)) / (
        (mu_pp + mu_tt + C1) * (sig_p + sig_t + C2))
    return torch.mean(ssim_map, dim=(1, 2, 3))


def compute_lpips(pred, target, feature_fn: Optional[Callable] = None) -> float:
    """LPIPS mean over frames; NaN without a feature model."""
    if feature_fn is None:
        return float("nan")
    return float(np.mean(feature_fn(pred, target)))


def evaluate_generation_metrics(generated: np.ndarray, ground_truth: np.ndarray,
                                device="cpu",
                                lpips_feature_fn: Optional[Callable] = None
                                ) -> Dict[str, float]:
    """Frame-aligned PSNR/SSIM/LPIPS against the ground truth decoded
    from the anchor frame on (the LPIPS hook gets the frames on
    ``device``)."""
    n = min(len(generated), len(ground_truth))
    gen = torch.as_tensor(np.asarray(generated[:n]), dtype=torch.float32,
                          device=device)
    gt = torch.as_tensor(np.asarray(ground_truth[:n]), dtype=torch.float32,
                         device=device)
    return {
        "psnr": float(torch.mean(psnr_per_frame(gen, gt))),
        "ssim": float(torch.mean(ssim_per_frame(gen, gt))),
        "lpips": compute_lpips(gen, gt, lpips_feature_fn),
        "num_frames_scored": int(n),
    }
