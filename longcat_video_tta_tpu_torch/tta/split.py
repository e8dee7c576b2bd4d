"""TTA latent split and frame-window guards (counterpart of
``longcat_video_tta_tpu/tta/split.py``)."""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from ..config import EarlyStoppingConfig, FrameConfig


def split_tta_latents(
    latents: torch.Tensor,
    num_context_latents: int,
    holdout_fraction: float = 0.25,
) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """[B, C, T, H, W] -> (cond, train, val or None) along T.

    cond = the leading clean context (timestep 0, never noised);
    T_val = max(1, int(remainder * holdout)); a remainder too short for
    both falls back to train only."""
    t_total = latents.shape[2]
    t_cond = min(num_context_latents, t_total - 1)
    remainder = t_total - t_cond
    t_val = max(1, int(remainder * holdout_fraction))
    t_train = remainder - t_val
    if t_train < 1:
        t_train = remainder
        t_val = 0
    cond = latents[:, :, :t_cond]
    train = latents[:, :, t_cond:t_cond + t_train]
    val = latents[:, :, t_cond + t_train:] if t_val > 0 else None
    return cond, train, val


def estimate_latent_len(num_pixel_frames: int, vae_t_scale: int = 4) -> int:
    n = max(1, int(num_pixel_frames))
    return 1 + (n - 1) // int(vae_t_scale)


def estimate_tta_split_budget(
    tta_total_frames: int,
    tta_context_frames: int,
    holdout_fraction: float = 0.25,
    vae_t_scale: int = 4,
) -> Dict[str, int]:
    """The latent counts ``split_tta_latents`` will give, from frame
    counts (the pre-flight guard)."""
    t_total = estimate_latent_len(tta_total_frames, vae_t_scale)
    t_ctx = estimate_latent_len(tta_context_frames, vae_t_scale)
    t_cond = min(t_ctx, t_total - 1)
    remainder = t_total - t_cond
    t_val = max(1, int(remainder * float(holdout_fraction)))
    t_train = remainder - t_val
    if t_train < 1:
        t_train = remainder
        t_val = 0
    return {
        "total_latents": t_total,
        "cond_latents": t_cond,
        "train_latents": t_train,
        "val_latents": t_val,
    }


def round_frames_4k1_down(num_frames: int) -> int:
    """Largest 4k+1 <= num_frames (>= 1): the causal VAE encodes 4k+1
    windows exactly, so a window is trimmed at its oldest end and stays
    flush with the anchor."""
    return ((max(int(num_frames), 1) - 1) // 4) * 4 + 1


def resolve_frame_window(frames: FrameConfig) -> FrameConfig:
    """The reference's defaulting and GT-leak clamp: tta_total defaults to
    num_cond_frames, the window never crosses the anchor, and the cond
    and TTA windows are rounded down to 4k+1."""
    ncond = round_frames_4k1_down(frames.num_cond_frames)
    if ncond != frames.num_cond_frames:
        print(f"[WARN] num_cond_frames ({frames.num_cond_frames}) is not 4k+1; "
              f"using {ncond} (oldest frames dropped so the window stays flush "
              "with the anchor).")
    frames = dataclasses.replace(frames, num_cond_frames=ncond)

    total = frames.tta_total_frames
    ctx = frames.tta_context_frames
    if total is None:
        total = frames.num_cond_frames
    else:
        r = round_frames_4k1_down(total)
        if r != total:
            print(f"[WARN] tta_total_frames ({total}) is not 4k+1; using {r}.")
        total = r
    if ctx is None or ctx > total:
        ctx = min(frames.num_cond_frames, total)
    if total > frames.gen_start_frame:
        print(f"[WARN] tta_total_frames ({total}) exceeds gen_start_frame "
              f"({frames.gen_start_frame}); clamping to avoid GT leakage.")
        total = round_frames_4k1_down(frames.gen_start_frame)
    if ctx > total:
        ctx = total
    return dataclasses.replace(frames, tta_total_frames=total,
                               tta_context_frames=ctx)


def validate_tta_feature_budget(frames: FrameConfig, es: EarlyStoppingConfig,
                                guard_mode: str = "fail",
                                context: str = "") -> Dict[str, Any]:
    """Pre-flight guard: early stopping needs at least one val latent.
    guard_mode: fail | warn | off (the reference's guard; its CLIP-gate
    check is not ported, the gate itself being unported)."""
    mode = (guard_mode or "fail").lower()
    if mode not in {"fail", "warn", "off"}:
        mode = "fail"
    prefix = f"[feature_budget:{context}]" if context else "[feature_budget]"
    total = int(frames.tta_total_frames or 0)
    ctx = int(frames.tta_context_frames or 0)
    split = estimate_tta_split_budget(total, ctx, es.holdout_fraction)
    if mode != "off":
        print(f"{prefix} split(total={split['total_latents']}, "
              f"cond={split['cond_latents']}, train={split['train_latents']}, "
              f"val={split['val_latents']})")
    if es.enabled and split["val_latents"] < 1:
        msg = (f"{prefix} ES is enabled but estimated val_latents=0 "
               f"(tta_total_frames={total}, tta_context_frames={ctx}, holdout="
               f"{es.holdout_fraction}). Increase tta_total_frames and/or reduce "
               "tta_context_frames.")
        if mode == "warn":
            print(f"WARNING: {msg}")
        elif mode == "fail":
            raise RuntimeError(msg)
    return {"split_budget": split}
