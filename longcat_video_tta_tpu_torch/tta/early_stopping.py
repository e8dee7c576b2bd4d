"""Anchored early stopping for TTA (counterpart of
``longcat_video_tta_tpu/tta/early_stopping.py``): a deterministic anchor
loss on held-out val latents at fixed sigmas x fixed noise draws (seeded
from md5(video_id)), checked every ``check_every`` steps, strategies
``patience`` / ``first_rise``, a best-state snapshot and the ``state``
export with the full ``loss_history``.

The fixed noises come from ``torch.Generator``s seeded with seed + d
(the reference uses jax PRNG keys of the same seeds, so the numbers
differ); ``setup`` takes them as an argument so tests can inject the
reference's draws.

Under a mesh every rank's anchor is rank 0's (``engine.agree``), so the
ranks keep one history and decide alike (a rank that decided otherwise
would hang the next collective).

Snapshots are plain references: the engine's updates make new tensors
and never write into old ones, so the best state stays as it was when
recorded, for a few adapter tensors and for ``full``'s whole DiT alike.
For ``full`` the best snapshot is one more model's worth of memory
whenever it is neither the current state nor the initial one (which
shares the base model's storage); with the current weights, the
gradients and AdamW's mu and nu that is five copies of the weights
beside the base, and during an update the new weights and moments are
made beside the old ones.
"""

from __future__ import annotations

import hashlib
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from ..config import DiTConfig, EarlyStoppingConfig
from .adapters import AdapterScheme
from .engine import agree, anchor_loss
from .losses import flow_matching_loss_conditioned_fixed


def fixed_noise_seed(video_id: str) -> int:
    """md5-derived base seed of a video's fixed anchor noises."""
    return int(hashlib.md5(video_id.encode()).hexdigest()[:8], 16) % (2 ** 31)


def draw_fixed_noises(val_latents: torch.Tensor, seed: int,
                      noise_draws: int) -> torch.Tensor:
    """[noise_draws, *val_latents.shape] fp32, draw d from a generator
    seeded with seed + d on the latents' device."""
    device = val_latents.device
    return torch.stack([
        torch.randn(val_latents.shape, dtype=torch.float32, device=device,
                    generator=torch.Generator(device=device).manual_seed(seed + d))
        for d in range(noise_draws)])


class AnchoredEarlyStopper:
    """``anchor_fn``: the backbone's anchor loss
    (``archs.get_arch(arch).anchor``)."""

    def __init__(self, escfg: EarlyStoppingConfig, scheme: AdapterScheme,
                 dit_cfg: DiTConfig,
                 anchor_fn: Callable = flow_matching_loss_conditioned_fixed):
        self.cfg = escfg
        self.scheme = scheme
        self.dit_cfg = dit_cfg
        self.anchor_fn = anchor_fn
        self._reset()

    def _reset(self):
        self.dit = None
        self.cond_latents = None
        self.val_latents = None
        self.text_emb = None
        self.text_mask = None
        self.fixed_noises = None
        self.best_loss = float("inf")
        self.best_state = None
        self.checks_without_improvement = 0
        self.step_count = 0
        self.stopped_early = False
        self.best_step = 0
        self.loss_history: List[Tuple[int, float]] = []

    # ------------------------------------------------------------------
    def setup(self, dit, cond_latents, val_latents, text_emb, text_mask,
              video_id: str, initial_train_params,
              fixed_noises: Optional[torch.Tensor] = None):
        """Per-video initialization: keep the tensors, draw the fixed
        noises (unless given), snapshot the initial state and record its
        anchor loss."""
        self._reset()
        self.dit = dit
        self.cond_latents = cond_latents
        self.val_latents = val_latents
        self.text_emb = text_emb
        self.text_mask = text_mask
        if fixed_noises is None:
            fixed_noises = draw_fixed_noises(val_latents, fixed_noise_seed(video_id),
                                             self.cfg.noise_draws)
        self.fixed_noises = fixed_noises
        self.best_state = initial_train_params
        self.best_loss = self.anchor_loss(initial_train_params)
        self.loss_history.append((0, self.best_loss))

    def anchor_loss(self, train_params) -> float:
        return float(agree(anchor_loss(
            self.scheme, self.dit, train_params, self.cond_latents,
            self.val_latents, self.text_emb, self.text_mask, self.fixed_noises,
            self.cfg.anchor_sigmas, anchor_fn=self.anchor_fn), self.dit))

    # ------------------------------------------------------------------
    def step(self, current_step: int, train_params) -> Tuple[bool, Dict[str, Any]]:
        """Call every training step with the current trainable params.
        Returns (should_stop, info)."""
        self.step_count = current_step
        if current_step == 0 or current_step % self.cfg.check_every != 0:
            return False, {}
        return self.step_with_loss(current_step, train_params,
                                   self.anchor_loss(train_params))

    def step_with_loss(self, current_step: int, train_params,
                       anchor_loss: float) -> Tuple[bool, Dict[str, Any]]:
        """Record a precomputed anchor loss (the chunked trainer evaluates
        it after its steps) and apply the patience / first_rise rule."""
        self.step_count = current_step
        loss = float(anchor_loss)
        self.loss_history.append((current_step, loss))

        improved = loss < self.best_loss
        if improved:
            self.best_loss = loss
            self.best_step = current_step
            self.best_state = train_params
            self.checks_without_improvement = 0
        else:
            self.checks_without_improvement += 1

        info = {
            "anchor_loss": loss,
            "best_loss": self.best_loss,
            "best_step": self.best_step,
            "checks_without_improvement": self.checks_without_improvement,
        }
        should_stop = False
        if self.cfg.strategy == "patience":
            should_stop = self.checks_without_improvement >= self.cfg.patience
        elif self.cfg.strategy == "first_rise":
            should_stop = (not improved) and current_step > 0
        if should_stop:
            self.stopped_early = True
        return should_stop, info

    # ------------------------------------------------------------------
    def restore(self):
        """The best trainable params (the caller swaps them in)."""
        return self.best_state

    @property
    def state(self) -> Optional[Dict[str, Any]]:
        if not self.loss_history:
            return None
        return {
            "stopped_early": self.stopped_early,
            "best_step": self.best_step,
            "best_loss": self.best_loss,
            "total_checks": len(self.loss_history),
            "loss_history": self.loss_history,
        }


def build_early_stopper(escfg: EarlyStoppingConfig, scheme: AdapterScheme,
                        dit_cfg: DiTConfig,
                        anchor_fn: Callable = flow_matching_loss_conditioned_fixed
                        ) -> Optional[AnchoredEarlyStopper]:
    if not escfg.enabled:
        return None
    return AnchoredEarlyStopper(escfg, scheme, dit_cfg, anchor_fn)
