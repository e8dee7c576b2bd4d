"""SAVi-DNO-style diffusion noise optimization (counterpart of
``longcat_video_tta_tpu/comparisons/noise_opt.py``): optimize the initial
noise of a K-step sampler so that its sample of the training region
reconstructs the target latents,

    z* = argmin_z || sample_K(z | cond, text) - target ||^2,
    with z <- p z + sqrt(1 - p^2) fresh every ``interp_every`` steps,

by backpropagating through the whole sampler. ``sample_from_noise`` is a
K-step Euler loop through ``LongCatDiT.forward`` (no CFG) with every block
checkpointed ("full" remat: only block inputs are kept across the K
steps). The optimizer is Adam with optax's defaults (eps 1e-8, no clip, no
weight decay). Random draws come from an explicit ``torch.Generator``;
tests pass the reference's draws instead.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Iterable, List, Optional, Tuple

import torch

from ..config import OptimConfig, SchedulerConfig
from ..models import scheduler as sched
from ..models.dit import LongCatDiT
from ..ops.quant import shallow_module
from ..tta.engine import Optimizer


def sample_from_noise(dit: LongCatDiT, sched_cfg: SchedulerConfig, noise: torch.Tensor,
                      cond_latents: torch.Tensor, text_emb, text_mask, *,
                      num_steps: int) -> torch.Tensor:
    """Differentiable K-step Euler sample of the region after
    ``cond_latents`` from ``noise`` [B, C, Lg, H, W] (unit variance): the
    conditional path only, the conditioning latents at timestep 0 in front
    of the noisy ones at every step. Returns fp32 [B, C, Lg, H, W]."""
    remat_dit = shallow_module(dit)
    remat_dit.cfg = dataclasses.replace(dit.cfg, remat=True, remat_policy="full")
    B, n_cond = noise.shape[0], cond_latents.shape[2]
    nt_total = n_cond + noise.shape[2]
    sigmas = sched.build_sigmas(num_steps, sched_cfg, device=noise.device)
    x = noise * sigmas[0]
    for i in range(num_steps):
        sigma, sigma_next = sigmas[i], sigmas[i + 1]
        full = torch.cat([cond_latents.float(), x.float()], dim=2)
        tsteps = torch.zeros((B, nt_total), dtype=torch.float32, device=noise.device)
        tsteps[:, n_cond:] = sched.sigma_to_timestep(sigma, sched_cfg)
        v = remat_dit(full, tsteps, text_emb, text_mask,
                      num_cond_latents=n_cond)[:, :, n_cond:]
        x = sched.euler_step(x, v, sigma, sigma_next)
    return x


def build_dno_optimizer(lr: float) -> Optimizer:
    """optax.adam(lr): b1 0.9, b2 0.999, eps 1e-8, no clip, no decay."""
    return Optimizer(OptimConfig(optimizer="adamw", lr=lr, eps=1e-8, weight_decay=0.0,
                                 grad_clip_norm=math.inf))


def make_dno_step(sched_cfg: SchedulerConfig, opt: Optimizer,
                  num_steps: int = 4) -> Callable:
    """step(noise, opt_state, dit, cond, target, text_emb, text_mask) ->
    (noise, opt_state, loss 0-d on the device): one Adam step on the
    noise against the fp32 MSE of its K-step sample to the target."""

    def step(noise, opt_state, dit, cond_latents, target_latents, text_emb, text_mask):
        z = noise.detach().requires_grad_(True)
        with torch.enable_grad():
            gen = sample_from_noise(dit, sched_cfg, z, cond_latents, text_emb, text_mask,
                                    num_steps=num_steps)
            loss = ((gen - target_latents.float()) ** 2).mean()
            (grad,) = torch.autograd.grad(loss, [z])
        new, opt_state = opt.update({"noise": grad}, opt_state, {"noise": noise})
        return new["noise"], opt_state, loss.detach()

    return step


def noise_interp(noise: torch.Tensor, generator: Optional[torch.Generator] = None,
                 p: float = 0.9, fresh: Optional[torch.Tensor] = None) -> torch.Tensor:
    """SAVi-DNO's noise interpolation z <- p z + sqrt(1 - p^2) fresh (unit
    marginal variance kept); ``fresh`` is drawn from ``generator`` unless
    given."""
    if fresh is None:
        fresh = torch.randn(noise.shape, generator=generator, dtype=noise.dtype,
                            device=noise.device)
    return p * noise + math.sqrt(1.0 - p * p) * fresh


def optimize_noise(dit: LongCatDiT, sched_cfg: SchedulerConfig, cond_latents,
                   target_latents, text_emb, text_mask,
                   generator: Optional[torch.Generator] = None, *,
                   num_opt_steps: int = 20, sampler_steps: int = 4, lr: float = 0.01,
                   interp_p: float = 0.9, interp_every: int = 5,
                   init_noise: Optional[torch.Tensor] = None,
                   fresh_noises: Optional[Iterable[torch.Tensor]] = None,
                   ) -> Tuple[torch.Tensor, Dict[str, List[float]]]:
    """The DNO loop -> (optimized noise shaped like ``target_latents``,
    {"losses": [...]}). The initial noise and the interpolation draws come
    from ``generator`` unless ``init_noise`` / ``fresh_noises`` (one per
    interpolation, in order) are given."""
    opt = build_dno_optimizer(lr)
    step = make_dno_step(sched_cfg, opt, sampler_steps)
    noise = init_noise
    if noise is None:
        noise = torch.randn(target_latents.shape, generator=generator,
                            dtype=torch.float32, device=target_latents.device)
    fresh = iter(fresh_noises) if fresh_noises is not None else None
    opt_state = opt.init({"noise": noise})
    losses: List[float] = []
    for i in range(num_opt_steps):
        noise, opt_state, loss = step(noise, opt_state, dit, cond_latents,
                                      target_latents, text_emb, text_mask)
        losses.append(float(loss))
        if interp_p < 1.0 and (i + 1) % interp_every == 0:
            noise = noise_interp(noise, generator, interp_p,
                                 None if fresh is None else next(fresh))
    return noise, {"losses": losses}
