"""Flow-match Euler discrete scheduler as plain tensor functions.

Rectified-flow convention:
    x_sigma = (1 - sigma) * x0 + sigma * noise
    velocity target v = noise - x0
    Euler step: x_{sigma'} = x_sigma + (sigma' - sigma) * v
"""

from __future__ import annotations

import torch

from ..config import SchedulerConfig


def timestep_shift(sigmas: torch.Tensor, shift: float) -> torch.Tensor:
    """sigma' = s*sigma / (1 + (s-1)*sigma); identity when shift == 1."""
    return shift * sigmas / (1.0 + (shift - 1.0) * sigmas)


def build_sigmas(num_inference_steps: int, cfg: SchedulerConfig,
                 device=None) -> torch.Tensor:
    """The (num_steps + 1,) fp32 schedule from sigma_max down to 0."""
    sigmas = torch.linspace(1.0, 1.0 / num_inference_steps, num_inference_steps,
                            dtype=torch.float32, device=device)
    sigmas = timestep_shift(sigmas, cfg.shift) * cfg.sigma_max
    return torch.cat([sigmas, sigmas.new_zeros(1)])


def sigma_to_timestep(sigma: torch.Tensor, cfg: SchedulerConfig) -> torch.Tensor:
    """Map sigma in [0, 1] to the model's timestep input (sigma * 1000)."""
    return sigma * cfg.num_train_timesteps


def add_noise(x0: torch.Tensor, noise: torch.Tensor, sigma) -> torch.Tensor:
    """Forward noising x_sigma = (1 - sigma) * x0 + sigma * noise; ``sigma``
    a scalar or broadcastable (e.g. [B, 1, 1, 1, 1])."""
    sigma = torch.as_tensor(sigma, dtype=x0.dtype, device=x0.device)
    return (1.0 - sigma) * x0 + sigma * noise


def velocity_target(x0: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
    """The rectified-flow velocity target v = noise - x0."""
    return noise - x0


def euler_step(x: torch.Tensor, v: torch.Tensor, sigma, sigma_next) -> torch.Tensor:
    """One Euler step along dx/dsigma = v."""
    dt = torch.as_tensor(sigma_next - sigma, dtype=x.dtype, device=x.device)
    return x + dt * v
