"""Flow-match Euler CFG sampling loop, LongCat branch (counterpart of
``longcat_video_tta_tpu/pipeline/sampler.py::sample_latents`` and
``_denoise_scan``).

CFG runs the unconditional and conditional branches as one 2B batch in
the order [uncond; cond]. The conditioning latents are either encoded
once into per-block K/V (``use_kv_cache=True``, exact thanks to the
prefix attention rule) or concatenated in front of the noise latents at
every step (``use_kv_cache=False``, the path that exercises the
attention kernel's conditioning-prefix mask). The reference's ``lax.scan``
becomes a Python loop.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from ..config import SchedulerConfig
from ..models import scheduler as sched
from ..models.dit import AdapterDict, LongCatDiT


def _denoise_loop(dit: LongCatDiT, sched_cfg: SchedulerConfig, x, sigmas,
                  emb2, mask2, g: float, cond2, kv_cache, *, n_cond: int,
                  use_kv_cache: bool, adapters: AdapterDict,
                  mark: Callable[[str], None]):
    """The CFG Euler loop over ``sigmas`` ((n_steps + 1,) fp32)."""
    B = x.shape[0]
    nt_total = n_cond + x.shape[2]
    for i in range(sigmas.shape[0] - 1):
        mark("step")
        sigma, sigma_next = sigmas[i], sigmas[i + 1]
        t_val = sched.sigma_to_timestep(sigma, sched_cfg)
        xb = torch.cat([x, x], dim=0)
        if n_cond == 0:
            v2 = dit(xb, t_val.expand(2 * B), emb2, mask2, num_cond_latents=0,
                     adapters=adapters)
        elif use_kv_cache:
            v2 = dit.forward_with_cache(xb, t_val.expand(2 * B), emb2, mask2,
                                        kv_cache, num_cond_latents=n_cond,
                                        adapters=adapters)
        else:
            full = torch.cat([cond2, xb], dim=2)
            tsteps = torch.zeros((2 * B, nt_total), dtype=torch.float32,
                                 device=x.device)
            tsteps[:, n_cond:] = t_val
            v2 = dit(full, tsteps, emb2, mask2, num_cond_latents=n_cond,
                     adapters=adapters)[:, :, n_cond:]
        v_u, v_c = v2[:B], v2[B:]
        x = sched.euler_step(x, v_u + g * (v_c - v_u), sigma, sigma_next)
    return x


def sample_latents(
    dit: LongCatDiT,
    sched_cfg: SchedulerConfig,
    text_emb: torch.Tensor,        # [B, L, C_text] (positive prompt)
    text_mask: torch.Tensor,       # [B, L]
    neg_text_emb: torch.Tensor,    # [B, L, C_text] (negative prompt)
    neg_text_mask: torch.Tensor,
    guidance_scale: float,
    *,
    num_gen_latents: int,
    num_steps: int,
    lat_h: int,
    lat_w: int,
    cond_latents: Optional[torch.Tensor] = None,  # [B, C, T_cond, H, W]
    use_kv_cache: bool = True,
    init_noise: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
    adapters: AdapterDict = None,
    on_phase: Optional[Callable[[str], None]] = None,
) -> torch.Tensor:
    """Returns denoised latents of the generated region
    [B, C, num_gen_latents, lat_h, lat_w] (normalized latent space), fp32.

    ``init_noise``: unit-variance [B, C, num_gen_latents, H, W] initial
    noise (tests inject the same draw into both packages); otherwise it
    is drawn from ``generator``. It is scaled by the first sigma.
    ``adapters`` (a TTA scheme's ``to_forward`` output) reach every DiT
    call, the cond-cache precompute included.
    ``on_phase(name)`` is called as "cond_cache" and each "step" begin."""
    mark = on_phase or (lambda name: None)
    B = text_emb.shape[0]
    C = dit.cfg.in_channels
    device = text_emb.device
    n_cond = 0 if cond_latents is None else cond_latents.shape[2]

    sigmas = sched.build_sigmas(num_steps, sched_cfg, device=device)
    if init_noise is not None:
        x = init_noise.to(device=device, dtype=torch.float32)
    else:
        x = torch.randn((B, C, num_gen_latents, lat_h, lat_w), generator=generator,
                        dtype=torch.float32, device=device)
    x = x * sigmas[0]

    emb2 = torch.cat([neg_text_emb, text_emb], dim=0)
    mask2 = torch.cat([neg_text_mask, text_mask], dim=0)

    cond2 = kv_cache = None
    if n_cond > 0:
        cond2 = torch.cat([cond_latents, cond_latents], dim=0)
        if use_kv_cache:
            mark("cond_cache")
            kv_cache = dit.precompute_cond_cache(cond2, emb2, mask2,
                                                 adapters=adapters)
    return _denoise_loop(dit, sched_cfg, x, sigmas, emb2, mask2,
                         float(guidance_scale), cond2, kv_cache, n_cond=n_cond,
                         use_kv_cache=use_kv_cache, adapters=adapters,
                         mark=mark)
