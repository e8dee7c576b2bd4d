"""Flow-match Euler CFG sampling loop, LongCat branch (counterpart of
``longcat_video_tta_tpu/pipeline/sampler.py::sample_latents``,
``sample_latents_segmented`` and ``_denoise_scan``).

CFG runs the unconditional and conditional branches as one 2B batch in
the order [uncond; cond]. The conditioning latents are either encoded
once into per-block K/V (``use_kv_cache=True``, exact thanks to the
prefix attention rule) or concatenated in front of the noise latents at
every step (``use_kv_cache=False``, the path that exercises the
attention kernel's conditioning-prefix mask). The reference's ``lax.scan``
becomes a Python loop, and its traced per-step flags become host lists.

Decode levers, as in the reference: block-sparse attention (``bsa_cfg``,
KV-cache path), Pyramid Attention Broadcast (``pab_cfg``: a per-block
self-attention cache reused on the flagged steps), CFG guidance-delta
reuse (``cfgr_cfg``: on the flagged steps only the conditional branch
runs and ``v_uncond = v_cond - delta`` with the delta of the last full
step; under PAB the conditional half of the attention cache is still
refreshed), gen-horizon bucketing (``num_valid_gen_latents``) and
segmented dispatch (``sample_latents_segmented``).
"""

from __future__ import annotations

from typing import Callable, List, Optional

import torch

from ..config import BSAConfig, CFGReuseConfig, PABConfig, SchedulerConfig
from ..models import scheduler as sched
from ..models.dit import AdapterDict, LongCatDiT, pab_init_cache


def _pab_reuse_flags(num_steps: int, pab_cfg) -> List[bool]:
    """True = reuse the attention cache at that step. Steps outside
    [start_frac, end_frac) and every ``every``-th step inside it
    recompute (refreshing the cache)."""
    start = int(round(pab_cfg.start_frac * num_steps))
    end = int(round(pab_cfg.end_frac * num_steps))
    return [start <= i < end and (i - start) % max(1, pab_cfg.every) != 0
            for i in range(num_steps)]


def _cfg_reuse_flags(num_steps: int, cfgr_cfg) -> List[bool]:
    """True = reuse the guidance delta at that step (conditional-branch
    forward only). PAB's schedule, except that step 0 never reuses (the
    delta starts at zeros)."""
    flags = _pab_reuse_flags(num_steps, cfgr_cfg)
    if flags:
        flags[0] = False
    return flags


def _sample(dit: LongCatDiT, sched_cfg: SchedulerConfig, text_emb, text_mask,
            neg_text_emb, neg_text_mask, guidance_scale: float, *,
            num_gen_latents: int, num_steps: int, lat_h: int, lat_w: int,
            cond_latents=None, use_kv_cache: bool = True, init_noise=None,
            generator=None, adapters: AdapterDict = None,
            bsa_cfg: Optional[BSAConfig] = None, pab_cfg: Optional[PABConfig] = None,
            cfgr_cfg: Optional[CFGReuseConfig] = None,
            num_valid_gen_latents: Optional[int] = None, segment_steps: int = 0,
            on_phase: Optional[Callable[[str], None]] = None) -> torch.Tensor:
    mark = on_phase or (lambda name: None)
    B = text_emb.shape[0]
    C = dit.cfg.in_channels
    device = text_emb.device
    n_cond = 0 if cond_latents is None else cond_latents.shape[2]
    nv = num_valid_gen_latents
    if pab_cfg is not None and n_cond > 0 and not use_kv_cache:
        raise NotImplementedError(
            "PAB is implemented for the KV-cache continuation path and t2v; "
            "drop pab_cfg for no-cache continuation sampling")

    sigmas = sched.build_sigmas(num_steps, sched_cfg, device=device)
    if init_noise is not None:
        x = init_noise.to(device=device, dtype=torch.float32)
    else:
        x = torch.randn((B, C, num_gen_latents, lat_h, lat_w), generator=generator,
                        dtype=torch.float32, device=device)
    x = x * sigmas[0]

    emb2 = torch.cat([neg_text_emb, text_emb], dim=0)
    mask2 = torch.cat([neg_text_mask, text_mask], dim=0)
    g = float(guidance_scale)

    cond2 = kv_cache = None
    if n_cond > 0:
        cond2 = torch.cat([cond_latents, cond_latents], dim=0)
        if use_kv_cache:
            mark("cond_cache")
            kv_cache = dit.precompute_cond_cache(cond2, emb2, mask2, adapters=adapters)

    pab_state, pab_flags = None, [False] * num_steps
    if pab_cfg is not None:
        pab_state = pab_init_cache(dit.cfg, 2 * B, num_gen_latents, lat_h, lat_w,
                                   device=device)
        pab_flags = _pab_reuse_flags(num_steps, pab_cfg)
    cfg_delta, cfg_flags = None, [False] * num_steps
    if cfgr_cfg is not None:
        cfg_delta = torch.zeros((B, dit.cfg.out_channels, num_gen_latents, lat_h, lat_w),
                                dtype=torch.float32, device=device)
        cfg_flags = _cfg_reuse_flags(num_steps, cfgr_cfg)

    def forward(x, t_val, pab_reuse: bool, cond_only: bool):
        """One model forward: the CFG pair as one 2B batch, or with
        ``cond_only`` the conditional branch alone (batch B)."""
        nb = B if cond_only else 2 * B
        xb = x if cond_only else torch.cat([x, x], dim=0)
        emb, msk = (emb2[B:], mask2[B:]) if cond_only else (emb2, mask2)
        t = t_val.expand(nb)
        if n_cond == 0:
            return dit(xb, t, emb, msk, num_cond_latents=0, adapters=adapters,
                       num_valid_latents=nv, pab_reuse=pab_reuse,
                       pab_cache=pab_state, cache_cond_half=cond_only)
        if use_kv_cache:
            return dit.forward_with_cache(
                xb, t, emb, msk, kv_cache, num_cond_latents=n_cond, adapters=adapters,
                bsa_cfg=bsa_cfg, num_valid_latents=nv, pab_reuse=pab_reuse,
                pab_cache=pab_state, cache_cond_half=cond_only)
        cnd = cond2[B:] if cond_only else cond2
        full = torch.cat([cnd, xb], dim=2)
        tsteps = torch.zeros((nb, n_cond + x.shape[2]), dtype=torch.float32,
                             device=x.device)
        tsteps[:, n_cond:] = t_val
        return dit(full, tsteps, emb, msk, num_cond_latents=n_cond, adapters=adapters,
                   num_valid_latents=None if nv is None else n_cond + nv
                   )[:, :, n_cond:]

    seg = max(1, int(segment_steps)) if segment_steps else num_steps
    for i in range(num_steps):
        mark("step")
        sigma, sigma_next = sigmas[i], sigmas[i + 1]
        t_val = sched.sigma_to_timestep(sigma, sched_cfg)
        if cfg_flags[i]:
            v_c = forward(x, t_val, pab_flags[i], cond_only=True)
            v2 = torch.cat([v_c - cfg_delta.to(v_c.dtype), v_c], dim=0)
        else:
            v2 = forward(x, t_val, pab_flags[i], cond_only=False)
            if cfg_delta is not None:
                cfg_delta = v2[B:] - v2[:B]
        v_u, v_c = v2[:B], v2[B:]
        x = sched.euler_step(x, v_u + g * (v_c - v_u), sigma, sigma_next)
        if (i + 1) % seg == 0 and i + 1 < num_steps and x.is_cuda:
            torch.cuda.synchronize(x.device)  # bound the work in flight
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
    bsa_cfg: Optional[BSAConfig] = None,
    pab_cfg: Optional[PABConfig] = None,
    cfgr_cfg: Optional[CFGReuseConfig] = None,
    num_valid_gen_latents: Optional[int] = None,
    on_phase: Optional[Callable[[str], None]] = None,
) -> torch.Tensor:
    """Returns denoised latents of the generated region
    [B, C, num_gen_latents, lat_h, lat_w] (normalized latent space), fp32.

    ``init_noise``: unit-variance [B, C, num_gen_latents, H, W] initial
    noise (tests inject the same draw into both packages); otherwise it
    is drawn from ``generator``. It is scaled by the first sigma.
    ``adapters`` (a TTA scheme's ``to_forward`` output) reach every DiT
    call, the cond-cache precompute included. ``num_valid_gen_latents``:
    ``num_gen_latents`` is a bucket and latent frames past this count are
    padding, masked out of attention (the caller slices them off).
    ``on_phase(name)`` is called as "cond_cache" and each "step" begin."""
    return _sample(dit, sched_cfg, text_emb, text_mask, neg_text_emb, neg_text_mask,
                   guidance_scale, num_gen_latents=num_gen_latents,
                   num_steps=num_steps, lat_h=lat_h, lat_w=lat_w,
                   cond_latents=cond_latents, use_kv_cache=use_kv_cache,
                   init_noise=init_noise, generator=generator, adapters=adapters,
                   bsa_cfg=bsa_cfg, pab_cfg=pab_cfg, cfgr_cfg=cfgr_cfg,
                   num_valid_gen_latents=num_valid_gen_latents, on_phase=on_phase)


def sample_latents_segmented(dit: LongCatDiT, sched_cfg: SchedulerConfig, text_emb,
                             text_mask, neg_text_emb, neg_text_mask, guidance_scale,
                             *, segment_steps: int, **kwargs) -> torch.Tensor:
    """``sample_latents`` with the device synchronized after every
    ``segment_steps`` steps (the reference splits its scan into one
    dispatch per segment to bound single executions). The per-step
    arithmetic is the same loop, so the result is identical."""
    return _sample(dit, sched_cfg, text_emb, text_mask, neg_text_emb, neg_text_mask,
                   guidance_scale, segment_steps=segment_steps, **kwargs)
