"""Flow-match Euler CFG sampling loops (counterpart of
``longcat_video_tta_tpu/pipeline/sampler.py``): the LongCat branch
(``sample_latents``, ``sample_latents_segmented``, the reference's
``_denoise_scan``) and the Open-Sora v2 MMDiT branch
(``sample_latents_mmdit``, ``sample_latents_mmdit_segmented``).

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

The MMDiT branch re-denoises the whole [cond | gen] latent volume every
step with triple CFG over one 3B batch [cond, uncond, uncond2] (prompt,
negative with the conditioning, negative without it), combined as
``u2 + g_img (u - u2) + g (c - u)``, on the Flux resolution-shifted
schedule; PAB and CFG reuse as in the reference (a reuse step runs the
conditional third alone and rebuilds u and u2 from the two deltas of the
last full step).

The CogVideoX branch (``sample_latents_cogvideox``,
``sample_latents_cogvideox_segmented``) is DDIM (eta 0) on v-prediction
over the zero-terminal-SNR schedule, also over the whole volume, with
2-row CFG [neg, pos] (uncond first) and the I2V image latents on the
channels; PAB caches each block's attention module output, and a
CFG-reuse step runs the conditional rows alone against the cache's
second half and rebuilds uncond = cond - delta.
"""

from __future__ import annotations

from typing import Callable, List, Optional

import torch

from ..config import BSAConfig, CFGReuseConfig, PABConfig, SchedulerConfig
from ..models import scheduler as sched
from ..models.cogvideox import CogVideoX, pab_init_cache_cogvideox
from ..models.dit import AdapterDict, LongCatDiT, pab_init_cache
from ..models.mmdit import MMDiT, pab_init_cache_mmdit
from ..utils.spans import span


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
            with span("sampler.cond_cache"):
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
        with span("sampler.step"):
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


# ---------------------------------------------------------------------------
# MMDiT (Open-Sora v2) sampling
# ---------------------------------------------------------------------------


def flux_time_shift(ts: torch.Tensor, image_seq_len: int) -> torch.Tensor:
    """The Flux / Open-Sora resolution-shifted schedule: mu linear in the
    image token count between (256, 0.5) and (4096, 1.15); each t > 0
    maps to exp(mu) / (exp(mu) + (1/t - 1)), t = 0 stays 0."""
    import math

    m = (1.15 - 0.5) / (4096 - 256)
    e = math.exp(m * image_seq_len + (0.5 - m * 256))
    safe = torch.where(ts > 0, ts, torch.ones_like(ts))
    return torch.where(ts > 0, e / (e + (1.0 / safe - 1.0)), torch.zeros_like(ts))


def _mmdit_setup(cfg, txt3, num_gen_latents, num_steps, lat_h, lat_w, cond_latents,
                 shift, init_x=None, generator=None):
    """(x, cond3, t_pairs) of both MMDiT samplers: the initial volume
    [B, C, T_cond + num_gen, H, W] (``init_x`` when given, else drawn from
    ``generator``), the triple-CFG conditioning [cond_in, cond_in, 0] and
    the (t_curr, t_prev) pairs of the schedule."""
    from ..tta.losses import mmdit_cond_input

    B = txt3.shape[0] // 3
    device = txt3.device
    t_cond = 0 if cond_latents is None else cond_latents.shape[2]
    T = t_cond + num_gen_latents
    shape = (B, cfg.in_channels, T, lat_h, lat_w)
    if init_x is not None:
        if tuple(init_x.shape) != shape:
            raise ValueError(f"init_x {tuple(init_x.shape)} != {shape}")
        x = init_x.to(device=device, dtype=torch.float32)
    else:
        x = torch.randn(shape, generator=generator, dtype=torch.float32, device=device)
    cond3 = None
    if cond_latents is not None:
        cond_in = mmdit_cond_input(cond_latents, T)
        cond3 = torch.cat([cond_in, cond_in, torch.zeros_like(cond_in)], dim=0)
    ts = torch.linspace(1.0, 0.0, num_steps + 1, dtype=torch.float32, device=device)
    if shift:
        ts = flux_time_shift(ts, T * (lat_h // cfg.patch_size) * (lat_w // cfg.patch_size))
    return x, cond3, torch.stack([ts[:-1], ts[1:]], dim=1)


def _sample_mmdit(dit: MMDiT, txt3, y_vec3, *, num_gen_latents: int, num_steps: int,
                  lat_h: int, lat_w: int, cond_latents=None, adapters: AdapterDict = None,
                  guidance: float = 7.5, guidance_img: float = 3.0, shift: bool = True,
                  pab_cfg: Optional[PABConfig] = None,
                  cfgr_cfg: Optional[CFGReuseConfig] = None, init_x=None, generator=None,
                  segment_steps: int = 0,
                  on_phase: Optional[Callable[[str], None]] = None) -> torch.Tensor:
    mark = on_phase or (lambda name: None)
    cfg = dit.cfg
    B = txt3.shape[0] // 3
    x, cond3, t_pairs = _mmdit_setup(cfg, txt3, num_gen_latents, num_steps, lat_h,
                                     lat_w, cond_latents, shift, init_x, generator)
    g_vec = torch.full((3 * B,), guidance, dtype=torch.float32, device=x.device)
    t_cond = 0 if cond_latents is None else cond_latents.shape[2]
    cache, pab_flags = None, [False] * num_steps
    if pab_cfg is not None:
        cache = pab_init_cache_mmdit(cfg, 3 * B, t_cond + num_gen_latents, lat_h, lat_w,
                                     txt3.shape[1], device=x.device)
        pab_flags = _pab_reuse_flags(num_steps, pab_cfg)
    deltas, cfg_flags = None, [False] * num_steps
    if cfgr_cfg is not None:
        deltas = (torch.zeros_like(x), torch.zeros_like(x))
        cfg_flags = _cfg_reuse_flags(num_steps, cfgr_cfg)

    def forward(x, t_curr, p_reuse, cond_only):
        nb = B if cond_only else 3 * B
        xb = x if cond_only else torch.cat([x, x, x], dim=0)
        rows = slice(0, nb)
        return dit(xb, t_curr.expand(nb), txt3[rows], y_vec3[rows],
                   cond=None if cond3 is None else cond3[rows], guidance=g_vec[rows],
                   adapters=adapters, pab_reuse=p_reuse, pab_cache=cache,
                   cache_cond_first=cond_only)

    seg = max(1, int(segment_steps)) if segment_steps else num_steps
    for i in range(num_steps):
        mark("step")
        with span("sampler.step"):
            t_curr, t_prev = t_pairs[i, 0], t_pairs[i, 1]
            if cfg_flags[i]:
                cp = forward(x, t_curr, pab_flags[i], cond_only=True)
                up = cp - deltas[0].to(cp.dtype)
                u2p = up - deltas[1].to(cp.dtype)
            else:
                pred = forward(x, t_curr, pab_flags[i], cond_only=False)
                cp, up, u2p = pred[:B], pred[B:2 * B], pred[2 * B:]
                if deltas is not None:
                    deltas = (cp - up, up - u2p)
            combined = u2p + guidance_img * (up - u2p) + guidance * (cp - up)
            x = x + (t_prev - t_curr) * combined
        if (i + 1) % seg == 0 and i + 1 < num_steps and x.is_cuda:
            torch.cuda.synchronize(x.device)  # bound the work in flight
    return x


def sample_latents_mmdit(dit: MMDiT, txt3: torch.Tensor, y_vec3: torch.Tensor, *,
                         num_gen_latents: int, num_steps: int, lat_h: int, lat_w: int,
                         cond_latents: Optional[torch.Tensor] = None,
                         adapters: AdapterDict = None, guidance: float = 7.5,
                         guidance_img: float = 3.0, shift: bool = True,
                         pab_cfg: Optional[PABConfig] = None,
                         cfgr_cfg: Optional[CFGReuseConfig] = None,
                         init_x: Optional[torch.Tensor] = None,
                         generator: Optional[torch.Generator] = None,
                         on_phase: Optional[Callable[[str], None]] = None) -> torch.Tensor:
    """The Open-Sora v2 v2v/i2v denoise loop. txt3 [3B, L, C_t5] and
    y_vec3 [3B, C_clip] in the order [prompt, neg, neg]; Euler steps on
    the shifted schedule. Returns the whole latent volume [B, C, T_cond +
    num_gen, H, W] fp32, the cond region included. ``init_x``: the initial
    volume (tests inject the reference's draw), else drawn from
    ``generator``. ``on_phase(name)`` is called as each "step" begins."""
    return _sample_mmdit(dit, txt3, y_vec3, num_gen_latents=num_gen_latents,
                         num_steps=num_steps, lat_h=lat_h, lat_w=lat_w,
                         cond_latents=cond_latents, adapters=adapters, guidance=guidance,
                         guidance_img=guidance_img, shift=shift, pab_cfg=pab_cfg,
                         cfgr_cfg=cfgr_cfg, init_x=init_x, generator=generator,
                         on_phase=on_phase)


def sample_latents_mmdit_segmented(dit: MMDiT, txt3, y_vec3, *, segment_steps: int,
                                   **kwargs) -> torch.Tensor:
    """``sample_latents_mmdit`` with the device synchronized every
    ``segment_steps`` steps; the same loop, so the same result. PAB caches
    and CFG-reuse deltas carry across segments."""
    return _sample_mmdit(dit, txt3, y_vec3, segment_steps=segment_steps, **kwargs)


# ---------------------------------------------------------------------------
# CogVideoX sampling (DDIM, v-prediction, zero terminal SNR)
# ---------------------------------------------------------------------------


def _linspace_f32(start: float, stop: float, num: int) -> torch.Tensor:
    """``jnp.linspace`` in fp32, in the order of operations XLA compiles it
    to: start * (1 - s) + stop * s with s = i * fp32(1 / (num - 1)) (the
    division becomes a product with the reciprocal), the last element
    ``stop`` itself."""
    start_t = torch.tensor(start, dtype=torch.float32)
    stop_t = torch.tensor(stop, dtype=torch.float32)
    if num == 1:
        return start_t.reshape(1)
    div = num - 1
    step = torch.arange(div, dtype=torch.float32) * (torch.tensor(1.0) / div)
    out = start_t * (1 - step) + stop_t * step
    return torch.cat([out, stop_t.reshape(1)])


def cogvideox_alphas_cumprod(num_train_timesteps: int = 1000, beta_start: float = 0.00085,
                             beta_end: float = 0.012) -> torch.Tensor:
    """The CogVideoXDDIMScheduler's alpha_bar [num_train_timesteps] fp32 on
    the host: scaled-linear betas, their cumulative product, then sqrt
    alpha_bar rescaled so the last is exactly 0 (zero terminal SNR), in the
    reference's fp32 order of operations."""
    betas = _linspace_f32(beta_start ** 0.5, beta_end ** 0.5, num_train_timesteps) ** 2
    alphas_bar = torch.cumprod(1.0 - betas, dim=0)
    sqrt_ab = torch.sqrt(alphas_bar)
    sqrt_ab = (sqrt_ab - sqrt_ab[-1]) * (sqrt_ab[0] / (sqrt_ab[0] - sqrt_ab[-1]))
    return sqrt_ab ** 2


def cogvideox_schedule(num_steps: int, device=None):
    """(step indices, alpha_bar at each, alpha_bar at the next) of the DDIM
    loop: indices round(linspace(999, 0, num_steps)) (half to even, as
    ``jnp.round``), alpha_bar_prev 1 after the last step."""
    ab = cogvideox_alphas_cumprod()
    idx = torch.round(_linspace_f32(ab.shape[0] - 1, 0, num_steps)).long()
    ab_t = ab[idx]
    ab_prev = torch.cat([ab[idx[1:]], torch.ones(1)])
    return idx.float().to(device), ab_t.to(device), ab_prev.to(device)


def _cogvideox_setup(cfg, text_emb2, num_gen_latents, lat_h, lat_w, cond_latents,
                     init_x=None, generator=None):
    """(x, img_lat2) of both CogVideoX samplers: the initial volume [B,
    latent_channels, T_cond + num_gen, H, W] (``init_x`` when given, else
    drawn from ``generator``) and the image latents of both CFG rows."""
    from ..tta.losses import cogvideox_image_latents

    B = text_emb2.shape[0] // 2
    device = text_emb2.device
    t_cond = 0 if cond_latents is None else cond_latents.shape[2]
    T = t_cond + num_gen_latents
    shape = (B, cfg.latent_channels, T, lat_h, lat_w)
    if init_x is not None:
        if tuple(init_x.shape) != shape:
            raise ValueError(f"init_x {tuple(init_x.shape)} != {shape}")
        x = init_x.to(device=device, dtype=torch.float32)
    else:
        x = torch.randn(shape, generator=generator, dtype=torch.float32, device=device)
    img2 = None
    if cond_latents is not None:
        img = cogvideox_image_latents(cond_latents, T)
        img2 = torch.cat([img, img], dim=0)
    return x, img2


def _sample_cogvideox(dit: CogVideoX, text_emb2, *, num_gen_latents: int, num_steps: int,
                      lat_h: int, lat_w: int, cond_latents=None,
                      adapters: AdapterDict = None, guidance: float = 6.0,
                      pab_cfg: Optional[PABConfig] = None,
                      cfgr_cfg: Optional[CFGReuseConfig] = None, init_x=None,
                      generator=None, segment_steps: int = 0,
                      on_phase: Optional[Callable[[str], None]] = None) -> torch.Tensor:
    mark = on_phase or (lambda name: None)
    cfg = dit.cfg
    B = text_emb2.shape[0] // 2
    x, img2 = _cogvideox_setup(cfg, text_emb2, num_gen_latents, lat_h, lat_w,
                               cond_latents, init_x, generator)
    t_idx, ab_t, ab_prev = cogvideox_schedule(num_steps, device=x.device)
    cache, pab_flags = None, [False] * num_steps
    if pab_cfg is not None:
        cache = pab_init_cache_cogvideox(cfg, 2 * B, x.shape[2], lat_h, lat_w,
                                         text_emb2.shape[1], device=x.device)
        pab_flags = _pab_reuse_flags(num_steps, pab_cfg)
    delta, cfg_flags = None, [False] * num_steps
    if cfgr_cfg is not None:
        delta = torch.zeros_like(x)
        cfg_flags = _cfg_reuse_flags(num_steps, cfgr_cfg)

    def forward(x, t, p_reuse, cond_only):
        """The [uncond, cond] pair as one 2B batch, or with ``cond_only``
        the conditional rows alone (the cache's second half)."""
        nb = B if cond_only else 2 * B
        xb = x if cond_only else torch.cat([x, x], dim=0)
        rows = slice(B, 2 * B) if cond_only else slice(0, 2 * B)
        return dit(xb, t.expand(nb), text_emb2[rows], None if img2 is None else img2[rows],
                   adapters=adapters, pab_reuse=p_reuse, pab_cache=cache,
                   cache_cond_half=cond_only)

    seg = max(1, int(segment_steps)) if segment_steps else num_steps
    for i in range(num_steps):
        mark("step")
        with span("sampler.step"):
            if cfg_flags[i]:
                cond = forward(x, t_idx[i], pab_flags[i], cond_only=True)
                uncond = cond - delta.to(cond.dtype)
            else:
                pred = forward(x, t_idx[i], pab_flags[i], cond_only=False)
                uncond, cond = pred[:B], pred[B:]
                if delta is not None:
                    delta = cond - uncond
            v = uncond + guidance * (cond - uncond)
            sq_a, sq_1a = torch.sqrt(ab_t[i]), torch.sqrt(1.0 - ab_t[i])
            x0 = sq_a * x - sq_1a * v
            eps = sq_1a * x + sq_a * v
            x = torch.sqrt(ab_prev[i]) * x0 + torch.sqrt(1.0 - ab_prev[i]) * eps
        if (i + 1) % seg == 0 and i + 1 < num_steps and x.is_cuda:
            torch.cuda.synchronize(x.device)  # bound the work in flight
    return x


def sample_latents_cogvideox(dit: CogVideoX, text_emb2: torch.Tensor, *,
                             num_gen_latents: int, num_steps: int, lat_h: int, lat_w: int,
                             cond_latents: Optional[torch.Tensor] = None,
                             adapters: AdapterDict = None, guidance: float = 6.0,
                             pab_cfg: Optional[PABConfig] = None,
                             cfgr_cfg: Optional[CFGReuseConfig] = None,
                             init_x: Optional[torch.Tensor] = None,
                             generator: Optional[torch.Generator] = None,
                             on_phase: Optional[Callable[[str], None]] = None
                             ) -> torch.Tensor:
    """The CogVideoX-I2V DDIM (eta 0) v-prediction loop. text_emb2 [2B, L,
    text_dim] in the order [neg, pos]; the image latents come from the
    first of ``cond_latents`` [B, C, T_cond, H, W]. Returns the whole
    latent volume [B, C, T_cond + num_gen, H, W] fp32, the cond region
    included. ``init_x``: the initial volume (tests inject the reference's
    draw), else drawn from ``generator``. ``on_phase(name)`` is called as
    each "step" begins."""
    return _sample_cogvideox(dit, text_emb2, num_gen_latents=num_gen_latents,
                             num_steps=num_steps, lat_h=lat_h, lat_w=lat_w,
                             cond_latents=cond_latents, adapters=adapters,
                             guidance=guidance, pab_cfg=pab_cfg, cfgr_cfg=cfgr_cfg,
                             init_x=init_x, generator=generator, on_phase=on_phase)


def sample_latents_cogvideox_segmented(dit: CogVideoX, text_emb2, *, segment_steps: int,
                                       **kwargs) -> torch.Tensor:
    """``sample_latents_cogvideox`` with the device synchronized every
    ``segment_steps`` steps; the same setup and step body, so the same
    result. The PAB cache and the CFG-reuse delta carry across segments."""
    return _sample_cogvideox(dit, text_emb2, segment_steps=segment_steps, **kwargs)
