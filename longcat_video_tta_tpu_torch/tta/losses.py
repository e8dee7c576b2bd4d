"""Conditioned flow-matching TTA losses (counterpart of
``longcat_video_tta_tpu/tta/losses.py``, LongCat and MMDiT branches).

Conventions (identical to the reference): x_t = (1-σ)x₀ + σε, target
v = ε - x₀, σ ~ U[sigma_min, sigma_max], per-latent-frame timesteps
[0 for the clean conditioning frames, σ·1000 for the target frames],
MSE in fp32 on the target slice only.

The MMDiT losses (Open-Sora v2) condition through the cond_embed channel
input ([masks | masked_ref], ``mmdit_cond_input``) with one per-row σ
over the whole [cond | noisy target] volume, MSE on the target slice;
their (emb, mask) slots carry (txt, y_vec). The CogVideoX losses
condition through the I2V image latents (the first conditioning latent,
zeros after it) and, as the reference does, noise and score the whole
[cond | target] window with one per-row σ (timestep σ·1000); its anchor
noises the target slice only. Each backbone's (train loss, anchor loss)
pair is in its record in ``archs.py``.

Random draws: σ and ε are arguments; when they are not given they are
drawn from ``generator`` (an explicit ``torch.Generator``), ε at the
shape the loss noises (the target, or CogVideoX's whole window). Tests pass the
reference's own draws so both packages see the same numbers.

Lanes (``--video-parallel``): with ``lanes=V`` the batch holds V videos
folded lane-minor (row r in lane r % V, ``fold_lanes``), ``generator`` is
a sequence of V generators (lane v's rows drawn from generator v, as its
own run would draw them), and every loss returns the [V] vector of the
lanes' own means: their sum's gradient is each lane's own gradient,
where one mean over the batch would scale it by 1/V.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch

from ..models.dit import LongCatDiT

NUM_TRAIN_TIMESTEPS = 1000.0


def fold_lanes(xs: Sequence[torch.Tensor]) -> torch.Tensor:
    """V per-lane batches [b, ...] as one batch [b * V, ...], lane-minor
    (row i * V + v is row i of lane v)."""
    return torch.stack(list(xs), dim=1).reshape((-1,) + tuple(xs[0].shape[1:]))


def lane_means(err: torch.Tensor, lanes: Optional[int]) -> torch.Tensor:
    """The mean of ``err``, or with ``lanes`` the [V] means of each lane's
    rows (row r in lane r % V)."""
    if lanes is None:
        return err.mean()
    return err.reshape(err.shape[0] // lanes, lanes, -1).mean(dim=(0, 2))


def draw_sigma_noise(target_latents: torch.Tensor, generator, *,
                     sigma_min: float = 0.001, sigma_max: float = 1.0):
    """(sigma [B], noise like target_latents) in fp32 from ``generator``;
    from a sequence of V generators, lane v's rows (r % V == v) from
    generator v, sigma first, as that lane alone would draw them."""
    if isinstance(generator, (list, tuple)):
        V = len(generator)
        parts = [draw_sigma_noise(target_latents[v::V], g, sigma_min=sigma_min,
                                  sigma_max=sigma_max) for v, g in enumerate(generator)]
        return fold_lanes([p[0] for p in parts]), fold_lanes([p[1] for p in parts])
    B = target_latents.shape[0]
    device = target_latents.device
    sigma = torch.rand((B,), generator=generator, device=device)
    sigma = sigma * (sigma_max - sigma_min) + sigma_min
    noise = torch.randn(target_latents.shape, generator=generator,
                        dtype=torch.float32, device=device)
    return sigma, noise


def _cond_timesteps(sigma: torch.Tensor, n_cond: int, n_tgt: int) -> torch.Tensor:
    """[B, n_cond + n_tgt]: 0 on the conditioning frames, sigma * 1000 on
    the target frames."""
    B = sigma.shape[0]
    return torch.cat([
        torch.zeros((B, n_cond), dtype=torch.float32, device=sigma.device),
        (sigma.float() * NUM_TRAIN_TIMESTEPS)[:, None].expand(B, n_tgt),
    ], dim=1)


def flow_matching_loss(
    dit: LongCatDiT,
    latents: torch.Tensor,          # [B, C, T, H, W] clean
    text_emb: torch.Tensor,
    text_mask: Optional[torch.Tensor],
    *,
    adapters: Optional[Dict[str, torch.Tensor]] = None,
    sigma: Optional[torch.Tensor] = None,
    noise: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
    sigma_min: float = 0.001,
    sigma_max: float = 1.0,
) -> torch.Tensor:
    """Unconditioned rectified-flow MSE: every latent frame noised at the
    row's sigma (timestep sigma * 1000), fp32 MSE against noise - x0.
    ``sigma`` [B] and ``noise`` (like ``latents``) are drawn from
    ``generator`` when not given."""
    if sigma is None or noise is None:
        s, n = draw_sigma_noise(latents, generator, sigma_min=sigma_min,
                                sigma_max=sigma_max)
        sigma = s if sigma is None else sigma
        noise = n if noise is None else noise
    B = latents.shape[0]
    lat32, noise = latents.float(), noise.float()
    sig = sigma.float().reshape(B, 1, 1, 1, 1)
    timestep = _cond_timesteps(sigma, 0, latents.shape[2] // dit.cfg.patch_size[0])
    pred = dit((1.0 - sig) * lat32 + sig * noise, timestep, text_emb, text_mask,
               adapters=adapters)
    return ((pred - (noise - lat32)) ** 2).mean()


def flow_matching_loss_fixed(
    dit: LongCatDiT,
    latents: torch.Tensor,          # [B, C, T, H, W] clean
    text_emb: torch.Tensor,
    text_mask: Optional[torch.Tensor],
    fixed_noises: torch.Tensor,     # [n_draws, B, C, T, H, W]
    *,
    fixed_sigmas: Sequence[float],
    adapters: Optional[Dict[str, torch.Tensor]] = None,
) -> torch.Tensor:
    """Deterministic unconditioned eval loss at fixed sigmas x injected
    noise draws (the reference draws them from seeds 42 + d), the mean of
    the grid's per-point MSEs, as one batched forward of G*B rows in the
    reference's order (sigma major, draw minor)."""
    B = latents.shape[0]
    lat32 = latents.float()
    n_draws = fixed_noises.shape[0]
    G = n_draws * len(fixed_sigmas)
    sig_b = torch.tensor(list(fixed_sigmas), dtype=torch.float32,
                         device=lat32.device).repeat_interleave(n_draws * B)  # [G*B]
    noi = torch.cat([fixed_noises.float()] * len(fixed_sigmas), dim=0)
    noi = noi.reshape((G * B,) + tuple(noi.shape[2:]))
    sig_rows = sig_b[:, None, None, None, None]
    lat_g = lat32.repeat(G, 1, 1, 1, 1)
    timestep = _cond_timesteps(sig_b, 0, latents.shape[2] // dit.cfg.patch_size[0])
    mask_g = None if text_mask is None else torch.cat([text_mask] * G, dim=0)
    pred = dit((1.0 - sig_rows) * lat_g + sig_rows * noi, timestep,
               torch.cat([text_emb] * G, dim=0), mask_g, adapters=adapters)
    return ((pred - (noi - lat_g)) ** 2).mean()


def flow_matching_loss_conditioned(
    dit: LongCatDiT,
    cond_latents: torch.Tensor,     # [B, C, T_cond, H, W] clean context
    target_latents: torch.Tensor,   # [B, C, T_target, H, W]
    text_emb: torch.Tensor,
    text_mask: Optional[torch.Tensor],
    *,
    adapters: Optional[Dict[str, torch.Tensor]] = None,
    sigma: Optional[torch.Tensor] = None,
    noise: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
    sigma_min: float = 0.001,
    sigma_max: float = 1.0,
    num_valid_target: Optional[int] = None,
    lanes: Optional[int] = None,
) -> torch.Tensor:
    """Conditioning-aware loss replicating LongCat inference: the clean
    conditioning latents and the noised target latents go through one
    forward with the prefix attention rule; fp32 MSE on the target
    slice. ``sigma`` [B] and ``noise`` (like ``target_latents``) are
    drawn from ``generator`` when not given.

    ``num_valid_target`` (``--bucket-shapes``): target latent frames at
    index >= this are bucket padding: masked out of attention as keys
    (``num_valid_latents``) and out of the MSE, whose sum runs over the
    valid frames and is divided by their element count, so the loss and
    its gradients do not depend on the pad's content."""
    if sigma is None or noise is None:
        s, n = draw_sigma_noise(target_latents, generator, sigma_min=sigma_min,
                                sigma_max=sigma_max)
        sigma = s if sigma is None else sigma
        noise = n if noise is None else noise
    B = cond_latents.shape[0]
    pt = dit.cfg.patch_size[0]
    t_cond, t_tgt = cond_latents.shape[2], target_latents.shape[2]
    sig = sigma.float().reshape(B, 1, 1, 1, 1)
    tgt32 = target_latents.float()
    noise = noise.float()
    noisy_tgt = (1.0 - sig) * tgt32 + sig * noise
    hidden = torch.cat([cond_latents.float(), noisy_tgt], dim=2)
    timestep = _cond_timesteps(sigma, t_cond // pt, t_tgt // pt)
    pred = dit(hidden, timestep, text_emb, text_mask, num_cond_latents=t_cond,
               adapters=adapters,
               num_valid_latents=(None if num_valid_target is None
                                  else t_cond + int(num_valid_target)))
    err = (pred[:, :, t_cond:] - (noise - tgt32)) ** 2
    if num_valid_target is None:
        return lane_means(err, lanes)
    if lanes is not None:
        raise ValueError("shape bucketing does not compose with lanes")
    valid = int(num_valid_target)
    return err[:, :, :valid].sum() / (valid * (err.numel() // t_tgt))


def flow_matching_loss_conditioned_fixed(
    dit: LongCatDiT,
    cond_latents: torch.Tensor,
    target_latents: torch.Tensor,
    text_emb: torch.Tensor,
    text_mask: Optional[torch.Tensor],
    fixed_noises: torch.Tensor,     # [n_draws, B, C, T_target, H, W]
    *,
    fixed_sigmas: Sequence[float],
    adapters: Optional[Dict[str, torch.Tensor]] = None,
    lanes: Optional[int] = None,
) -> torch.Tensor:
    """Deterministic conditioned anchor loss for the early stopper: the
    |sigmas| x |draws| grid as ONE batched forward of G*B rows (G =
    len(fixed_sigmas) * n_draws), in the reference's row order (sigma
    major, draw minor); with ``lanes``, each lane's anchor ([V])."""
    B = cond_latents.shape[0]
    pt = dit.cfg.patch_size[0]
    t_cond, t_tgt = cond_latents.shape[2], target_latents.shape[2]
    tgt32 = target_latents.float()
    n_draws = fixed_noises.shape[0]
    G = n_draws * len(fixed_sigmas)
    sig = torch.tensor(list(fixed_sigmas), dtype=torch.float32,
                       device=tgt32.device).repeat_interleave(n_draws)  # [G]
    noi = torch.cat([fixed_noises.float()] * len(fixed_sigmas), dim=0)
    noi = noi.reshape((G * B,) + tuple(noi.shape[2:]))
    sig_b = sig.repeat_interleave(B)  # [G*B]
    sig_rows = sig_b[:, None, None, None, None]
    tgt_g = tgt32.repeat(G, 1, 1, 1, 1)
    noisy = (1.0 - sig_rows) * tgt_g + sig_rows * noi
    hidden = torch.cat([cond_latents.float().repeat(G, 1, 1, 1, 1), noisy], dim=2)
    timestep = _cond_timesteps(sig_b, t_cond // pt, t_tgt // pt)
    emb_g = torch.cat([text_emb] * G, dim=0)
    mask_g = None if text_mask is None else torch.cat([text_mask] * G, dim=0)
    pred = dit(hidden, timestep, emb_g, mask_g, num_cond_latents=t_cond,
               adapters=adapters)
    return lane_means((pred[:, :, t_cond:] - (noi - tgt_g)) ** 2, lanes)


# ---------------------------------------------------------------------------
# MMDiT (Open-Sora v2) backbone
# ---------------------------------------------------------------------------


def mmdit_cond_input(cond_latents: torch.Tensor, t_total: int) -> torch.Tensor:
    """[B, 1+C, t_total, H, W] fp32: masks (1 on the conditioning frames)
    and masked_ref (the clean cond latents, zeros after them)."""
    B, C, t_cond, H, W = cond_latents.shape
    out = torch.zeros((B, 1 + C, t_total, H, W), dtype=torch.float32,
                      device=cond_latents.device)
    out[:, :1, :t_cond] = 1.0
    out[:, 1:, :t_cond] = cond_latents.float()
    return out


def mmdit_flow_matching_loss_conditioned(
    dit,
    cond_latents: torch.Tensor,     # [B, C, T_cond, H, W] clean context
    target_latents: torch.Tensor,   # [B, C, T_target, H, W]
    txt: torch.Tensor,              # [B, L, context_in_dim] (T5)
    y_vec: torch.Tensor,            # [B, vec_in_dim] (CLIP pooled)
    *,
    adapters: Optional[Dict[str, torch.Tensor]] = None,
    sigma: Optional[torch.Tensor] = None,
    noise: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
    sigma_min: float = 0.001,
    sigma_max: float = 1.0,
    guidance: float = 7.5,
    num_valid_target: Optional[int] = None,
    lanes: Optional[int] = None,
) -> torch.Tensor:
    """The MMDiT's conditioned loss: noise on the target frames only, the
    conditioning through ``cond``, the vec's timestep the row's sigma; fp32
    MSE on the target slice. ``sigma`` [B] and ``noise`` are drawn from
    ``generator`` when not given."""
    if num_valid_target is not None:
        raise NotImplementedError("CP / shape bucketing are not wired for the MMDiT "
                                  "backbone")
    if sigma is None or noise is None:
        s, n = draw_sigma_noise(target_latents, generator, sigma_min=sigma_min,
                                sigma_max=sigma_max)
        sigma = s if sigma is None else sigma
        noise = n if noise is None else noise
    B, _, t_cond = cond_latents.shape[:3]
    t_tgt = target_latents.shape[2]
    sig = sigma.float().reshape(B, 1, 1, 1, 1)
    tgt32, noise = target_latents.float(), noise.float()
    noisy = (1.0 - sig) * tgt32 + sig * noise
    full = torch.cat([cond_latents.float(), noisy], dim=2)
    pred = dit(full, sigma.float(), txt, y_vec,
               cond=mmdit_cond_input(cond_latents, t_cond + t_tgt),
               guidance=torch.full((B,), guidance, device=full.device), adapters=adapters)
    return lane_means((pred[:, :, t_cond:] - (noise - tgt32)) ** 2, lanes)


def mmdit_flow_matching_loss_conditioned_fixed(
    dit,
    cond_latents: torch.Tensor,
    target_latents: torch.Tensor,
    txt: torch.Tensor,
    y_vec: torch.Tensor,
    fixed_noises: torch.Tensor,     # [n_draws, B, C, T_target, H, W]
    *,
    fixed_sigmas: Sequence[float],
    adapters: Optional[Dict[str, torch.Tensor]] = None,
    guidance: float = 7.5,
    lanes: Optional[int] = None,
) -> torch.Tensor:
    """The MMDiT anchor loss: one B-row forward per (sigma, draw), sigma
    major, draw minor (the reference's scan), the mean of their MSEs (per
    lane with ``lanes``)."""
    B, _, t_cond = cond_latents.shape[:3]
    tgt32, cond32 = target_latents.float(), cond_latents.float()
    cond_in = mmdit_cond_input(cond_latents, t_cond + target_latents.shape[2])
    g = torch.full((B,), guidance, device=tgt32.device)
    total, n = torch.zeros((), device=tgt32.device), 0
    for s in fixed_sigmas:
        for noise in fixed_noises.float():
            sigma = torch.full((B,), float(s), device=tgt32.device)
            noisy = (1.0 - sigma[0]) * tgt32 + sigma[0] * noise
            pred = dit(torch.cat([cond32, noisy], dim=2), sigma, txt, y_vec,
                       cond=cond_in, guidance=g, adapters=adapters)
            total = total + lane_means((pred[:, :, t_cond:] - (noise - tgt32)) ** 2, lanes)
            n += 1
    return total / n


# ---------------------------------------------------------------------------
# CogVideoX backbone
# ---------------------------------------------------------------------------


def cogvideox_image_latents(cond_latents: torch.Tensor, t_total: int) -> torch.Tensor:
    """[B, C, t_total, H, W] fp32: the first conditioning latent (the
    encoded conditioning image), zeros after it (the CogVideoX-I2V
    channel-concat convention)."""
    B, C, _, H, W = cond_latents.shape
    out = torch.zeros((B, C, t_total, H, W), dtype=torch.float32,
                      device=cond_latents.device)
    out[:, :, :1] = cond_latents[:, :, :1].float()
    return out


def _cogvideox_image_input(dit, cond_latents, t_total):
    cfg = dit.cfg
    if cfg.in_channels == cfg.latent_channels:
        return None
    return cogvideox_image_latents(cond_latents, t_total)


def cogvideox_flow_matching_loss_conditioned(
    dit,
    cond_latents: torch.Tensor,     # [B, C, T_cond, H, W]
    target_latents: torch.Tensor,   # [B, C, T_target, H, W]
    text_emb: torch.Tensor,         # [B, L, text_dim]
    text_mask=None,                 # unused (the engine's slot)
    *,
    adapters: Optional[Dict[str, torch.Tensor]] = None,
    sigma: Optional[torch.Tensor] = None,
    noise: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
    sigma_min: float = 0.001,
    sigma_max: float = 1.0,
    num_valid_target: Optional[int] = None,
    lanes: Optional[int] = None,
) -> torch.Tensor:
    """The reference's rectified-flow TTA loss for CogVideoX: the whole
    [cond | target] window noised with one sigma per row, x_t = (1-σ)x +
    σε, timestep σ·1000, the image latents built from the first
    conditioning latent, fp32 MSE against ε - x over the whole window.
    (CogVideoX is a v-prediction model; the reference trains it with this
    rectified-flow objective all the same, and the port reproduces it.)
    ``sigma`` [B] and ``noise`` (like the window) are drawn from
    ``generator`` when not given."""
    if num_valid_target is not None:
        raise NotImplementedError(
            "CP / shape bucketing are not wired for the CogVideoX backbone")
    B = cond_latents.shape[0]
    full = torch.cat([cond_latents.float(), target_latents.float()], dim=2)
    if sigma is None or noise is None:
        s, n = draw_sigma_noise(full, generator, sigma_min=sigma_min, sigma_max=sigma_max)
        sigma = s if sigma is None else sigma
        noise = n if noise is None else noise
    sig = sigma.float().reshape(B, 1, 1, 1, 1)
    noise = noise.float()
    noisy = (1.0 - sig) * full + sig * noise
    pred = dit(noisy, sigma.float() * NUM_TRAIN_TIMESTEPS, text_emb,
               _cogvideox_image_input(dit, cond_latents, full.shape[2]), adapters=adapters)
    return lane_means((pred - (noise - full)) ** 2, lanes)


def cogvideox_flow_matching_loss_conditioned_fixed(
    dit,
    cond_latents: torch.Tensor,
    target_latents: torch.Tensor,
    text_emb: torch.Tensor,
    text_mask,
    fixed_noises: torch.Tensor,     # [n_draws, B, C, T_target, H, W]
    *,
    fixed_sigmas: Sequence[float],
    adapters: Optional[Dict[str, torch.Tensor]] = None,
    lanes: Optional[int] = None,
) -> torch.Tensor:
    """The CogVideoX anchor loss: fixed noise on the target slice, the
    conditioning latents clean; one B-row forward per (sigma, draw), sigma
    major, draw minor (the reference's scan), the mean of their MSEs on
    the target slice (per lane with ``lanes``)."""
    B, _, t_cond = cond_latents.shape[:3]
    tgt32, cond32 = target_latents.float(), cond_latents.float()
    img = _cogvideox_image_input(dit, cond_latents, t_cond + target_latents.shape[2])
    total, n = torch.zeros((), device=tgt32.device), 0
    for s in fixed_sigmas:
        for noise in fixed_noises.float():
            sigma = torch.full((B,), float(s), device=tgt32.device)
            noisy = (1.0 - sigma[0]) * tgt32 + sigma[0] * noise
            pred = dit(torch.cat([cond32, noisy], dim=2), sigma * NUM_TRAIN_TIMESTEPS,
                       text_emb, img, adapters=adapters)
            total = total + lane_means((pred[:, :, t_cond:] - (noise - tgt32)) ** 2, lanes)
            n += 1
    return total / n
