"""Pretrain the longcat_demo stack on a synthetic motion distribution
(counterpart of the repository's ``scripts/pretrain_demo.py``), so the
demo campaign evaluates TTA on a shifted distribution B where adaptation
has signal, with weights trained by the port itself.

Phases (one device):
  1. VAE: reconstruction MSE + 1e-6 KL on 9-frame clips of distribution
     A, ``clip_by_global_norm(1.0)`` then AdamW (optax's defaults: eps
     1e-8, betas (0.9, 0.999), no warmup);
  2. latent statistics: per-channel mean / std over distribution-A
     17-frame clips, in float64 on the host (std + 1e-6), put in the
     config's VAE record and from there in ``vae/config.json``;
  3. DiT: the conditioned flow-matching loss TTA uses
     (``tta/losses.py``) on cond-4 + target-8 latent windows (45 frames,
     encoded whole by ``vae_encode``), every parameter trained through
     the engine's ``train_step`` with ``FullScheme`` and AdamW with a
     linear warmup.
The clips are made on the device from three scalars per clip
(``make_clip_gen``). The numpy stream keeps the reference's order
(``draw_params`` per batch, then the caption's ``randint`` in phase 3),
so one seed gives the reference's clips and captions; the sigma, noise
and KL draws come from a ``torch.Generator`` seeded from ``--seed``, and
the step functions take them as arguments. The result is a checkpoint
folder in the upstream layout (``models/convert.py::save_checkpoint_dir``)
that ``run_tta --checkpoint-dir`` reads, plus PROVENANCE.json.

Distribution A: sinusoid fields, speed in [0.02, 0.05], frequency in
[2, 5], direction +x (B, the campaign's evaluation data, lives in
``run_demo_campaign.DIST_B``).

Usage:
    python3 -m longcat_video_tta_tpu_torch.scripts.pretrain_demo \\
        --out-dir campaign/demo_ckpt_torch [--vae-steps 1200] \\
        [--dit-steps 4000] [--smoke] [--device cuda]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import time
from typing import Dict, List

import numpy as np
import torch

DIST_A = {"speed_range": (0.02, 0.05), "freq_range": (2.0, 5.0),
          "direction": 1.0}

CAPTIONS = ["a ball moving across the scene",
            "waves rolling over a beach",
            "a car driving down a road",
            "a bird flying in the sky"]

VAE_KL_WEIGHT = 1e-6
VAE_LOGVAR_RANGE = (-30.0, 20.0)


def sample_clip(rng: np.random.RandomState, frames: int, height: int,
                width: int) -> np.ndarray:
    """One distribution-A clip [3, T, H, W] in [-1, 1] (the runner's
    ``make_synthetic_dataset`` family)."""
    t = np.arange(frames, dtype=np.float32)
    yy, xx = np.meshgrid(np.linspace(0, 1, height),
                         np.linspace(0, 1, width), indexing="ij")
    lo, hi = DIST_A["freq_range"]
    freq = lo + rng.rand() * (hi - lo)
    phase = rng.rand() * 6.28
    lo, hi = DIST_A["speed_range"]
    speed = DIST_A["direction"] * (lo + rng.rand() * (hi - lo))
    clip = np.stack([
        0.5 + 0.5 * np.sin(
            6.28 * (freq * (xx + speed * ti) + yy * freq / 2) + phase)
        for ti in t
    ])  # [T, H, W]
    clip = np.broadcast_to(clip[None], (3,) + clip.shape)
    return (clip * 2.0 - 1.0).astype(np.float32)


def batch_clips(rng, b, frames, h, w):
    return np.stack([sample_clip(rng, frames, h, w) for _ in range(b)])


def draw_params(rng: np.random.RandomState, b: int):
    """Per-clip (freq, phase, speed) draws in ``sample_clip``'s stream
    order, for ``make_clip_gen``."""
    f, p, s = [], [], []
    lo_f, hi_f = DIST_A["freq_range"]
    lo_s, hi_s = DIST_A["speed_range"]
    for _ in range(b):
        f.append(lo_f + rng.rand() * (hi_f - lo_f))
        p.append(rng.rand() * 6.28)
        s.append(DIST_A["direction"] * (lo_s + rng.rand() * (hi_s - lo_s)))
    return (np.asarray(f, np.float32), np.asarray(p, np.float32),
            np.asarray(s, np.float32))


def make_clip_gen(frames: int, height: int, width: int, device):
    """(freq, phase, speed) numpy [B] -> clips [B, 3, T, H, W] in [-1, 1]
    made on ``device`` in fp32 (``sample_clip``'s formula), so a step
    uploads 3 floats per clip instead of its pixels."""
    device = torch.device(device)
    f32 = dict(dtype=torch.float32, device=device)
    t = torch.arange(frames, **f32)
    yy, xx = torch.meshgrid(torch.linspace(0.0, 1.0, height, **f32),
                            torch.linspace(0.0, 1.0, width, **f32), indexing="ij")

    def gen(freq, phase, speed):
        f, p, s = (torch.as_tensor(np.asarray(a, np.float32), device=device)
                   .view(-1, 1, 1, 1) for a in (freq, phase, speed))
        arg = 6.28 * (f * (xx[None, None] + s * t[None, :, None, None])
                      + yy[None, None] * f / 2.0) + p
        clip = 0.5 + 0.5 * torch.sin(arg)  # [B, T, H, W]
        clip = clip[:, None].expand(clip.shape[0], 3, *clip.shape[1:])
        return clip * 2.0 - 1.0

    return gen


def vae_optimizer(lr: float):
    """``optax.chain(clip_by_global_norm(1.0), adamw(lr, weight_decay=1e-5))``
    with optax's adamw defaults (eps 1e-8, betas (0.9, 0.999), no warmup),
    not ``OptimConfig``'s eps 1e-15."""
    from ..config import OptimConfig
    from ..tta.engine import Optimizer

    return Optimizer(OptimConfig(optimizer="adamw", lr=lr, betas=(0.9, 0.999), eps=1e-8,
                                 grad_clip_norm=1.0, warmup_steps=0, weight_decay=1e-5))


def dit_optimizer(lr: float, steps: int):
    """The engine's AdamW (eps 1e-15) with warmup min(100, steps // 4),
    weight decay 1e-4, clip 1.0."""
    from ..config import OptimConfig
    from ..tta.engine import build_optimizer

    return build_optimizer(OptimConfig(optimizer="adamw", lr=lr, steps=steps,
                                       warmup_steps=min(100, steps // 4),
                                       weight_decay=1e-4, grad_clip_norm=1.0))


def vae_loss(vae, x: torch.Tensor, noise: torch.Tensor):
    """(MSE + 1e-6 KL, MSE) of one reconstruction: the encoder's moments,
    logvar clipped to [-30, 20], z = mean + exp(logvar / 2) * noise (noise
    of the latent mean's shape), the decoder core."""
    from ..models.vae import _vae_decode_core, vae_encode_moments

    mean, logvar = vae_encode_moments(vae, x)
    lv = torch.clamp(logvar, *VAE_LOGVAR_RANGE)
    z = mean + torch.exp(0.5 * lv) * noise
    recon = _vae_decode_core(vae, z)
    mse = torch.mean((recon - x) ** 2)
    kl = 0.5 * torch.mean(mean ** 2 + torch.exp(lv) - 1.0 - lv)
    return mse + VAE_KL_WEIGHT * kl, mse


def latent_shape(vae_cfg, x_shape) -> tuple:
    """The encoder's latent shape for pixels ``x_shape`` [B, 3, T, H, W]."""
    B, _, T, H, W = x_shape
    sf = vae_cfg.spatial_factor
    return (B, vae_cfg.z_dim, 1 + (T - 1) // vae_cfg.temporal_factor, H // sf, W // sf)


def vae_step(vae, params: Dict[str, torch.Tensor], opt, state: Dict, x: torch.Tensor,
             noise: torch.Tensor):
    """One VAE step on the tensors ``params`` (keyed by ``vae``'s
    parameter names) -> (new params, new state, mse as a 0-d tensor)."""
    from ..tta.adapters import with_tensors
    from ..tta.engine import _grads

    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    with torch.enable_grad():
        loss, mse = vae_loss(with_tensors(vae, leaves), x, noise)
        grads = _grads(loss, leaves.values())
    grads = {k: torch.zeros_like(v) if g is None else g
             for (k, v), g in zip(leaves.items(), grads)}
    del leaves
    params, state = opt.update(grads, state, params)
    return params, state, mse.detach()


def dit_step(scheme, dit, opt, params: Dict[str, torch.Tensor], state: Dict, cond, target,
             emb, mask, sigma: torch.Tensor, noise: torch.Tensor):
    """One DiT pretraining step (the engine's ``train_step`` with
    ``FullScheme``) on the given draws -> (new params, new state, loss)."""
    from ..tta.engine import train_step

    return train_step(scheme, dit, opt, params, state, cond, target, emb, mask,
                      sigma=sigma, noise=noise)


def latent_statistics(vae, clips) -> tuple:
    """(mean, std + 1e-6) per latent channel over the un-normalized
    latents of ``clips`` (an iterable of pixel batches), in float64 on the
    host."""
    from ..models.vae import vae_encode

    zs = []
    with torch.no_grad():
        for x in clips:
            zs.append(vae_encode(vae, x, normalize=False).double().cpu().numpy())
    z = np.concatenate(zs, 0)  # [N, C, T, H, W]
    return z.mean(axis=(0, 2, 3, 4)), z.std(axis=(0, 2, 3, 4)) + 1e-6


def with_latent_stats(bundle, mean, std):
    """``bundle`` whose config and VAE carry the latent statistics."""
    cfg = bundle.cfg
    vcfg = dataclasses.replace(cfg.vae, latents_mean=tuple(float(v) for v in mean),
                               latents_std=tuple(float(v) for v in std))
    bundle.vae.cfg = vcfg
    return dataclasses.replace(bundle, cfg=dataclasses.replace(cfg, vae=vcfg))


def card_name(device: torch.device) -> str:
    """The card's name and power limit as ``nvidia-smi`` reports them, or
    "cpu"."""
    if device.type != "cuda":
        return "cpu"
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              check=True).stdout.strip().splitlines()[0]
    except (OSError, subprocess.CalledProcessError, IndexError):
        return torch.cuda.get_device_name(device)


def _copy_into(module: torch.nn.Module, params: Dict[str, torch.Tensor]) -> None:
    with torch.no_grad():
        for name, p in module.named_parameters():
            p.copy_(params[name])


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--out-dir", default="campaign/demo_ckpt_torch")
    p.add_argument("--height", type=int, default=192)
    p.add_argument("--width", type=int, default=320)
    p.add_argument("--vae-steps", type=int, default=1200)
    p.add_argument("--dit-steps", type=int, default=4000)
    p.add_argument("--vae-lr", type=float, default=3e-4)
    p.add_argument("--dit-lr", type=float, default=2e-4)
    p.add_argument("--batch", type=int, default=2)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--preset", default="longcat_demo")
    p.add_argument("--smoke", action="store_true",
                   help="tiny geometry and a handful of steps (CPU tests)")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a GPU) or cpu")
    args = p.parse_args(argv)
    if args.smoke:
        args.preset = "longcat_tiny"
        args.height, args.width = 16, 32
        args.vae_steps = min(args.vae_steps, 4)
        args.dit_steps = min(args.dit_steps, 4)
        args.batch = 1
    return args


def main(argv=None, on_phase=None) -> List[dict]:
    """Pretrain and save; returns the loss history. ``on_phase(name,
    bundle)`` is called as "vae", "stats", "dit" and "save" begin."""
    from ..config import AdapterConfig, get_model_config
    from ..models.convert import save_checkpoint_dir
    from ..models.vae import vae_encode
    from ..pipeline.pipeline import ModelBundle
    from ..tta.adapters import build_scheme
    from ..tta.losses import draw_sigma_noise
    from ..utils.device import resolve_device

    args = parse_args(argv)
    device = resolve_device(args.device)
    mark = on_phase or (lambda name, bundle: None)
    cfg = get_model_config(args.preset)
    bundle = ModelBundle.init_random(cfg, seed=args.seed, device=device)
    rng = np.random.RandomState(args.seed)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    tf = cfg.vae.temporal_factor
    hist: List[dict] = []

    # ---- phase 1: VAE reconstruction --------------------------------
    mark("vae", bundle)
    vae_frames = 2 * tf + 1  # 3 latent frames
    vopt = vae_optimizer(args.vae_lr)
    vparams = {k: p.detach() for k, p in bundle.vae.named_parameters()}
    vstate = vopt.init(vparams)
    vgen = make_clip_gen(vae_frames, args.height, args.width, device)
    t0 = time.time()
    for s in range(args.vae_steps):
        x = vgen(*draw_params(rng, args.batch))
        noise = torch.randn(latent_shape(cfg.vae, x.shape), generator=gen, device=device)
        vparams, vstate, mse = vae_step(bundle.vae, vparams, vopt, vstate, x, noise)
        if s % 100 == 0 or s == args.vae_steps - 1:
            m = float(mse)
            hist.append({"phase": "vae", "step": s, "mse": m,
                         "wall_s": round(time.time() - t0, 1)})
            print(f"[vae {s}/{args.vae_steps}] recon mse {m:.5f} "
                  f"({time.time() - t0:.0f}s)", flush=True)
    _copy_into(bundle.vae, vparams)
    del vparams, vstate

    # ---- phase 2: latent statistics over A ---------------------------
    mark("stats", bundle)
    sgen = make_clip_gen(4 * tf + 1, args.height, args.width, device)  # 5 latents
    mean, std = latent_statistics(
        bundle.vae, (sgen(*draw_params(rng, args.batch))
                     for _ in range(8 if not args.smoke else 2)))
    bundle = with_latent_stats(bundle, mean, std)
    cfg = bundle.cfg
    print(f"[stats] latent mean [{mean.min():.3f}, {mean.max():.3f}] "
          f"std [{std.min():.3f}, {std.max():.3f}]", flush=True)

    # ---- phase 3: DiT flow matching (cond 4 + target 8 latents) ------
    mark("dit", bundle)
    n_cond_lat, n_tgt_lat = (4, 8) if not args.smoke else (2, 2)
    win_frames = (n_cond_lat + n_tgt_lat - 1) * tf + 1
    scheme = build_scheme(cfg.dit, AdapterConfig(method="full"))
    dopt = dit_optimizer(args.dit_lr, args.dit_steps)
    dparams = scheme.init(device, dit=bundle.dit)
    dstate = dopt.init(dparams)
    with torch.no_grad():
        emb_bank = [bundle.encode_prompt(c) for c in CAPTIONS]
    dgen = make_clip_gen(win_frames, args.height, args.width, device)
    t0 = time.time()
    for s in range(args.dit_steps):
        x = dgen(*draw_params(rng, args.batch))
        with torch.no_grad():
            z = vae_encode(bundle.vae, x)  # normalized with the new statistics
        cond_l, tgt_l = z[:, :, :n_cond_lat], z[:, :, n_cond_lat:]
        emb, mask = emb_bank[rng.randint(len(emb_bank))]
        emb = emb.expand((args.batch,) + tuple(emb.shape[1:]))
        mask = mask.expand((args.batch,) + tuple(mask.shape[1:]))
        sigma, noise = draw_sigma_noise(tgt_l, gen)
        dparams, dstate, loss = dit_step(scheme, bundle.dit, dopt, dparams, dstate,
                                         cond_l, tgt_l, emb, mask, sigma, noise)
        if s % 200 == 0 or s == args.dit_steps - 1:
            ls = float(loss)
            hist.append({"phase": "dit", "step": s, "loss": ls,
                         "wall_s": round(time.time() - t0, 1)})
            print(f"[dit {s}/{args.dit_steps}] flow loss {ls:.4f} "
                  f"({time.time() - t0:.0f}s)", flush=True)
    _copy_into(bundle.dit, dparams)
    del dparams, dstate

    # ---- save ---------------------------------------------------------
    mark("save", bundle)
    save_checkpoint_dir(bundle, args.out_dir)
    with open(os.path.join(args.out_dir, "PROVENANCE.json"), "w") as f:
        json.dump({
            "pretrained_by": "longcat_video_tta_tpu_torch/scripts/pretrain_demo.py",
            "preset": args.preset,
            "distribution_A": {k: list(v) if isinstance(v, tuple) else v
                               for k, v in DIST_A.items()},
            "vae_steps": args.vae_steps, "dit_steps": args.dit_steps,
            "height": args.height, "width": args.width,
            "seed": args.seed,
            "device": card_name(device),
            "note": ("text_encoder is frozen random (the demo world's "
                     "fixed text space); dit+vae are trained on "
                     "synthetic distribution A"),
            "history": hist,
        }, f, indent=2)
    print(f"[pretrain] checkpoint saved to {args.out_dir}")
    return hist


if __name__ == "__main__":
    main()
