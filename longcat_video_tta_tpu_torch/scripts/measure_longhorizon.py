"""Measure the 93-frame single-card decode at bench scale with the int8 +
BSA + segmented-dispatch lever stack, and the lever stack's latent
fidelity against the dense bf16 decode (counterpart of the repository's
``scripts/measure_longhorizon.py``; the fidelity target is latent corr
>= 0.999).

Geometry, as the reference's: ``longcat_bench`` (DiT 2048 wide, 16
blocks, 16 heads of 128) at full width and depth, random weights drawn
on the device from seed 0, latents 60 x 104 (1560 tokens a latent
frame), 4 conditioning latents and ``--gen-latents`` generated ones,
guidance 4.0 against a zero negative text. Text and conditioning are
drawn from generators seeded 2 and 3, the initial noise from 7 (corr)
or 5 and 6 (wall's two runs); JAX's PRNG draws cannot be reproduced, so
the numbers are the reference's in distribution, not bit for bit.

- ``--mode corr``: the dense bf16 decode and the lever stack (W8A8 unless
  ``--no-int8``, BSA at ``--keep``, PAB and CFG reuse when asked) from
  the same initial noise; corr and relative error of the two latents in
  float64. The bf16 blocks are freed before the lever run.
- ``--mode wall``: the lever stack twice on two seeds, each timed on the
  host clock up to ``torch.cuda.synchronize()``. ``first_incl_compile_s``
  keeps the reference's name: it is the first run, including the
  kernels' build or load (nothing is traced or compiled besides).

Prints one JSON line with the reference's keys; on a CUDA device also a
line on stderr with the run's peak allocated memory.

Usage:
    python3 -m longcat_video_tta_tpu_torch.scripts.measure_longhorizon \\
        --mode corr --keep 0.15 --pab-every 4 --cfg-reuse-every 2
    python3 -m longcat_video_tta_tpu_torch.scripts.measure_longhorizon \\
        --mode wall --keep 0.15 --gen-latents 24 --segment 5 [--int8qk]
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Optional, Sequence

import numpy as np
import torch

# the reference's geometry and draws
LAT_H, LAT_W, COND_LATENTS, GUIDANCE = 60, 104, 4, 4.0
SEEDS = dict(weights=0, text=2, cond=3, corr=7, wall=(5, 6))


def build_parser() -> argparse.ArgumentParser:
    """The reference's flags and defaults, plus ``--device``."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--mode", choices=["corr", "wall"], default="wall")
    ap.add_argument("--keep", type=float, default=0.35)
    ap.add_argument("--gen-latents", type=int, default=24)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--segment", type=int, default=5)
    ap.add_argument("--no-int8", action="store_true")
    ap.add_argument("--int8qk", action="store_true",
                    help="int8 QK^T inside the BSA kernel (--quantize-decode int8qk)")
    ap.add_argument("--pab-every", type=int, default=0,
                    help="Pyramid Attention Broadcast: compute decode self-attention "
                         "only every Nth step inside [--pab-start, --pab-end) of the "
                         "trajectory (0 = off)")
    ap.add_argument("--pab-start", type=float, default=0.1)
    ap.add_argument("--pab-end", type=float, default=0.9)
    ap.add_argument("--cfg-reuse-every", type=int, default=0,
                    help="CFG guidance-delta reuse (FasterCache): run only the "
                         "conditional branch on reuse steps (0 = off)")
    ap.add_argument("--cfg-reuse-start", type=float, default=0.1)
    ap.add_argument("--cfg-reuse-end", type=float, default=0.9)
    ap.add_argument("--device", default="cuda")
    return ap


def parse_args(argv=None) -> argparse.Namespace:
    return build_parser().parse_args(argv)


def lever_configs(args, block_q: int = 1024, block_k: int = 1024):
    """(BSAConfig, PABConfig or None, CFGReuseConfig or None) of ``args``."""
    from ..config import BSAConfig, CFGReuseConfig, PABConfig

    bsa = BSAConfig(keep_ratio=args.keep, block_q=block_q, block_k=block_k,
                    qk_int8=args.int8qk)
    pab = (None if args.pab_every <= 0 else
           PABConfig(every=args.pab_every, start_frac=args.pab_start,
                     end_frac=args.pab_end))
    cfgr = (None if args.cfg_reuse_every <= 0 else
            CFGReuseConfig(every=args.cfg_reuse_every, start_frac=args.cfg_reuse_start,
                           end_frac=args.cfg_reuse_end))
    return bsa, pab, cfgr


def clamped_top_k(bsa_cfg, n_keys: int, n_cond_tokens: int) -> int:
    """Key blocks each q-block attends to in the decode: the DiT's keep-ratio
    rule, clamped up to the forced set (conditioning blocks + diagonal)."""
    from ..ops import bsa

    n_kb = -(-n_keys // bsa_cfg.block_k)
    top_k = bsa.decode_top_k(n_kb, bsa_cfg.keep_ratio, bsa_cfg.min_blocks)
    return bsa.clamp_top_k(top_k, n_keys, bsa_cfg.block_k, n_cond_tokens)


def measure_longhorizon(args, cfg, *, lat_h: int = LAT_H, lat_w: int = LAT_W,
                        cond_latents: int = COND_LATENTS, block_q: int = 1024,
                        block_k: int = 1024, dit=None, text: Optional[torch.Tensor] = None,
                        cond: Optional[torch.Tensor] = None,
                        init_noises: Optional[Sequence[torch.Tensor]] = None,
                        device="cuda"):
    """Run ``args.mode`` on ``cfg`` (a ModelConfig) -> (record, latents).

    ``record`` is the JSON line's dict; ``latents`` the fp32 outputs:
    (dense, lever) in corr mode, (run 1, run 2) in wall mode. ``dit`` (a
    16-bit LongCatDiT), ``text`` [1, text_len, text_dim], ``cond`` [1, C,
    cond_latents, lat_h, lat_w] and ``init_noises`` (one unit-variance [1,
    C, gen_latents, lat_h, lat_w] per sampler run) are drawn from the
    reference's seeds when not given. ``block_q`` / ``block_k``: the BSA
    blocks (the CPU tests use small ones)."""
    from ..models.weights import init_random_dit
    from ..ops.quant import quantize_dit_blocks_int8
    from ..pipeline.sampler import sample_latents, sample_latents_segmented

    device = torch.device(device)
    dcfg = cfg.dit
    gen = lambda seed: torch.Generator(device=device).manual_seed(seed)
    if dit is None:
        dit = init_random_dit(dcfg, device, gen(SEEDS["weights"]))
    if text is None:
        text = torch.randn((1, dcfg.text_len, dcfg.text_dim), generator=gen(SEEDS["text"]),
                           device=device).to(torch.bfloat16)
    if cond is None:
        cond = torch.randn((1, dcfg.in_channels, cond_latents, lat_h, lat_w),
                           generator=gen(SEEDS["cond"]), device=device)
    text, cond = text.to(device), cond.to(device)
    mask = torch.ones((1, text.shape[1]), dtype=torch.int32, device=device)
    neg = torch.zeros_like(text)
    bsa_cfg, pab_cfg, cfgr_cfg = lever_configs(args, block_q, block_k)
    kw = dict(num_gen_latents=args.gen_latents, num_steps=args.steps, lat_h=lat_h,
              lat_w=lat_w, cond_latents=cond, use_kv_cache=True)

    def run(model, i: int, seed: int, segment: int, levers: bool):
        noise = None if init_noises is None else init_noises[i].to(device)
        lever_kw = (dict(bsa_cfg=bsa_cfg, pab_cfg=pab_cfg, cfgr_cfg=cfgr_cfg)
                    if levers else {})
        sampler = sample_latents
        if segment > 0:
            sampler = lambda *a, **k: sample_latents_segmented(*a, segment_steps=segment,
                                                               **k)
        with torch.no_grad():
            out = sampler(model, cfg.scheduler, text, mask, neg, mask, GUIDANCE,
                          init_noise=noise, generator=None if noise is not None
                          else gen(seed), **lever_kw, **kw)
        if out.is_cuda:
            torch.cuda.synchronize(out.device)
        return out

    int8 = not args.no_int8
    if args.mode == "corr":
        # fidelity vs dense bf16. Run it at the geometry you intend to
        # deploy: the forced-keep clamp (cond blocks + diagonal) sets a
        # sparsity floor that depends on the cond:noise block ratio
        ref = run(dit, 0, SEEDS["corr"], args.segment, levers=False)
        fast_dit = quantize_dit_blocks_int8(dit) if int8 else dit
        del dit  # the bf16 blocks go before the lever-stack run
        fast = run(fast_dit, 0, SEEDS["corr"], args.segment, levers=True)
        r = ref.double().cpu().numpy().ravel()
        f = fast.double().cpu().numpy().ravel()
        corr = float(np.corrcoef(r, f)[0, 1])
        rel = float(np.linalg.norm(f - r) / np.linalg.norm(r))
        record = {"mode": "corr", "keep": args.keep, "pab_every": args.pab_every,
                  "cfg_reuse_every": args.cfg_reuse_every, "int8": int8,
                  "steps": args.steps, "gen_latents": args.gen_latents,
                  "segment": args.segment, "latent_corr": round(corr, 5),
                  "rel_err": round(rel, 4)}
        return record, (ref, fast)

    # wall mode: the segmented long-horizon decode; only the W8A8 copy
    # of the blocks stays when int8 is on
    fast_dit = quantize_dit_blocks_int8(dit) if int8 else dit
    del dit
    outs, secs = [], []
    for i, seed in enumerate(SEEDS["wall"]):
        t0 = time.perf_counter()
        outs.append(run(fast_dit, i, seed, args.segment, levers=True))
        secs.append(time.perf_counter() - t0)
    record = {"mode": "wall", "keep": args.keep, "int8": int8, "int8qk": args.int8qk,
              "pab_every": args.pab_every, "cfg_reuse_every": args.cfg_reuse_every,
              "gen_latents": args.gen_latents, "frames": 1 + (args.gen_latents - 1) * 4,
              "steps": args.steps, "segment": args.segment,
              "first_incl_compile_s": round(secs[0], 1), "decode_s": round(secs[1], 1),
              "s_per_step": round(secs[1] / args.steps, 3)}
    return record, tuple(outs)


def main(argv=None) -> dict:
    """Parse ``argv``, run longcat_bench at the reference's geometry, print
    the JSON line (and the peak memory on stderr); returns the record."""
    from ..config import longcat_bench
    from ..utils.device import resolve_device

    args = parse_args(argv)
    device = resolve_device(args.device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    record, _ = measure_longhorizon(args, longcat_bench(), device=device)
    print(json.dumps(record), flush=True)
    if device.type == "cuda":
        print(f"[measure_longhorizon] max_memory_allocated "
              f"{torch.cuda.max_memory_allocated(device) / 2**30:.2f} GiB on "
              f"{torch.cuda.get_device_name(device)}", file=sys.stderr)
    return record


if __name__ == "__main__":
    main()
