"""Benchmark the two hot loops of the TTA workload on one card: the delta_a
train step and the 50-step CFG video continuation (counterpart of the
repository's root ``bench.py``, which runs the JAX package).

Geometry, as the reference's: ``longcat_bench`` (DiT 2048 wide, 16 blocks,
16 heads of 128) at full width and depth, random weights drawn on the
device from seed 0, a 480p latent grid of 60 x 104 (1560 tokens a latent
frame). The TTA window is 4 latents split 2 context / 1 train / 1 val
(4680 train tokens behind a 3120-token prefix); the continuation is 4
conditioning + 8 generated latents (29 frames) under guidance 4.0 against a
zero negative text, with the exact conditioning KV cache.

Sections, each a function that returns its JSON keys and its raw outputs:
  - ``delta_a_step``: 1 warm-up and ``steps`` timed AdamW steps (lr 5e-3);
  - ``continuations``: five forms, each a warm-up run and a timed run on
    the next seed: dense bf16; BSA keep 0.35; W8A8 + BSA; + PAB every 4;
    + CFG reuse every 2 (both over [0.06, 0.96));
  - ``lora_vs_denoise``: the LoRA r1 (alpha 2) step against one denoising
    step of the dense continuation (BASELINE.md's target: at most 2x);
  - ``video_parallel``: 2 videos' adapters as lanes of one batched chunk of
    2 steps, against the single-video step;
  - ``scale2``: ``longcat_bench_3b`` (2560 wide, 24 blocks, full remat);
  - ``scale3``: the 13.6B flagship's block geometry (4096 wide, ffn 11008,
    32 heads of 128, full remat) at depths 1 and 2; the per-block slope
    extrapolated to 48 blocks.
MFU divides by the card's dense bf16 tensor-core peak (``PEAK_BF16_FLOPS``,
keyed by the device name; another card raises). The baseline is the
reference's Delta-A run on one H200: 20.9 s a video at 5 steps, 13.6B
parameters, 989 TFLOP/s dense bf16.

Timing: each timed window starts and ends with ``torch.cuda.synchronize()``
around host-clock reads; the kernels build and load in the warm-ups.
Draws come from ``torch.Generator``s seeded with the reference's PRNG seeds
(JAX's draws cannot be reproduced, so the numbers are the reference's in
distribution); every section takes injected draws instead.

A section that fails ends the run with its traceback: no key is printed
for it. Prints one JSON line; on a CUDA device the peak allocated memory
goes to stderr.

Usage:
    python3 -m longcat_video_tta_tpu_torch.scripts.bench [--device cuda]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from ..config import DiTConfig, longcat_bench, longcat_bench_3b
from ..models.mmdit import count_params

# the reference's geometry
LAT_H, LAT_W = 60, 104          # 480p (832 x 480) latent grid
WINDOW_LATENTS, CONTEXT_LATENTS, HOLDOUT = 4, 2, 0.25  # cond14: context 2 / train 1 / val 1
COND_LATENTS, GEN_LATENTS = 4, 8
GEN_FRAMES = 1 + (GEN_LATENTS - 1) * 4  # 29
GUIDANCE, LR = 4.0, 5e-3
BSA_KEEP = 0.35
LEVER_RANGE = (0.06, 0.96)      # PAB's and CFG reuse's [start, end) fractions
# bench.py's step counts; chip_smoke cuts them
COUNTS = dict(steps=5, gen_steps=50, vp_lanes=2, vp_steps=2, scale2_steps=3,
              scale2_gen_steps=10, scale3_steps=3)
GEOMETRY = dict(lat_h=LAT_H, lat_w=LAT_W, block_q=1024, block_k=1024)

# the reference's PRNG seeds: the warm-up step's and the first timed
# step's (step i: first + i); a form's warm-up run (the timed run: + 1);
# a V 2 chunk's lane v step s: base + 50 v + s
SEEDS = dict(weights=0, text=2, cond=3, window=4, delta_a=5, lora=6,
             delta_a_steps=(99, 100), lora_steps=(200, 201), vp_chunks=(300, 400),
             scale2_weights=50, scale2_adapter=51, scale2_steps=(300, 301),
             scale2_gen=60, scale3_weights=70, scale3_adapter=71, scale3_text=72,
             scale3_steps=(400, 401))
# the continuation forms in the reference's order: its keys are
# gen_<steps>step_<key>_s and (against the dense form) gen_<form>_speedup;
# the warm-up run draws from ``seed``, the timed run from seed + 1
FORMS = {
    "dense": dict(key=f"cfg_{GEN_FRAMES}frames", seed=0),
    "bsa": dict(key="bsa_keep35", seed=2, bsa=True),
    "int8_bsa": dict(key="int8_bsa", seed=7, int8=True, bsa=True),
    "int8_bsa_pab": dict(key="int8_bsa_pab", seed=11, int8=True, bsa=True, pab=True),
    "full_stack": dict(key="full_stack", seed=13, int8=True, bsa=True, pab=True, cfgr=True),
}

# the card's dense bf16 tensor-core peak (SXM at its 700 W limit)
PEAK_BF16_FLOPS = {"NVIDIA H100 80GB HBM3": 989e12}
# the reference's Delta-A run (BASELINE.md; summary_printout.txt:134)
BASELINE_STEP_S = 20.9 / 5.0
BASELINE_PARAMS = 13.6e9
H200_BF16_FLOPS = 989e12
METRIC = "delta_a_tta_step_seconds_480p_1p2B_h100"


@dataclasses.dataclass
class Inputs:
    """The model and the tensors every section reads."""

    cfg: object                 # ModelConfig (longcat_bench)
    dit: torch.nn.Module
    text: torch.Tensor          # [1, text_len, text_dim] bf16
    mask: torch.Tensor          # [1, text_len] int32 ones
    context: torch.Tensor       # the TTA window's context latents
    train: torch.Tensor         # its train latents
    cond: torch.Tensor          # [1, C, COND_LATENTS, lat_h, lat_w]
    lat_h: int
    lat_w: int
    block_q: int                # the BSA blocks (the CPU tests use small ones)
    block_k: int
    device: torch.device

    def gen(self, seed: int) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(seed)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _timed(fn, device):
    """(fn(), its seconds on the host clock up to a device sync)."""
    _sync(device)
    t0 = time.perf_counter()
    out = fn()
    _sync(device)
    return out, time.perf_counter() - t0


def setup(cfg, device, *, lat_h: int = LAT_H, lat_w: int = LAT_W, block_q: int = 1024,
          block_k: int = 1024, dit=None, text=None, window=None, cond=None) -> Inputs:
    """The DiT (seed 0), text (seed 2), the TTA window (seed 4) split by
    ``split_tta_latents(window, 2, 0.25)``, and the continuation's
    conditioning latents (seed 3); any of them injected instead."""
    from ..models.weights import init_random_dit
    from ..tta.split import split_tta_latents

    device = torch.device(device)
    dcfg = cfg.dit
    gen = lambda seed: torch.Generator(device=device).manual_seed(seed)
    if dit is None:
        dit = init_random_dit(dcfg, device, gen(SEEDS["weights"]))
    if text is None:
        text = torch.randn((1, dcfg.text_len, dcfg.text_dim), generator=gen(SEEDS["text"]),
                           device=device).to(torch.bfloat16)
    if window is None:
        window = torch.randn((1, dcfg.in_channels, WINDOW_LATENTS, lat_h, lat_w),
                             generator=gen(SEEDS["window"]), device=device)
    if cond is None:
        cond = torch.randn((1, dcfg.in_channels, COND_LATENTS, lat_h, lat_w),
                           generator=gen(SEEDS["cond"]), device=device)
    context, train, _ = split_tta_latents(window.to(device), CONTEXT_LATENTS, HOLDOUT)
    mask = torch.ones((1, text.shape[1]), dtype=torch.int32, device=device)
    return Inputs(cfg, dit, text.to(device), mask, context, train, cond.to(device), lat_h,
                  lat_w, block_q, block_k, device)


def step_draws(inp: Inputs, seeds: Sequence[int]) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """(sigma, noise) of the conditioned loss per step, each from a
    generator seeded with that step's seed."""
    from ..tta.losses import draw_sigma_noise

    return [draw_sigma_noise(inp.train, inp.gen(s)) for s in seeds]


def _train(scheme, dit, inp: Inputs, *, init_seed: int, seeds: Tuple[int, int], steps: int,
           draws=None, train_params=None, text=None, mask=None):
    """One warm-up step, then ``steps`` timed ones -> (seconds a timed step,
    losses [1 + steps], the trained tensors). Draws: ``draws`` or the
    step seeds ``seeds[0]`` (warm-up), ``seeds[1] + i``."""
    from ..config import OptimConfig
    from ..tta.engine import build_optimizer, train_step

    opt = build_optimizer(OptimConfig(lr=LR))
    tp = train_params
    if tp is None:
        tp = scheme.init(inp.device, dit=dit, generator=inp.gen(init_seed))
    state = opt.init(tp)
    if draws is None:
        draws = step_draws(inp, [seeds[0]] + [seeds[1] + i for i in range(steps)])
    text = inp.text if text is None else text
    mask = inp.mask if mask is None else mask
    losses = []

    def run(chunk):
        nonlocal tp, state
        for sigma, noise in chunk:
            tp, state, loss = train_step(scheme, dit, opt, tp, state, inp.context, inp.train,
                                         text, mask, sigma=sigma, noise=noise)
            losses.append(loss)

    _timed(lambda: run(draws[:1]), inp.device)  # the kernels build and load here
    _, secs = _timed(lambda: run(draws[1:]), inp.device)
    return secs / steps, torch.stack(losses), tp


def delta_a_step(inp: Inputs, *, steps: int = 5, draws=None, train_params=None):
    """bench.py:58-75 -> ({"tta_step_s"}, {"s", "losses", "train_params"})."""
    from ..config import AdapterConfig
    from ..tta.adapters import build_scheme

    scheme = build_scheme(inp.cfg.dit, AdapterConfig(method="delta_a"))
    s, losses, tp = _train(scheme, inp.dit, inp, init_seed=SEEDS["delta_a"],
                           seeds=SEEDS["delta_a_steps"], steps=steps, draws=draws,
                           train_params=train_params)
    return {"tta_step_s": round(s, 3)}, dict(s=s, losses=losses, train_params=tp)


def continuations(inp: Inputs, *, steps: int = 50, forms: Sequence[str] = tuple(FORMS),
                  init_noises: Optional[Sequence[torch.Tensor]] = None):
    """bench.py:77-164: each form's warm-up run and timed run ->
    (its keys, {"s": {form: timed seconds}, "latents": {form: (warm-up,
    timed)}}). ``init_noises``: the (warm-up, timed) runs' unit-variance
    initial noise, the same for every form, else drawn from the forms'
    seeds. The W8A8 copy of the blocks is made once, outside the timed
    runs."""
    from ..config import BSAConfig, CFGReuseConfig, PABConfig
    from ..ops.quant import quantize_dit_blocks_int8
    from ..pipeline.sampler import sample_latents

    start, end = LEVER_RANGE
    bsa = BSAConfig(keep_ratio=BSA_KEEP, block_q=inp.block_q, block_k=inp.block_k)
    pab = PABConfig(every=4, start_frac=start, end_frac=end)
    cfgr = CFGReuseConfig(every=2, start_frac=start, end_frac=end)
    neg = torch.zeros_like(inp.text)
    int8_dit = None
    secs, latents = {}, {}
    for form in forms:
        spec = FORMS[form]
        if spec.get("int8") and int8_dit is None:
            int8_dit = quantize_dit_blocks_int8(inp.dit)
        model = int8_dit if spec.get("int8") else inp.dit
        runs = []
        for i in range(2):  # the warm-up, then the timed run on the next seed
            noise = None if init_noises is None else init_noises[i].to(inp.device)

            def run():
                with torch.no_grad():
                    return sample_latents(
                        model, inp.cfg.scheduler, inp.text, inp.mask, neg, inp.mask,
                        GUIDANCE, num_gen_latents=GEN_LATENTS, num_steps=steps,
                        lat_h=inp.lat_h, lat_w=inp.lat_w, cond_latents=inp.cond,
                        use_kv_cache=True, init_noise=noise,
                        generator=None if noise is not None else inp.gen(spec["seed"] + i),
                        bsa_cfg=bsa if spec.get("bsa") else None,
                        pab_cfg=pab if spec.get("pab") else None,
                        cfgr_cfg=cfgr if spec.get("cfgr") else None)

            runs.append(_timed(run, inp.device))
        latents[form] = (runs[0][0], runs[1][0])
        secs[form] = runs[1][1]
    keys = {}
    dense = secs.get("dense")
    for form in forms:
        keys[f"gen_{steps}step_{FORMS[form]['key']}_s"] = round(secs[form], 2)
        if form == "dense":
            keys["gen_frames_per_s"] = round(GEN_FRAMES / secs[form], 3)
        elif dense is not None:
            keys[f"gen_{form}_speedup"] = round(dense / secs[form], 3)
    return keys, dict(s=secs, latents=latents)


def lora_vs_denoise(inp: Inputs, *, dense_s: float, gen_steps: int, steps: int = 5,
                    draws=None, train_params=None):
    """bench.py:166-183: the LoRA r1 (alpha 2) step against one of the
    ``gen_steps`` CFG denoising steps of the dense continuation that took
    ``dense_s``."""
    from ..config import AdapterConfig
    from ..tta.adapters import build_scheme

    scheme = build_scheme(inp.cfg.dit, AdapterConfig(method="lora", lora_rank=1,
                                                     lora_alpha=2.0))
    s, losses, tp = _train(scheme, inp.dit, inp, init_seed=SEEDS["lora"],
                           seeds=SEEDS["lora_steps"], steps=steps, draws=draws,
                           train_params=train_params)
    denoise = dense_s / gen_steps
    keys = {"lora_r1_step_s": round(s, 3), "denoise_step_s": round(denoise, 3),
            "lora_step_over_denoise_step": round(s / denoise, 3)}
    return keys, dict(s=s, losses=losses, train_params=tp)


def video_parallel(inp: Inputs, *, tta_step_s: float, lanes: int = 2, steps: int = 2,
                   draws=None, train_params=None):
    """bench.py:185-229: ``lanes`` videos' delta_a adapters (each from the
    same init) as lanes of one batched chunk of ``steps`` steps
    (``train_chunk_batched``: one forward and one backward over the lanes'
    rows), a warm-up chunk then a timed one. ``draws``: per chunk, per
    step, per lane (sigma, noise)."""
    from ..config import AdapterConfig, OptimConfig
    from ..tta.adapters import build_scheme
    from ..tta.engine import build_optimizer, train_chunk_batched

    scheme = build_scheme(inp.cfg.dit, AdapterConfig(method="delta_a"))
    opt = build_optimizer(OptimConfig(lr=LR))
    tps = train_params
    if tps is None:
        inits = [scheme.init(inp.device, dit=inp.dit, generator=inp.gen(SEEDS["delta_a"]))
                 for _ in range(lanes)]
        tps = {k: torch.stack([t[k] for t in inits]) for k in inits[0]}
    state = opt.init(tps)
    stack = lambda x: torch.stack([x] * lanes)
    batch = (stack(inp.context), stack(inp.train), stack(inp.text), stack(inp.mask))
    if draws is None:
        draws = [[step_draws(inp, [base + 50 * v + s for v in range(lanes)])
                  for s in range(steps)] for base in SEEDS["vp_chunks"]]
    losses = []

    def chunk(chunk_draws):
        nonlocal tps, state
        tps, state, loss, _ = train_chunk_batched(scheme, inp.dit, opt, tps, state, *batch,
                                                  steps=steps, draws=chunk_draws)
        losses.append(loss)

    _timed(lambda: chunk(draws[0]), inp.device)
    _, secs = _timed(lambda: chunk(draws[1]), inp.device)
    per_video = secs / (steps * lanes)
    keys = {f"vp{lanes}_step_s_per_video": round(per_video, 3),
            f"vp{lanes}_speedup_vs_sequential": round(tta_step_s / per_video, 3),
            f"vp{lanes}_note": "one card: the lanes are batch rows of each forward and "
                               "backward, so the gain per video is the card time one "
                               "video's step leaves unused; across cards the lanes split "
                               "over --data-mesh"}
    return keys, dict(s=per_video, losses=torch.cat(losses, dim=1), train_params=tps)


# ---------------------------------------------------------------------------
# accounting (bench.py:231-266, :395-406)
# ---------------------------------------------------------------------------


def token_counts(lat_h: int, lat_w: int) -> Tuple[int, int]:
    """(tokens a latent frame, train tokens: context 2 + train 1 latents)."""
    nhw = (lat_h // 2) * (lat_w // 2)
    return nhw, 3 * nhw


def matmul_params(dc) -> int:
    """Matmul parameters touched per token (per block: qkv, proj, cross
    q/kv/proj, the SwiGLU FFN, adaLN)."""
    D, F, Ct = dc.hidden_size, dc.ffn_dim, dc.adaln_tembed_dim
    return dc.depth * (3 * D * D + D * D + (D * D + 2 * D * D + D * D) + 3 * D * F
                       + Ct * 6 * D)


def train_flops(dc, s_train: int) -> float:
    """One train step: forward 2 P S, backward twice that; self-attention
    4 S^2 D per block forward, about 2.5x that in the backward."""
    return 6 * matmul_params(dc) * s_train + dc.depth * 14 * s_train ** 2 * dc.hidden_size


def gen_flops(dc, nhw: int) -> float:
    """One CFG denoising step: batch 2, forward only; attention of the
    generated tokens against conditioning + generated (the KV cache)."""
    s_noise, s_cond = GEN_LATENTS * nhw, COND_LATENTS * nhw
    return 2 * (2 * matmul_params(dc) * s_noise
                + dc.depth * 4 * s_noise * (s_noise + s_cond) * dc.hidden_size)


def ref_flops(s_train: int) -> float:
    """The reference's train step at the same tokens (13.6B: D 4096, F
    about 12288, 48 blocks)."""
    Dr, Fr, Lr = 4096, 12288, 48
    p_block = 3 * Dr * Dr + Dr * Dr + 4 * Dr * Dr + 3 * Dr * Fr + 512 * 6 * Dr
    return 6 * Lr * p_block * s_train + Lr * 14 * s_train ** 2 * Dr


def per_param_ratio(step_s: float, n_params: int) -> float:
    """The baseline's seconds per step per parameter over ours."""
    return (BASELINE_STEP_S / BASELINE_PARAMS) / (step_s / n_params)


def ref_mfu(s_train: int) -> float:
    return ref_flops(s_train) / BASELINE_STEP_S / H200_BF16_FLOPS


def scale2(inp: Inputs, cfg2, *, peak: float, steps: int = 3, gen_steps: int = 10,
           draws=None, init_noises=None):
    """bench.py:268-333: ``cfg2`` (longcat_bench_3b) drawn from seed 50:
    1 + ``steps`` delta_a steps, then a dense ``gen_steps``-step
    continuation, warm-up and timed. The model is freed on return."""
    from ..config import AdapterConfig
    from ..models.weights import init_random_dit
    from ..pipeline.sampler import sample_latents
    from ..tta.adapters import build_scheme

    d2 = cfg2.dit
    dit2 = init_random_dit(d2, inp.device, inp.gen(SEEDS["scale2_weights"]))
    n2 = count_params(dit2)
    scheme = build_scheme(d2, AdapterConfig(method="delta_a"))
    step_s, losses, _ = _train(scheme, dit2, inp, init_seed=SEEDS["scale2_adapter"],
                               seeds=SEEDS["scale2_steps"], steps=steps, draws=draws)
    neg = torch.zeros_like(inp.text)
    runs = []
    for i in range(2):
        noise = None if init_noises is None else init_noises[i].to(inp.device)

        def run():
            with torch.no_grad():
                return sample_latents(
                    dit2, cfg2.scheduler, inp.text, inp.mask, neg, inp.mask, GUIDANCE,
                    num_gen_latents=GEN_LATENTS, num_steps=gen_steps, lat_h=inp.lat_h,
                    lat_w=inp.lat_w, cond_latents=inp.cond, use_kv_cache=True,
                    init_noise=noise,
                    generator=None if noise is not None else inp.gen(SEEDS["scale2_gen"] + i))

        runs.append(_timed(run, inp.device))
    gen_s = runs[1][1]
    nhw, s_train = token_counts(inp.lat_h, inp.lat_w)
    keys = {
        "scale2_geometry": f"depth={d2.depth} hidden={d2.hidden_size} ffn={d2.ffn_dim} "
                           f"heads={d2.num_heads} ({n2 / 1e9:.2f}B, {d2.remat_policy} remat)",
        "scale2_tta_step_s": round(step_s, 3),
        "scale2_tta_step_mfu": round(train_flops(d2, s_train) / step_s / peak, 4),
        f"scale2_gen_{gen_steps}step_s": round(gen_s, 2),
        "scale2_gen_mfu": round(gen_flops(d2, nhw) / (gen_s / gen_steps) / peak, 4),
        "scale2_per_param_vs_baseline": round(per_param_ratio(step_s, n2), 3),
    }
    return keys, dict(s=step_s, losses=losses, latents=(runs[0][0], runs[1][0]))


def flagship_config():
    """The 13.6B flagship's DiT (hidden 4096, ffn 11008, 32 heads of 128, 48
    blocks) with full remat; scale 3 draws its block at depths 1 and 2."""
    return DiTConfig(remat_policy="full")


def scale3(inp: Inputs, flagship, *, peak: float, steps: int = 3, draws=None):
    """bench.py:339-389: ``flagship`` at depths 1 and 2 (weights from seed
    70 + depth, its text from 72): 1 + ``steps`` delta_a steps each; the
    slope gives the per-block forward and backward and the fixed cost, and
    the step of all ``flagship.depth`` blocks is extrapolated from them.
    ``draws``: per depth, the steps' (sigma, noise)."""
    from ..config import AdapterConfig
    from ..models.weights import init_random_dit
    from ..tta.adapters import build_scheme

    text = torch.randn((1, flagship.text_len, flagship.text_dim),
                       generator=inp.gen(SEEDS["scale3_text"]),
                       device=inp.device).to(torch.bfloat16)
    mask = torch.ones((1, flagship.text_len), dtype=torch.int32, device=inp.device)
    times, losses = {}, {}
    for depth in (1, 2):
        d3 = dataclasses.replace(flagship, depth=depth)
        dit3 = init_random_dit(d3, inp.device, inp.gen(SEEDS["scale3_weights"] + depth))
        scheme = build_scheme(d3, AdapterConfig(method="delta_a"))
        times[depth], losses[depth], _ = _train(
            scheme, dit3, inp, init_seed=SEEDS["scale3_adapter"], seeds=SEEDS["scale3_steps"],
            steps=steps, draws=None if draws is None else draws[depth - 1], text=text,
            mask=mask)
    per_block = times[2] - times[1]
    fixed = times[1] - per_block
    est = flagship.depth * per_block + fixed
    _, s_train = token_counts(inp.lat_h, inp.lat_w)
    keys = {
        "scale3_geometry": f"flagship block: hidden {flagship.hidden_size} ffn "
                           f"{flagship.ffn_dim} heads {flagship.num_heads} (depth 1/2 "
                           f"slope, {s_train} train tokens, {flagship.remat_policy} remat)",
        "scale3_block_fwd_bwd_s": round(per_block, 4),
        "scale3_fixed_overhead_s": round(fixed, 4),
        "scale3_est_13p6B_step_s": round(est, 3),
        "scale3_est_13p6B_step_mfu": round(train_flops(flagship, s_train) / est / peak, 4),
    }
    return keys, dict(times=times, losses=losses)


# ---------------------------------------------------------------------------
# the run
# ---------------------------------------------------------------------------


def peak_flops(device) -> float:
    """The card's dense bf16 peak from ``PEAK_BF16_FLOPS``; raises for a
    card (or device) not in the table."""
    device = torch.device(device)
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else str(device)
    if name not in PEAK_BF16_FLOPS:
        raise RuntimeError(f"no bf16 peak is known for {name!r} (known: "
                           f"{sorted(PEAK_BF16_FLOPS)}); add it to PEAK_BF16_FLOPS")
    return PEAK_BF16_FLOPS[name]


def device_info() -> Dict:
    """The card's name and power limit as nvidia-smi reports them."""
    line = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    name, limit = (x.strip() for x in line.rsplit(",", 1))
    return {"name": name, "power_limit_w": float(limit.split()[0])}


def run(device, *, peak: float, card: Dict, cfg=None, cfg2=None, flagship=None,
        counts: Optional[Dict] = None, geometry: Optional[Dict] = None, init_noises=None,
        log=None):
    """Every section in the reference's order -> (the JSON record, {section:
    raw outputs}). ``cfg`` / ``cfg2`` / ``flagship``: longcat_bench,
    longcat_bench_3b and ``flagship_config()`` unless given; ``counts`` /
    ``geometry``: ``COUNTS`` / ``GEOMETRY`` unless given; ``init_noises``:
    the continuations' (warm-up, timed) initial noise; ``log``: called
    with a line as each section ends."""
    cfg = longcat_bench() if cfg is None else cfg
    cfg2 = longcat_bench_3b() if cfg2 is None else cfg2
    flagship = flagship_config() if flagship is None else flagship
    n = dict(COUNTS if counts is None else counts)
    geo = dict(GEOMETRY if geometry is None else geometry)
    say = log or (lambda line: None)
    t0 = time.perf_counter()

    def done(name):
        say(f"{name} done at {time.perf_counter() - t0:.1f} s")

    # nothing is freed between sections: each section's own models and
    # copies go when it returns, and the rest fits the card together (a
    # peak of 13 GiB at the bench geometry on the H100)
    inp = setup(cfg, device, **geo)
    outs, keys = {}, {}
    keys["delta_a"], outs["delta_a"] = delta_a_step(inp, steps=n["steps"])
    done("delta_a step")
    keys["gen"], outs["gen"] = continuations(inp, steps=n["gen_steps"],
                                             init_noises=init_noises)
    done("continuations")
    tta_s, dense_s = outs["delta_a"]["s"], outs["gen"]["s"]["dense"]
    keys["lora"], outs["lora"] = lora_vs_denoise(inp, dense_s=dense_s,
                                                 gen_steps=n["gen_steps"], steps=n["steps"])
    done("lora r1 step")
    keys["vp"], outs["vp"] = video_parallel(inp, tta_step_s=tta_s, lanes=n["vp_lanes"],
                                            steps=n["vp_steps"])
    done(f"video-parallel V {n['vp_lanes']}")
    keys["scale2"], outs["scale2"] = scale2(inp, cfg2, peak=peak, steps=n["scale2_steps"],
                                            gen_steps=n["scale2_gen_steps"])
    done("scale 2")
    keys["scale3"], outs["scale3"] = scale3(inp, flagship, peak=peak,
                                            steps=n["scale3_steps"])
    done("scale 3")
    return record(inp, keys, outs, peak=peak, card=card, gen_steps=n["gen_steps"]), outs


def record(inp: Inputs, keys: Dict, outs: Dict, *, peak: float, card: Dict,
           gen_steps: int) -> Dict:
    """The JSON line: the reference's structure and keys (bench.py:408-471),
    with the metric named for the card, the ``device`` key, and no recorded
    number of another run."""
    dc = inp.cfg.dit
    sf = inp.cfg.vae.spatial_factor
    params = count_params(inp.dit)
    nhw, s_train = token_counts(inp.lat_h, inp.lat_w)
    tta_s, dense_s = outs["delta_a"]["s"], outs["gen"]["s"]["dense"]
    train_mfu = train_flops(dc, s_train) / tta_s / peak
    gen = dict(keys["gen"])
    dense_key = f"gen_{gen_steps}step_{FORMS['dense']['key']}_s"
    detail = {
        "geometry": f"depth={dc.depth} hidden={dc.hidden_size} ffn={dc.ffn_dim} "
                    f"heads={dc.num_heads} ({params / 1e9:.2f}B params, {dc.param_dtype}, "
                    f"{card['name']} {card['power_limit_w']:.0f} W, {inp.lat_h * sf}x"
                    f"{inp.lat_w * sf} frames, {inp.lat_h}x{inp.lat_w} latent grid)",
        "tta_step_mfu": round(train_mfu, 4),
        dense_key: gen.pop(dense_key),
        "gen_frames_per_s": gen.pop("gen_frames_per_s"),
        "gen_mfu": round(gen_flops(dc, nhw) / (dense_s / gen_steps) / peak, 4),
        **gen,
        **keys["lora"],
        **keys["vp"],
        **keys["scale2"],
        **keys["scale3"],
        "wall_ratio_unnormalized": round(BASELINE_STEP_S / tta_s, 3),
        "baseline_step_mfu_est": round(ref_mfu(s_train), 4),
        "mfu_advantage_vs_h200": round(train_mfu / ref_mfu(s_train), 2),
        "baseline": f"Delta-A lr5e-3 5 steps: 20.9 s/video on 1xH200 13.6B "
                    f"(summary_printout.txt:134); per-param normalization factor "
                    f"{params / 1e9:.2f}/13.6",
    }
    return {"metric": METRIC, "value": keys["delta_a"]["tta_step_s"], "unit": "s/step",
            "vs_baseline": round(per_param_ratio(tta_s, params), 3), "device": card,
            "detail": detail}


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    return ap


def main(argv=None) -> Dict:
    """Run every section at the reference's geometry and counts on
    ``--device``, print the JSON line (and the peak memory on stderr);
    returns the record."""
    from ..utils.device import resolve_device

    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    peak = peak_flops(device)
    card = device_info()
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    rec, _ = run(device, peak=peak, card=card,
                 log=lambda line: print(f"[bench] {line}", file=sys.stderr, flush=True))
    print(json.dumps(rec), flush=True)
    if device.type == "cuda":
        print(f"[bench] max_memory_allocated "
              f"{torch.cuda.max_memory_allocated(device) / 2**30:.2f} GiB on {card['name']}, "
              f"{card['power_limit_w']:.0f} W", file=sys.stderr)
    return rec


if __name__ == "__main__":
    main()
