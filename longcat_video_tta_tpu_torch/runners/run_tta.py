"""TTA runner of the PyTorch port (counterpart of
``longcat_video_tta_tpu/runners/run_tta.py``). Two methods are ported:
the no-TTA baseline (``--method none``) and delta_a (one delta on the
t-embedding, the reference runner's default). Per video: load and encode
the TTA window that ends at the anchor; for delta_a, split it into
cond/train/val latents, set up the anchored early stopper, run the
chunked train loop (``check_every`` AdamW steps, then the anchor eval, one
host sync per chunk), restore the best state; then ``generate_vc`` with
the trained adapter (VAE encode, prompt encode, cond-cache precompute,
CFG Euler loop, VAE decode), PSNR/SSIM against the ground truth,
``checkpoint.json``; at the end ``summary.json`` with the reference
runner's keys. Generation takes the reference runner's decode levers
(``--bsa-keep-ratio``, ``--quantize-decode``, ``--fast-decode``,
``--pab-*``, ``--cfg-reuse-*``, ``--gen-segment-steps``, ``--bucket-gen``)
and its ``--fast-decode-verify`` fidelity record.

CLI:
  python -m longcat_video_tta_tpu_torch.runners.run_tta \\
      --method delta_a --preset longcat_tiny --synthetic 2 \\
      --output-dir /tmp/out --device cpu

The default device is ``cuda``; asking for it on a machine without a GPU
raises. ``main(argv, on_phase=...)`` calls ``on_phase(name)`` as each
phase of a video begins ("video", "encode_window", "setup_anchor",
"train_chunk", "anchor_check", "generation" and ``generate_vc``'s own
phases, "video_end"), so a profiler can time the code that serves.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

METHODS = ["none", "full", "lora", "delta_a", "delta_b", "delta_c",
           "norm_tune", "film", "dno"]
PORTED_METHODS = ("none", "delta_a")

# the per-video record of a disabled CLIP gate (reference defaults)
CLIP_GATE_OFF = {
    "clip_gate_enabled": False, "clip_gate_backend": "clip",
    "clip_gate_threshold": 0.2, "clip_gate_log_only": False,
    "skip_tta": False, "clip_gate_score": None, "clip_gate_error": None,
}


def build_arg_parser() -> argparse.ArgumentParser:
    from ..config import MODEL_PRESETS

    p = argparse.ArgumentParser(description="LongCat video TTA (PyTorch port)")
    p.add_argument("--method", default="delta_a", choices=METHODS)
    p.add_argument("--data-dir", default=None)
    p.add_argument("--output-dir", required=True)
    p.add_argument("--preset", default="longcat_13b", choices=sorted(MODEL_PRESETS))
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cpu' runs the plain PyTorch path")
    p.add_argument("--synthetic", type=int, default=0,
                   help="Generate N synthetic clips instead of --data-dir")
    p.add_argument("--max-videos", type=int, default=100)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--height", type=int, default=480)
    p.add_argument("--width", type=int, default=832)
    # optimization (same defaults as the reference runner)
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--loss-fetch-every", type=int, default=0,
                   help="host-sync cadence of the chunked train loop "
                        "(0 = auto: es check_every, or 25 when ES is off)")
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--optimizer", default="adamw", choices=["adamw", "sgd"])
    p.add_argument("--warmup-steps", type=int, default=0)
    p.add_argument("--weight-decay", type=float, default=0.01)
    p.add_argument("--max-grad-norm", type=float, default=1.0)
    # frames
    p.add_argument("--num-cond-frames", type=int, default=14)
    p.add_argument("--num-frames", type=int, default=28)
    p.add_argument("--gen-start-frame", type=int, default=32)
    p.add_argument("--tta-total-frames", type=int, default=None)
    p.add_argument("--tta-context-frames", type=int, default=None)
    # generation
    p.add_argument("--num-inference-steps", type=int, default=50)
    p.add_argument("--guidance-scale", type=float, default=4.0)
    p.add_argument("--no-kv-cache", action="store_true")
    # decode levers (the reference runner's flags and defaults)
    p.add_argument("--bsa-keep-ratio", type=float, default=0.0,
                   help="block-sparse decode attention: keep this fraction of "
                        "k-blocks per q-block (0 = dense; the cond cache stays "
                        "exact; ops/bsa.py)")
    p.add_argument("--bucket-gen", action="store_true",
                   help="pad the gen-latent horizon to the bucket ladder and "
                        "mask the padding")
    p.add_argument("--quantize-decode", choices=["none", "int8", "int8qk"],
                   default="none",
                   help="W8A8 per-block linears in the denoise loop "
                        "(ops/quant.py); 'int8qk' also runs attention QK^T in "
                        "int8 with per-token scales (rides the BSA kernel). "
                        "Training stays 16-bit")
    p.add_argument("--fast-decode", action="store_true",
                   help="fill the unset decode-lever flags with the recommended "
                        "stack: int8 W8A8 + BSA (keep 0.35, or 0.15 at >= 16 gen "
                        "latents) + PAB every 4 over [0.06, 0.96) + CFG reuse "
                        "every 2 over the same range + 5-step segments on long "
                        "horizons (apply_fast_decode_defaults)")
    p.add_argument("--pab-every", type=int, default=0,
                   help="Pyramid Attention Broadcast: compute decode "
                        "self-attention every Nth step inside the range, "
                        "reusing each block's last output (0 = off)")
    p.add_argument("--pab-start-frac", type=float, default=0.1,
                   help="broadcast range start as a fraction of steps")
    p.add_argument("--pab-end-frac", type=float, default=0.9,
                   help="broadcast range end as a fraction of steps")
    p.add_argument("--cfg-reuse-every", type=int, default=0,
                   help="CFG guidance-delta reuse: run the unconditional branch "
                        "only every Nth step inside the range, with v_uncond = "
                        "v_cond - cached delta on the others (0 = off)")
    p.add_argument("--cfg-reuse-start-frac", type=float, default=0.1,
                   help="reuse range start as a fraction of steps")
    p.add_argument("--cfg-reuse-end-frac", type=float, default=0.9,
                   help="reuse range end as a fraction of steps")
    p.add_argument("--gen-segment-steps", type=int, default=0,
                   help="synchronize the device every N denoising steps "
                        "(0 = never)")
    p.add_argument("--fast-decode-verify", type=int, default=0,
                   help="for the first K videos also generate with every "
                        "decode lever off (same seed and adapters) and record "
                        "fast-vs-dense PSNR and the metric deltas (0 = off)")
    p.add_argument("--skip-generation", action="store_true")
    p.add_argument("--no-save-videos", action="store_true")
    # early stopping
    p.add_argument("--es-disable", action="store_true")
    p.add_argument("--es-check-every", type=int, default=5)
    p.add_argument("--es-patience", type=int, default=3)
    p.add_argument("--es-anchor-sigmas", default="0.25,0.5,0.75")
    p.add_argument("--es-noise-draws", type=int, default=2)
    p.add_argument("--es-strategy", default="patience",
                   choices=["patience", "first_rise"])
    p.add_argument("--es-holdout-fraction", type=float, default=0.25)
    p.add_argument("--feature-frame-guard-mode", default="fail",
                   choices=["fail", "warn", "off"])
    # reference options that are not ported yet: asking for one raises
    p.add_argument("--bucket-shapes", action="store_true", help="not yet ported")
    p.add_argument("--save-adapters", action="store_true", help="not yet ported")
    p.add_argument("--aug-enabled", action="store_true", help="not yet ported")
    p.add_argument("--batch-videos", type=int, default=1, help="not yet ported")
    p.add_argument("--clip-gate-enabled", action="store_true", help="not yet ported")
    # caption guard / override
    p.add_argument("--caption-guard-topk", type=int, default=5)
    p.add_argument("--caption-guard-min-nonempty-ratio", type=float, default=0.95)
    p.add_argument("--caption-guard-min-unique-ratio", type=float, default=0.10)
    p.add_argument("--caption-guard-max-top1-ratio", type=float, default=0.50)
    p.add_argument("--caption-guard-max-generic-top1-ratio", type=float,
                   default=0.20)
    p.add_argument("--caption-guard-mode", default="fail",
                   choices=["fail", "warn", "off"])
    p.add_argument("--fixed-caption", default=None)
    p.add_argument("--load-fps", type=float, default=None,
                   help="Subsample frames to this fps (stride = round(24 / "
                        "target)); default: consecutive frames")
    return p


def _check_ported(args) -> None:
    if args.method not in PORTED_METHODS:
        raise NotImplementedError(
            f"--method {args.method} is not yet ported to the PyTorch runner "
            f"(ported: {', '.join(PORTED_METHODS)})")
    unported = [flag for on, flag in (
        (args.bucket_shapes, "--bucket-shapes"),
        (args.save_adapters, "--save-adapters"),
        (args.aug_enabled, "--aug-enabled"),
        (args.batch_videos > 1, "--batch-videos"),
        (args.clip_gate_enabled, "--clip-gate-enabled")) if on]
    if unported:
        raise NotImplementedError(
            f"{', '.join(unported)}: not yet ported to the PyTorch runner")


def apply_fast_decode_defaults(args) -> None:
    """--fast-decode: fill the UNSET decode-lever flags with the
    reference's recommended stack (flags set by hand win). BSA keep ratio
    0.15 at >= 16 gen latents, else 0.35. The port has no mesh flags, so
    BSA is on for every LongCat preset on the KV-cache path."""
    if not args.fast_decode:
        return
    from ..pipeline.pipeline import round_frames_4k1

    n_gen_latents = (round_frames_4k1(args.num_frames) - 1) // 4 + 1
    long_horizon = n_gen_latents >= 16 and args.num_inference_steps >= 20
    if args.quantize_decode == "none":
        args.quantize_decode = "int8"
    if args.no_kv_cache:
        # BSA, PAB and int8qk ride the KV-cache decode path
        if args.cfg_reuse_every <= 0:
            args.cfg_reuse_every = 2
        if args.gen_segment_steps <= 0 and long_horizon:
            args.gen_segment_steps = 5
        return
    if args.bsa_keep_ratio <= 0 and args.preset.startswith("longcat"):
        args.bsa_keep_ratio = 0.15 if n_gen_latents >= 16 else 0.35
    if args.pab_every <= 0:
        args.pab_every = 4
        # parser defaults only: a broadcast range set by hand wins
        if args.pab_start_frac == 0.1:
            args.pab_start_frac = 0.06
        if args.pab_end_frac == 0.9:
            args.pab_end_frac = 0.96
    if args.cfg_reuse_every <= 0:
        # range aligned with PAB's, so the full steps refresh both caches
        args.cfg_reuse_every = 2
        if args.cfg_reuse_start_frac == 0.1:
            args.cfg_reuse_start_frac = args.pab_start_frac
        if args.cfg_reuse_end_frac == 0.9:
            args.cfg_reuse_end_frac = args.pab_end_frac
    if args.gen_segment_steps <= 0 and long_horizon:
        args.gen_segment_steps = 5


def check_decode_levers(args) -> None:
    """Refuse at start-up the lever combinations that generation would
    reject, before any training budget is spent."""
    if args.fast_decode_verify > 0:
        if args.skip_generation:
            raise SystemExit("--fast-decode-verify needs generation "
                             "(drop --skip-generation)")
        if not (args.quantize_decode != "none" or args.bsa_keep_ratio > 0
                or args.pab_every > 0 or args.cfg_reuse_every > 0 or args.bucket_gen):
            raise SystemExit("--fast-decode-verify: no decode lever is active, "
                             "nothing to verify (enable --fast-decode or "
                             "individual levers)")
    if not args.skip_generation and args.no_kv_cache:
        bad = [name for on, name in (
            (args.pab_every > 0, "--pab-every"),
            (args.bsa_keep_ratio > 0, "--bsa-keep-ratio"),
            (args.quantize_decode == "int8qk", "--quantize-decode int8qk")) if on]
        if bad:
            raise SystemExit(f"{', '.join(bad)}: requires the KV-cache decode "
                             "path (drop --no-kv-cache)")


def decode_levers(args) -> Dict[str, Any]:
    """``generate_vc``'s lever arguments from the flags."""
    from ..config import BSAConfig, CFGReuseConfig, PABConfig

    return dict(
        bsa_cfg=(None if args.bsa_keep_ratio <= 0
                 else BSAConfig(keep_ratio=args.bsa_keep_ratio)),
        quantize_decode=args.quantize_decode,
        bucket_gen=args.bucket_gen,
        pab_cfg=(None if args.pab_every <= 0 else PABConfig(
            every=args.pab_every, start_frac=args.pab_start_frac,
            end_frac=args.pab_end_frac)),
        cfgr_cfg=(None if args.cfg_reuse_every <= 0 else CFGReuseConfig(
            every=args.cfg_reuse_every, start_frac=args.cfg_reuse_start_frac,
            end_frac=args.cfg_reuse_end_frac)))


def _summarize_fast_decode_verify(ok_results):
    """Mean fast-vs-dense PSNR and mean metric-vs-GT deltas over the
    videos with a --fast-decode-verify record; None when there are none."""
    recs = [r["fast_decode_verify"] for r in ok_results if "fast_decode_verify" in r]
    if not recs:
        return None
    out = {"num_verified": len(recs),
           "same_noise": all(r.get("same_noise") for r in recs)}
    for key in ("psnr_fast_vs_dense", "psnr_delta", "ssim_delta", "dense_gen_time"):
        vals = [r[key] for r in recs if key in r and np.isfinite(r[key])]
        if vals:
            out[f"{key}_mean"] = float(np.mean(vals))
    return out


def video_seed(seed: int, vid_idx: int) -> int:
    """Seed of one video's training draws: distinct for every (seed,
    video) pair, as the reference's fold_in keys are."""
    return int(np.random.SeedSequence([seed, vid_idx]).generate_state(1)[0])


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _clock(device: torch.device):
    """A point in time on the device's stream (a recorded CUDA event) or
    on the host clock (the CPU path is synchronous)."""
    if device.type == "cuda":
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev
    return time.perf_counter()


def _seconds(a, b) -> float:
    """Seconds between two ``_clock`` points (after a sync)."""
    return a.elapsed_time(b) / 1e3 if isinstance(a, torch.cuda.Event) else b - a


def make_synthetic_dataset(out_dir: str, n: int, height: int, width: int,
                           frames: int = 64, seed: int = 0,
                           speed_range: Tuple[float, float] = (0.02, 0.10),
                           freq_range: Tuple[float, float] = (2.0, 8.0),
                           direction: float = 1.0) -> str:
    """Deterministic synthetic moving-pattern clips + metadata.csv (the
    same clips as the reference runner's generator for the same seed)."""
    import csv

    os.makedirs(out_dir, exist_ok=True)
    rng = np.random.RandomState(seed)
    rows = []
    captions = ["a ball moving across the scene",
                "waves rolling over a beach",
                "a car driving down a road",
                "a bird flying in the sky"]
    for i in range(n):
        t = np.arange(frames, dtype=np.float32)
        yy, xx = np.meshgrid(np.linspace(0, 1, height),
                             np.linspace(0, 1, width), indexing="ij")
        freq = freq_range[0] + rng.rand() * (freq_range[1] - freq_range[0])
        phase = rng.rand() * 6.28
        speed = direction * (
            speed_range[0] + rng.rand() * (speed_range[1] - speed_range[0]))
        clip = np.stack([
            0.5 + 0.5 * np.sin(
                6.28 * (freq * (xx + speed * ti) + yy * freq / 2) + phase
            ) for ti in t
        ])[..., None].repeat(3, -1)
        clip = (clip * 255).astype(np.uint8)
        name = f"clip_{i:03d}.npy"
        np.save(os.path.join(out_dir, name), clip)
        rows.append({"filename": name, "caption": captions[i % len(captions)],
                     "category": f"cat{i % 2}"})
    with open(os.path.join(out_dir, "metadata.csv"), "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=["filename", "caption", "category"])
        w.writeheader()
        w.writerows(rows)
    return out_dir


def load_bundle(args):
    from ..config import get_model_config
    from ..pipeline.pipeline import ModelBundle

    print(f"[runner] random-init weights (preset {args.preset}) on {args.device}")
    return ModelBundle.init_random(get_model_config(args.preset), seed=args.seed,
                                   device=args.device)


def _summary(args, results: List[Dict], caption_stats, t_start) -> Dict[str, Any]:
    """summary.json with the reference runner's keys (the clip gate and
    online FVD/FID are not ported; their entries say so the way the
    reference does when they are off)."""
    ok = [r for r in results if r.get("success") and "psnr" in r]

    def stats(key):
        vals = [r[key] for r in ok if np.isfinite(r.get(key, np.nan))]
        if not vals:
            return None
        return {"mean": float(np.mean(vals)), "std": float(np.std(vals)),
                "min": float(np.min(vals)), "max": float(np.max(vals))}

    def avg(key):
        return float(np.mean([r.get(key, 0) for r in ok])) if ok else None

    return {
        "method": args.method,
        "config": vars(args),
        "num_videos": len(results),
        "num_success": len(ok),
        "metrics": {k: stats(k) for k in ("psnr", "ssim", "lpips")},
        "avg_train_time": avg("train_time"),
        "avg_gen_time": avg("gen_time"),
        "avg_es_check_time": avg("es_check_time"),
        "avg_encode_time": avg("encode_time"),
        "avg_clip_gate_eval_time": avg("clip_gate_eval_time"),
        "clip_gate_stats": {"clip_gate_enabled": False},
        "fast_decode_verify": _summarize_fast_decode_verify(ok),
        "caption_stats": caption_stats,
        "online_eval": {"fvd": None, "fid": None, "num_videos": 0},
        "wall_time": time.time() - t_start,
        "results": results,
    }


def main(argv: Optional[List[str]] = None,
         on_phase: Optional[Callable[[str], None]] = None) -> Dict[str, Any]:
    args = build_arg_parser().parse_args(argv)
    apply_fast_decode_defaults(args)
    _check_ported(args)
    check_decode_levers(args)
    mark = on_phase or (lambda name: None)

    from ..config import (
        AdapterConfig,
        CaptionGuardConfig,
        EarlyStoppingConfig,
        FrameConfig,
        OptimConfig,
    )
    from ..data.datasets import (
        apply_fixed_caption,
        load_video_list,
        validate_caption_quality,
    )
    from ..data.video_io import annotate_borders, load_gt_frames, \
        load_video_frames, save_video
    from ..eval.metrics import evaluate_generation_metrics
    from ..pipeline.pipeline import generate_vc
    from ..tta.adapters import build_scheme
    from ..tta.early_stopping import build_early_stopper
    from ..tta.engine import adapter_norm, build_optimizer
    from ..tta.split import (
        estimate_latent_len,
        resolve_frame_window,
        validate_tta_feature_budget,
    )
    from ..utils.checkpoint import (
        load_checkpoint,
        save_checkpoint,
        save_config,
        save_results,
    )
    from ..utils.device import resolve_device

    device = resolve_device(args.device)
    t_start = time.time()
    os.makedirs(args.output_dir, exist_ok=True)

    frames = resolve_frame_window(FrameConfig(
        num_cond_frames=args.num_cond_frames, num_frames=args.num_frames,
        gen_start_frame=args.gen_start_frame,
        tta_total_frames=args.tta_total_frames,
        tta_context_frames=args.tta_context_frames,
        height=args.height, width=args.width))
    is_tta = args.method != "none"
    escfg = EarlyStoppingConfig(
        enabled=(not args.es_disable) and is_tta,
        check_every=args.es_check_every,
        patience=args.es_patience,
        anchor_sigmas=tuple(float(x) for x in args.es_anchor_sigmas.split(",")),
        noise_draws=args.es_noise_draws,
        strategy=args.es_strategy,
        holdout_fraction=args.es_holdout_fraction)
    validate_tta_feature_budget(frames, escfg, args.feature_frame_guard_mode,
                                context=args.method)

    if args.synthetic:
        data_dir = make_synthetic_dataset(
            os.path.join(args.output_dir, "synthetic_data"),
            args.synthetic, args.height, args.width, seed=args.seed)
    elif args.data_dir:
        data_dir = args.data_dir
    else:
        raise SystemExit("--data-dir or --synthetic required")
    videos = load_video_list(data_dir, max_videos=args.max_videos, seed=args.seed)
    caption_stats = validate_caption_quality(videos, CaptionGuardConfig(
        mode=args.caption_guard_mode,
        min_nonempty_ratio=args.caption_guard_min_nonempty_ratio,
        min_unique_ratio=args.caption_guard_min_unique_ratio,
        max_top1_ratio=args.caption_guard_max_top1_ratio,
        max_generic_top1_ratio=args.caption_guard_max_generic_top1_ratio,
        topk=args.caption_guard_topk))
    apply_fixed_caption(videos, args.fixed_caption)

    bundle = load_bundle(args)
    dit_cfg = bundle.cfg.dit
    scheme = opt = stopper = None
    if is_tta:
        scheme = build_scheme(dit_cfg, AdapterConfig(method=args.method))
        opt = build_optimizer(OptimConfig(
            optimizer=args.optimizer, lr=args.lr, steps=args.steps,
            warmup_steps=args.warmup_steps, weight_decay=args.weight_decay,
            grad_clip_norm=args.max_grad_norm))
        stopper = build_early_stopper(escfg, scheme, dit_cfg)

    ckpt_path = os.path.join(args.output_dir, "checkpoint.json")
    ckpt = load_checkpoint(ckpt_path)
    start_idx = ckpt["next_idx"] if ckpt else 0
    results: List[Dict] = ckpt["results"] if ckpt else []
    save_config(os.path.join(args.output_dir, "config.json"), vars(args))
    videos_dir = os.path.join(args.output_dir, "videos")
    levers = decode_levers(args)
    # resume-safe: the verified count carries over from the checkpoint
    fd_verified = sum(1 for r in results if "fast_decode_verify" in r)
    n_ctx_lat = estimate_latent_len(frames.tta_context_frames)
    tta_start = frames.gen_start_frame - frames.tta_total_frames

    for idx in range(start_idx, len(videos)):
        entry = videos[idx]
        vid_id = os.path.basename(entry["path"])
        print(f"\n[{idx + 1}/{len(videos)}] {vid_id}")
        mark("video")
        t_vid = time.time()
        res: Dict[str, Any] = {"video": vid_id, "path": entry["path"],
                               "caption": entry["caption"], "index": idx,
                               "success": True}
        try:
            # the TTA window, ending at the anchor (for --method none it
            # is the conditioning window: tta_total defaults to it)
            mark("encode_window")
            t0 = time.time()
            window_px = load_video_frames(
                entry["path"], frames.tta_total_frames, frames.height,
                frames.width, start_frame=tta_start, target_fps=args.load_fps)
            with torch.no_grad():
                window_lat = bundle.encode_video(torch.from_numpy(window_px))
            _sync(device)
            res["encode_time"] = time.time() - t0
            # no CLIP gate in the port: the reference's disabled-gate record
            res.update(CLIP_GATE_OFF)
            res["clip_gate_eval_time"] = 0.0

            train_time = es_time = 0.0
            tp = None
            if is_tta:
                tp, train_time, es_time = _adapt(
                    args, res, bundle, scheme, opt, stopper, escfg, window_lat,
                    n_ctx_lat, entry["caption"], idx, vid_id, mark)
                res["adapter_norm"] = adapter_norm(tp)
                res["trainable_params"] = scheme.num_params(tp)

            gen_time = 0.0
            if not args.skip_generation:
                mark("generation")
                gen_bundle, adapters = bundle, None
                if tp is not None:
                    dit, adapters = scheme.to_forward(tp, bundle.dit)
                    if dit is not bundle.dit:
                        gen_bundle = dataclasses.replace(bundle, dit=dit)
                cond_px = load_video_frames(
                    entry["path"], frames.num_cond_frames, frames.height,
                    frames.width,
                    start_frame=frames.gen_start_frame - frames.num_cond_frames,
                    target_fps=args.load_fps)
                gen_kw = dict(num_frames=frames.num_frames,
                              num_inference_steps=args.num_inference_steps,
                              guidance_scale=args.guidance_scale,
                              seed=args.seed + idx,
                              use_kv_cache=not args.no_kv_cache, adapters=adapters,
                              gen_segment_steps=args.gen_segment_steps)
                t0 = time.time()
                gen = generate_vc(gen_bundle, cond_px, entry["caption"],
                                  on_phase=on_phase, **gen_kw, **levers)
                gen_time = time.time() - t0
                gt = load_gt_frames(entry["path"], len(gen), frames.height,
                                    frames.width, frames.gen_start_frame,
                                    target_fps=args.load_fps)
                res.update(evaluate_generation_metrics(gen, gt, device=device))
                if fd_verified < args.fast_decode_verify:
                    res["fast_decode_verify"] = _verify_fast_decode(
                        gen_bundle, cond_px, entry["caption"], gen, gt, res,
                        gen_kw, args.bucket_gen, device)
                    fd_verified += 1
                if not args.no_save_videos:
                    # the baseline artifact has a green GENERATED border
                    res["video_path"] = save_video(
                        gen if is_tta else annotate_borders(gen, (0, 200, 0)),
                        os.path.join(videos_dir, f"{idx:04d}_{vid_id}.mp4"))
            res["train_time"] = train_time
            res["gen_time"] = gen_time
            res["es_check_time"] = es_time
            res["total_time"] = time.time() - t_vid
            print(f"  psnr={res.get('psnr', float('nan')):.3f} "
                  f"train={train_time:.1f}s gen={gen_time:.1f}s")
        except Exception as e:  # per-video fault tolerance, as the reference
            import traceback

            traceback.print_exc()
            res["success"] = False
            res["error"] = f"{type(e).__name__}: {e}"
        mark("video_end")
        results.append(res)
        save_checkpoint(ckpt_path, idx + 1, results)

    summary = _summary(args, results, caption_stats, t_start)
    save_results(os.path.join(args.output_dir, "summary.json"), summary)
    print(f"\nDone: {summary['num_success']}/{len(results)} videos, "
          f"summary at {args.output_dir}/summary.json")
    return summary


def _verify_fast_decode(bundle, cond_px, caption, gen, gt, res, gen_kw,
                        bucket_gen: bool, device) -> Dict[str, Any]:
    """The --fast-decode-verify record: generate again with every decode
    lever off (same seed, adapters and segmenting) and compare. The
    per-pixel PSNR is a same-sample comparison only when the fast path
    kept the plain noise draw (``bucket_gen`` draws at the bucket's
    shape); the deltas against the ground truth hold either way. LPIPS is
    not ported, so there are no lpips keys."""
    from ..eval.metrics import evaluate_generation_metrics
    from ..pipeline.pipeline import generate_vc

    t0 = time.time()
    dense = generate_vc(bundle, cond_px, caption, **gen_kw)
    dense_time = time.time() - t0
    dm = evaluate_generation_metrics(dense, gt, device=device)
    mse = float(np.mean((np.asarray(gen, np.float64) - np.asarray(dense)) ** 2))
    return {
        "psnr_fast_vs_dense": float("inf") if mse == 0 else -10.0 * np.log10(mse),
        "same_noise": not bucket_gen,
        "dense_gen_time": dense_time,
        **{f"{k}_dense": v for k, v in dm.items()
           if k not in ("num_frames_scored", "lpips")},
        **{f"{k}_delta": res[k] - v for k, v in dm.items()
           if k in ("psnr", "ssim") and np.isfinite(v)},
    }


def _adapt(args, res, bundle, scheme, opt, stopper, escfg, window_lat, n_ctx_lat,
           caption, idx, vid_id, mark):
    """One video's TTA: split the window, set up the stopper, run the
    chunked train loop and restore the best state. Writes ``losses`` and
    ``early_stopping_info`` into ``res``; returns (train_params,
    train_time, es_time) with the reference's accounting: es_time is the
    stopper's setup plus every anchor check, train_time the loop's wall
    time without the anchor checks."""
    from ..tta.engine import train_chunk
    from ..tta.split import split_tta_latents

    device = bundle.device
    cond_l, train_l, val_l = split_tta_latents(window_lat, n_ctx_lat,
                                               escfg.holdout_fraction)
    with torch.no_grad():
        emb, mask = bundle.encode_prompt(caption)
    tp = scheme.init(device)
    opt_state = opt.init(tp)
    es_active = stopper is not None and val_l is not None
    es_time = 0.0
    if es_active:
        _sync(device)
        mark("setup_anchor")
        t0 = time.time()
        stopper.setup(bundle.dit, cond_l, val_l, emb, mask, vid_id, tp)
        es_time += time.time() - t0

    gen = torch.Generator(device=device).manual_seed(video_seed(args.seed, idx))
    k0 = escfg.check_every if es_active else (args.loss_fetch_every or 25)
    marks = {}

    def on_phase(name):
        marks[name] = _clock(device)
        mark(name)

    losses: List[float] = []
    es_loop_time = 0.0
    t_train = time.time()
    s = 0
    while s < args.steps:
        k = min(k0, args.steps - s)
        do_anchor = es_active and (s + k) % escfg.check_every == 0
        marks.clear()
        tp, opt_state, loss_vec, anchor = train_chunk(
            scheme, bundle.dit, opt, tp, opt_state, cond_l, train_l, emb, mask,
            steps=k, generator=gen,
            val_latents=val_l if do_anchor else None,
            fixed_noises=stopper.fixed_noises if do_anchor else None,
            anchor_sigmas=escfg.anchor_sigmas, on_phase=on_phase)
        end = _clock(device)
        s += k
        losses.extend(float(x) for x in loss_vec.tolist())  # the chunk's host sync
        if do_anchor:
            es_loop_time += _seconds(marks["anchor_check"], end)
            stop, _ = stopper.step_with_loss(s, tp, float(anchor))
            if stop:
                print(f"  early stop at step {s}")
                break
    es_time += es_loop_time
    train_time = time.time() - t_train - es_loop_time
    if es_active:
        tp = stopper.restore()
        res["early_stopping_info"] = stopper.state
    res["losses"] = losses
    return tp, train_time, es_time


if __name__ == "__main__":
    main()
