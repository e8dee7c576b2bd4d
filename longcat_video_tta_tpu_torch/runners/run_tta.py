"""TTA runner of the PyTorch port (counterpart of
``longcat_video_tta_tpu/runners/run_tta.py``), with every ``--method``
of the reference runner: the no-TTA baseline (``none``), the seven TTA
methods (``delta_a``, the default; ``delta_b``, ``delta_c``, ``film``,
``lora``, ``norm_tune``, ``full``: ``tta/adapters.py``) and SAVi-DNO noise
optimization (``dno``: ``comparisons/noise_opt.py``). Per video: load and
encode the TTA window that ends at the anchor; for a TTA method, split it
into cond/train/val latents, set up the anchored early stopper, run the
chunked train loop (``check_every`` AdamW steps, then the anchor eval, one
host sync per chunk), restore the best state; for dno, optimize the
initial noise against the window's train latents; then ``generate_vc``
with the trained adapter, adapted DiT or optimized noise (VAE encode,
prompt encode, cond-cache precompute, CFG Euler loop, VAE decode),
PSNR/SSIM against the ground truth, ``checkpoint.json``; at the end
``summary.json`` with the reference runner's keys. Generation takes the
reference runner's decode levers (``--bsa-keep-ratio``,
``--quantize-decode``, ``--fast-decode``, ``--pab-*``, ``--cfg-reuse-*``,
``--gen-segment-steps``, ``--bucket-gen``) and its
``--fast-decode-verify`` fidelity record. Weights come from
``--checkpoint-dir`` (a LongCat folder in the upstream torch layout,
converted tensor by tensor: ``models/convert.py``) or are drawn from
``--seed``; ``--remat-policy`` picks the per-block checkpoint. The TTA
loop takes the reference's ``--bucket-shapes``, ``--aug-*`` and
``--batch-videos`` inputs (``TrainInputs``), ``--save-adapters``, the
``--stop-file`` drain and ``--preflight-only``. The CLIP gate
(``--clip-gate-*``: ``tta/clip_gate.py``) scores each TTA window against
its caption first, and a video it skips trains nothing and generates on
the base weights; ``--lpips-model-path`` scores LPIPS (``eval/lpips.py``)
and ``--fvd-enabled`` / ``--inception-model-path`` stream FVD and FID
(``eval/i3d.py``, ``eval/inception.py``, ``eval/frechet.py``) into
``online_eval``, their moments saved in ``fvd_state.npz`` for a resume;
``--compute-vbench`` scores the saved clips on the VBench dimensions at
the end (``eval/vbench.py``; towers from ``--vbench-towers-dir``) into
``online_eval.vbench``, after writing summary.json once without it.

``--preset opensora_v2`` (or ``opensora_v2_tiny``) runs the Open-Sora v2
MMDiT backbone (``models/mmdit.py``), ``--preset cogvideox_5b`` (or
``cogvideox_tiny``) CogVideoX-5B-I2V (``models/cogvideox.py``), each with
the methods the reference ports to it (none, delta_a, lora, full), its
conditioned losses and its sampler (triple-CFG Euler; 2-row CFG DDIM);
the flags the reference refuses for these backbones are refused at
start-up with its messages.

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
import json
import os
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..ops.layers import REMAT_POLICIES

METHODS = ["none", "full", "lora", "delta_a", "delta_b", "delta_c",
           "norm_tune", "film", "dno"]


def build_arg_parser() -> argparse.ArgumentParser:
    from ..config import ALL_PRESET_NAMES

    p = argparse.ArgumentParser(description="LongCat video TTA (PyTorch port)")
    p.add_argument("--method", default="delta_a", choices=METHODS)
    p.add_argument("--checkpoint-dir", default=None,
                   help="checkpoint folder in the upstream torch layout "
                        "(<dir>/{dit,vae,text_encoder} .safetensors or .bin shards, and "
                        "<dir>/clip for an Open-Sora v2 preset; optional <dir>/tokenizer); "
                        "random-init weights if unset")
    p.add_argument("--data-dir", default=None)
    p.add_argument("--output-dir", required=True)
    p.add_argument("--preset", default="longcat_13b", choices=sorted(ALL_PRESET_NAMES))
    p.add_argument("--remat-policy", default=None, choices=list(REMAT_POLICIES),
                   help="override the preset's per-block gradient-checkpoint policy "
                        "(ops/layers.py::remat_wrap): 'full' keeps only block inputs; "
                        "'dots' also the linears' outputs; 'dots_attn' also the "
                        "attention forward's o and lse (no forward kernel in the "
                        "backward; the most memory)")
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
    p.add_argument("--bucket-shapes", action="store_true",
                   help="pad the TTA target latents up to the bucket ladder "
                        "(tta/bucket.py); the pad is masked out of attention and "
                        "of the loss")
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
    p.add_argument("--save-adapters", action="store_true",
                   help="save each video's trained tensors (torch.save) under "
                        "<output-dir>/adapters/ and record adapter_path")
    p.add_argument("--skip-generation", action="store_true")
    p.add_argument("--no-save-videos", action="store_true")
    p.add_argument("--stop-file", default=None,
                   help="graceful drain: when this file (or $LONGCAT_STOP_FILE, or "
                        "<output-dir>/STOP) exists at a video boundary, checkpoint, "
                        "write <output-dir>/DRAINED and exit without summary.json; "
                        "a later run resumes from checkpoint.json")
    p.add_argument("--preflight-only", action="store_true",
                   help="validate the run (frame window, feature budget, data, "
                        "captions, flag combinations) and exit without loading "
                        "the model")
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
    # method knobs (the reference runner's flags and defaults)
    p.add_argument("--lora-rank", type=int, default=8)
    p.add_argument("--lora-alpha", type=float, default=16.0)
    p.add_argument("--lora-target-modules", default="qkv,proj")
    p.add_argument("--lora-target-ffn", action="store_true")
    p.add_argument("--num-groups", type=int, default=4)
    p.add_argument("--delta-target", default="timestep", choices=["timestep", "hidden"])
    p.add_argument("--delta-dim", type=int, default=None)
    p.add_argument("--target-blocks", default="all")
    p.add_argument("--norm-target", default="cross_attn_norm",
                   choices=["cross_attn_norm", "qk_norm", "all_norm"])
    p.add_argument("--also-tune-delta", action="store_true",
                   help="norm_tune with a delta_a vector trained alongside")
    p.add_argument("--use-builtin-lora", action="store_true",
                   help="merge scale * a @ b into the block weights instead of the "
                        "low-rank side branch (same function, a weight copy per step)")
    p.add_argument("--film-mode", default="full",
                   choices=["full", "shift_scale", "scale_only"])
    # --method dno: --steps noise-optimization steps at Adam lr --lr
    p.add_argument("--dno-sampler-steps", type=int, default=4,
                   help="K of the differentiable K-step Euler sampler backpropagated "
                        "through per DNO step")
    p.add_argument("--dno-interp-p", type=float, default=0.9,
                   help="noise-interpolation regularization p (1.0 disables)")
    p.add_argument("--dno-interp-every", type=int, default=5,
                   help="apply the noise interpolation every N optimization steps")
    # augmentation of the TTA clip (data/augment.py)
    p.add_argument("--aug-enabled", action="store_true")
    p.add_argument("--aug-hflip", action="store_true")
    p.add_argument("--aug-rotate-degrees", default="",
                   help="comma-separated fixed rotations in degrees")
    p.add_argument("--aug-speed-factors", default="",
                   help="comma-separated speed factors (>1 strides, <1 repeats)")
    # batch TTA: train on the video and its caption neighbours in turn
    p.add_argument("--batch-videos", type=int, default=1)
    p.add_argument("--batch-method", default="similarity", choices=["similarity"])
    p.add_argument("--retrieval-pool-dir", default=None)
    p.add_argument("--retrieval-sbert-path", default=None,
                   help="local SentenceTransformer folder (needs the "
                        "sentence_transformers package); absent = hashed "
                        "bag-of-words embedding")
    # CLIP gate (tta/clip_gate.py)
    p.add_argument("--clip-gate-enabled", action="store_true")
    p.add_argument("--clip-gate-backend", default="clip", choices=["clip", "xclip"])
    p.add_argument("--clip-gate-model-path", default=None)
    p.add_argument("--clip-gate-threshold", type=float, default=0.2)
    p.add_argument("--clip-gate-sample-frames", type=int, default=4)
    p.add_argument("--clip-gate-sampling-mode", default="full_window",
                   choices=["full_window", "late_only"])
    p.add_argument("--clip-gate-late-fraction", type=float, default=0.4)
    p.add_argument("--clip-gate-aggregate", default="mean", choices=["mean", "min", "max"])
    p.add_argument("--clip-gate-log-only", action="store_true")
    p.add_argument("--clip-gate-fail-closed", action="store_true")
    p.add_argument("--clip-gate-scorer", default="jax", choices=["jax", "torch"],
                   help="'jax' (the reference's name, kept so a sweep's flags carry "
                        "over): the checkpoint converted once into the port's own CLIP / "
                        "X-CLIP towers, scored on --device (models/clip.py, "
                        "models/xclip.py); 'torch': the transformers models at run "
                        "time (needs the transformers package)")
    p.add_argument("--clip-gate-hash-tokenizer", action="store_true",
                   help="allow the deterministic hash tokenizer when the gate "
                        "checkpoint folder has no tokenizer files (synthetic or test "
                        "weights only: scores are meaningless on real captions)")
    # online evaluation
    p.add_argument("--fvd-enabled", action="store_true")
    p.add_argument("--compute-vbench", action="store_true",
                   help="score the saved clips on the VBench dimensions at the end "
                        "(eval/vbench.py: the vbench package when installed, else the "
                        "port's native dimensions on --device) into "
                        "online_eval.vbench")
    p.add_argument("--vbench-towers-dir", default=None,
                   help="folder of dino_vits16.pth, aesthetic_l14.pth + clip_l14/ and "
                        "musiq_spaq.pth (each with an optional config sidecar) for "
                        "subject_consistency, aesthetic_quality and imaging_quality")
    p.add_argument("--min-fvd-videos", type=int, default=256,
                   help="small-sample warning threshold of the online Frechet "
                        "accumulator")
    p.add_argument("--i3d-model-path", default=None,
                   help="pytorch-i3d state dict or the DFoT TorchScript file; with "
                        "--fvd-enabled, online FVD through the port's I3D tower "
                        "(eval/i3d.py); a file that does not convert raises")
    p.add_argument("--inception-model-path", default=None,
                   help="torchvision inception_v3 state dict; enables online FID "
                        "through the port's InceptionV3 tower (eval/inception.py)")
    p.add_argument("--lpips-model-path", default=None,
                   help="state dict of lpips.LPIPS(net='alex'); runs the port's LPIPS "
                        "tower per video (eval/lpips.py). Without it lpips=NaN.")
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


def check_composition(args, arch: str = "longcat") -> None:
    """Refuse at start-up the flag combinations the reference refuses
    (its runner :722-726, :825-836 and :1011-1022), before any weight is
    loaded."""
    if args.compute_vbench and (args.no_save_videos or args.skip_generation):
        raise SystemExit("--compute-vbench scores the saved clips; it cannot run with "
                         "--no-save-videos or --skip-generation")
    if args.method == "dno" and arch != "longcat":
        raise SystemExit("--method dno is wired for the LongCat backbone only "
                         "(carried init_noise rides the cond-KV/noise-split sampler)")
    if args.method == "dno":
        bad = [name for on, name in ((args.aug_enabled, "augmentation"),
                                     (args.batch_videos > 1, "--batch-videos"),
                                     (args.bucket_shapes, "--bucket-shapes"),
                                     (args.save_adapters, "--save-adapters")) if on]
        if bad:
            raise SystemExit(f"--method dno does not compose with {', '.join(bad)}")
    if args.batch_videos > 1:
        if args.aug_enabled:
            # the round robin over [video + neighbours] would drop the variants
            raise SystemExit("--batch-videos does not compose with augmentation "
                             "(the round-robin stack would drop the augmented variants)")
        if not args.retrieval_pool_dir:
            raise SystemExit("--retrieval-pool-dir required for batch TTA")
        if args.retrieval_sbert_path and not os.path.exists(args.retrieval_sbert_path):
            raise SystemExit(f"--retrieval-sbert-path {args.retrieval_sbert_path} does "
                             "not exist; omit the flag to use the hashed bag-of-words "
                             "embedding")


def augmentation_config(args):
    from ..config import AugmentationConfig
    from ..data.augment import parse_speed_factors

    return AugmentationConfig(
        enabled=args.aug_enabled, hflip=args.aug_hflip,
        rotate_degrees=tuple(float(x) for x in args.aug_rotate_degrees.split(",")
                             if x.strip()),
        speed_factors=tuple(parse_speed_factors(args.aug_speed_factors)))


def _drain_file(args) -> Optional[str]:
    """The first stop-file candidate that exists, or None."""
    for c in (args.stop_file, os.environ.get("LONGCAT_STOP_FILE"),
              os.path.join(args.output_dir, "STOP")):
        if c and os.path.exists(c):
            return c
    return None


def adapter_config(args):
    """The TTA method's ``AdapterConfig`` from the flags."""
    from ..config import AdapterConfig

    return AdapterConfig(
        method=args.method, lora_rank=args.lora_rank, lora_alpha=args.lora_alpha,
        lora_target_modules=tuple(args.lora_target_modules.split(",")),
        lora_target_ffn=args.lora_target_ffn, num_groups=args.num_groups,
        delta_target=args.delta_target, delta_dim=args.delta_dim,
        target_blocks=args.target_blocks, norm_target=args.norm_target,
        film_mode=args.film_mode, also_tune_delta=args.also_tune_delta,
        lora_builtin=args.use_builtin_lora)


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


def check_decode_levers(args, arch: str = "longcat") -> None:
    """Refuse at start-up the lever combinations that generation would
    reject, before any training budget is spent; on another backbone than
    LongCat also --bucket-shapes and the levers its joint-volume sampler
    does not take (the reference runner's :678 and :698-712)."""
    if arch != "longcat" and args.bucket_shapes:
        raise SystemExit("--bucket-shapes is only wired for the LongCat backbone")
    if args.fast_decode_verify > 0:
        if args.skip_generation:
            raise SystemExit("--fast-decode-verify needs generation "
                             "(drop --skip-generation)")
        if not (args.quantize_decode != "none" or args.bsa_keep_ratio > 0
                or args.pab_every > 0 or args.cfg_reuse_every > 0 or args.bucket_gen):
            raise SystemExit("--fast-decode-verify: no decode lever is active, "
                             "nothing to verify (enable --fast-decode or "
                             "individual levers)")
    if not args.skip_generation and arch != "longcat":
        bad = [name for on, name in (
            (args.bsa_keep_ratio > 0, "--bsa-keep-ratio"),
            (args.bucket_gen, "--bucket-gen"),
            (args.quantize_decode == "int8qk", "--quantize-decode int8qk")) if on]
        if bad:
            raise SystemExit(f"{', '.join(bad)}: not supported on the {arch} decode "
                             "path (LongCat only — no cond-KV/noise split in the "
                             "joint-volume sampler)")
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
    for key in ("psnr_fast_vs_dense", "psnr_delta", "ssim_delta", "lpips_delta",
                "dense_gen_time"):
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
    """The preset's bundle (with ``--remat-policy`` applied) from
    ``--checkpoint-dir``, else drawn at random from ``--seed``."""
    import dataclasses

    from ..config import get_model_config
    from ..pipeline.pipeline import ModelBundle

    cfg = get_model_config(args.preset)
    if getattr(args, "remat_policy", None):
        cfg = dataclasses.replace(cfg, dit=dataclasses.replace(
            cfg.dit, remat_policy=args.remat_policy))
    if args.checkpoint_dir:
        print(f"[runner] weights from {args.checkpoint_dir} (preset {args.preset}) "
              f"on {args.device}")
        return ModelBundle.from_checkpoint_dir(cfg, args.checkpoint_dir, args.device)
    print(f"[runner] random-init weights (preset {args.preset}) on {args.device}")
    return ModelBundle.init_random(cfg, seed=args.seed, device=args.device)


def gate_config(args):
    from ..config import ClipGateConfig

    return ClipGateConfig(
        enabled=args.clip_gate_enabled, backend=args.clip_gate_backend,
        threshold=args.clip_gate_threshold, sample_frames=args.clip_gate_sample_frames,
        sampling_mode=args.clip_gate_sampling_mode,
        late_fraction=args.clip_gate_late_fraction, aggregate=args.clip_gate_aggregate,
        log_only=args.clip_gate_log_only, fail_open=not args.clip_gate_fail_closed)


def make_gate_scorer(args, gatecfg, device):
    """The gate's scorer, built once; None without a checkpoint (the gate
    then records the error and fails open or closed)."""
    from ..tta import clip_gate

    if not (gatecfg.enabled and args.clip_gate_model_path):
        return None
    if args.clip_gate_scorer == "torch":
        maker = (clip_gate.make_hf_xclip_scorer if gatecfg.backend == "xclip"
                 else clip_gate.make_hf_clip_scorer)
        return maker(args.clip_gate_model_path, device)
    return clip_gate.make_clip_scorer(args.clip_gate_model_path, gatecfg.backend, device,
                                      allow_hash_tokenizer=args.clip_gate_hash_tokenizer)


def make_online_eval(args, device):
    """(the FVD/FID accumulator, the LPIPS hook or None), their towers
    converted once onto ``device``."""
    from ..eval.frechet import OnlineFrechetAccumulator

    i3d_fn = inception_fn = lpips_fn = None
    if args.fvd_enabled and args.i3d_model_path:
        from ..eval.i3d import load_i3d_params, make_i3d_feature_fn

        i3d_fn = make_i3d_feature_fn(load_i3d_params(args.i3d_model_path, device))
    if args.inception_model_path:
        from ..eval.inception import load_inception_params, make_inception_feature_fn

        inception_fn = make_inception_feature_fn(
            load_inception_params(args.inception_model_path, device))
    if args.lpips_model_path:
        from ..eval.lpips import load_lpips_params, make_lpips_feature_fn

        lpips_fn = make_lpips_feature_fn(load_lpips_params(args.lpips_model_path, device))
    fvd = OnlineFrechetAccumulator(video_feature_fn=i3d_fn, frame_feature_fn=inception_fn,
                                   min_videos=args.min_fvd_videos)
    return fvd, lpips_fn


def restore_online_eval(fvd, path: str, start_idx: int) -> None:
    """On a resume, the saved moments back, and the videos they miss
    reported (saves are amortised and written after the checkpoint, so
    they can lag it; a video is never counted twice)."""
    cursor = fvd.load_state(path)
    if cursor is None:
        print("[resume] WARNING: fvd_state.npz missing: online FVD/FID will cover only "
              "post-resume videos")
    elif cursor == -1:
        print(f"[resume] restored legacy FVD/FID moments ({fvd.compute()['num_videos']} "
              "pairs; pre-cursor format: if the previous run crashed between its FVD "
              "save and its checkpoint, the first re-run video may be double-counted)")
    elif cursor < start_idx:
        print(f"[resume] restored FVD/FID moments through video {cursor}: "
              f"{start_idx - cursor} completed video(s) are missing from the streaming "
              "stats (state saves are amortized; never double-counted)")
    else:
        print(f"[resume] restored online FVD/FID moments "
              f"({fvd.compute()['num_videos']} pairs)")


def _summary(args, results: List[Dict], caption_stats, t_start, fvd) -> Dict[str, Any]:
    """summary.json with the reference runner's keys."""
    from ..tta.clip_gate import summarize_clip_gate_stats

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
        "clip_gate_stats": summarize_clip_gate_stats(results),
        "fast_decode_verify": _summarize_fast_decode_verify(ok),
        "caption_stats": caption_stats,
        "online_eval": fvd.compute(),
        "wall_time": time.time() - t_start,
        "results": results,
    }


def main(argv: Optional[List[str]] = None,
         on_phase: Optional[Callable[[str], None]] = None) -> Dict[str, Any]:
    args = build_arg_parser().parse_args(argv)
    apply_fast_decode_defaults(args)
    from ..archs import get_arch
    from ..config import get_model_config

    arch = get_model_config(args.preset).arch
    check_decode_levers(args, arch)
    check_composition(args, arch)
    mark = on_phase or (lambda name: None)

    from ..config import (
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
    from ..tta.clip_gate import evaluate_clip_gate
    from ..tta.early_stopping import build_early_stopper
    from ..tta.engine import adapter_norm, build_optimizer
    from ..tta.split import (
        estimate_latent_len,
        resolve_frame_window,
        validate_tta_feature_budget,
    )
    from ..utils.checkpoint import (
        load_checkpoint,
        save_adapter_state,
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
    is_dno = args.method == "dno"
    is_adapter = is_tta and not is_dno
    escfg = EarlyStoppingConfig(
        enabled=(not args.es_disable) and is_adapter,
        check_every=args.es_check_every,
        patience=args.es_patience,
        anchor_sigmas=tuple(float(x) for x in args.es_anchor_sigmas.split(",")),
        noise_draws=args.es_noise_draws,
        strategy=args.es_strategy,
        holdout_fraction=args.es_holdout_fraction)
    gatecfg = gate_config(args)
    validate_tta_feature_budget(frames, escfg, args.feature_frame_guard_mode,
                                context=args.method, clip_gate=gatecfg)

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
    if args.preflight_only:
        print(f"[preflight] OK: {len(videos)} videos, method {args.method}, preset "
              f"{args.preset}, window total={frames.tta_total_frames} "
              f"ctx={frames.tta_context_frames}")
        return {"preflight": True, "num_videos": len(videos)}

    bundle = load_bundle(args)
    dit_cfg = bundle.cfg.dit
    scheme = opt = stopper = None
    if is_adapter:
        scheme = build_scheme(dit_cfg, adapter_config(args))
        opt = build_optimizer(OptimConfig(
            optimizer=args.optimizer, lr=args.lr, steps=args.steps,
            warmup_steps=args.warmup_steps, weight_decay=args.weight_decay,
            grad_clip_norm=args.max_grad_norm))
        stopper = build_early_stopper(escfg, scheme, dit_cfg,
                                      anchor_fn=get_arch(arch).anchor)
    gate_scorer = make_gate_scorer(args, gatecfg, device)
    pool = None
    if args.batch_videos > 1:
        from ..data.retrieval import build_retrieval_pool

        pool = build_retrieval_pool(
            load_video_list(args.retrieval_pool_dir, max_videos=10 ** 9, seed=args.seed),
            sbert_model_path=args.retrieval_sbert_path)
        args.retrieval_embedder = pool.embedder
    fvd, lpips_fn = make_online_eval(args, device)
    fvd_state_path = os.path.join(args.output_dir, "fvd_state.npz")

    ckpt_path = os.path.join(args.output_dir, "checkpoint.json")
    # a fresh (re)launch clears the sentinel of an earlier drain
    if os.path.exists(os.path.join(args.output_dir, "DRAINED")):
        os.remove(os.path.join(args.output_dir, "DRAINED"))
    ckpt = load_checkpoint(ckpt_path)
    start_idx = ckpt["next_idx"] if ckpt else 0
    results: List[Dict] = ckpt["results"] if ckpt else []
    if start_idx > 0 and fvd.enabled:
        restore_online_eval(fvd, fvd_state_path, start_idx)
    save_config(os.path.join(args.output_dir, "config.json"), vars(args))
    videos_dir = os.path.join(args.output_dir, "videos")
    levers = decode_levers(args)
    # resume-safe: the verified count carries over from the checkpoint
    fd_verified = sum(1 for r in results if "fast_decode_verify" in r)
    n_ctx_lat = estimate_latent_len(frames.tta_context_frames)
    tta_start = frames.gen_start_frame - frames.tta_total_frames

    def encode_window(path: str):
        """(pixels [1, 3, T, H, W] in [-1, 1], latents) of a video's TTA
        window."""
        px = load_video_frames(path, frames.tta_total_frames, frames.height,
                               frames.width, start_frame=tta_start,
                               target_fps=args.load_fps)
        with torch.no_grad():
            lat = bundle.encode_video(torch.from_numpy(px))
        return px, lat

    train_inputs = TrainInputs(args, bundle, escfg, augmentation_config(args), pool,
                               n_ctx_lat, encode_window)
    for idx in range(start_idx, len(videos)):
        stop_f = _drain_file(args)
        if stop_f:
            # no summary.json: a drained run resumes from checkpoint.json;
            # DRAINED tells a sweep this exit was a drain
            save_checkpoint(ckpt_path, idx, results)
            with open(os.path.join(args.output_dir, "DRAINED"), "w") as f:
                json.dump({"next_idx": idx, "stop_file": stop_f}, f)
            print(f"\n[drain] stop file {stop_f} present: exiting at "
                  f"{idx}/{len(videos)} videos (checkpointed; run again to resume)")
            return {"drained": True, "next_idx": idx, "num_videos": len(results)}
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
            window_px, window_lat = encode_window(entry["path"])
            _sync(device)
            res["encode_time"] = time.time() - t0
            t0 = time.time()
            gate = evaluate_clip_gate((window_px[0].transpose(1, 2, 3, 0) + 1.0) / 2.0,
                                      entry["caption"], gatecfg, gate_scorer)
            res.update(gate)
            res["clip_gate_eval_time"] = time.time() - t0

            train_time = es_time = 0.0
            tp = dno_noise = None
            if gate["skip_tta"]:
                print(f"  CLIP gate: score {gate['clip_gate_score']} < "
                      f"{gatecfg.threshold}, TTA skipped")
            elif is_adapter:
                tp, train_time, es_time = _adapt(
                    args, res, bundle, scheme, opt, stopper, escfg, train_inputs,
                    window_px, window_lat, entry, idx, vid_id, mark)
                res["adapter_norm"] = adapter_norm(tp)
                res["trainable_params"] = scheme.num_params(tp)
                if args.save_adapters:
                    res["adapter_path"] = save_adapter_state(os.path.join(
                        args.output_dir, "adapters", f"{idx:04d}_{vid_id}.pt"), tp)
            elif is_dno:
                dno_noise, train_time = _optimize_noise(
                    args, res, bundle, window_lat, n_ctx_lat, entry["caption"], idx,
                    mark)

            gen_time = 0.0
            if not args.skip_generation:
                mark("generation")
                adapters = adapted = None
                if tp is not None:
                    adapted, adapters = scheme.to_forward(tp, bundle.dit)
                    if adapted is bundle.dit:
                        adapted = None
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
                              dit=adapted, init_noise=dno_noise,
                              gen_segment_steps=args.gen_segment_steps)
                t0 = time.time()
                gen = generate_vc(bundle, cond_px, entry["caption"],
                                  on_phase=on_phase, **gen_kw, **levers)
                gen_time = time.time() - t0
                gt = load_gt_frames(entry["path"], len(gen), frames.height,
                                    frames.width, frames.gen_start_frame,
                                    target_fps=args.load_fps)
                res.update(evaluate_generation_metrics(gen, gt, device=device,
                                                       lpips_feature_fn=lpips_fn))
                if fd_verified < args.fast_decode_verify:
                    res["fast_decode_verify"] = _verify_fast_decode(
                        bundle, cond_px, entry["caption"], gen, gt, res,
                        gen_kw, args.bucket_gen, device, lpips_fn)
                    fd_verified += 1
                if fvd.enabled:
                    fvd.update(gen, gt)
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
        if fvd.enabled:
            # after the checkpoint, so a crash between the two writes leaves
            # the moments behind it (reported on resume, never counted
            # twice); with Inception the moments are ~67 MB, so every 5th
            # video, and always the last
            every = 5 if fvd.frame_feature_fn is not None else 1
            if (idx + 1) % every == 0 or idx + 1 == len(videos):
                try:
                    fvd.save_state(fvd_state_path, next_idx=idx + 1)
                except OSError as e:  # a full disk must not end the run
                    print(f"  WARNING: fvd_state save failed: {e}")

    summary = _summary(args, results, caption_stats, t_start, fvd)
    if args.compute_vbench:
        from ..eval.vbench import run_vbench

        # never lose the run's summary to a scorer failure: write it
        # first, then amend it with the VBench scores
        save_results(os.path.join(args.output_dir, "summary.json"), summary)
        try:
            summary["online_eval"]["vbench"] = run_vbench(
                videos_dir, towers_dir=args.vbench_towers_dir, device=device)
        except Exception as e:
            summary["online_eval"]["vbench"] = {"error": f"{type(e).__name__}: {e}"}
    save_results(os.path.join(args.output_dir, "summary.json"), summary)
    print(f"\nDone: {summary['num_success']}/{len(results)} videos, "
          f"summary at {args.output_dir}/summary.json")
    return summary


def _verify_fast_decode(bundle, cond_px, caption, gen, gt, res, gen_kw,
                        bucket_gen: bool, device, lpips_fn=None) -> Dict[str, Any]:
    """The --fast-decode-verify record: generate again with every decode
    lever off (same seed, adapters and segmenting) and compare. The
    per-pixel PSNR is a same-sample comparison only when the fast path
    kept the plain noise draw (``bucket_gen`` draws at the bucket's
    shape); the deltas against the ground truth hold either way, each
    metric's only when it is finite (LPIPS needs --lpips-model-path)."""
    from ..eval.metrics import evaluate_generation_metrics
    from ..pipeline.pipeline import generate_vc

    t0 = time.time()
    dense = generate_vc(bundle, cond_px, caption, **gen_kw)
    dense_time = time.time() - t0
    dm = evaluate_generation_metrics(dense, gt, device=device, lpips_feature_fn=lpips_fn)
    mse = float(np.mean((np.asarray(gen, np.float64) - np.asarray(dense)) ** 2))
    return {
        "psnr_fast_vs_dense": float("inf") if mse == 0 else -10.0 * np.log10(mse),
        "same_noise": not bucket_gen,
        "dense_gen_time": dense_time,
        **{f"{k}_dense": v for k, v in dm.items() if k != "num_frames_scored"},
        **{f"{k}_delta": res[k] - v for k, v in dm.items()
           if k in ("psnr", "ssim", "lpips") and np.isfinite(v)},
    }


class TrainInputs:
    """What one video's TTA trains on, as the reference runner builds it
    (:1343-1420): a list of stacks {"cond", "train", "emb", "mask"[,
    "valid"]} and the stack each step takes.
      - the video's own split (one stack);
      - with augmentation, one stack per variant (original, hflip,
        rotations, speeds; data/augment.py), a variant drawn per step from
        ``RandomState(seed + video)``;
      - with ``--batch-videos N``, the video and its N - 1 caption
        neighbours from the retrieval pool, in turn;
      - with ``--bucket-shapes``, each target padded to its bucket and all
        to the largest, with the valid latent count ("valid")."""

    def __init__(self, args, bundle, escfg, augcfg, pool, n_ctx_lat: int,
                 encode_window: Callable):
        from ..archs import get_arch

        self.args, self.bundle, self.escfg = args, bundle, escfg
        self.augcfg, self.pool, self.n_ctx_lat = augcfg, pool, n_ctx_lat
        self.encode_window = encode_window
        # the backbone's (train loss, anchor loss): the reference runner's
        # per-arch loss dispatch
        arch = get_arch(bundle.cfg.arch)
        self.losses = (arch.loss, arch.anchor)

    def build(self, window_px, cond_l, train_l, emb, mask, entry, idx: int):
        from ..data.augment import build_augmented_latent_variants
        from ..tta.bucket import pad_target_latents
        from ..tta.split import split_tta_latents

        args, holdout = self.args, self.escfg.holdout_fraction
        variants = [{"cond": cond_l, "train": train_l}]
        if self.augcfg.enabled:
            variants = build_augmented_latent_variants(
                self.bundle, (window_px[0].transpose(1, 2, 3, 0) + 1) / 2, self.augcfg,
                self.n_ctx_lat, holdout, seed=args.seed + idx)
        stacks = [{"cond": v["cond"], "train": v["train"], "emb": emb, "mask": mask}
                  for v in variants]
        if self.pool is not None:
            stacks = stacks[:1]
            for nb in self.pool.neighbors(entry["caption"], entry["path"],
                                          args.batch_videos - 1):
                _, nb_lat = self.encode_window(nb["path"])
                nc, ntr, _ = split_tta_latents(nb_lat, self.n_ctx_lat, holdout)
                with torch.no_grad():
                    nb_emb, nb_mask = self.bundle.encode_prompt(nb["caption"])
                stacks.append({"cond": nc, "train": ntr, "emb": nb_emb, "mask": nb_mask})
        if self.pool is not None and len(stacks) > 1:
            select = [s % len(stacks) for s in range(args.steps)]
        else:
            rng = np.random.RandomState(args.seed + idx)
            select = [int(rng.randint(len(stacks))) for _ in range(args.steps)]
        if args.bucket_shapes:
            for d in stacks:
                d["train"], d["valid"] = pad_target_latents(d["train"])
            t_max = max(d["train"].shape[2] for d in stacks)
            for d in stacks:  # ragged variants padded to the largest bucket
                t = d["train"].shape[2]
                if t < t_max:
                    d["train"] = torch.nn.functional.pad(
                        d["train"], (0, 0, 0, 0, 0, t_max - t))
        return stacks, select


def _adapt(args, res, bundle, scheme, opt, stopper, escfg, inputs: TrainInputs,
           window_px, window_lat, entry, idx, vid_id, mark):
    """One video's TTA: split the window, set up the stopper, build the
    train stacks, run the chunked train loop and restore the best state.
    Writes ``losses`` and ``early_stopping_info`` into ``res``; returns
    (train_params, train_time, es_time) with the reference's accounting:
    es_time is the stopper's setup plus every anchor check, train_time the
    loop's wall time without the anchor checks."""
    from ..tta.engine import train_chunk
    from ..tta.split import split_tta_latents

    device = bundle.device
    cond_l, train_l, val_l = split_tta_latents(window_lat, inputs.n_ctx_lat,
                                               escfg.holdout_fraction)
    with torch.no_grad():
        emb, mask = bundle.encode_prompt(entry["caption"])
    stacks, select = inputs.build(window_px, cond_l, train_l, emb, mask, entry, idx)
    # the video's draws: LoRA's init first, then each step's sigma and noise
    gen = torch.Generator(device=device).manual_seed(video_seed(args.seed, idx))
    tp = scheme.init(device, dit=bundle.dit, generator=gen)
    opt_state = opt.init(tp)
    es_active = stopper is not None and val_l is not None
    es_time = 0.0
    if es_active:
        _sync(device)
        mark("setup_anchor")
        t0 = time.time()
        stopper.setup(bundle.dit, cond_l, val_l, emb, mask, vid_id, tp)
        es_time += time.time() - t0

    k0 = escfg.check_every if es_active else (args.loss_fetch_every or 25)
    marks = {}

    def on_phase(name):
        marks[name] = _clock(device)
        mark(name)

    first = stacks[0]  # the anchor's inputs (the reference's stack entry 0)
    losses: List[float] = []
    es_loop_time = 0.0
    t_train = time.time()
    s = 0
    while s < args.steps:
        k = min(k0, args.steps - s)
        do_anchor = es_active and (s + k) % escfg.check_every == 0
        marks.clear()
        tp, opt_state, loss_vec, anchor = train_chunk(
            scheme, bundle.dit, opt, tp, opt_state, first["cond"], first["train"],
            first["emb"], first["mask"], steps=k, generator=gen,
            val_latents=val_l if do_anchor else None,
            fixed_noises=stopper.fixed_noises if do_anchor else None,
            anchor_sigmas=escfg.anchor_sigmas, on_phase=on_phase,
            variants=stacks, select=select[s:s + k], loss_fn=inputs.losses[0],
            anchor_fn=inputs.losses[1])
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


def _optimize_noise(args, res, bundle, window_lat, n_ctx_lat, caption, idx, mark):
    """One video's DNO: the initial noise of the window's train latents
    (split at holdout 0, which still keeps the last latent out; no early
    stopping), optimized over ``--steps`` Adam steps
    of the ``--dno-sampler-steps``-step sampler; draws from a generator
    seeded with seed + video index. Writes ``losses``,
    ``trainable_params`` and ``noise_norm`` into ``res``; returns (noise,
    train_time)."""
    from ..comparisons.noise_opt import optimize_noise
    from ..tta.split import split_tta_latents

    device = bundle.device
    cond_l, train_l, _ = split_tta_latents(window_lat, n_ctx_lat, 0.0)
    with torch.no_grad():
        emb, mask = bundle.encode_prompt(caption)
    mark("train_chunk")
    t0 = time.time()
    noise, info = optimize_noise(
        bundle.dit, bundle.cfg.scheduler, cond_l, train_l, emb, mask,
        torch.Generator(device=device).manual_seed(args.seed + idx),
        num_opt_steps=args.steps, sampler_steps=args.dno_sampler_steps, lr=args.lr,
        interp_p=args.dno_interp_p, interp_every=args.dno_interp_every)
    train_time = time.time() - t0
    res["losses"] = info["losses"]
    res["trainable_params"] = int(noise.numel())
    res["noise_norm"] = float(noise.norm())
    return noise, train_time


if __name__ == "__main__":
    main()
