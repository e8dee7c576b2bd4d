"""Post-hoc re-evaluation of saved TTA adapters (counterpart of
``longcat_video_tta_tpu/runners/run_eval_adapters.py``).

Given a completed run directory (summary.json, and the ``.pt`` adapter
files of ``run_tta --save-adapters``), regenerate each video's
continuation in ``baseline`` (base weights) or ``adapted`` mode,
optionally at other generation settings (steps, guidance, horizon,
decode levers), and write fresh PSNR/SSIM/LPIPS and
``eval_summary.json`` with the reference's keys. The scheme is rebuilt
from the run's summary config; weights come from ``--checkpoint-dir``
(or the run's), else are drawn from the run's seed.

CLI:
  python -m longcat_video_tta_tpu_torch.runners.run_eval_adapters \\
      --results-dir results/delta_a/R1 --output-dir results/delta_a/R1/eval \\
      --mode adapted [--bsa-keep-ratio 0.5] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Any, Dict, List, Optional

import numpy as np


def build_arg_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="re-evaluate saved TTA adapters")
    p.add_argument("--results-dir", required=True,
                   help="completed run dir (summary.json; adapters/ when mode=adapted)")
    p.add_argument("--output-dir", required=True)
    p.add_argument("--mode", choices=["baseline", "adapted"], default="adapted")
    p.add_argument("--checkpoint-dir", default=None)
    p.add_argument("--preset", default=None, help="defaults to the run's preset")
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cpu' runs the plain PyTorch path")
    p.add_argument("--max-videos", type=int, default=0,
                   help="0 = all scored videos in the run")
    # generation overrides (None = the run's settings)
    p.add_argument("--num-frames", type=int, default=None)
    p.add_argument("--num-inference-steps", type=int, default=None)
    p.add_argument("--guidance-scale", type=float, default=None)
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--bsa-keep-ratio", type=float, default=0.0)
    p.add_argument("--quantize-decode", choices=["none", "int8", "int8qk"],
                   default="none")
    p.add_argument("--bucket-gen", action="store_true")
    p.add_argument("--no-save-videos", action="store_true")
    p.add_argument("--lpips-model-path", default=None,
                   help="state dict of lpips.LPIPS(net='alex') for the port's LPIPS "
                        "tower (else lpips=NaN)")
    return p


def adapter_config_from_run(summary: Dict[str, Any]):
    """The run's ``AdapterConfig``, from its summary config (the
    reference's defaults for a key the config lacks)."""
    from ..config import AdapterConfig

    rcfg = summary["config"]
    return AdapterConfig(
        method=summary.get("method", rcfg.get("method", "delta_a")),
        lora_rank=rcfg.get("lora_rank", 4),
        lora_alpha=rcfg.get("lora_alpha", 1.0),
        lora_target_modules=tuple(str(rcfg.get("lora_target_modules", "qkv,proj")).split(",")),
        lora_target_ffn=rcfg.get("lora_target_ffn", False),
        num_groups=rcfg.get("num_groups", 1),
        delta_target=rcfg.get("delta_target", "timestep"),
        delta_dim=rcfg.get("delta_dim"),
        target_blocks=rcfg.get("target_blocks", "all"),
        norm_target=rcfg.get("norm_target", "qk_norm"),
        film_mode=rcfg.get("film_mode", "full"),
        also_tune_delta=rcfg.get("also_tune_delta", False),
        lora_builtin=rcfg.get("use_builtin_lora", False),
    )


def main(argv: Optional[List[str]] = None) -> Dict[str, Any]:
    args = build_arg_parser().parse_args(argv)

    from ..config import BSAConfig, get_model_config
    from ..data.video_io import load_gt_frames, load_video_frames, save_video
    from ..eval.metrics import evaluate_generation_metrics
    from ..pipeline.pipeline import ModelBundle, generate_vc
    from ..tta.adapters import build_scheme
    from ..utils.checkpoint import load_adapter_state, save_results
    from ..utils.device import resolve_device

    device = resolve_device(args.device)
    lpips_fn = None
    if args.lpips_model_path:
        from ..eval.lpips import load_lpips_params, make_lpips_feature_fn

        lpips_fn = make_lpips_feature_fn(load_lpips_params(args.lpips_model_path, device))

    with open(os.path.join(args.results_dir, "summary.json")) as f:
        summary = json.load(f)
    rcfg = summary["config"]

    rows = [r for r in summary.get("results", []) if r.get("success")]
    if args.mode == "adapted":
        rows = [r for r in rows if r.get("adapter_path")]
        if not rows:
            raise SystemExit("no per-video adapter artifacts in the run — rerun with "
                             "run_tta --save-adapters")
    if args.max_videos:
        rows = rows[: args.max_videos]

    preset = args.preset or rcfg.get("preset", "longcat_tiny")
    cfg = get_model_config(preset)
    ckpt_dir = args.checkpoint_dir or rcfg.get("checkpoint_dir")
    if ckpt_dir:
        bundle = ModelBundle.from_checkpoint_dir(cfg, ckpt_dir, device)
    else:
        print("[eval] random-init weights (matching the run's seed)")
        bundle = ModelBundle.init_random(cfg, seed=rcfg.get("seed", 42), device=device)
    scheme = build_scheme(cfg.dit, adapter_config_from_run(summary))

    def g(key, default=None):
        ov = getattr(args, key, None)
        return ov if ov is not None else rcfg.get(key, default)

    num_frames = g("num_frames", 5)
    steps = g("num_inference_steps", 50)
    guidance = g("guidance_scale", 4.0)
    seed = g("seed", 42)
    height = rcfg.get("height", 480)
    width = rcfg.get("width", 832)
    num_cond = rcfg.get("num_cond_frames", 14)
    gen_start = rcfg.get("gen_start_frame", 32)
    bsa_cfg = None if args.bsa_keep_ratio <= 0 else BSAConfig(keep_ratio=args.bsa_keep_ratio)

    os.makedirs(args.output_dir, exist_ok=True)
    out_rows: List[Dict[str, Any]] = []
    for i, r in enumerate(rows):
        path = r.get("path") or r["video"]
        rec: Dict[str, Any] = {"video": r["video"], "mode": args.mode}
        try:
            adapted = adapters = None
            if args.mode == "adapted":
                tp = load_adapter_state(r["adapter_path"], device)
                # adapter-only schemes return the base DiT and carry the
                # trained tensors in ``adapters``; weight-training schemes
                # (norm_tune, full, builtin LoRA) return an adapted DiT
                adapted, adapters = scheme.to_forward(tp, bundle.dit)
                if adapted is bundle.dit:
                    adapted = None
            cond_px = load_video_frames(path, num_cond, height, width,
                                        start_frame=gen_start - num_cond)
            t0 = time.time()
            gen = generate_vc(bundle, cond_px, r.get("caption", ""),
                              num_frames=num_frames, num_inference_steps=steps,
                              guidance_scale=guidance, seed=seed + i,
                              adapters=adapters, dit=adapted, bsa_cfg=bsa_cfg,
                              quantize_decode=args.quantize_decode,
                              bucket_gen=args.bucket_gen)
            rec["gen_time"] = time.time() - t0
            del adapted, adapters
            gt = load_gt_frames(path, len(gen), height, width, gen_start)
            rec.update(evaluate_generation_metrics(gen, gt, device=device,
                                                   lpips_feature_fn=lpips_fn))
            if not args.no_save_videos:
                rec["video_path"] = save_video(
                    gen, os.path.join(args.output_dir, "videos", f"{i:04d}_{r['video']}.mp4"))
            rec["success"] = True
        except Exception as e:  # per-video fault tolerance, as the reference
            rec["success"] = False
            rec["error"] = f"{type(e).__name__}: {e}"
        out_rows.append(rec)
        msg = (f"psnr={rec.get('psnr', float('nan')):.3f}" if rec["success"]
               else f"FAILED: {rec['error'][:80]}")
        print(f"[{i + 1}/{len(rows)}] {r['video']} ({args.mode}) {msg}")

    ok = [r for r in out_rows if r["success"]]
    eval_summary = {
        "mode": args.mode,
        "source_run": args.results_dir,
        "method": summary.get("method"),
        "generation": {"num_frames": num_frames, "steps": steps,
                       "guidance": guidance, "seed": seed,
                       "quantize_decode": args.quantize_decode,
                       "bsa_keep_ratio": args.bsa_keep_ratio},
        "num_videos": len(out_rows),
        "num_success": len(ok),
        "metrics": {
            m: float(np.mean([r[m] for r in ok if np.isfinite(r.get(m, np.nan))]))
            for m in ("psnr", "ssim", "lpips") if ok
        },
        "results": out_rows,
    }
    save_results(os.path.join(args.output_dir, "eval_summary.json"), eval_summary)
    print(f"eval summary: {os.path.join(args.output_dir, 'eval_summary.json')}")
    return eval_summary


if __name__ == "__main__":
    main()
