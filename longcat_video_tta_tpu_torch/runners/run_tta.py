"""TTA runner of the PyTorch port (counterpart of
``longcat_video_tta_tpu/runners/run_tta.py``). Only the no-TTA baseline
(``--method none``) is ported so far: per video, load the conditioning
clip, run ``generate_vc`` (VAE encode, prompt encode, cond-cache
precompute, CFG Euler loop, VAE decode), score PSNR/SSIM against the
ground truth, write ``checkpoint.json``; at the end write
``summary.json`` with the reference runner's keys.

CLI:
  python -m longcat_video_tta_tpu_torch.runners.run_tta \\
      --method none --preset longcat_tiny --synthetic 2 \\
      --output-dir /tmp/out --device cpu

The default device is ``cuda``; asking for it on a machine without a GPU
raises.
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

METHODS = ["none", "full", "lora", "delta_a", "delta_b", "delta_c",
           "norm_tune", "film", "dno"]

# the per-video record of a disabled CLIP gate (reference defaults)
CLIP_GATE_OFF = {
    "clip_gate_enabled": False, "clip_gate_backend": "clip",
    "clip_gate_threshold": 0.2, "clip_gate_log_only": False,
    "skip_tta": False, "clip_gate_score": None, "clip_gate_error": None,
}


def build_arg_parser() -> argparse.ArgumentParser:
    from ..config import MODEL_PRESETS

    p = argparse.ArgumentParser(description="LongCat video TTA (PyTorch port)")
    p.add_argument("--method", default="none", choices=METHODS)
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
    p.add_argument("--num-cond-frames", type=int, default=14)
    p.add_argument("--num-frames", type=int, default=28)
    p.add_argument("--gen-start-frame", type=int, default=32)
    p.add_argument("--num-inference-steps", type=int, default=50)
    p.add_argument("--guidance-scale", type=float, default=4.0)
    p.add_argument("--no-kv-cache", action="store_true")
    p.add_argument("--skip-generation", action="store_true")
    p.add_argument("--no-save-videos", action="store_true")
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


def round_frames_4k1_down(num_frames: int) -> int:
    """Largest 4k+1 <= num_frames (>= 1): the causal VAE encodes 4k+1
    windows exactly, so the cond window is trimmed at its oldest end."""
    return ((max(int(num_frames), 1) - 1) // 4) * 4 + 1


def load_bundle(args):
    from ..config import get_model_config
    from ..pipeline.pipeline import ModelBundle

    print(f"[runner] random-init weights (preset {args.preset}) on {args.device}")
    return ModelBundle.init_random(get_model_config(args.preset), seed=args.seed,
                                   device=args.device)


def _summary(args, results: List[Dict], caption_stats, t_start) -> Dict[str, Any]:
    """summary.json with the reference runner's keys (the clip gate,
    fast-decode check and online FVD/FID are not ported; their entries
    say so the way the reference does when they are off)."""
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
        "fast_decode_verify": None,
        "caption_stats": caption_stats,
        "online_eval": {"fvd": None, "fid": None, "num_videos": 0},
        "wall_time": time.time() - t_start,
        "results": results,
    }


def main(argv: Optional[List[str]] = None) -> Dict[str, Any]:
    args = build_arg_parser().parse_args(argv)
    if args.method != "none":
        raise NotImplementedError(
            f"--method {args.method} is not yet ported to the PyTorch runner "
            "(only 'none' is)")

    from ..config import CaptionGuardConfig
    from ..data.datasets import (
        apply_fixed_caption,
        load_video_list,
        validate_caption_quality,
    )
    from ..data.video_io import annotate_borders, load_gt_frames, \
        load_video_frames, save_video
    from ..eval.metrics import evaluate_generation_metrics
    from ..pipeline.pipeline import generate_vc
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

    ncond = round_frames_4k1_down(args.num_cond_frames)
    if ncond != args.num_cond_frames:
        print(f"[WARN] num_cond_frames ({args.num_cond_frames}) is not 4k+1; "
              f"using {ncond} (oldest frames dropped so the window stays "
              "flush with the anchor).")

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

    ckpt_path = os.path.join(args.output_dir, "checkpoint.json")
    ckpt = load_checkpoint(ckpt_path)
    start_idx = ckpt["next_idx"] if ckpt else 0
    results: List[Dict] = ckpt["results"] if ckpt else []
    save_config(os.path.join(args.output_dir, "config.json"), vars(args))
    videos_dir = os.path.join(args.output_dir, "videos")

    for idx in range(start_idx, len(videos)):
        entry = videos[idx]
        vid_id = os.path.basename(entry["path"])
        print(f"\n[{idx + 1}/{len(videos)}] {vid_id}")
        t_vid = time.time()
        res: Dict[str, Any] = {"video": vid_id, "path": entry["path"],
                               "caption": entry["caption"], "index": idx,
                               "success": True}
        try:
            # the conditioning window, encoded on its own as the reference
            # runner does for every method (its TTA window defaults to the
            # conditioning frames); generate_vc re-encodes the clip itself
            t0 = time.time()
            cond_px = load_video_frames(
                entry["path"], ncond, args.height, args.width,
                start_frame=args.gen_start_frame - ncond,
                target_fps=args.load_fps)
            with torch.inference_mode():
                bundle.encode_video(torch.from_numpy(cond_px))
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            res["encode_time"] = time.time() - t0
            # no CLIP gate in the port: the reference's disabled-gate record
            res.update(CLIP_GATE_OFF)
            res["clip_gate_eval_time"] = 0.0

            gen_time = 0.0
            if not args.skip_generation:
                t0 = time.time()
                gen = generate_vc(
                    bundle, cond_px, entry["caption"],
                    num_frames=args.num_frames,
                    num_inference_steps=args.num_inference_steps,
                    guidance_scale=args.guidance_scale,
                    seed=args.seed + idx,
                    use_kv_cache=not args.no_kv_cache)
                gen_time = time.time() - t0
                gt = load_gt_frames(entry["path"], len(gen), args.height,
                                    args.width, args.gen_start_frame,
                                    target_fps=args.load_fps)
                res.update(evaluate_generation_metrics(gen, gt, device=device))
                if not args.no_save_videos:
                    # baseline artifact: green GENERATED border
                    res["video_path"] = save_video(
                        annotate_borders(gen, (0, 200, 0)),
                        os.path.join(videos_dir, f"{idx:04d}_{vid_id}.mp4"))
            res["train_time"] = 0.0
            res["gen_time"] = gen_time
            res["es_check_time"] = 0.0
            res["total_time"] = time.time() - t_vid
            print(f"  psnr={res.get('psnr', float('nan')):.3f} "
                  f"gen={gen_time:.1f}s")
        except Exception as e:  # per-video fault tolerance, as the reference
            import traceback

            traceback.print_exc()
            res["success"] = False
            res["error"] = f"{type(e).__name__}: {e}"
        results.append(res)
        save_checkpoint(ckpt_path, idx + 1, results)

    summary = _summary(args, results, caption_stats, t_start)
    save_results(os.path.join(args.output_dir, "summary.json"), summary)
    print(f"\nDone: {summary['num_success']}/{len(results)} videos, "
          f"summary at {args.output_dir}/summary.json")
    return summary


if __name__ == "__main__":
    main()
