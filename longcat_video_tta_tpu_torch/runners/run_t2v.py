"""Text-to-video runner of the PyTorch port (counterpart of
``longcat_video_tta_tpu/runners/run_t2v.py``): ``generate_t2v`` from one
``--prompt`` or from the captions of a ``--data-dir``, with the long
negative prompt, each clip saved as ``t2v_XXX.npy`` and ``summary.json``
with the reference's keys. Weights come from ``--checkpoint-dir`` or are
drawn from ``--seed`` (``run_tta.load_bundle``).

CLI:
  python -m longcat_video_tta_tpu_torch.runners.run_t2v \\
      --prompt "a red ball rolling" --preset longcat_tiny --num-frames 5 \\
      --height 16 --width 32 --num-inference-steps 2 --output-dir /tmp/t2v \\
      --device cpu
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import List, Optional

import numpy as np

DEFAULT_NEGATIVE_PROMPT = (
    "worst quality, low quality, blurry, distorted, deformed, disfigured, "
    "bad anatomy, watermark, text, logo, static image, still frame, "
    "flickering, jittery motion, oversaturated, underexposed"
)


def build_arg_parser() -> argparse.ArgumentParser:
    from ..config import ALL_PRESET_NAMES

    p = argparse.ArgumentParser(description="LongCat T2V (PyTorch port)")
    p.add_argument("--output-dir", required=True)
    p.add_argument("--data-dir", default=None,
                   help="Dataset dir: prompts come from metadata.csv captions")
    p.add_argument("--prompt", default=None, help="Single prompt mode")
    p.add_argument("--preset", default="longcat_13b", choices=sorted(ALL_PRESET_NAMES))
    p.add_argument("--checkpoint-dir", default=None)
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cpu' runs the plain PyTorch path")
    p.add_argument("--max-videos", type=int, default=10)
    p.add_argument("--num-frames", type=int, default=93)
    p.add_argument("--height", type=int, default=480)
    p.add_argument("--width", type=int, default=832)
    p.add_argument("--num-inference-steps", type=int, default=50)
    p.add_argument("--guidance-scale", type=float, default=4.0)
    p.add_argument("--negative-prompt", default=DEFAULT_NEGATIVE_PROMPT)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--pab-every", type=int, default=0,
                   help="Pyramid Attention Broadcast on the t2v denoise loop "
                        "(0 = off; see run_tta --pab-every)")
    p.add_argument("--cfg-reuse-every", type=int, default=0,
                   help="CFG guidance-delta reuse on the t2v denoise loop "
                        "(0 = off; see run_tta --cfg-reuse-every)")
    return p


def main(argv: Optional[List[str]] = None):
    args = build_arg_parser().parse_args(argv)

    from ..config import CFGReuseConfig, PABConfig
    from ..data.datasets import load_video_list
    from ..data.video_io import save_video
    from ..pipeline.pipeline import generate_t2v
    from .run_tta import load_bundle

    os.makedirs(args.output_dir, exist_ok=True)
    if args.prompt:
        prompts = [args.prompt]
    else:
        if not args.data_dir:
            raise SystemExit("--prompt or --data-dir required")
        entries = load_video_list(args.data_dir, max_videos=args.max_videos,
                                  seed=args.seed)
        prompts = [e["caption"] for e in entries]

    bundle = load_bundle(args)
    results = []
    for i, prompt in enumerate(prompts):
        t0 = time.time()
        frames = generate_t2v(
            bundle, prompt,
            num_frames=args.num_frames, height=args.height, width=args.width,
            num_inference_steps=args.num_inference_steps,
            guidance_scale=args.guidance_scale, seed=args.seed + i,
            negative_prompt=args.negative_prompt,
            pab_cfg=None if args.pab_every <= 0 else PABConfig(every=args.pab_every),
            cfgr_cfg=(None if args.cfg_reuse_every <= 0 else
                      CFGReuseConfig(every=args.cfg_reuse_every)),
        )
        path = save_video(frames, os.path.join(args.output_dir, f"t2v_{i:03d}.mp4"))
        results.append({"prompt": prompt, "video_path": path,
                        "gen_time": time.time() - t0,
                        "num_frames": int(frames.shape[0])})
        print(f"[{i + 1}/{len(prompts)}] {results[-1]['gen_time']:.1f}s -> {path}")

    with open(os.path.join(args.output_dir, "summary.json"), "w") as f:
        json.dump({
            "results": results,
            "avg_gen_time": float(np.mean([r["gen_time"] for r in results])),
        }, f, indent=2)
    return results


if __name__ == "__main__":
    main()
