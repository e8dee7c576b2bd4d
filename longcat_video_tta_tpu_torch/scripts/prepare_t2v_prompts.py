"""Dump a dataset's captions as a t2v prompt list (counterpart of the
repository's ``scripts/prepare_t2v_prompts.py``), read through the
port's ``data.datasets.load_video_list``.

Usage:
    python3 -m longcat_video_tta_tpu_torch.scripts.prepare_t2v_prompts \\
        --data-dir DIR --output prompts.json [--max-prompts 100]
"""

from __future__ import annotations

import argparse
import json


def main(argv=None) -> list:
    p = argparse.ArgumentParser(description="dataset captions -> a t2v prompt list")
    p.add_argument("--data-dir", required=True)
    p.add_argument("--output", required=True)
    p.add_argument("--max-prompts", type=int, default=100)
    args = p.parse_args(argv)
    from ..data.datasets import load_video_list

    entries = load_video_list(args.data_dir, max_videos=args.max_prompts)
    prompts = [e["caption"] for e in entries if e["caption"]]
    with open(args.output, "w") as f:
        json.dump(prompts, f, indent=2)
    print(f"wrote {len(prompts)} prompts -> {args.output}")
    return prompts


if __name__ == "__main__":
    main()
