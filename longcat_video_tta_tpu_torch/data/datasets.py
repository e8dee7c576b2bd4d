"""Dataset listing and caption-quality guard (counterpart of
``longcat_video_tta_tpu/data/datasets.py``): ``metadata.csv``
(filename, caption, category) or a recursive glob of clips, caption
normalization, stratified sampling, and the fail/warn/off caption guard.
"""

from __future__ import annotations

import ast
import csv
import os
import random
from collections import Counter
from pathlib import Path
from typing import Any, Dict, List, Optional

from ..config import CaptionGuardConfig

VIDEO_EXTS = (".mp4", ".avi", ".npy")

GENERIC_CAPTIONS = {
    "", "video", "a video", "a video of", "no caption", "none", "null",
    "a person", "people", "scene", "a scene",
}


def normalize_caption(raw: Any) -> str:
    """Caption cleanup incl. python-list-string parsing."""
    if raw is None:
        return ""
    s = str(raw).strip()
    if s.startswith("[") and s.endswith("]"):
        try:
            parsed = ast.literal_eval(s)
            if isinstance(parsed, (list, tuple)) and parsed:
                s = str(parsed[0]).strip()
        except (ValueError, SyntaxError):
            pass
    return " ".join(s.split())


def _category_from_name(path: str) -> str:
    stem = Path(path).stem
    return stem.split("_")[1] if "_" in stem else ""


def load_video_list(data_dir: str, max_videos: int = 100, seed: int = 42,
                    stratify: bool = True) -> List[Dict[str, str]]:
    """Read metadata.csv or glob clips. Returns
    [{"path", "caption", "category"}...], deterministically sampled;
    per-category stratification turns itself off when categories are
    mostly singletons."""
    data_dir = str(data_dir)
    meta_path = os.path.join(data_dir, "metadata.csv")
    entries: List[Dict[str, str]] = []
    if os.path.exists(meta_path):
        with open(meta_path, newline="") as f:
            for row in csv.DictReader(f):
                fn = row.get("filename") or row.get("path") or ""
                path = fn if os.path.isabs(fn) else os.path.join(data_dir, fn)
                if not os.path.exists(path):
                    alt = os.path.join(data_dir, "videos", fn)
                    path = alt if os.path.exists(alt) else path
                entries.append({
                    "path": path,
                    "caption": normalize_caption(row.get("caption", "")),
                    "category": str(row.get("category", "")),
                })
    else:
        for p in sorted(Path(data_dir).rglob("*")):
            if p.suffix.lower() in VIDEO_EXTS:
                entries.append({"path": str(p), "caption": "",
                                "category": _category_from_name(str(p))})
    if not entries:
        raise ValueError(f"No videos found under {data_dir}")

    rng = random.Random(seed)
    if len(entries) <= max_videos:
        return entries
    by_cat: Dict[str, List[Dict]] = {}
    for e in entries:
        by_cat.setdefault(e["category"], []).append(e)
    singleton_ratio = sum(1 for v in by_cat.values() if len(v) <= 1) / len(by_cat)
    if stratify and len(by_cat) > 1 and singleton_ratio < 0.5:
        for v in by_cat.values():
            rng.shuffle(v)
        cats = sorted(by_cat)
        out: List[Dict] = []
        i = 0
        while len(out) < max_videos:
            c = cats[i % len(cats)]
            if by_cat[c]:
                out.append(by_cat[c].pop())
            i += 1
            if all(not v for v in by_cat.values()):
                break
        return out[:max_videos]
    return rng.sample(entries, max_videos)


def apply_fixed_caption(entries: List[Dict], fixed_caption: Optional[str]):
    """Global caption override for ablations."""
    if fixed_caption is None:
        return entries
    for e in entries:
        e["caption"] = normalize_caption(fixed_caption)
    return entries


def analyze_caption_quality(entries: List[Dict], topk: int = 5) -> Dict[str, Any]:
    captions = [e["caption"] for e in entries]
    n = max(len(captions), 1)
    nonempty = [c for c in captions if c]
    counts = Counter(nonempty)
    top = counts.most_common(topk)
    top1, top1_count = (top[0] if top else ("", 0))
    return {
        "num_videos": len(captions),
        "nonempty_ratio": len(nonempty) / n,
        "unique_ratio": (len(counts) / len(nonempty)) if nonempty else 0.0,
        "top1_caption": top1,
        "top1_ratio": top1_count / n,
        "top1_is_generic": top1.lower() in GENERIC_CAPTIONS,
        "topk": top,
    }


def validate_caption_quality(entries: List[Dict],
                             cfg: CaptionGuardConfig) -> Dict[str, Any]:
    """Fail/warn/off gate over the caption stats."""
    stats = analyze_caption_quality(entries, cfg.topk)
    if cfg.mode == "off":
        return stats
    issues = []
    if stats["nonempty_ratio"] < cfg.min_nonempty_ratio:
        issues.append(f"nonempty ratio {stats['nonempty_ratio']:.2f} < "
                      f"{cfg.min_nonempty_ratio}")
    if stats["unique_ratio"] < cfg.min_unique_ratio:
        issues.append(f"unique ratio {stats['unique_ratio']:.2f} < "
                      f"{cfg.min_unique_ratio}")
    if stats["top1_ratio"] > cfg.max_top1_ratio:
        issues.append(f"top-1 ratio {stats['top1_ratio']:.2f} > "
                      f"{cfg.max_top1_ratio}")
    if stats["top1_is_generic"] and stats["top1_ratio"] > cfg.max_generic_top1_ratio:
        issues.append(f"generic top-1 '{stats['top1_caption']}' at "
                      f"{stats['top1_ratio']:.2f} > {cfg.max_generic_top1_ratio}")
    print(f"[caption_guard] top-{cfg.topk}: {stats['topk']}")
    if issues:
        msg = "[caption_guard] " + " | ".join(issues)
        if cfg.mode == "fail":
            raise RuntimeError(msg)
        print(f"WARNING: {msg}")
    return stats
