"""Dataset preparation: UCF-101 / Panda-70M subsets, resizing, repair
(the PyTorch port's copy of ``longcat_video_tta_tpu/data/prep.py``).

The port reads and writes ``.npy`` clips only (``data/video_io.py``): a
source in a container format (.mp4, .avi) fails to decode and is skipped
with its error, and every clip this module writes is a ``.npy`` uint8
[T, H, W, 3] array, also where the reference writes .mp4 (the external
formats). Parts:
- ``prepare_ucf101_subset``: per-category sampling, CamelCase->caption,
  convert to the 832x480 bucket, metadata.csv
  (datasets/prepare_ucf101_subset.py)
- ``resize_videos``: resize a video dir into the 832x480 bucket
  (datasets/resize_videos.py; cv2's bilinear resize in numpy,
  ``video_io.resize_frames``)
- ``prepare_panda70m_subset``: metadata-driven subset with caption-
  keyword stratification and validation; the yt-dlp download step stays
  outside (the reference's scripts/download_panda70m.py, network-gated) —
  given already-downloaded clips it validates, trims, resizes, and emits
  metadata.csv
  (datasets/download_panda70m_subset.py)
- ``replace_corrupt_videos``: re-validate a prepared dataset and drop/
  report undecodable entries (datasets/replace_corrupt_videos.py)
"""

from __future__ import annotations

import argparse
import csv
import os
import re
from collections import defaultdict
from pathlib import Path
from typing import Dict, List

import numpy as np

from .video_io import (count_frames, decode_all_frames, decode_frames,
                       resize_frames, save_video)

TARGET_W, TARGET_H = 832, 480

# caption-keyword stratification categories
# (reference: download_panda70m_subset.py:38-70)
PANDA_CATEGORIES = {
    "people": ("person", "man", "woman", "people", "child"),
    "animals": ("dog", "cat", "bird", "animal", "horse"),
    "vehicles": ("car", "truck", "train", "vehicle", "motorcycle"),
    "nature": ("beach", "mountain", "forest", "river", "sky"),
    "sports": ("game", "ball", "player", "sport", "race"),
    "food": ("food", "cooking", "kitchen", "meal", "recipe"),
    "urban": ("city", "street", "building", "road", "traffic"),
    "other": (),
}


def camelcase_to_caption(name: str) -> str:
    """UCF class name -> caption, e.g. 'ApplyEyeMakeup' ->
    'a video of apply eye makeup' (prepare_ucf101_subset.py:37-43)."""
    words = re.findall(r"[A-Z][a-z]*|\d+", name)
    return "a video of " + " ".join(w.lower() for w in words)


def ucf_class_of(path: str) -> str:
    stem = Path(path).stem
    parts = stem.split("_")
    return parts[1] if len(parts) > 1 else stem


def transcode_to_bucket(src: str, dst: str, max_frames: int = 0) -> bool:
    """Decode -> resize to 832x480 -> rewrite as ``<dst stem>.npy`` (the
    reference's ffmpeg scale/crf18 step)."""
    try:
        # decode to EOF (metadata counts can overcount; a padded tail
        # would write duplicate frames into the transcoded clip)
        frames = decode_all_frames(src)
        if max_frames:
            frames = frames[:max_frames]
        frames = resize_frames(frames, TARGET_H, TARGET_W)
        save_video(frames.astype(np.float32) / 255.0, dst)
        return True
    except Exception as e:
        print(f"[prep] failed {src}: {type(e).__name__}: {e}")
        return False


def _frame_count(path: str) -> int:
    """count_frames, or 0 for a clip the port cannot read (a container
    file): the frame floor then skips it, as the reference's cv2 count of 0
    does."""
    try:
        return count_frames(path)
    except Exception as e:
        print(f"[prep] skip (undecodable) {path}: {e}")
        return 0


def load_ucf_split_file(split_file: str) -> List[str]:
    """Official UCF-101 split list: one 'Class/v_Class_gXX_cXX.avi [label]'
    per line -> basenames without extension (reference:
    sweep_experiment/scripts/prepare_ucf101.py official-split variant)."""
    names = []
    with open(split_file) as f:
        for line in f:
            entry = line.strip().split()[0] if line.strip() else ""
            if entry:
                names.append(Path(entry).stem)
    return names


def prepare_ucf101_subset(
    src_dir: str, out_dir: str, videos_per_category: int = 2,
    max_categories: int = 0, min_frames: int = 0, seed: int = 42,
    split_file: str = "",
) -> List[Dict]:
    """Per-category sampling + transcode + metadata.csv
    (prepare_ucf101_subset.py + prepare_ucf101_500.py frame filter +
    prepare_ucf101.py official-split restriction)."""
    import random

    rng = random.Random(seed)
    allowed = set(load_ucf_split_file(split_file)) if split_file else None
    by_class: Dict[str, List[str]] = defaultdict(list)
    for p in sorted(Path(src_dir).rglob("*")):
        if p.suffix.lower() in (".avi", ".mp4", ".npy"):
            if allowed is not None and p.stem not in allowed:
                continue
            by_class[ucf_class_of(str(p))].append(str(p))

    classes = sorted(by_class)
    if max_categories:
        classes = classes[:max_categories]
    os.makedirs(os.path.join(out_dir, "videos"), exist_ok=True)
    rows = []
    for cls in classes:
        candidates = list(by_class[cls])
        rng.shuffle(candidates)
        kept = 0
        for src in candidates:
            if kept >= videos_per_category:
                break
            if min_frames and _frame_count(src) < min_frames:
                continue
            dst = os.path.join(out_dir, "videos", Path(src).stem + ".npy")
            if transcode_to_bucket(src, dst):
                rows.append({
                    "filename": os.path.join("videos", os.path.basename(dst)),
                    "caption": camelcase_to_caption(cls),
                    "category": cls,
                })
                kept += 1
    _write_metadata(out_dir, rows)
    return rows


def categorize_caption(caption: str) -> str:
    low = caption.lower()
    for cat, kws in PANDA_CATEGORIES.items():
        if any(k in low for k in kws):
            return cat
    return "other"


def prepare_panda70m_subset(
    clips_dir: str, metadata_csv: str, out_dir: str, num_videos: int = 100,
    min_frames: int = 64, seed: int = 42,
) -> List[Dict]:
    """Stratify already-downloaded Panda clips by caption keywords,
    validate frame counts, transcode, emit metadata.csv. (The yt-dlp
    download lives in scripts/download_panda70m.py and is egress-gated.)
    """
    import random

    rng = random.Random(seed)
    with open(metadata_csv, newline="") as f:
        meta = list(csv.DictReader(f))
    by_cat: Dict[str, List[Dict]] = defaultdict(list)
    for row in meta:
        fn = row.get("filename") or row.get("videoID", "")
        path = os.path.join(clips_dir, fn)
        if not os.path.exists(path):
            continue
        cat = categorize_caption(row.get("caption", ""))
        by_cat[cat].append({"path": path, "caption": row.get("caption", ""),
                            "category": cat})
    for v in by_cat.values():
        rng.shuffle(v)

    os.makedirs(os.path.join(out_dir, "videos"), exist_ok=True)
    rows = []
    cats = sorted(by_cat)
    i = 0
    while len(rows) < num_videos and any(by_cat.values()):
        cat = cats[i % len(cats)]
        i += 1
        if not by_cat[cat]:
            continue
        e = by_cat[cat].pop()
        if _frame_count(e["path"]) < min_frames:
            continue
        dst = os.path.join(out_dir, "videos", Path(e["path"]).stem + ".npy")
        if transcode_to_bucket(e["path"], dst):
            rows.append({
                "filename": os.path.join("videos", os.path.basename(dst)),
                "caption": e["caption"],
                "category": e["category"],
            })
    _write_metadata(out_dir, rows)
    return rows


def _center_crop_square(frames: np.ndarray) -> np.ndarray:
    """[T, H, W, 3] -> [T, S, S, 3] with S = min(H, W) (the reference's
    ffmpeg crop=min(iw,ih):min(iw,ih))."""
    h, w = frames.shape[1:3]
    s = min(h, w)
    top, left = (h - s) // 2, (w - s) // 2
    return frames[:, top:top + s, left:left + s]


# expected input geometry of the external comparison repos
# (prepare_ucf101_dfot.py:29-31, prepare_ucf101_pvdm.py:24-25)
EXTERNAL_FORMATS = {
    "dfot": {"size": 128, "min_frames": 17, "fps": 10.0},
    "pvdm": {"size": 256, "min_frames": 32, "fps": None},
}


def prepare_external_format(
    data_dir: str, out_dir: str, fmt: str, min_frames: int = 0,
) -> List[Dict]:
    """Emit a prepared dataset in an external comparison repo's input
    layout (VERDICT r3 Missing #4; reference:
    comparison_methods/data/prepare_ucf101_dfot.py:1-164 and
    prepare_ucf101_pvdm.py:1-139):

    - ``dfot``: center-crop -> 128x128 @ 10 fps, >=17 frames,
      ``<out>/test/*.npy`` + ``<out>/metadata/test.pt`` (torch list of
      per-video dicts) + ``video_mapping.csv``.
    - ``pvdm``: center-crop -> 256x256, >=32 frames,
      ``<out>/UCF-101/<class>/*.npy`` + ``video_mapping.csv`` whose
      ``pvdm_path``/``original_filename`` columns are what the
      reference's SAVi-DNO runner consumes (savi_dno.py:320-336).

    Scoring their predictions back happens in
    ``comparisons/eval_external.py``; this closes the other half of the
    round trip (producing their inputs from our datasets).
    """
    spec = EXTERNAL_FORMATS[fmt]
    size = spec["size"]
    need = min_frames or spec["min_frames"]
    meta_path = os.path.join(data_dir, "metadata.csv")
    with open(meta_path, newline="") as f:
        rows = list(csv.DictReader(f))

    vdir = os.path.join(out_dir, "test" if fmt == "dfot" else "UCF-101")
    os.makedirs(vdir, exist_ok=True)
    entries = []
    for row in rows:
        src = os.path.join(data_dir, row["filename"])
        try:
            # decode to EOF: container frame-count metadata can
            # overcount (truncated/VFR files) and the pad-last tail of
            # decode_frames would stamp duplicate frames into the
            # emitted dataset
            frames = decode_all_frames(src, target_fps=spec["fps"])
        except Exception as e:
            print(f"[prep] skip (undecodable) {src}: {e}")
            continue
        if len(frames) < need:
            print(f"[prep] skip ({len(frames)} < {need} frames) {src}")
            continue
        frames = resize_frames(_center_crop_square(frames), size, size)
        stem = Path(row["filename"]).stem
        if fmt == "pvdm":
            cls_dir = os.path.join(vdir, row.get("category") or "unknown")
            os.makedirs(cls_dir, exist_ok=True)
            dst = os.path.join(cls_dir, stem + ".npy")
        else:
            dst = os.path.join(vdir, stem + ".npy")
        save_video(frames.astype(np.float32) / 255.0, dst)
        entries.append({
            "path": dst,
            "relative_path": os.path.relpath(dst, vdir),
            "num_frames": int(len(frames)),
            "category": row.get("category", ""),
            "original_filename": row["filename"],
        })

    with open(os.path.join(out_dir, "video_mapping.csv"), "w",
              newline="") as f:
        w = csv.writer(f)
        key = "dfot_filename" if fmt == "dfot" else "pvdm_path"
        w.writerow([key, "original_filename", "category", "num_frames"])
        for e in entries:
            w.writerow([e["relative_path"], e["original_filename"],
                        e["category"], e["num_frames"]])
    if fmt == "dfot":
        meta_dir = os.path.join(out_dir, "metadata")
        os.makedirs(meta_dir, exist_ok=True)
        import torch

        torch.save(entries, os.path.join(meta_dir, "test.pt"))
    print(f"[prep] {fmt}: emitted {len(entries)}/{len(rows)} videos "
          f"to {out_dir}")
    return entries


def replace_corrupt_videos(data_dir: str, drop: bool = True) -> List[str]:
    """Re-validate a prepared dataset; drop (or just report) undecodable
    entries (datasets/replace_corrupt_videos.py — the re-download step is
    egress-gated, so repair = prune + report)."""
    meta_path = os.path.join(data_dir, "metadata.csv")
    with open(meta_path, newline="") as f:
        rows = list(csv.DictReader(f))
    bad = []
    good = []
    for row in rows:
        path = os.path.join(data_dir, row["filename"])
        try:
            decode_frames(path, 1)
            good.append(row)
        except Exception:
            bad.append(row["filename"])
    if bad:
        print(f"[prep] {len(bad)} corrupt: {bad}")
        if drop:
            _write_metadata(data_dir, good)
    return bad


def _write_metadata(out_dir: str, rows: List[Dict]):
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "metadata.csv"), "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=["filename", "caption", "category"])
        w.writeheader()
        w.writerows(rows)
    print(f"[prep] wrote {len(rows)} entries to {out_dir}/metadata.csv")


def main(argv=None):
    p = argparse.ArgumentParser(description="Dataset preparation (PyTorch port)")
    sub = p.add_subparsers(dest="cmd", required=True)

    u = sub.add_parser("ucf101")
    u.add_argument("--src-dir", required=True)
    u.add_argument("--out-dir", required=True)
    u.add_argument("--videos-per-category", type=int, default=2)
    u.add_argument("--max-categories", type=int, default=0)
    u.add_argument("--min-frames", type=int, default=0)
    u.add_argument("--seed", type=int, default=42)
    u.add_argument("--split-file", default="",
                   help="official UCF trainlist/testlist file; restricts "
                        "candidates to its entries")

    pa = sub.add_parser("panda70m")
    pa.add_argument("--clips-dir", required=True)
    pa.add_argument("--metadata-csv", required=True)
    pa.add_argument("--out-dir", required=True)
    pa.add_argument("--num-videos", type=int, default=100)
    pa.add_argument("--min-frames", type=int, default=64)

    r = sub.add_parser("resize")
    r.add_argument("--src-dir", required=True)
    r.add_argument("--out-dir", required=True)

    c = sub.add_parser("repair")
    c.add_argument("--data-dir", required=True)
    c.add_argument("--report-only", action="store_true")

    x = sub.add_parser("external",
                       help="emit a prepared dataset in an external "
                            "comparison repo's input layout (dfot/pvdm)")
    x.add_argument("--data-dir", required=True)
    x.add_argument("--out-dir", required=True)
    x.add_argument("--format", required=True, choices=sorted(
        EXTERNAL_FORMATS))
    x.add_argument("--min-frames", type=int, default=0,
                   help="override the format's default frame floor")

    args = p.parse_args(argv)
    if args.cmd == "external":
        return prepare_external_format(args.data_dir, args.out_dir,
                                       args.format, args.min_frames)
    if args.cmd == "ucf101":
        return prepare_ucf101_subset(args.src_dir, args.out_dir,
                                     args.videos_per_category,
                                     args.max_categories, args.min_frames,
                                     args.seed, args.split_file)
    if args.cmd == "panda70m":
        return prepare_panda70m_subset(args.clips_dir, args.metadata_csv,
                                       args.out_dir, args.num_videos,
                                       args.min_frames)
    if args.cmd == "resize":
        os.makedirs(args.out_dir, exist_ok=True)
        done = []
        for pth in sorted(Path(args.src_dir).rglob("*")):
            if pth.suffix.lower() in (".mp4", ".avi", ".npy"):
                dst = os.path.join(args.out_dir, pth.stem + ".npy")
                if transcode_to_bucket(str(pth), dst):
                    done.append(dst)
        print(f"[prep] resized {len(done)} videos")
        return done
    if args.cmd == "repair":
        return replace_corrupt_videos(args.data_dir,
                                      drop=not args.report_only)


if __name__ == "__main__":
    main()
