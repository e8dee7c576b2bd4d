"""Baseline post-processing tools (the PyTorch port's copy of
``longcat_video_tta_tpu/sweep/baseline_tools.py``, host only): one
module and subcommand CLI in place of the reference's five baseline
utility scripts. Clips are ``.npy`` uint8 [T, H, W, 3] arrays, read and
written through the port's ``data/video_io.py`` (the runner's saved
generations are ``<idx>_<video>.npy``):

- prune_and_summarize: keep-list pruning of saved clips + RESULTS.md
  (reference: baseline_experiment/scripts/prune_and_summarize.py:1-266)
- extract_gt_videos: anchor-layout GT clips with cond/gen border
  annotation (reference: extract_gt_videos.py:1-223)
- annotate_existing_videos: retrofit cond/gen annotation onto saved
  generations (reference: annotate_existing_videos.py:1-169)
- plot_baseline_sweep / plot_baseline_sweep_dual: metric-vs-cond/gen
  grids over cond{N}_gen{M} result dirs (reference:
  plot_baseline_sweep.py:1-180, plot_baseline_sweep_dual.py:1-218)
- plot_backbone_comparison: mean±std metric bars across backbones;
  data-driven generalization of the reference's hardcoded
  plot_v20_vs_longcat.py:1-165

Annotation uses colored borders (red conditioning / green generated,
matching run_baseline.py:195-231 semantics) via
``data.video_io.annotate_borders``.
"""

from __future__ import annotations

import argparse
import csv
import json
import os
import re
import sys
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..data.datasets import load_video_list
from ..data.video_io import (
    annotate_borders,
    decode_frames,
    resize_frames,
    save_video,
)

COND_COLOR = (200, 0, 0)
GEN_COLOR = (0, 200, 0)
METRICS = ("psnr", "ssim", "lpips")
METRIC_LABELS = {"psnr": "PSNR (dB)", "ssim": "SSIM", "lpips": "LPIPS"}


# ---------------------------------------------------------------------------
# per-video metric loading
# ---------------------------------------------------------------------------


def load_per_video_metrics(results_dir: str) -> List[Dict[str, Any]]:
    """Rows of {video, psnr, ssim, lpips, ...} from per_video_metrics.csv
    (run_baseline.py output) or summary.json results."""
    d = Path(results_dir)
    csv_path = d / "per_video_metrics.csv"
    if csv_path.exists():
        with open(csv_path, newline="") as f:
            rows = []
            for row in csv.DictReader(f):
                for m in METRICS:
                    if row.get(m) not in (None, ""):
                        row[m] = float(row[m])
                rows.append(row)
            return rows
    sp = d / "summary.json"
    if sp.exists():
        with open(sp) as f:
            summary = json.load(f)
        return [r for r in summary.get("results", []) if r.get("success")]
    raise FileNotFoundError(
        f"no per_video_metrics.csv or summary.json in {results_dir}")


def _video_key(row: Dict[str, Any]) -> str:
    v = row.get("video") or row.get("path") or ""
    return Path(str(v)).stem


# ---------------------------------------------------------------------------
# prune_and_summarize
# ---------------------------------------------------------------------------


def prune_and_summarize(
    results_dir: str,
    *,
    create_keep_list: bool = False,
    keep_list: Optional[str] = None,
    top_n: int = 10,
    bottom_n: int = 10,
    videos_subdir: str = "videos",
    dry_run: bool = False,
) -> Dict[str, Any]:
    """Sort per-video rows by PSNR; keep top-N + bottom-N (or an
    existing keep list so runs 2..K prune to the same set); delete
    non-kept clips; write keep_videos.txt + RESULTS.md. Mirrors
    prune_and_summarize.py's two modes."""
    d = Path(results_dir)
    rows = load_per_video_metrics(results_dir)
    by_psnr = sorted(
        (r for r in rows if isinstance(r.get("psnr"), float)),
        key=lambda r: r["psnr"],
    )

    if keep_list:
        keep = {ln.strip() for ln in open(keep_list) if ln.strip()}
    else:
        picked = by_psnr[-top_n:] + by_psnr[:bottom_n]
        keep = {_video_key(r) for r in picked}
        if create_keep_list:
            with open(d / "keep_videos.txt", "w") as f:
                f.write("\n".join(sorted(keep)) + "\n")

    vid_dir = d / videos_subdir
    removed: List[str] = []
    if vid_dir.is_dir():
        for clip in sorted(vid_dir.glob("*.npy")):
            # exact stem or the '<idx>_<stem>' save pattern (as
            # annotate_existing_videos matches) — raw substring
            # containment would keep 'v12' for keep-key 'v1' and
            # deletion is irreversible. The runner names saved clips
            # '<idx>_<basename-with-source-extension>.npy' while keep
            # keys are extension-stripped stems, so the source-suffix-
            # stripped form must match too ('0003_clip.npy.npy' ->
            # bare 'clip.npy' -> 'clip').
            bare = re.sub(r"^\d+_", "", clip.stem)
            if not (clip.stem in keep or bare in keep
                    or Path(bare).stem in keep):
                removed.append(clip.name)
                if not dry_run:
                    clip.unlink()

    def _stats(key: str) -> Dict[str, float]:
        vals = [r[key] for r in rows if isinstance(r.get(key), float)
                and np.isfinite(r[key])]
        if not vals:
            return {}
        a = np.asarray(vals, np.float64)
        return {"mean": float(a.mean()), "std": float(a.std()),
                "min": float(a.min()), "max": float(a.max())}

    report = {m: _stats(m) for m in METRICS}
    lines = [f"# Results — {d.name}", "",
             f"videos scored: {len(rows)}; kept clips: {len(keep)}; "
             f"pruned: {len(removed)}", "",
             "| metric | mean | std | min | max |", "|---|---|---|---|---|"]
    for m in METRICS:
        s = report[m]
        if s:
            lines.append(
                f"| {m} | {s['mean']:.4f} | {s['std']:.4f} "
                f"| {s['min']:.4f} | {s['max']:.4f} |")
    if by_psnr:
        lines += ["", "Top PSNR: " + ", ".join(
            f"{_video_key(r)} ({r['psnr']:.2f})" for r in by_psnr[-3:][::-1]),
            "Bottom PSNR: " + ", ".join(
            f"{_video_key(r)} ({r['psnr']:.2f})" for r in by_psnr[:3])]
    if not dry_run:
        (d / "RESULTS.md").write_text("\n".join(lines) + "\n")
    return {"kept": sorted(keep), "removed": removed, "stats": report}


# ---------------------------------------------------------------------------
# extract_gt_videos / annotate_existing_videos
# ---------------------------------------------------------------------------


def _annotate_cond_gen(cond: np.ndarray, gen: np.ndarray) -> np.ndarray:
    return np.concatenate(
        [annotate_borders(cond, COND_COLOR), annotate_borders(gen, GEN_COLOR)],
        axis=0)


def extract_gt_videos(
    data_dir: str,
    out_dir: str,
    *,
    num_cond: int = 14,
    num_gen: int = 14,
    gen_start_frame: int = 32,
    max_videos: int = 100,
    seed: int = 42,
) -> List[str]:
    """Annotated GT clips with the run_baseline anchor layout:
    cond = video[anchor-num_cond:anchor], GT = video[anchor:anchor+num_gen]
    (reference extract_gt_videos.py docstring). Frames stay at native
    resolution, [0,1] float."""
    entries = load_video_list(data_dir, max_videos=max_videos, seed=seed)
    os.makedirs(out_dir, exist_ok=True)
    written: List[str] = []
    for i, e in enumerate(entries):
        start = max(0, gen_start_frame - num_cond)
        frames = decode_frames(
            e["path"], num_cond + num_gen, start_frame=start
        ).astype(np.float32) / 255.0
        clip = _annotate_cond_gen(frames[:num_cond], frames[num_cond:])
        path = os.path.join(out_dir, f"{i:03d}_{Path(e['path']).stem}_gt.npy")
        written.append(save_video(clip, path))
    return written


def annotate_existing_videos(
    gen_dir: str,
    orig_dir: str,
    out_dir: str,
    *,
    num_cond_frames: int = 14,
) -> List[str]:
    """For each saved generation, prepend the matching original's
    conditioning frames (red border) and mark generated frames green
    (reference annotate_existing_videos.py). Matching prefers
    stem-substring (run_tta save names embed the source stem); the
    leading-integer index into the sorted originals is only a fallback —
    generation indices follow load_video_list's seeded/stratified sample
    order, not the sorted directory order, so the index can pair the
    wrong clip when orig_dir is the raw dataset."""
    gens = sorted(p for p in Path(gen_dir).iterdir() if p.suffix.lower() == ".npy")
    origs = sorted(p for p in Path(orig_dir).rglob("*") if p.suffix.lower() == ".npy")
    os.makedirs(out_dir, exist_ok=True)
    written: List[str] = []
    by_stem = {o.stem: o for o in origs}
    for g in gens:
        # run_tta save names are '<idx>_<source-stem>'; exact stem match
        # first, then LONGEST substring (a first-hit substring scan
        # would pair 'video_12' with 'video_1'), then the index fallback
        bare = re.sub(r"^\d+_", "", g.stem)
        orig: Optional[Path] = by_stem.get(bare) or by_stem.get(g.stem)
        if orig is None:
            matches = [o for o in origs
                       if o.stem in g.stem or g.stem in o.stem]
            if matches:
                orig = max(matches, key=lambda o: len(o.stem))
        if orig is None:
            m = re.match(r"^(\d+)", g.stem)
            if m and int(m.group(1)) < len(origs):
                orig = origs[int(m.group(1))]
        if orig is None:
            print(f"[annotate] no original match for {g.name}; skipped")
            continue
        gen = np.load(g).astype(np.float32)
        if gen.max() > 1.5:
            gen = gen / 255.0
        cond = decode_frames(str(orig), num_cond_frames)
        h, w = gen.shape[1], gen.shape[2]
        if cond.shape[1:3] != (h, w):
            cond = resize_frames(cond, h, w)  # cv2's uint8 resize
        clip = _annotate_cond_gen(cond.astype(np.float32) / 255.0, gen)
        written.append(
            save_video(clip, os.path.join(out_dir, g.stem + "_annotated.npy")))
    return written


# ---------------------------------------------------------------------------
# plots
# ---------------------------------------------------------------------------


def _scan_cond_gen_dirs(results_root: str, prefix: str = "panda"
                        ) -> Dict[Tuple[int, int], Dict[str, Any]]:
    """{(cond, gen): summary-stats} from cond{N}_gen{M} (panda) or
    {prefix}_cond{N}_gen{M} result dirs."""
    pat = (re.compile(r"^cond(\d+)_gen(\d+)$") if prefix == "panda"
           else re.compile(rf"^{re.escape(prefix)}_cond(\d+)_gen(\d+)$"))
    out: Dict[Tuple[int, int], Dict[str, Any]] = {}
    root = Path(results_root)
    if not root.is_dir():
        return out
    for d in sorted(root.iterdir()):
        m = pat.match(d.name)
        if not m:
            continue
        try:
            rows = load_per_video_metrics(str(d))
        except FileNotFoundError:
            continue
        stats = {}
        for met in METRICS:
            vals = [r[met] for r in rows if isinstance(r.get(met), float)
                    and np.isfinite(r[met])]
            if vals:
                stats[met] = {"mean": float(np.mean(vals)),
                              "std": float(np.std(vals))}
        out[(int(m.group(1)), int(m.group(2)))] = stats
    return out


def _plt():
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def plot_baseline_sweep(results_root: str, out_dir: str,
                        prefix: str = "panda") -> Optional[str]:
    """3x2 grid: each metric vs cond frames (one line per gen) and vs
    gen frames (one line per cond). Reference plot_baseline_sweep.py."""
    data = _scan_cond_gen_dirs(results_root, prefix)
    if not data:
        print(f"[plot] no cond/gen result dirs under {results_root}")
        return None
    plt = _plt()
    fig, axes = plt.subplots(3, 2, figsize=(11, 12))
    conds = sorted({c for c, _ in data})
    gens = sorted({g for _, g in data})
    for row, met in enumerate(METRICS):
        ax = axes[row][0]
        for g in gens:
            xs = [c for c in conds if (c, g) in data and met in data[(c, g)]]
            ys = [data[(c, g)][met]["mean"] for c in xs]
            if xs:
                ax.plot(xs, ys, marker="o", label=f"gen={g}")
        ax.set_xlabel("conditioning frames")
        ax.set_ylabel(METRIC_LABELS[met])
        ax.legend(fontsize=7)
        ax = axes[row][1]
        for c in conds:
            xs = [g for g in gens if (c, g) in data and met in data[(c, g)]]
            ys = [data[(c, g)][met]["mean"] for g in xs]
            if xs:
                ax.plot(xs, ys, marker="o", label=f"cond={c}")
        ax.set_xlabel("generated frames")
        ax.set_ylabel(METRIC_LABELS[met])
        ax.legend(fontsize=7)
    fig.suptitle(f"Baseline sweep — {prefix}")
    fig.tight_layout()
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"baseline_sweep_{prefix}.png")
    fig.savefig(path, dpi=150)
    plt.close(fig)
    return path


def plot_baseline_sweep_dual(results_root: str, out_dir: str,
                             prefixes: Sequence[str] = ("panda", "ucf101")
                             ) -> Optional[str]:
    """Side-by-side dataset comparison, one row per metric, PSNR vs cond
    frames per dataset (reference plot_baseline_sweep_dual.py)."""
    datas = {p: _scan_cond_gen_dirs(results_root, p) for p in prefixes}
    if not any(datas.values()):
        print(f"[plot] no cond/gen result dirs under {results_root}")
        return None
    plt = _plt()
    fig, axes = plt.subplots(3, len(prefixes),
                             figsize=(5.5 * len(prefixes), 12), squeeze=False)
    for col, p in enumerate(prefixes):
        data = datas[p]
        conds = sorted({c for c, _ in data})
        gens = sorted({g for _, g in data})
        for row, met in enumerate(METRICS):
            ax = axes[row][col]
            for g in gens:
                xs = [c for c in conds
                      if (c, g) in data and met in data[(c, g)]]
                ys = [data[(c, g)][met]["mean"] for c in xs]
                es = [data[(c, g)][met]["std"] for c in xs]
                if xs:
                    ax.errorbar(xs, ys, yerr=es, marker="o", capsize=2,
                                label=f"gen={g}")
            ax.set_xlabel("conditioning frames")
            ax.set_ylabel(METRIC_LABELS[met])
            ax.set_title(p if row == 0 else "")
            ax.legend(fontsize=7)
    fig.tight_layout()
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "baseline_sweep_dual.png")
    fig.savefig(path, dpi=150)
    plt.close(fig)
    return path


def plot_backbone_comparison(
    summaries: Sequence[Tuple[str, str]],
    out_dir: str,
) -> List[str]:
    """Mean±std bars per metric across labeled summary.json files — the
    data-driven form of the reference's plot_v20_vs_longcat.py (which
    hardcodes the two result dicts)."""
    stats: List[Tuple[str, Dict[str, Dict[str, float]]]] = []
    for label, path in summaries:
        rows = load_per_video_metrics(os.path.dirname(path)
                                      if path.endswith(".json") else path)
        s = {}
        for met in METRICS:
            vals = [r[met] for r in rows if isinstance(r.get(met), float)
                    and np.isfinite(r[met])]
            if vals:
                s[met] = {"mean": float(np.mean(vals)),
                          "std": float(np.std(vals))}
        stats.append((label, s))
    plt = _plt()
    os.makedirs(out_dir, exist_ok=True)
    paths = []
    for met in METRICS:
        fig, ax = plt.subplots(figsize=(4.5, 4))
        labels = [lb for lb, s in stats if met in s]
        means = [s[met]["mean"] for _, s in stats if met in s]
        stds = [s[met]["std"] for _, s in stats if met in s]
        if not labels:
            plt.close(fig)
            continue
        ax.bar(range(len(labels)), means, yerr=stds, capsize=4,
               color=["#4878CF", "#EE854A", "#6ACC64", "#D65F5F"][:len(labels)])
        ax.set_xticks(range(len(labels)))
        ax.set_xticklabels(labels, rotation=15, ha="right")
        ax.set_ylabel(METRIC_LABELS[met])
        fig.tight_layout()
        path = os.path.join(out_dir, f"backbone_comparison_{met}.png")
        fig.savefig(path, dpi=150)
        plt.close(fig)
        paths.append(path)
    return paths


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------


def main(argv: Optional[Sequence[str]] = None) -> int:
    p = argparse.ArgumentParser(prog="baseline_tools", description=__doc__)
    sub = p.add_subparsers(dest="cmd", required=True)

    pr = sub.add_parser("prune")
    pr.add_argument("--results-dir", required=True)
    pr.add_argument("--create-keep-list", action="store_true")
    pr.add_argument("--keep-list")
    pr.add_argument("--top-n", type=int, default=10)
    pr.add_argument("--bottom-n", type=int, default=10)
    pr.add_argument("--dry-run", action="store_true")

    gt = sub.add_parser("extract-gt")
    gt.add_argument("--data-dir", required=True)
    gt.add_argument("--out-dir", required=True)
    gt.add_argument("--num-cond", type=int, default=14)
    gt.add_argument("--num-gen", type=int, default=14)
    gt.add_argument("--gen-start-frame", type=int, default=32)
    gt.add_argument("--max-videos", type=int, default=100)

    an = sub.add_parser("annotate")
    an.add_argument("--gen-dir", required=True)
    an.add_argument("--orig-dir", required=True)
    an.add_argument("--out-dir", required=True)
    an.add_argument("--num-cond-frames", type=int, default=14)

    ps = sub.add_parser("plot-sweep")
    ps.add_argument("--results-root", required=True)
    ps.add_argument("--out-dir", required=True)
    ps.add_argument("--prefix", default="panda")
    ps.add_argument("--dual", action="store_true")

    pb = sub.add_parser("plot-backbones")
    pb.add_argument("--summary", action="append", required=True,
                    metavar="LABEL=PATH")
    pb.add_argument("--out-dir", required=True)

    a = p.parse_args(argv)
    if a.cmd == "prune":
        out = prune_and_summarize(
            a.results_dir, create_keep_list=a.create_keep_list,
            keep_list=a.keep_list, top_n=a.top_n, bottom_n=a.bottom_n,
            dry_run=a.dry_run)
        print(json.dumps(out["stats"], indent=2))
    elif a.cmd == "extract-gt":
        w = extract_gt_videos(
            a.data_dir, a.out_dir, num_cond=a.num_cond, num_gen=a.num_gen,
            gen_start_frame=a.gen_start_frame, max_videos=a.max_videos)
        print(f"wrote {len(w)} GT clips")
    elif a.cmd == "annotate":
        w = annotate_existing_videos(
            a.gen_dir, a.orig_dir, a.out_dir,
            num_cond_frames=a.num_cond_frames)
        print(f"wrote {len(w)} annotated clips")
    elif a.cmd == "plot-sweep":
        fn = plot_baseline_sweep_dual if a.dual else plot_baseline_sweep
        if a.dual:
            print(fn(a.results_root, a.out_dir))
        else:
            print(fn(a.results_root, a.out_dir, a.prefix))
    elif a.cmd == "plot-backbones":
        pairs = [tuple(s.split("=", 1)) for s in a.summary]
        for path in plot_backbone_comparison(pairs, a.out_dir):
            print(path)
    return 0


if __name__ == "__main__":
    sys.exit(main())
