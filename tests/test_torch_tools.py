"""The port's post-processing tools against the JAX modules on the same
inputs: comparisons/compare_all.py and comparisons/eval_external.py,
sweep/diagnostics.py, sweep/baseline_tools.py, sweep/figures.py and
data/prep.py.

The run folders come from the port's runner at longcat_tiny size on the
CPU (a delta_a series and a baseline series of 2 synthetic videos each,
plus an in-progress and an empty run). JSON returns, CSV and Markdown
outputs must be equal; clips bit for bit; the figures the same file set
with the same plotted arrays (read from each figure as it is saved).
The port writes .npy clips where the JAX modules write .mp4 through
imageio: on the JAX side ``save_video`` is pointed at its own .npy
branch, and names are compared without the extension. eval_external
also runs with small LPIPS and I3D tower files on the CPU: its LPIPS
equals the runner's metric code on the same clips, its FVD is finite.
"""

import contextlib
import csv
import io
import json
import os
import shutil

import matplotlib
import numpy as np
import pytest
import torch
import yaml

import chip_smoke
from longcat_video_tta_tpu.comparisons import compare_all as jca
from longcat_video_tta_tpu.comparisons import eval_external as jee
from longcat_video_tta_tpu.data import prep as jprep
from longcat_video_tta_tpu.sweep import baseline_tools as jbt
from longcat_video_tta_tpu.sweep import diagnostics as jdiag
from longcat_video_tta_tpu.sweep import figures as jfig
from longcat_video_tta_tpu_torch.comparisons import compare_all as tca
from longcat_video_tta_tpu_torch.comparisons import eval_external as tee
from longcat_video_tta_tpu_torch.data import prep as tprep
from longcat_video_tta_tpu_torch.data.video_io import decode_frames, resize_frames
from longcat_video_tta_tpu_torch.eval.lpips import load_lpips_params, make_lpips_feature_fn
from longcat_video_tta_tpu_torch.eval.metrics import evaluate_generation_metrics
from longcat_video_tta_tpu_torch.runners import run_baseline, run_tta
from longcat_video_tta_tpu_torch.sweep import baseline_tools as tbt
from longcat_video_tta_tpu_torch.sweep import diagnostics as tdiag
from longcat_video_tta_tpu_torch.sweep import export_loss_curves, export_results
from longcat_video_tta_tpu_torch.sweep import figures as tfig

torch.set_num_threads(2)

# 48 x 64: LPIPS's AlexNet needs about 40 pixels
GEOM = dict(height=48, width=64, gen_start=16, gen_frames=5)
RUN_ARGS = ["--preset", "longcat_tiny", "--synthetic", "2", "--device", "cpu",
            "--height", "48", "--width", "64", "--num-cond-frames", "5",
            "--num-frames", "5", "--gen-start-frame", "16", "--tta-total-frames", "13",
            "--steps", "2", "--es-check-every", "1", "--num-inference-steps", "2",
            "--caption-guard-mode", "off"]


def _quiet(fn, *a, **k):
    with contextlib.redirect_stdout(io.StringIO()):
        return fn(*a, **k)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """results/<series>/<run>: a delta_a run and a baseline run (2 videos
    each, clips saved), an in-progress run and an empty one; the sweep
    YAML that expects them; the synthetic clips."""
    root = tmp_path_factory.mktemp("tools")
    results = root / "results"
    tta = results / "smoke_tiny" / "lr1e-2"
    base = results / "smoke_baseline" / "base"
    _quiet(run_tta.main, ["--method", "delta_a", "--output-dir", str(tta), *RUN_ARGS])
    _quiet(run_baseline.main, ["--output-dir", str(base), *RUN_ARGS])
    prog = results / "smoke_tiny" / "lr5e-3"
    prog.mkdir(parents=True)
    (prog / "checkpoint.json").write_text(json.dumps({"next_idx": 1, "results": [
        {"video": "clip_000.npy", "success": False,
         "error": "RuntimeError: CUDA out of memory"}]}))
    (results / "smoke_tiny" / "empty").mkdir()
    cfg = {"method": "delta_a", "series": "smoke_tiny", "fixed": {},
           "sweep": [{"run_id": r} for r in ("lr1e-2", "lr5e-3", "empty", "missing")]}
    (root / "sweep.yaml").write_text(yaml.safe_dump(cfg))
    return dict(root=root, results=results, tta=tta, base=base,
                data=tta / "synthetic_data")


def _fold(obj, root):
    """A JSON-able return with the run root's path taken out."""
    return json.loads(json.dumps(obj, default=str).replace(str(root), "ROOT"))


# ---------------------------------------------------------------------------
# compare_all, eval_external
# ---------------------------------------------------------------------------


def test_compare_all_matches_jax(runs, tmp_path):
    specs = [f"tta={runs['tta']}/summary.json", f"base={runs['base']}/summary.json"]
    outs = []
    for mod, name in ((jca, "j"), (tca, "t")):
        path = tmp_path / f"{name}.json"
        rows = _quiet(mod.main, specs + ["--output", str(path)])
        outs.append((rows, path.read_text()))
    assert outs[0][0] == outs[1][0]
    assert outs[0][1] == outs[1][1]
    assert [r["label"] for r in outs[1][0]] == ["tta", "base"]


def _gt_dir(runs, folder):
    """The runner's ground truth of each video (the anchor window at the
    run's geometry) as uint8 clips named after the video."""
    os.makedirs(folder, exist_ok=True)
    for i in range(2):
        src = os.path.join(runs["data"], f"clip_{i:03d}.npy")
        frames = resize_frames(decode_frames(src, GEOM["gen_frames"], GEOM["gen_start"]),
                               GEOM["height"], GEOM["width"])
        np.save(os.path.join(folder, f"clip_{i:03d}.npy.npy"), frames)
    return folder


def test_eval_external_matches_jax_and_scores_lpips_and_fvd(runs, tmp_path):
    gen_dir = str(runs["tta"] / "videos")
    gt_dir = _gt_dir(runs, str(tmp_path / "gt"))
    ref = _quiet(jee.evaluate_external, gen_dir, gt_dir)
    got = _quiet(tee.evaluate_external, gen_dir, gt_dir, device="cpu")
    assert set(got) == set(ref) and got["n"] == ref["n"] == 2
    assert got["fvd"] is None and ref["fvd"] is None
    for a, b in zip(got["per_video"], ref["per_video"]):
        assert a["video"] == b["video"] and set(a) == set(b)
        np.testing.assert_allclose([a["psnr"], a["ssim"]], [b["psnr"], b["ssim"]], rtol=1e-5,
                                   atol=1e-6)
        assert np.isnan(a["lpips"]) and np.isnan(b["lpips"])
    np.testing.assert_allclose([got["psnr"], got["ssim"]], [ref["psnr"], ref["ssim"]],
                               rtol=1e-5, atol=1e-6)

    # the port's towers: small LPIPS and I3D files drawn on the CPU
    gen = torch.Generator().manual_seed(5)
    paths = {}
    for name, shapes in (("lpips", chip_smoke.lpips_state_shapes()),
                         ("i3d", chip_smoke.i3d_state_shapes())):
        paths[name] = str(tmp_path / f"{name}.pt")
        torch.save({k: chip_smoke.tower_value(k, s, gen, "cpu") for k, s in shapes.items()},
                   paths[name])
    out = tmp_path / "ext.json"
    full = _quiet(tee.main, ["--gen-dir", gen_dir, "--gt-dir", gt_dir, "--device", "cpu",
                             "--lpips-model-path", paths["lpips"], "--i3d-model-path",
                             paths["i3d"], "--output", str(out)])
    assert np.isfinite(full["fvd"]) and json.loads(out.read_text())["n"] == 2
    lp = make_lpips_feature_fn(load_lpips_params(paths["lpips"], "cpu"))
    for row in full["per_video"]:
        g = np.load(os.path.join(gen_dir, row["video"])) / 255.0
        t = np.load(os.path.join(gt_dir, row["video"][5:])) / 255.0
        m = evaluate_generation_metrics(g, t, device="cpu", lpips_feature_fn=lp)
        np.testing.assert_allclose([row[k] for k in ("psnr", "ssim", "lpips")],
                                   [m[k] for k in ("psnr", "ssim", "lpips")], rtol=1e-6)
        assert np.isfinite(row["lpips"])
    # against the runner's own records: the saved clip is the generation
    # truncated to uint8 (the reference's save), so PSNR moves by a little
    summary = json.loads((runs["tta"] / "summary.json").read_text())
    for row, r in zip(full["per_video"], summary["results"]):
        assert abs(row["psnr"] - r["psnr"]) < 0.1 and abs(row["ssim"] - r["ssim"]) < 0.01


# ---------------------------------------------------------------------------
# diagnostics
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cmd", ["status", "audit", "regressions", "calibration", "stalled",
                                 "failures", "xclip", "check-matrix"])
def test_diagnostics_match_jax(runs, cmd, tmp_path):
    r = str(runs["results"])
    argv = {
        "status": ["status", "--results-roots", r],
        "audit": ["audit", str(runs["base"]), str(runs["tta"])],
        "regressions": ["regressions", str(runs["tta"]), str(runs["base"])],
        "calibration": ["calibration", str(runs["tta"]), str(runs["base"])],
        "stalled": ["stalled", "--results-roots", r, "--stale-minutes", "0"],
        "failures": ["failures", "--results-roots", r],
        "xclip": ["xclip", "--root", r],
        "check-matrix": ["check-matrix", str(runs["root"] / "sweep.yaml"),
                         "--output-base", r, "--report", "REPORT"],
    }[cmd]
    outs = []
    for mod, side in ((jdiag, "j"), (tdiag, "t")):
        a = [str(tmp_path / f"{side}.json") if x == "REPORT" else x for x in argv]
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            ret = mod.main(a)
        text = buf.getvalue().replace(str(tmp_path / f"{side}.json"), "REPORT")
        report = (tmp_path / f"{side}.json")
        outs.append((_fold(ret, runs["root"]), text,
                     report.read_text().replace(f"{side}.json", "R") if report.exists()
                     else None))
    assert outs[0] == outs[1]
    if cmd == "status":
        ret = outs[1][0]
        assert len(ret["complete"]) == 2 and len(ret["in_progress"]) == 1
        assert len(ret["failed_empty"]) == 1


# ---------------------------------------------------------------------------
# baseline_tools
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def _jax_writes_npy():
    """The JAX module's save_video at its own .npy branch (imageio would
    write .mp4, which the port does not read or write)."""
    orig = jbt.save_video, jprep.save_video

    def save(frames, path, fps=24):
        return orig[0](frames, os.path.splitext(path)[0] + ".npy")

    jbt.save_video = jprep.save_video = save
    try:
        yield
    finally:
        jbt.save_video, jprep.save_video = orig


def _clips(folder):
    return {f: np.load(os.path.join(folder, f)) for f in sorted(os.listdir(folder))
            if f.endswith(".npy")}


def _assert_same_clips(a, b):
    ca, cb = _clips(a), _clips(b)
    assert list(ca) == list(cb) and ca
    for k in ca:
        np.testing.assert_array_equal(ca[k], cb[k], err_msg=k)


def test_prune_and_summarize_matches_jax(runs, tmp_path):
    """On copies of the run: the JAX module prunes .mp4 names, the port the
    .npy clips the runner saves; the same keep set, removals and report."""
    out = {}
    for mod, side, ext in ((jbt, "j", ".mp4"), (tbt, "t", ".npy")):
        d = tmp_path / side / "run"  # RESULTS.md is headed by the folder's name
        shutil.copytree(runs["tta"], d, ignore=shutil.ignore_patterns("synthetic_data"))
        for f in os.listdir(d / "videos"):
            os.rename(d / "videos" / f, d / "videos" / (os.path.splitext(f)[0] + ext))
        ret = _quiet(mod.prune_and_summarize, str(d), create_keep_list=True, top_n=1,
                     bottom_n=0)
        ret["removed"] = [os.path.splitext(x)[0] for x in ret["removed"]]
        out[side] = (ret, (d / "RESULTS.md").read_text().replace("mp4s", "clips"),
                     (d / "keep_videos.txt").read_text(), sorted(os.listdir(d / "videos")))
    assert out["j"][:3] == out["t"][:3]
    assert [os.path.splitext(x)[0] for x in out["j"][3]] == \
        [os.path.splitext(x)[0] for x in out["t"][3]]
    assert len(out["t"][3]) == 1 and len(out["t"][0]["removed"]) == 1


def test_extract_gt_and_annotate_match_jax(runs, tmp_path):
    with _jax_writes_npy():
        kw = dict(num_cond=3, num_gen=5, gen_start_frame=16, max_videos=2)
        w_j = _quiet(jbt.extract_gt_videos, str(runs["data"]), str(tmp_path / "gt_j"), **kw)
        w_t = _quiet(tbt.extract_gt_videos, str(runs["data"]), str(tmp_path / "gt_t"), **kw)
        assert [os.path.basename(p) for p in w_j] == [os.path.basename(p) for p in w_t]
        _assert_same_clips(tmp_path / "gt_j", tmp_path / "gt_t")
        for mod, side in ((jbt, "j"), (tbt, "t")):
            _quiet(mod.annotate_existing_videos, str(runs["tta"] / "videos"),
                   str(runs["data"]), str(tmp_path / f"an_{side}"), num_cond_frames=3)
    _assert_same_clips(tmp_path / "an_j", tmp_path / "an_t")
    clip = next(iter(_clips(tmp_path / "an_t").values()))
    assert clip.shape[0] == 3 + GEOM["gen_frames"]


@pytest.fixture
def plotted(monkeypatch):
    """{file name: the arrays each axis of the figure holds} for every
    figure saved while the fixture is active."""
    record = {}
    orig = matplotlib.figure.Figure.savefig

    def savefig(fig, path, *a, **k):
        axes = []
        for ax in fig.get_axes():
            axes.append({
                "lines": [np.asarray(l.get_xydata(), np.float64).tolist()
                          for l in ax.get_lines()],
                "patches": [[float(p.get_x()), float(p.get_y()), float(p.get_width()),
                             float(p.get_height())] for p in ax.patches
                            if hasattr(p, "get_height")],
                "collections": [np.asarray(c.get_offsets(), np.float64).tolist()
                                for c in ax.collections],
                "texts": [t.get_text() for t in ax.texts],
                "labels": [ax.get_xlabel(), ax.get_ylabel(), ax.get_title()],
            })
        record[os.path.basename(str(path))] = axes
        return orig(fig, path, *a, **k)

    monkeypatch.setattr(matplotlib.figure.Figure, "savefig", savefig)
    return record


def _cond_gen_dirs(root):
    rng = np.random.RandomState(0)
    for c in (5, 13):
        for g in (8, 16):
            for prefix in ("", "ucf101_"):
                d = os.path.join(root, f"{prefix}cond{c}_gen{g}")
                os.makedirs(d)
                with open(os.path.join(d, "per_video_metrics.csv"), "w", newline="") as f:
                    w = csv.writer(f)
                    w.writerow(["video", "psnr", "ssim", "lpips"])
                    for i in range(3):
                        w.writerow([f"v{i}", 20 + rng.rand(), 0.7 + 0.1 * rng.rand(),
                                    0.3 * rng.rand()])


def test_baseline_plots_match_jax(runs, tmp_path, plotted):
    _cond_gen_dirs(str(tmp_path / "sweep"))
    pairs = [("tta", str(runs["tta"] / "summary.json")), ("base", str(runs["base"]))]
    made = {}
    for mod, side in ((jbt, "j"), (tbt, "t")):
        out = str(tmp_path / f"figs_{side}")
        paths = [mod.plot_baseline_sweep(str(tmp_path / "sweep"), out),
                 mod.plot_baseline_sweep(str(tmp_path / "sweep"), out, prefix="ucf101"),
                 mod.plot_baseline_sweep_dual(str(tmp_path / "sweep"), out)]
        paths += mod.plot_backbone_comparison(pairs, out)
        made[side] = ({os.path.basename(p) for p in paths}, dict(plotted))
        plotted.clear()
    assert made["j"] == made["t"]
    # three sweep grids; psnr and ssim bars (the runs score no LPIPS)
    assert len(made["t"][0]) == 5 and len(made["t"][1]) == 5


# ---------------------------------------------------------------------------
# figures
# ---------------------------------------------------------------------------


def _fabricated_runs():
    """Run records that reach the figure families the two tiny runs do not
    (tests/test_sweep.py's records)."""
    rng = np.random.RandomState(0)
    runs = []
    for series, key, vals in (("es_ablation_patience", "es_patience", (1, 2, 3)),
                              ("es_ablation_check_freq", "es_check_every", (1, 2, 5))):
        for v in vals:
            runs.append({"status": "complete", "series": series, "run_id": f"{key}{v}",
                         "method": "full", "psnr_mean": 22.0 + rng.rand(), "psnr_std": 0.5,
                         "ssim_mean": 0.7 + 0.01 * rng.rand(), "ssim_std": 0.01,
                         "lpips_mean": 0.25, "lpips_std": 0.02,
                         "es_stopped_ratio": float(rng.rand()),
                         "es_stopped_count": int(rng.randint(0, 20)), "es_total_count": 20,
                         "avg_train_time": 60.0 + 30 * rng.rand(), "avg_gen_time": 120.0,
                         "config": {key: v}, "delta_psnr": rng.rand(), "dataset": "panda"})
    for m in ("delta_a", "lora"):
        for ds in ("panda", "ucf101"):
            runs.append({"status": "complete", "series": f"s_{m}", "run_id": m, "method": m,
                         "psnr_mean": 22.3, "psnr_std": 0.4, "ssim_mean": 0.71,
                         "ssim_std": 0.01, "lpips_mean": 0.24, "lpips_std": 0.02,
                         "delta_psnr": 0.3, "dataset": ds, "config": {},
                         "avg_train_time": 40.0, "avg_gen_time": 110.0})
    return runs


def test_figures_match_jax(runs, tmp_path, plotted):
    all_results = str(tmp_path / "all_results.json")
    curves = str(tmp_path / "loss_curves.json")
    _quiet(export_results.main, ["--results-roots", str(runs["results"]),
                                 "--output", all_results])
    _quiet(export_loss_curves.main, ["--results-roots", str(runs["results"]),
                                     "--output", curves])
    with open(all_results) as f:
        doc = json.load(f)
    doc["runs"] += _fabricated_runs()
    with open(all_results, "w") as f:
        json.dump(doc, f)
    made = {}
    for mod, side in ((jfig, "j"), (tfig, "t")):
        out = str(tmp_path / f"figs_{side}")
        paths = _quiet(mod.main, ["--all-results", all_results, "--loss-curves", curves,
                                  "--output-dir", out])
        # as JSON text: a NaN in a plotted array equals a NaN
        made[side] = json.dumps((sorted(os.path.basename(p) for p in paths),
                                 sorted(os.listdir(out)), plotted), sort_keys=True)
        plotted.clear()
    assert made["j"] == made["t"]
    made = json.loads(made["t"])
    names = made[0]
    assert any("method_comparison" in n for n in names)
    assert any("loss_curves" in n for n in names) and len(names) >= 10


# ---------------------------------------------------------------------------
# prep
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def ucf_like(tmp_path_factory):
    """UCF-named .npy clips of 3 classes (24 x 40, 20 frames), a
    Panda-style metadata.csv over them, and one container file."""
    src = tmp_path_factory.mktemp("ucf")
    rng = np.random.RandomState(1)
    rows = []
    for cls in ("ApplyEyeMakeup", "Basketball", "CliffDiving"):
        for g in (1, 2):
            name = f"v_{cls}_g0{g}_c01.npy"
            np.save(src / name, (rng.rand(20, 24, 40, 3) * 255).astype(np.uint8))
            rows.append({"filename": name, "caption": f"a person doing {cls.lower()}",
                         "category": cls})
    (src / "v_Broken_g01_c01.avi").write_bytes(b"not a container")
    with open(src / "metadata.csv", "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=["filename", "caption", "category"])
        w.writeheader()
        w.writerows(rows)
    return src


def _tree(folder):
    out = {}
    for dirpath, _, files in os.walk(folder):
        for f in files:
            out[os.path.relpath(os.path.join(dirpath, f), folder)] = os.path.join(dirpath, f)
    return out


@pytest.mark.parametrize("cmd", ["ucf101", "panda70m", "resize", "dfot", "pvdm", "repair"])
def test_prep_matches_jax(ucf_like, tmp_path, cmd):
    outs = {}
    with _jax_writes_npy():
        for mod, side in ((jprep, "j"), (tprep, "t")):
            out = tmp_path / side
            if cmd == "ucf101":
                argv = ["ucf101", "--src-dir", str(ucf_like), "--out-dir", str(out),
                        "--videos-per-category", "1", "--min-frames", "10"]
            elif cmd == "panda70m":
                argv = ["panda70m", "--clips-dir", str(ucf_like), "--metadata-csv",
                        str(ucf_like / "metadata.csv"), "--out-dir", str(out),
                        "--num-videos", "4", "--min-frames", "10"]
            elif cmd == "resize":
                argv = ["resize", "--src-dir", str(ucf_like), "--out-dir", str(out)]
            elif cmd == "repair":
                shutil.copytree(ucf_like, out)
                with open(out / "metadata.csv", "a") as f:
                    f.write("v_Broken_g01_c01.avi,broken,Broken\n")
                argv = ["repair", "--data-dir", str(out)]
            else:
                argv = ["external", "--data-dir", str(ucf_like), "--out-dir", str(out),
                        "--format", cmd, "--min-frames", "4"]
            ret = _quiet(mod.main, argv)
            ret = _fold(ret, out)
            outs[side] = (json.loads(json.dumps(ret).replace(".mp4", ".npy")), _tree(out))
    (ret_j, tree_j), (ret_t, tree_t) = outs["j"], outs["t"]
    assert ret_j == ret_t
    strip = lambda names: sorted(n.replace(".mp4", ".npy") for n in names)
    assert strip(tree_j) == strip(tree_t) and tree_t
    for rel, path in tree_t.items():
        jpath = tree_j.get(rel) or tree_j[rel.replace(".npy", ".mp4")]
        if rel.endswith(".npy"):
            np.testing.assert_array_equal(np.load(path), np.load(jpath), err_msg=rel)
        elif rel.endswith(".pt"):
            a, b = torch.load(path), torch.load(jpath)
            assert _fold(a, tmp_path / "t") == json.loads(
                json.dumps(_fold(b, tmp_path / "j")).replace(".mp4", ".npy"))
        else:
            with open(path) as f, open(jpath) as g:
                assert f.read() == g.read().replace(".mp4", ".npy"), rel
    if cmd != "repair":
        assert any(r.endswith(".npy") for r in tree_t)
