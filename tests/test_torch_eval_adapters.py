"""The port's thin runners over saved adapters and the baseline CSV.

- ``run_tta --save-adapters`` (delta_a, lora's side branch, norm_tune's
  adapted DiT; early stopping off so the trained state is kept), then
  ``run_eval_adapters`` in both modes: the adapted mode regenerates the
  run's own continuation (same weights, adapters and seed: the run's
  PSNR within 1e-5), the baseline mode differs from it, and
  ``--bsa-keep-ratio`` / ``--quantize-decode`` run on the CPU path.
- ``eval_summary.json``'s keys equal the JAX runner's, run in baseline
  mode over the same run directory (the JAX runner cannot read the
  port's ``.pt`` adapters: its adapted mode records an error per video).
- The adapted mode of a run without adapter files exits.
- ``run_baseline``'s per_video_metrics.csv equals the JAX runner's CSV
  written from the same summary.
"""

import json
import os

import numpy as np
import pytest
import torch

from longcat_video_tta_tpu.runners import run_baseline as jax_run_baseline
from longcat_video_tta_tpu.runners import run_eval_adapters as jax_eval
from longcat_video_tta_tpu_torch.runners import run_baseline, run_eval_adapters, run_tta

torch.set_num_threads(2)

GEOM = ["--preset", "longcat_tiny", "--device", "cpu", "--height", "16", "--width", "32",
        "--num-cond-frames", "5", "--num-frames", "5", "--gen-start-frame", "16",
        "--num-inference-steps", "2", "--caption-guard-mode", "off", "--seed", "4"]
# learning rates large enough that 3 steps move the tiny model's output;
# norm_tune's trained affines move its random-weight output far less
# (PSNR by about 1e-5) than delta_a's and lora's
METHODS = {"delta_a": ["--lr", "5.0"],
           "lora": ["--lr", "0.05", "--lora-target-ffn"],
           "norm_tune": ["--lr", "1.0", "--norm-target", "all_norm"]}
MIN_PSNR_MOVE = {"delta_a": 1e-3, "lora": 1e-3, "norm_tune": 0.0}


def _tta(out, method, extra=()):
    return run_tta.main(["--method", method, "--output-dir", str(out), "--synthetic", "2",
                         "--tta-total-frames", "13", "--steps", "3", "--es-disable"]
                        + METHODS[method] + GEOM + list(extra))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("tta_runs")
    return {m: (root / m, _tta(root / m, m, ["--save-adapters"])) for m in METHODS}


def _eval(run_dir, out, mode, extra=()):
    return run_eval_adapters.main(["--results-dir", str(run_dir), "--output-dir", str(out),
                                   "--mode", mode, "--device", "cpu"] + list(extra))


@pytest.mark.parametrize("method", list(METHODS))
def test_adapted_mode_reproduces_the_run(runs, tmp_path, method):
    run_dir, summary = runs[method]
    assert all(os.path.exists(r["adapter_path"]) for r in summary["results"])
    adapted = _eval(run_dir, tmp_path / "a", "adapted")
    base = _eval(run_dir, tmp_path / "b", "baseline")
    assert adapted["num_success"] == base["num_success"] == 2
    for run_r, a, b in zip(summary["results"], adapted["results"], base["results"]):
        assert run_r["adapter_norm"] > 0
        assert abs(a["psnr"] - run_r["psnr"]) <= 1e-5
        assert abs(a["psnr"] - b["psnr"]) > MIN_PSNR_MOVE[method], \
            "adapted mode used the base weights"
        clip_a, clip_b = np.load(a["video_path"]), np.load(b["video_path"])
        np.testing.assert_array_equal(clip_a, np.load(run_r["video_path"]))
        assert np.abs(clip_a.astype(int) - clip_b).max() > 0
    assert adapted["metrics"]["psnr"] != base["metrics"]["psnr"]


def test_decode_levers_on_saved_adapters(runs, tmp_path):
    run_dir, _ = runs["delta_a"]
    for extra in (["--bsa-keep-ratio", "0.5"], ["--quantize-decode", "int8"],
                  ["--bucket-gen", "--num-inference-steps", "3", "--max-videos", "1"]):
        out = _eval(run_dir, tmp_path / extra[0][2:], "adapted", extra + ["--no-save-videos"])
        assert out["num_success"] == out["num_videos"] > 0, out["results"]
        assert all(np.isfinite(r["psnr"]) and "video_path" not in r for r in out["results"])
    assert out["generation"]["steps"] == 3


def test_eval_summary_keys_match_jax(runs, tmp_path):
    run_dir, _ = runs["delta_a"]
    out = _eval(run_dir, tmp_path / "t", "baseline", ["--max-videos", "1"])
    ref = jax_eval.main(["--results-dir", str(run_dir), "--output-dir", str(tmp_path / "j"),
                         "--mode", "baseline", "--max-videos", "1"])
    assert ref["num_success"] == 1, ref["results"]
    assert set(out) == set(ref)
    assert set(out["generation"]) == set(ref["generation"])
    assert set(out["metrics"]) == set(ref["metrics"])
    assert set(out["results"][0]) == set(ref["results"][0])
    with open(tmp_path / "t" / "eval_summary.json") as f:
        assert set(json.load(f)) == set(ref)


def test_adapted_mode_without_adapters_exits(tmp_path):
    _tta(tmp_path / "run", "delta_a")
    with pytest.raises(SystemExit, match="save-adapters"):
        _eval(tmp_path / "run", tmp_path / "e", "adapted")


def test_baseline_csv_matches_jax(tmp_path, monkeypatch):
    out = tmp_path / "base"
    summary = run_baseline.main(["--output-dir", str(out), "--synthetic", "2"] + GEOM)
    assert summary["method"] == "none" and summary["num_success"] == 2
    jout = tmp_path / "jax"
    jout.mkdir()
    fed = dict(summary, config=dict(summary["config"], output_dir=str(jout)))
    monkeypatch.setattr(jax_run_baseline, "tta_main", lambda argv: fed)
    jax_run_baseline.main(["--output-dir", str(jout)])
    with open(out / "per_video_metrics.csv") as f:
        port_csv = f.read()
    with open(jout / "per_video_metrics.csv") as f:
        assert port_csv == f.read()
    assert port_csv.splitlines()[0] == ",".join(run_baseline.CSV_COLUMNS)
