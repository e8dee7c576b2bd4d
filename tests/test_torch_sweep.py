"""The port's sweep runner (sweep/run_sweep.py) against the JAX one.

- Every row of every configs/*.yaml builds the JAX sweep's argv, less
  the documented drops (compile_cache_dir, attn_impl), and the port
  runner's parser takes it; the not-yet-ported keys raise.
- The campaign YAMLs pass the port runner's --preflight-only.
- Dry-run, resume-skip, --jobs with a CUDA_VISIBLE_DEVICES pool, the
  fleet STOP file and the subprocess drain sentinel, as tests/test_sweep.py
  holds the JAX sweep (the subprocess stubbed).
- configs/smoke_tiny.yaml end to end through both sweeps on the CPU: the
  launch records and the summary.json keys are equal.
"""

import contextlib
import glob
import io
import json
import os

import pytest
import torch
import yaml

from longcat_video_tta_tpu.sweep import run_sweep as jsw
from longcat_video_tta_tpu_torch.runners.run_tta import build_arg_parser
from longcat_video_tta_tpu_torch.runners.run_tta import main as run_main
from longcat_video_tta_tpu_torch.sweep import run_sweep as tsw

torch.set_num_threads(2)

CONFIGS = sorted(glob.glob("configs/*.yaml"))
DROPPED = ("--compile-cache-dir", "--attn-impl")


def _rows(path):
    cfg = jsw.load_config(path)
    for row in cfg["sweep"]:
        params = dict(cfg["fixed"])
        params.update({k: v for k, v in row.items() if k != "run_id"})
        yield cfg["method"], row["run_id"], params


def _without_drops(argv):
    out, i = [], 0
    while i < len(argv):
        if argv[i] in DROPPED:
            i += 2
            continue
        out.append(argv[i])
        i += 1
    return out


def test_every_config_is_covered():
    assert len(CONFIGS) >= 80


@pytest.mark.parametrize("path", CONFIGS, ids=os.path.basename)
def test_build_argv_matches_jax_and_parses(path):
    parser = build_arg_parser()
    for method, run_id, params in _rows(path):
        data = params.get("data_dir", "/data")
        with contextlib.redirect_stdout(io.StringIO()) as notes:
            ref = jsw.build_argv(method, params, "/out", data)
            argv = tsw.build_argv(method, params, "/out", data)
        assert argv == _without_drops(ref), (path, run_id)
        for key in ("compile_cache_dir", "attn_impl"):
            if key in params:
                assert f"'{key}' dropped" in notes.getvalue()
        parser.parse_args(argv)  # SystemExit on a flag the port lacks


@pytest.mark.parametrize("key", tsw._NOT_PORTED)
def test_not_ported_keys_raise(key):
    with pytest.raises(ValueError, match="not yet ported"):
        tsw.build_argv("delta_a", {key: True}, "/out", None)


def test_reference_keys_and_unknown_keys():
    params = {"delta_lr": 5e-3, "resolution": "480p", "clip_gate_late_only": True,
              "clip_gate_fail_open": False, "compute_fvd": True, "compute_fid": True,
              "target_ffn": True, "delta_mode": "per_channel", "run_id": "R"}
    with contextlib.redirect_stdout(io.StringIO()):
        assert tsw.build_argv("delta_b", params, "/o", None) == \
            jsw.build_argv("delta_b", params, "/o", None)
    for bad in ({"not_a_key": 1}, {"delta_mode": "weird"}, {"resolution": "720p"}):
        with pytest.raises(ValueError):
            tsw.build_argv("delta_c", bad, "/o", None)


def test_estimators_use_the_h100_table():
    a = tsw.estimate_minutes("delta_a", {"max_videos": 10, "steps": 5})
    b = tsw.estimate_minutes("lora", {"max_videos": 10, "steps": 5})
    none = tsw.estimate_minutes("none", {"max_videos": 10, "steps": 5})
    assert b > a > none > 0
    # the levers carry a factor of 1.0 (no H100 ratio measured)
    assert tsw.estimate_minutes("delta_a", {"bsa_keep_ratio": 0.5}) == \
        tsw.estimate_minutes("delta_a", {})
    assert tsw.estimate_memory_gb("lora", {})["device_hbm_gb"] == tsw.H100_PEAK_GIB["lora"]


def _tiny_data_dir(tmp_path):
    from longcat_video_tta_tpu_torch.runners.run_tta import make_synthetic_dataset

    return make_synthetic_dataset(str(tmp_path / "data"), 1, 16, 32, seed=3)


def test_campaign_yamls_pass_preflight(tmp_path):
    data = _tiny_data_dir(tmp_path)
    paths = sorted(glob.glob("configs/campaign_bench_*.yaml"))
    assert paths
    for path in paths:
        for method, run_id, params in _rows(path):
            params["max_videos"] = 1
            with contextlib.redirect_stdout(io.StringIO()):
                argv = tsw.build_argv(method, params, str(tmp_path / "out" / run_id), data)
                out = run_main(argv + ["--device", "cpu", "--preflight-only"])
            assert out["preflight"] and out["num_videos"] == 1, (path, run_id)


def test_preflight_catches_bad_frame_window(tmp_path):
    cfg = {"method": "delta_a", "series": "pf", "fixed": {
        "preset": "longcat_bench", "max_videos": 1, "height": 480, "width": 832,
        "num_cond_frames": 14, "num_frames": 28, "gen_start_frame": 32, "steps": 2,
        "caption_guard_mode": "off"}, "sweep": [{"run_id": "BAD_WINDOW"}]}
    p = tmp_path / "pf.yaml"
    p.write_text(yaml.dump(cfg))
    out = tsw.run_sweep(str(p), str(tmp_path / "out"), data_dir=_tiny_data_dir(tmp_path),
                        device="cpu")
    assert out[0]["status"].startswith("preflight-failed"), out[0]
    assert not os.path.exists(tmp_path / "out" / "pf" / "BAD_WINDOW" / "config.json")


def _cfg_file(tmp_path, rows):
    cfg = yaml.safe_load(open("configs/smoke_tiny.yaml"))
    cfg["sweep"] = rows
    p = os.path.join(str(tmp_path), "cfg.yaml")
    yaml.safe_dump(cfg, open(p, "w"))
    return p


def test_dry_run_stop_file_and_device_forwarded(tmp_path):
    p = _cfg_file(tmp_path, [{"run_id": "a", "lr": 0.01}, {"run_id": "b"}])
    base = os.path.join(str(tmp_path), "res")
    rows = tsw.run_sweep(p, base, dry_run=True, device="cpu", run_ids=["a"])
    assert [r["run_id"] for r in rows] == ["a"] and rows[0]["status"] == "dry-run"
    argv = rows[0]["argv"]
    assert argv[argv.index("--stop-file") + 1] == os.path.join(base, "STOP")
    assert argv[argv.index("--device") + 1] == "cpu"
    assert "--lr" in argv and "--attn-impl" not in argv
    with open(os.path.join(base, "sweep_smoke_tiny.json")) as f:
        assert [r["run_id"] for r in json.load(f)] == ["a"]


def test_jobs_pin_rows_to_cuda_visible_devices(tmp_path, monkeypatch):
    import subprocess
    import threading
    import time

    p = _cfg_file(tmp_path, [{"run_id": f"r{i}", "lr": 0.01} for i in range(4)])
    lock = threading.Lock()
    state = {"live": 0, "max_live": 0, "devices": [], "modules": set()}

    class _R:
        returncode = 0

    def fake_run(cmd, env=None):
        with lock:
            state["live"] += 1
            state["max_live"] = max(state["max_live"], state["live"])
            state["devices"].append((env or {}).get("CUDA_VISIBLE_DEVICES"))
            state["modules"].add(cmd[2])
        time.sleep(0.15)
        with lock:
            state["live"] -= 1
        return _R()

    monkeypatch.setattr(subprocess, "run", fake_run)
    launched = tsw.run_sweep(p, os.path.join(str(tmp_path), "res"), jobs=2,
                             device_pool=["0", "1"])
    assert state["max_live"] == 2 and sorted(state["devices"]) == ["0", "0", "1", "1"]
    assert state["modules"] == {"longcat_video_tta_tpu_torch.runners.run_tta"}
    assert all(r["status"] == "ok" and r["device"] in ("0", "1") for r in launched)


def test_fleet_stop_file_skips_pending_rows(tmp_path):
    p = _cfg_file(tmp_path, [{"run_id": "a"}, {"run_id": "b"}])
    base = os.path.join(str(tmp_path), "res")
    os.makedirs(base)
    open(os.path.join(base, "STOP"), "w").close()
    rows = tsw.run_sweep(p, base, device="cpu")
    assert [r["status"] for r in rows] == ["drained (not launched)"] * 2


def test_subprocess_drain_classified_by_sentinel(tmp_path, monkeypatch):
    import subprocess

    p = _cfg_file(tmp_path, [{"run_id": "drains"}, {"run_id": "plain"}])

    class _R:
        returncode = 0

    def fake_run(cmd, env=None):
        out = cmd[cmd.index("--output-dir") + 1]
        os.makedirs(out, exist_ok=True)
        if "drains" in out:
            with open(os.path.join(out, "DRAINED"), "w") as f:
                f.write("{}")
        return _R()

    monkeypatch.setattr(subprocess, "run", fake_run)
    rows = tsw.run_sweep(p, os.path.join(str(tmp_path), "res"), subprocess_mode=True)
    assert {r["run_id"]: r["status"] for r in rows} == {"drains": "drained", "plain": "ok"}


@pytest.fixture(scope="module")
def both_sweeps(tmp_path_factory):
    """configs/smoke_tiny.yaml's first row through the JAX sweep and the
    port's (in-process, --device cpu), then a second port call that must
    skip the completed row."""
    out = str(tmp_path_factory.mktemp("sweeps"))
    jrows = jsw.run_sweep("configs/smoke_tiny.yaml", os.path.join(out, "jax"),
                          run_ids=["lr1e-2"])
    trows = tsw.run_sweep("configs/smoke_tiny.yaml", os.path.join(out, "torch"),
                          run_ids=["lr1e-2"], device="cpu")
    again = tsw.run_sweep("configs/smoke_tiny.yaml", os.path.join(out, "torch"),
                          run_ids=["lr1e-2"], device="cpu")
    return out, jrows, trows, again


def test_smoke_tiny_through_both_sweeps(both_sweeps):
    out, jrows, trows, _ = both_sweeps
    assert [r["status"] for r in jrows] == [r["status"] for r in trows] == ["ok"]
    assert set(jrows[0]) == set(trows[0])
    for key in ("run_id", "series", "method"):
        assert jrows[0][key] == trows[0][key]
    assert _without_drops(jrows[0]["argv"]) == [
        a.replace(os.path.join(out, "torch"), os.path.join(out, "jax"))
        for a in trows[0]["argv"][:-2]]
    assert trows[0]["argv"][-2:] == ["--device", "cpu"]
    sums = []
    for side in ("jax", "torch"):
        with open(os.path.join(out, side, "smoke_tiny", "lr1e-2", "summary.json")) as f:
            sums.append(json.load(f))
        with open(os.path.join(out, side, "sweep_smoke_tiny.json")) as f:
            assert [r["run_id"] for r in json.load(f)] == ["lr1e-2"]
    j, t = sums
    assert set(t) == set(j)
    assert set(t["results"][0]) == set(j["results"][0])
    assert t["num_success"] == j["num_success"] == 2


def test_completed_row_is_skipped(both_sweeps):
    _, _, _, again = both_sweeps
    assert again[0]["status"] == "skipped (summary.json exists)"
