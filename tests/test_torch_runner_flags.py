"""The reference runner's debugging and profiling flags on the port's
runner: --debug-nans (anomaly detection; a non-finite train loss or
anchor raises FloatingPointError, the video fails with it), --profile-dir
(a torch.profiler trace of the first video), --attn-impl (xla = the plain
version, the same numbers as the default on the CPU; pallas on the CPU
refused), --compile-cache-dir (the kernels' build folder), and the sweep
forwarding the five keys it no longer refuses or drops."""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from longcat_video_tta_tpu.sweep import run_sweep as jsw
from longcat_video_tta_tpu_torch import archs
from longcat_video_tta_tpu_torch.ops import attention as tattn
from longcat_video_tta_tpu_torch.ops import flash_attention as fa
from longcat_video_tta_tpu_torch.runners import run_tta
from longcat_video_tta_tpu_torch.sweep import run_sweep as tsw

torch.set_num_threads(2)


def _run(out, *extra):
    argv = ["--method", "delta_a", "--preset", "longcat_tiny", "--synthetic", "1",
            "--device", "cpu", "--output-dir", str(out), "--height", "16", "--width", "32",
            "--num-cond-frames", "5", "--num-frames", "5", "--gen-start-frame", "16",
            "--tta-total-frames", "13", "--steps", "2", "--es-check-every", "1",
            "--num-inference-steps", "2", "--caption-guard-mode", "off",
            "--no-save-videos", *extra]
    return run_tta.main(argv)


def _with_loss(monkeypatch, **fns):
    rec = archs.get_arch("longcat")
    monkeypatch.setitem(archs._archs(), "longcat", dataclasses.replace(rec, **fns))
    return rec


@pytest.mark.parametrize("where", ["loss", "anchor"])
def test_debug_nans_raises_on_an_injected_nan(tmp_path, monkeypatch, where):
    """A NaN in the train loss (anomaly detection stops its backward) or in
    the anchor (the chunk's finite check): the video fails with
    FloatingPointError. Without the flag the NaN flows into the record."""
    rec = archs.get_arch("longcat")
    if where == "loss":
        _with_loss(monkeypatch, loss=lambda *a, **k: rec.loss(*a, **k) * float("nan"))
    else:
        _with_loss(monkeypatch, anchor=lambda *a, **k: rec.anchor(*a, **k) * float("nan"))
    r = _run(tmp_path / "nan", "--debug-nans")["results"][0]
    assert not r["success"] and r["error"].startswith("FloatingPointError"), r.get("error")
    assert not torch.is_anomaly_enabled()  # the mode ends with the run
    if where == "loss":
        r = _run(tmp_path / "plain")["results"][0]
        assert r["success"] and np.isnan(r["losses"]).all()


def test_debug_nans_in_a_video_parallel_group(tmp_path, monkeypatch):
    rec = archs.get_arch("longcat")
    _with_loss(monkeypatch, anchor=lambda *a, **k: rec.anchor(*a, **k) * float("nan"))
    s = _run(tmp_path / "vp", "--synthetic", "2", "--video-parallel", "2", "--debug-nans")
    assert s["num_success"] == 0
    assert all(r["error"].startswith("FloatingPointError") for r in s["results"])


def test_profile_dir_writes_a_trace(tmp_path):
    prof = tmp_path / "prof"
    s = _run(tmp_path / "run", "--profile-dir", str(prof), "--synthetic", "2")
    assert s["num_success"] == 2
    with open(prof / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name", "") for e in events}
    assert any("aten::" in n for n in names) and len(events) > 100
    assert {"tta.step", "tta.anchor", "sampler.step", "dit.block", "op.rope"} <= names


def test_attn_impl_xla_equals_the_default_on_the_cpu(tmp_path):
    a = _run(tmp_path / "a")
    b = _run(tmp_path / "b", "--attn-impl", "xla")
    ra, rb = a["results"][0], b["results"][0]
    assert ra["losses"] == rb["losses"] and ra["psnr"] == rb["psnr"]
    with open(tmp_path / "b" / "config.json") as f:
        assert json.load(f)["attn_impl"] == "xla"
    with pytest.raises(SystemExit, match="CUDA"):
        _run(tmp_path / "c", "--attn-impl", "pallas")


def test_attention_impl_switch():
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(1, 40, 2, 16, generator=g) for _ in range(3))
    ref = tattn.attention(q, k, v, num_cond_tokens=16)
    with tattn.attention_impl("xla"):
        assert torch.equal(tattn.attention(q, k, v, num_cond_tokens=16), ref)
    with tattn.attention_impl("pallas"):
        with pytest.raises(RuntimeError, match="CUDA"):
            tattn.attention(q, k, v)
    assert tattn._impl is None
    with pytest.raises(ValueError):
        with tattn.attention_impl("triton"):
            pass


def test_compile_cache_dir_is_the_kernel_build_folder(tmp_path):
    default = fa.BUILD_DIR
    with fa.kernel_build_dir("auto") as d:
        assert d == default == fa.DEFAULT_BUILD_DIR
    target = tmp_path / "kernels"
    with fa.kernel_build_dir(str(target)) as d:
        assert d == fa.BUILD_DIR == str(target)
        assert fa._lib_path(fa.SOURCES[0]).startswith(str(target))
    assert fa.BUILD_DIR == default
    with fa.kernel_build_dir("off") as d:
        assert fa.BUILD_DIR == d and os.path.isdir(d) and d != default
    assert not os.path.exists(d) and fa.BUILD_DIR == default
    # through the runner: recorded, and the folder is restored after the run
    s = _run(tmp_path / "run", "--compile-cache-dir", str(target))
    assert s["config"]["compile_cache_dir"] == str(target) and fa.BUILD_DIR == default


@pytest.mark.parametrize("key,value,flag", [
    ("video_parallel", 2, "--video-parallel"), ("native_prefetch", True, "--native-prefetch"),
    ("debug_nans", True, "--debug-nans"), ("attn_impl", "xla", "--attn-impl"),
    ("compile_cache_dir", "/tmp/kc", "--compile-cache-dir")])
def test_sweep_forwards_the_keys(key, value, flag):
    argv = tsw.build_argv("delta_a", {key: value}, "/out", None)
    assert argv == jsw.build_argv("delta_a", {key: value}, "/out", None)
    assert flag in argv
    assert getattr(run_tta.build_arg_parser().parse_args(argv), key) == value
