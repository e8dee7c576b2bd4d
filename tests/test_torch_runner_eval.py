"""The port's runner with the CLIP gate and the evaluation towers on the
CPU (longcat_tiny, the plain path): the gate's record and decision against
the JAX gate on the same window, the skip path (no training, no DNO, no
anchor evaluations, generation on the base weights), LPIPS in the metrics
and in --fast-decode-verify, online FVD and its resume.

The tower files are chip_smoke.py's synthetic checkpoints (tiny CLIP and
X-CLIP geometry; LPIPS, I3D and InceptionV3 at their fixed published
geometries), written on the CPU. FID through the runner is driven on the
card by chip_smoke's [eval] phase: its 2048-d sqrtm takes seconds here.
Tolerances: the gate score 1e-5 absolute against the JAX scorer; the
resumed FVD equal to the unbroken run's to 1e-9 relative (the same
float64 moments).
"""

import json
import os

import numpy as np
import pytest
import torch

import chip_smoke
from longcat_video_tta_tpu.config import ClipGateConfig as JGateConfig
from longcat_video_tta_tpu.eval import frechet as jfrechet
from longcat_video_tta_tpu.tta import clip_gate as jgate
from longcat_video_tta_tpu_torch.config import longcat_tiny
from longcat_video_tta_tpu_torch.data.video_io import load_video_frames
from longcat_video_tta_tpu_torch.ops import flash_attention as fa
from longcat_video_tta_tpu_torch.runners import run_tta

torch.set_num_threads(2)

TINY_CLIP = dict(vocab=100, max_len=16, text_width=32, text_layers=2, text_heads=4,
                 vision_width=32, vision_layers=2, vision_heads=4, patch=8, image=32,
                 proj=24, frames=8, mit_layers=1, mit_heads=4, prompt_layers=2,
                 prompt_heads=4)
L = longcat_tiny().dit.depth
INFERENCE_STEPS = 2


@pytest.fixture(scope="module")
def towers(tmp_path_factory):
    return chip_smoke.write_tower_files(str(tmp_path_factory.mktemp("towers")), 3, "cpu",
                                        clip_geometry=TINY_CLIP)


def _argv(out, method="delta_a", videos=1, extra=()):
    return ["--method", method, "--preset", "longcat_tiny", "--synthetic", str(videos),
            "--device", "cpu", "--output-dir", str(out), "--height", "48", "--width", "64",
            "--num-cond-frames", "5", "--num-frames", "5", "--gen-start-frame", "16",
            "--tta-total-frames", "13", "--steps", "2", "--es-check-every", "2",
            "--num-inference-steps", str(INFERENCE_STEPS), "--caption-guard-mode", "off",
            "--no-save-videos", *extra]


def test_gate_and_online_eval_summary(towers, tmp_path):
    """A log-only CLIP gate, LPIPS and online FVD on 2 videos: the JAX
    runner's keys, the JAX scorer's score on the same window, finite
    metrics, the moments saved with the checkpoint cursor."""
    out = tmp_path / "run"
    summary = run_tta.main(_argv(out, videos=2, extra=[
        "--clip-gate-enabled", "--clip-gate-model-path", towers["clip"],
        "--clip-gate-hash-tokenizer", "--clip-gate-log-only", "--clip-gate-threshold", "0.9",
        "--lpips-model-path", towers["lpips"], "--fvd-enabled",
        "--i3d-model-path", towers["i3d"], "--min-fvd-videos", "2"]))
    with open(out / "summary.json") as f:
        on_disk = json.load(f)
    assert summary["num_success"] == 2
    jscorer = jgate.make_tpu_clip_scorer(towers["clip"], "clip", allow_hash_tokenizer=True)
    jcfg = JGateConfig(enabled=True, log_only=True, threshold=0.9)
    for r in on_disk["results"]:
        window = load_video_frames(r["path"], 13, 48, 64, start_frame=16 - 13)
        ref = jgate.evaluate_clip_gate((window[0].transpose(1, 2, 3, 0) + 1) / 2,
                                       r["caption"], jcfg, jscorer)
        assert set(ref) | {"clip_gate_eval_time"} <= set(r)
        assert r["clip_gate_frame_offsets"] == ref["clip_gate_frame_offsets"]
        assert abs(r["clip_gate_score"] - ref["clip_gate_score"]) <= 1e-5
        assert r["skip_tta"] is False and ref["skip_tta"] is False  # log-only
        assert r["clip_gate_eval_time"] > 0 and np.isfinite(r["lpips"]) and r["losses"]
    assert set(on_disk["clip_gate_stats"]) == set(
        jgate.summarize_clip_gate_stats([ref]))
    assert on_disk["clip_gate_stats"]["num_evaluated"] == 2
    oe = on_disk["online_eval"]
    assert set(oe) == set(jfrechet.OnlineFrechetAccumulator().compute())
    assert oe["num_videos"] == 2 and np.isfinite(oe["fvd"]) and oe["fid"] is None
    assert np.isfinite(on_disk["metrics"]["lpips"]["mean"])
    with np.load(out / "fvd_state.npz") as z:
        assert int(z["next_idx"]) == 2 and int(z["num_pairs"]) == 2


@pytest.mark.parametrize("method,backend", [("delta_a", "clip"), ("dno", "xclip")])
def test_skip_path_trains_nothing(towers, tmp_path, monkeypatch, method, backend):
    """Threshold 2.0 (above any cosine): TTA is skipped. No losses, no
    anchor evaluation, train_time 0, no backward call; the attention
    forwards are one generation's (chip_smoke's method_launches)."""
    calls = {"flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0}
    ref_fwd, ref_bwd = fa.attention_reference, fa.FlashAttentionFunction.backward

    def fwd(*a, **k):
        calls["flash_fwd"] += 1
        return ref_fwd(*a, **k)

    def bwd(ctx, do):
        calls["flash_bwd_dq"] += int(ctx.needs_input_grad[0])
        calls["flash_bwd_dkv"] += int(ctx.needs_input_grad[1] or ctx.needs_input_grad[2])
        return ref_bwd(ctx, do)

    monkeypatch.setattr(fa, "attention_reference", fwd)
    monkeypatch.setattr(fa.FlashAttentionFunction, "backward", staticmethod(bwd))
    summary = run_tta.main(_argv(tmp_path / "run", method=method, extra=[
        "--clip-gate-enabled", "--clip-gate-backend", backend,
        "--clip-gate-model-path", towers[backend], "--clip-gate-hash-tokenizer",
        "--clip-gate-threshold", "2.0"]))
    r = summary["results"][0]
    assert r["success"] and r["skip_tta"] is True and np.isfinite(r["clip_gate_score"])
    assert r["train_time"] == 0 and r["es_check_time"] == 0
    assert not {"losses", "early_stopping_info", "noise_norm", "adapter_norm"} & set(r)
    assert np.isfinite(r["psnr"])
    assert calls == chip_smoke.method_launches("t_embed", L, steps=0, anchors=0,
                                               inference_steps=INFERENCE_STEPS)
    assert summary["clip_gate_stats"]["num_skipped"] == 1


def test_fast_decode_verify_records_lpips(towers, tmp_path):
    summary = run_tta.main(_argv(tmp_path / "run", method="none", extra=[
        "--fast-decode", "--fast-decode-verify", "1",
        "--lpips-model-path", towers["lpips"]]))
    rec = summary["results"][0]["fast_decode_verify"]
    assert np.isfinite(rec["lpips_dense"]) and np.isfinite(rec["lpips_delta"])
    assert rec["lpips_delta"] == pytest.approx(
        summary["results"][0]["lpips"] - rec["lpips_dense"])
    assert summary["fast_decode_verify"]["lpips_delta_mean"] == pytest.approx(
        rec["lpips_delta"])


def test_stopped_and_resumed_run_keeps_fvd(towers, tmp_path):
    """3 videos, drained after the first by the stop file, then resumed:
    the same FVD and num_videos as one unbroken run."""
    extra = ["--fvd-enabled", "--i3d-model-path", towers["i3d"]]
    whole = run_tta.main(_argv(tmp_path / "whole", method="none", videos=3, extra=extra))
    stop = str(tmp_path / "STOP_NOW")

    def touch_after_first(name):
        if name == "video_end" and not os.path.exists(stop):
            open(stop, "w").close()

    out = tmp_path / "resumed"
    argv = _argv(out, method="none", videos=3, extra=extra + ["--stop-file", stop])
    drained = run_tta.main(argv, on_phase=touch_after_first)
    assert drained == {"drained": True, "next_idx": 1, "num_videos": 1}
    with np.load(out / "fvd_state.npz") as z:
        assert int(z["next_idx"]) == 1
    os.remove(stop)
    resumed = run_tta.main(argv)
    assert resumed["num_videos"] == whole["num_videos"] == 3
    assert resumed["online_eval"]["num_videos"] == whole["online_eval"]["num_videos"] == 3
    assert resumed["online_eval"]["fvd"] == pytest.approx(whole["online_eval"]["fvd"],
                                                          rel=1e-9)
