"""The port's runner on CogVideoX (``--preset cogvideox_tiny --device cpu
--synthetic 2``): none, delta_a, lora and full succeed with finite values
and the JAX runner's summary and result keys for the same arguments (and
delta_a's trainable count equal to the JAX runner's); the start-up
refusals for this backbone carry the JAX runner's messages; the launch
derivation chip_smoke gates the card's runs with, on the CPU path."""

import json
import os

import numpy as np
import pytest
import torch

from longcat_video_tta_tpu.runners import run_tta as jax_run_tta
from longcat_video_tta_tpu_torch.ops import flash_attention as fa
from longcat_video_tta_tpu_torch.runners import run_tta

torch.set_num_threads(1)


def _argv(out_dir, method, *extra):
    return ["--method", method, "--preset", "cogvideox_tiny", "--synthetic", "2",
            "--output-dir", str(out_dir), "--height", "32", "--width", "48",
            "--num-cond-frames", "5", "--num-frames", "5", "--gen-start-frame", "16",
            "--tta-total-frames", "13", "--steps", "2", "--es-check-every", "2",
            "--num-inference-steps", "2", "--no-save-videos", *extra]


@pytest.fixture(scope="module")
def jax_delta_a(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax_delta_a")
    return jax_run_tta.main(_argv(out, "delta_a", "--attn-impl", "xla"))


@pytest.mark.parametrize("method", ["none", "delta_a", "lora", "full"])
def test_runner_methods_match_jax_keys(tmp_path, jax_delta_a, method):
    fa.reset_launches()
    summary = run_tta.main(_argv(tmp_path, method, "--device", "cpu"))
    assert fa.launches == 0  # the CPU path: plain versions only
    assert summary["num_success"] == 2
    with open(os.path.join(tmp_path, "summary.json")) as f:
        assert json.load(f)["num_success"] == 2
    assert set(summary) == set(jax_delta_a)
    for r in summary["results"]:
        assert np.isfinite([r["psnr"], r["ssim"]]).all()
        if method == "none":
            assert "losses" not in r
            continue
        assert set(r) == set(jax_delta_a["results"][0])
        history = [x for _, x in r["early_stopping_info"]["loss_history"]]
        assert len(r["losses"]) == 2 and np.isfinite(r["losses"] + history).all()
        assert r["trainable_params"] > 0
    if method == "delta_a":  # the 32-d time embedding, as the JAX runner counts
        assert [r["trainable_params"] for r in summary["results"]] == \
            [r["trainable_params"] for r in jax_delta_a["results"]] == [32, 32]


REFUSALS = [
    ("delta_a", ["--bucket-shapes"]),
    ("none", ["--bsa-keep-ratio", "0.3", "--bucket-gen"]),
    ("none", ["--quantize-decode", "int8qk"]),
    ("dno", []),
    ("delta_b", []),
    ("film", []),
    ("norm_tune", []),
]


@pytest.mark.parametrize("method,flags", REFUSALS,
                         ids=["bucket_shapes", "bsa_bucket_gen", "int8qk", "dno", "delta_b",
                              "film", "norm_tune"])
def test_runner_refusals_match_jax(tmp_path, method, flags):
    """The same exception type and message as the JAX runner (SystemExit
    for the flag refusals, build_scheme's ValueError for an unported
    method)."""
    with pytest.raises((SystemExit, ValueError)) as te:
        run_tta.main(_argv(tmp_path / "t", method, "--device", "cpu", *flags))
    with pytest.raises((SystemExit, ValueError)) as je:
        jax_run_tta.main(_argv(tmp_path / "j", method, "--attn-impl", "xla", *flags))
    assert type(te.value) is type(je.value)
    assert str(te.value) == str(je.value)


def test_runner_launch_derivation(tmp_path, monkeypatch):
    """The attention forwards, dQ and dK/dV backwards of a delta_a run with
    the lever flags (2 videos: 2 steps, the anchor at setup and after step
    2, a 2-step W8A8 generation with PAB and CFG reuse every 2), counted on
    the CPU path, against chip_smoke's ``joint_run_launches`` and
    ``joint_gen_launches`` that the card's gates use."""
    import chip_smoke
    from longcat_video_tta_tpu_torch.models.backbones import cogvideox_tiny

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
    summary = run_tta.main(_argv(tmp_path, "delta_a", "--device", "cpu", "--quantize-decode",
                                 "int8", "--pab-every", "2", "--cfg-reuse-every", "2",
                                 "--gen-segment-steps", "1"))
    assert summary["num_success"] == 2
    n_attn = cogvideox_tiny().dit.depth
    per_video = chip_smoke.joint_run_launches(n_attn, steps=2, anchors=2, anchor_draws=6,
                                              inference_steps=2)
    per_video["flash_fwd"] += (chip_smoke.joint_gen_launches(n_attn, steps=2, pab_every=2)
                               - chip_smoke.joint_gen_launches(n_attn, steps=2))
    assert calls == {k: 2 * n for k, n in per_video.items()}


def test_runner_takes_chip_smoke_depth_cut(tmp_path):
    """chip_smoke's ``preset_depth`` with a CogVideoX block count reaches
    the runner: ``full`` trains the cut DiT's parameters, the count
    chip_smoke's ``cogvideox_trainable`` derives."""
    import chip_smoke
    from longcat_video_tta_tpu_torch.models.backbones import cogvideox_tiny

    with chip_smoke.preset_depth(1, preset="cogvideox_tiny"):
        summary = run_tta.main(_argv(tmp_path, "full", "--device", "cpu"))
    cut = chip_smoke.cogvideox_trainable(
        "full", chip_smoke.depth_cut_config(1, "cogvideox_tiny").dit)
    assert cut < chip_smoke.cogvideox_trainable("full", cogvideox_tiny().dit)
    assert [r["trainable_params"] for r in summary["results"]] == [cut, cut]
