"""PyTorch port generate_vc, metrics and runner vs the JAX package.

- ``generate_vc`` on longcat_tiny with the same weights and the same
  full-size ``init_noise`` given to both (JAX and torch draws differ),
  on the KV-cache and the no-cache paths. fp32; tolerance 1e-4 abs on
  pixels in [0, 1] (measured ~4e-6).
- PSNR/SSIM against eval/metrics.py on textured frames (and a flat one,
  where the reference SSIM formula has no variance clamp); 1e-4 abs.
- The runner (``--method none``, ``--device cpu``) writes summary.json
  and checkpoint.json with the JAX runner's keys for the same arguments.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from longcat_video_tta_tpu.config import longcat_tiny as jax_tiny
from longcat_video_tta_tpu.eval import metrics as jmetrics
from longcat_video_tta_tpu.pipeline import ModelBundle as JaxBundle
from longcat_video_tta_tpu.pipeline import generate_vc as jax_generate_vc
from longcat_video_tta_tpu.pipeline.pipeline import HashTokenizer as JaxTok
from longcat_video_tta_tpu.runners import run_tta as jax_run_tta
from longcat_video_tta_tpu_torch.config import longcat_tiny
from longcat_video_tta_tpu_torch.eval import metrics as tmetrics
from longcat_video_tta_tpu_torch.ops import flash_attention as fa
from longcat_video_tta_tpu_torch.pipeline.pipeline import (
    HashTokenizer,
    ModelBundle,
    generate_vc,
    round_frames_4k1,
)
from longcat_video_tta_tpu_torch.runners import run_tta

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def bundles():
    jb = JaxBundle.init_random(jax_tiny(), seed=0)
    tonp = lambda t: jax.tree.map(np.asarray, t)
    tb = ModelBundle.from_numpy(longcat_tiny(), tonp(jb.dit_params),
                                tonp(jb.vae_params), tonp(jb.text_params),
                                device="cpu")
    return jb, tb


@pytest.mark.parametrize("use_kv_cache", [True, False])
def test_generate_vc_matches_jax(bundles, use_kv_cache):
    jb, tb = bundles
    rng = np.random.default_rng(0)
    cond = rng.uniform(-1, 1, (1, 3, 5, 16, 32)).astype(np.float32)
    # 5 generated frames -> 2 latents of 2 x 4 (16x32 pixels / 8)
    noise = rng.standard_normal((1, 16, 2, 2, 4)).astype(np.float32)
    kw = dict(num_frames=5, num_inference_steps=3, guidance_scale=4.0,
              negative_prompt="blurry", use_kv_cache=use_kv_cache)
    ref = jax_generate_vc(jb, jnp.asarray(cond), "a ball moving",
                          init_noise=jnp.asarray(noise), **kw)
    fa.reset_launches()
    phases = []
    out = generate_vc(tb, cond, "a ball moving",
                      init_noise=torch.from_numpy(noise), on_phase=phases.append,
                      **kw)
    assert fa.launches == 0  # CPU tensors: the plain version, no kernel
    assert phases == (["vae_encode", "prompt_encode"]
                      + ["cond_cache"] * use_kv_cache + ["step"] * 3
                      + ["vae_decode", "end"])
    assert out.shape == ref.shape == (5, 16, 32, 3)
    np.testing.assert_allclose(out, np.asarray(ref), atol=1e-4)


def test_hash_tokenizer_and_frame_rounding_match():
    for text in ("a ball moving across the scene", "", "Waves  ROLLING"):
        for a, b in zip(HashTokenizer(512, 16)(text), JaxTok(512, 16)(text)):
            np.testing.assert_array_equal(a, b)
    from longcat_video_tta_tpu.pipeline.pipeline import round_frames_4k1 as jr

    assert [round_frames_4k1(n) for n in range(1, 30)] == [jr(n) for n in range(1, 30)]


def _textured(seed, flat=False):
    rng = np.random.default_rng(seed)
    yy, xx = np.meshgrid(np.linspace(0, 1, 24), np.linspace(0, 1, 32),
                         indexing="ij")
    base = 0.5 + 0.4 * np.sin(12 * xx + 7 * yy + seed)
    frames = base[None, :, :, None] + 0.1 * rng.standard_normal((3, 24, 32, 3))
    if flat:
        frames[1] = 0.5
    return np.clip(frames, 0, 1).astype(np.float32)


@pytest.mark.parametrize("flat", [False, True])
def test_psnr_ssim_match_reference(flat):
    pred, gt = _textured(1, flat), _textured(2)
    pj, pt = jnp.asarray(pred), torch.from_numpy(pred)
    gj, gtt = jnp.asarray(gt), torch.from_numpy(gt)
    np.testing.assert_allclose(tmetrics.psnr_per_frame(pt, gtt).numpy(),
                               np.asarray(jmetrics.psnr_per_frame(pj, gj)),
                               atol=1e-4)
    np.testing.assert_allclose(tmetrics.ssim_per_frame(pt, gtt).numpy(),
                               np.asarray(jmetrics.ssim_per_frame(pj, gj)),
                               atol=1e-4)
    mt = tmetrics.evaluate_generation_metrics(pred, gt)
    mj = jmetrics.evaluate_generation_metrics(pred, gt)
    assert set(mt) == set(mj) and np.isnan(mt["lpips"]) and np.isnan(mj["lpips"])
    for key in ("psnr", "ssim"):
        assert abs(mt[key] - mj[key]) < 1e-4
    assert mt["num_frames_scored"] == mj["num_frames_scored"] == 3


def test_npy_clip_loading_matches_reference(tmp_path):
    from longcat_video_tta_tpu.data import video_io as jio
    from longcat_video_tta_tpu_torch.data import video_io as tio

    rng = np.random.default_rng(5)
    path = str(tmp_path / "clip.npy")
    np.save(path, rng.integers(0, 256, (20, 16, 24, 3), dtype=np.uint8))
    for kw in (dict(start_frame=3), dict(start_frame=2, target_fps=12.0),
               dict(start_frame=18)):  # the last pads with the final frame
        np.testing.assert_array_equal(
            tio.load_video_frames(path, 5, 16, 24, **kw),
            jio.load_video_frames(path, 5, 16, 24, **kw))
    np.testing.assert_array_equal(tio.load_gt_frames(path, 4, 16, 24, 7),
                                  jio.load_gt_frames(path, 4, 16, 24, 7))
    assert tio.load_video_frames(path, 2, 8, 12).shape == (1, 3, 2, 8, 12)
    with pytest.raises(ValueError, match="only .npy"):
        tio.decode_frames(str(tmp_path / "clip.mp4"), 4)


RUN_ARGS = ["--method", "none", "--preset", "longcat_tiny", "--synthetic", "2",
            "--height", "16", "--width", "32", "--num-cond-frames", "5",
            "--num-frames", "5", "--gen-start-frame", "16",
            "--num-inference-steps", "2", "--caption-guard-mode", "off"]


def test_runner_summary_keys_match_jax_runner(tmp_path):
    j_out, t_out = str(tmp_path / "jax"), str(tmp_path / "torch")
    js = jax_run_tta.main(RUN_ARGS + ["--output-dir", j_out, "--attn-impl", "xla"])
    ts = run_tta.main(RUN_ARGS + ["--output-dir", t_out, "--device", "cpu"])
    assert ts["num_success"] == js["num_success"] == 2
    for out in (j_out, t_out):
        assert os.path.exists(os.path.join(out, "config.json"))
    with open(os.path.join(t_out, "summary.json")) as f:
        t_summary = json.load(f)
    with open(os.path.join(j_out, "summary.json")) as f:
        j_summary = json.load(f)
    assert set(t_summary) == set(j_summary)
    assert set(t_summary["metrics"]) == set(j_summary["metrics"])
    assert set(t_summary["metrics"]["psnr"]) == set(j_summary["metrics"]["psnr"])
    assert set(t_summary["results"][0]) == set(j_summary["results"][0])
    with open(os.path.join(t_out, "checkpoint.json")) as f:
        t_ckpt = json.load(f)
    with open(os.path.join(j_out, "checkpoint.json")) as f:
        j_ckpt = json.load(f)
    assert set(t_ckpt) == set(j_ckpt) and t_ckpt["next_idx"] == 2
    for r in t_summary["results"]:
        assert np.isfinite(r["psnr"]) and np.isfinite(r["ssim"])


def test_runner_rejects_unported_method(tmp_path):
    """Every --method runs; an option that is not ported (the native
    prefetch loader) still raises before any work."""
    with pytest.raises(SystemExit):
        run_tta.main(["--method", "film", "--native-prefetch", "--output-dir",
                      str(tmp_path), "--device", "cpu", "--synthetic", "1"])
    assert not os.listdir(tmp_path)
