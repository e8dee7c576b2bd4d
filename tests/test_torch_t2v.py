"""The port's text-to-video path against the JAX package's.

- ``generate_t2v`` on longcat_tiny with the same weights
  (``models/weights.py`` from the JAX tree) and the same ``init_noise``:
  the JAX reference is its own ``generate_t2v`` composed by hand (JAX
  ``sample_latents(cond_latents=None, init_noise=...)`` then
  ``decode_latents``), since it takes no noise. Dense, and with PAB and
  CFG reuse every 2; fp32, 1e-4 abs on pixels in [0, 1].
- ``run_t2v`` in prompt and --data-dir modes writes ``t2v_XXX.npy`` and a
  summary.json whose keys equal the JAX runner's.
- chip_smoke's ``t2v_launches`` equals the plain path's attention calls.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from longcat_video_tta_tpu.config import CFGReuseConfig as JCFGR
from longcat_video_tta_tpu.config import PABConfig as JPAB
from longcat_video_tta_tpu.config import longcat_tiny as jax_tiny
from longcat_video_tta_tpu.pipeline import ModelBundle as JaxBundle
from longcat_video_tta_tpu.pipeline.sampler import sample_latents as jax_sample_latents
from longcat_video_tta_tpu.runners import run_t2v as jax_run_t2v
from longcat_video_tta_tpu_torch.config import CFGReuseConfig, PABConfig, longcat_tiny
from longcat_video_tta_tpu_torch.ops import flash_attention as fa
from longcat_video_tta_tpu_torch.pipeline.pipeline import ModelBundle, generate_t2v
from longcat_video_tta_tpu_torch.runners import run_t2v

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def bundles():
    jb = JaxBundle.init_random(jax_tiny(), seed=0)
    tonp = lambda t: jax.tree.map(np.asarray, t)
    tb = ModelBundle.from_numpy(longcat_tiny(), tonp(jb.dit_params), tonp(jb.vae_params),
                                tonp(jb.text_params), device="cpu")
    return jb, tb


def jax_t2v(jb, prompt, noise, *, num_frames, steps, guidance, negative, pab, cfgr):
    """JAX ``generate_t2v`` with ``init_noise`` passed to its sampler."""
    cfg = jb.cfg
    nf = ((num_frames - 1 + 3) // 4) * 4 + 1
    emb, mask = jb.encode_prompt(prompt)
    nemb, nmask = jb.encode_prompt(negative)
    lat = jax_sample_latents(
        jb.dit_params, cfg.dit, cfg.scheduler, jax.random.PRNGKey(0), emb, mask, nemb,
        nmask, guidance, num_gen_latents=noise.shape[2], num_steps=steps,
        lat_h=noise.shape[3], lat_w=noise.shape[4], cond_latents=None,
        pab_cfg=JPAB(every=pab) if pab else None,
        cfgr_cfg=JCFGR(every=cfgr) if cfgr else None, init_noise=jnp.asarray(noise))
    return np.asarray(jb.decode_latents(lat)[0].transpose(1, 2, 3, 0)[:nf])


CASES = {"dense": dict(num_frames=5, steps=3, pab=0, cfgr=0),
         "pab_cfg_reuse": dict(num_frames=5, steps=4, pab=2, cfgr=2),
         "frames_rounded_up": dict(num_frames=7, steps=2, pab=0, cfgr=0)}


@pytest.mark.parametrize("case", CASES)
def test_generate_t2v_matches_jax(bundles, case):
    jb, tb = bundles
    c = CASES[case]
    n_lat = ((c["num_frames"] - 1 + 3) // 4) + 1
    noise = np.random.default_rng(1).standard_normal((1, 16, n_lat, 2, 4)).astype(np.float32)
    ref = jax_t2v(jb, "a ball moving", noise, num_frames=c["num_frames"], steps=c["steps"],
                  guidance=4.0, negative="blurry", pab=c["pab"], cfgr=c["cfgr"])
    phases = []
    out = generate_t2v(tb, "a ball moving", num_frames=c["num_frames"], height=16,
                       width=32, num_inference_steps=c["steps"], guidance_scale=4.0,
                       negative_prompt="blurry", init_noise=torch.from_numpy(noise),
                       pab_cfg=PABConfig(every=c["pab"]) if c["pab"] else None,
                       cfgr_cfg=CFGReuseConfig(every=c["cfgr"]) if c["cfgr"] else None,
                       on_phase=phases.append)
    assert phases == ["prompt_encode"] + ["step"] * c["steps"] + ["vae_decode", "end"]
    assert out.shape == ref.shape == (4 * n_lat - 3, 16, 32, 3)
    np.testing.assert_allclose(out, ref, atol=1e-4)


def test_generate_t2v_draws_from_seed_or_generator(bundles):
    _, tb = bundles
    kw = dict(num_frames=5, height=16, width=32, num_inference_steps=2)
    a = generate_t2v(tb, "waves", seed=7, **kw)
    b = generate_t2v(tb, "waves", generator=torch.Generator().manual_seed(7), **kw)
    c = generate_t2v(tb, "waves", seed=8, **kw)
    np.testing.assert_array_equal(a, b)
    assert np.abs(a - c).max() > 0 and np.isfinite(a).all()
    assert 0.0 <= a.min() and a.max() <= 1.0


@pytest.mark.parametrize("steps,pab,cfgr", [(4, 0, 0), (4, 2, 2), (8, 2, 0), (5, 3, 2)])
def test_t2v_launches_match_plain_attention_calls(bundles, monkeypatch, steps, pab, cfgr):
    _, tb = bundles
    calls = [0]
    ref = fa.attention_reference

    def counted(*a, **k):
        calls[0] += 1
        return ref(*a, **k)

    monkeypatch.setattr(fa, "attention_reference", counted)
    generate_t2v(tb, "a ball", num_frames=5, height=16, width=32,
                 num_inference_steps=steps,
                 pab_cfg=PABConfig(every=pab) if pab else None,
                 cfgr_cfg=CFGReuseConfig(every=cfgr) if cfgr else None)
    assert calls[0] == chip_smoke.t2v_launches(tb.cfg.dit.depth, steps, pab, cfgr)


def test_generate_t2v_refuses_joint_backbones():
    from longcat_video_tta_tpu_torch.config import get_model_config

    tb = ModelBundle.init_random(get_model_config("cogvideox_tiny"), seed=0, device="cpu")
    with pytest.raises(NotImplementedError, match="LongCat"):
        generate_t2v(tb, "a ball", num_frames=5, height=16, width=32,
                     num_inference_steps=1)


T2V_ARGS = ["--preset", "longcat_tiny", "--num-frames", "5", "--height", "16",
            "--width", "32", "--num-inference-steps", "2", "--seed", "3"]


@pytest.fixture(scope="module")
def jax_summary(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("jax_t2v"))
    jax_run_t2v.main(["--prompt", "a ball", "--output-dir", out,
                      "--compile-cache-dir", "off"] + T2V_ARGS)
    with open(os.path.join(out, "summary.json")) as f:
        return json.load(f)


def test_run_t2v_prompt_mode_keys_match_jax(jax_summary, tmp_path):
    results = run_t2v.main(["--prompt", "a ball", "--output-dir", str(tmp_path),
                            "--device", "cpu", "--pab-every", "2",
                            "--cfg-reuse-every", "2"] + T2V_ARGS)
    with open(tmp_path / "summary.json") as f:
        summary = json.load(f)
    assert set(summary) == set(jax_summary)
    assert set(summary["results"][0]) == set(jax_summary["results"][0])
    assert summary["results"] == results and len(results) == 1
    clip = np.load(tmp_path / "t2v_000.npy")
    assert results[0]["video_path"] == str(tmp_path / "t2v_000.npy")
    assert clip.shape == (5, 16, 32, 3) and clip.dtype == np.uint8


def test_run_t2v_data_dir_mode(tmp_path):
    from longcat_video_tta_tpu_torch.runners.run_tta import make_synthetic_dataset

    data = make_synthetic_dataset(str(tmp_path / "data"), 2, 16, 32, seed=3)
    out = tmp_path / "out"
    results = run_t2v.main(["--data-dir", data, "--output-dir", str(out), "--device",
                            "cpu", "--max-videos", "2"] + T2V_ARGS)
    assert [os.path.basename(r["video_path"]) for r in results] == \
        ["t2v_000.npy", "t2v_001.npy"]
    assert all(r["num_frames"] == 5 and r["prompt"] for r in results)
    with pytest.raises(SystemExit):
        run_t2v.main(["--output-dir", str(out), "--device", "cpu"] + T2V_ARGS)
