"""The port's decode levers vs the JAX package on longcat_tiny (the same
weights through models/weights.py, the same injected noise; fp32 on the
CPU, where the port runs its plain versions and JAX its Pallas kernels in
interpret mode).

Tolerances:
- DiT forwards and the sampler: 1e-4 abs / 1e-4 rel, as
  test_torch_models.py (summation order only; block selection is exact);
- with int8 QK^T or W8A8: 2e-3 abs. Activations are quantized per token
  from fp32 values that differ in the last bits, so a value on a rounding
  boundary can land one int8 step (1/127 of its token's range) apart;
  and int8 QK^T rounds p to bf16 at another running maximum;
- generate_vc pixels in [0, 1]: 1e-4 abs, 2e-3 with int8;
- the segmented sampler: bit-equal to the one-pass sampler.
"""

import argparse
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from longcat_video_tta_tpu import config as jconfig
from longcat_video_tta_tpu.models import dit as jdit
from longcat_video_tta_tpu.pipeline import ModelBundle as JaxBundle
from longcat_video_tta_tpu.pipeline import generate_vc as jax_generate_vc
from longcat_video_tta_tpu.pipeline import sampler as jsampler
from longcat_video_tta_tpu.runners import run_tta as jax_run_tta
from longcat_video_tta_tpu_torch import config as tconfig
from longcat_video_tta_tpu_torch.config import longcat_tiny
from longcat_video_tta_tpu_torch.models.dit import pab_init_cache
from longcat_video_tta_tpu_torch.ops import bsa
from longcat_video_tta_tpu_torch.pipeline import sampler as tsampler
from longcat_video_tta_tpu_torch.pipeline.pipeline import ModelBundle, generate_vc
from longcat_video_tta_tpu_torch.runners import run_tta
from longcat_video_tta_tpu_torch.tta.bucket import DEFAULT_BUCKETS, bucket_len

torch.set_num_threads(1)

TOL = dict(atol=1e-4, rtol=1e-4)
INT8_TOL = dict(atol=2e-3, rtol=0)
JCFG = jconfig.longcat_tiny()
TCFG = longcat_tiny()


@pytest.fixture(scope="module")
def bundles():
    jb = JaxBundle.init_random(JCFG, seed=0)
    tonp = lambda t: jax.tree.map(np.asarray, t)
    tb = ModelBundle.from_numpy(TCFG, tonp(jb.dit_params), tonp(jb.vae_params),
                                tonp(jb.text_params), device="cpu")
    return jb, tb


@pytest.fixture(scope="module")
def inputs():
    """2 cond + 2 noise latents of 8 x 12 (24 tokens each): 96 keys in 12
    blocks of 8, 6 of them conditioning."""
    rng = np.random.default_rng(0)
    lat = rng.standard_normal((2, 16, 4, 8, 12)).astype(np.float32)
    text = rng.standard_normal((2, 16, 48)).astype(np.float32)
    mask = np.ones((2, 16), np.int32)
    mask[:, 10:] = 0
    return lat, text, mask


def _bsa(jax_side: bool, **kw):
    cls = jconfig.BSAConfig if jax_side else tconfig.BSAConfig
    return cls(**{**dict(keep_ratio=0.6, block_q=8, block_k=8, min_blocks=1), **kw})


FWD_CASES = {
    # bsa kwargs or None, qk_int8, num_valid_latents, PAB mode, cond half
    "bsa": (dict(), None, None, False),
    "bsa_qk_int8": (dict(qk_int8=True), None, None, False),
    "kv_valid": (None, 1, None, False),
    "bsa_kv_valid": (dict(), 1, None, False),
    "pab_compute": (None, None, "compute", False),
    "pab_reuse": (dict(), None, "reuse", False),
    "cond_half_pab_compute": (dict(), None, "compute", True),
    "cond_half_pab_reuse": (None, None, "reuse", True),
}


@pytest.mark.parametrize("case", list(FWD_CASES))
def test_forward_with_cache_levers_match_jax(bundles, inputs, case):
    jb, tb = bundles
    bsa_kw, nv, pab, half = FWD_CASES[case]
    lat, text, mask = inputs
    cache = jdit.dit_precompute_cond_cache(jb.dit_params, JCFG.dit, jnp.asarray(lat[:, :, :2]),
                                           jnp.asarray(text), jnp.asarray(mask))
    nb = 1 if half else 2
    noise, ts = lat[:nb, :, 2:], np.full((nb,), 640.0, np.float32)
    rng = np.random.default_rng(1)
    pab_np = (rng.standard_normal((2, 2, 2, 24, 64)).astype(np.float32)
              if pab else None)  # [depth, 2B, nt, nhw, D]
    jkw = dict(num_cond_latents=2,
               bsa_cfg=None if bsa_kw is None else _bsa(True, **bsa_kw),
               num_valid_latents=None if nv is None else jnp.int32(nv),
               cache_cond_half=half)
    if pab:
        jkw.update(pab_reuse=jnp.bool_(pab == "reuse"), pab_cache=jnp.asarray(pab_np))
    ref = jdit.dit_forward_with_cache(jb.dit_params, JCFG.dit, jnp.asarray(noise),
                                      jnp.asarray(ts), jnp.asarray(text[-nb:]),
                                      jnp.asarray(mask[-nb:]), cache, **jkw)
    ref_cache = None
    if pab:
        ref, ref_cache = ref
    t_cache = tuple(torch.from_numpy(np.array(c)) for c in cache)
    t_pab = None if pab_np is None else torch.from_numpy(pab_np.copy())
    bsa.reset_launches()
    with torch.no_grad():
        out = tb.dit.forward_with_cache(
            torch.from_numpy(noise), torch.from_numpy(ts), torch.from_numpy(text[-nb:]),
            torch.from_numpy(mask[-nb:]), t_cache, num_cond_latents=2,
            bsa_cfg=None if bsa_kw is None else _bsa(False, **bsa_kw),
            num_valid_latents=nv, pab_reuse=pab == "reuse", pab_cache=t_pab,
            cache_cond_half=half)
    assert bsa.bsa_launches == bsa.bsa_int8_launches == 0
    tol = INT8_TOL if bsa_kw and bsa_kw.get("qk_int8") else TOL
    ref = np.asarray(ref)
    if nv is not None:  # pad outputs are garbage in both packages
        out, ref = out[:, :, :nv], ref[:, :, :nv]
    np.testing.assert_allclose(out.numpy(), ref, **tol)
    if pab:
        # the cache row the forward used: all of it, or its conditional half
        used = t_pab[:, 2 - nb:].numpy()
        np.testing.assert_allclose(used, np.asarray(ref_cache), **tol)
        if half:  # the unconditional half is untouched
            np.testing.assert_array_equal(t_pab[:, :1].numpy(), pab_np[:, :1])


def test_dense_forward_valid_count_and_pab_match_jax(bundles, inputs):
    """The no-cache forward with a valid count and PAB (the t2v sampler's
    path)."""
    jb, tb = bundles
    lat, text, mask = inputs
    ts = np.full((2,), 500.0, np.float32)
    pab_np = np.zeros((2, 2, 4, 24, 64), np.float32)
    ref, ref_cache = jdit.dit_forward(
        jb.dit_params, JCFG.dit, jnp.asarray(lat), jnp.asarray(ts), jnp.asarray(text),
        jnp.asarray(mask), num_valid_latents=jnp.int32(3), pab_reuse=jnp.bool_(False),
        pab_cache=jnp.asarray(pab_np))
    t_pab = torch.from_numpy(pab_np.copy())
    with torch.no_grad():
        out = tb.dit(torch.from_numpy(lat), torch.from_numpy(ts), torch.from_numpy(text),
                     torch.from_numpy(mask), num_valid_latents=3, pab_cache=t_pab)
    np.testing.assert_allclose(out[:, :, :3].numpy(), np.asarray(ref)[:, :, :3], **TOL)
    np.testing.assert_allclose(t_pab[:, :, :3].numpy(), np.asarray(ref_cache)[:, :, :3],
                               **TOL)


def test_pab_init_cache_shape():
    c = pab_init_cache(TCFG.dit, 4, 3, 8, 12)
    ref = jdit.pab_init_cache(JCFG.dit, 4, 3, 8, 12)
    assert tuple(c.shape) == ref.shape and float(c.abs().max()) == 0.0


@pytest.mark.parametrize("steps", [1, 2, 4, 8, 10, 50])
def test_reuse_flags_match_jax(steps):
    for every, start, end in ((2, 0.1, 0.9), (4, 0.06, 0.96), (3, 0.0, 1.0), (1, 0.1, 0.9)):
        for jcls, tcls in ((jconfig.PABConfig, tconfig.PABConfig),
                           (jconfig.CFGReuseConfig, tconfig.CFGReuseConfig)):
            jc, tc = jcls(every, start, end), tcls(every, start, end)
            assert tsampler._pab_reuse_flags(steps, tc) == \
                np.asarray(jsampler._pab_reuse_flags(steps, jc)).tolist()
            assert tsampler._cfg_reuse_flags(steps, tc) == \
                np.asarray(jsampler._cfg_reuse_flags(steps, jc)).tolist()


SAMPLE_CASES = {
    # bsa kwargs, PAB every, CFG-reuse every, num_valid, kv cache, cond
    "bsa": (dict(), 0, 0, None, True, True),
    "pab": (None, 2, 0, None, True, True),
    "cfg_reuse": (None, 0, 2, None, True, True),
    "bucket_valid": (dict(), 0, 0, 1, True, True),
    "all_composed": (dict(qk_int8=True), 2, 2, 1, True, True),
    "no_cache_cfg_reuse_valid": (None, 0, 2, 1, False, True),
    "t2v_pab_cfg_reuse": (None, 2, 2, None, True, False),
}


def _sample_inputs(inputs):
    lat, text, mask = inputs
    rng = np.random.default_rng(2)
    noise = rng.standard_normal((1, 16, 2, 8, 12)).astype(np.float32)
    return lat[:1, :, :2], text[:1], mask[:1], text[1:], mask[1:], noise


@pytest.mark.parametrize("case", list(SAMPLE_CASES))
def test_sample_latents_levers_match_jax(bundles, inputs, case):
    jb, tb = bundles
    bsa_kw, pab, cfgr, nv, kv, with_cond = SAMPLE_CASES[case]
    cond, emb, msk, nemb, nmsk, noise = _sample_inputs(inputs)
    kw = dict(num_gen_latents=2, num_steps=4, lat_h=8, lat_w=12, use_kv_cache=kv)
    ref = jsampler.sample_latents(
        jb.dit_params, JCFG.dit, JCFG.scheduler, jax.random.PRNGKey(0),
        *(jnp.asarray(a) for a in (emb, msk, nemb, nmsk)), 4.0,
        cond_latents=jnp.asarray(cond) if with_cond else None,
        bsa_cfg=None if bsa_kw is None else _bsa(True, **bsa_kw),
        pab_cfg=jconfig.PABConfig(every=pab, start_frac=0.0) if pab else None,
        cfgr_cfg=jconfig.CFGReuseConfig(every=cfgr, start_frac=0.0) if cfgr else None,
        num_valid_gen_latents=None if nv is None else jnp.int32(nv),
        init_noise=jnp.asarray(noise), **kw)
    tkw = dict(kw, cond_latents=torch.from_numpy(cond) if with_cond else None,
               bsa_cfg=None if bsa_kw is None else _bsa(False, **bsa_kw),
               pab_cfg=tconfig.PABConfig(every=pab, start_frac=0.0) if pab else None,
               cfgr_cfg=(tconfig.CFGReuseConfig(every=cfgr, start_frac=0.0)
                         if cfgr else None),
               num_valid_gen_latents=nv, init_noise=torch.from_numpy(noise))
    args = (tb.dit, TCFG.scheduler, *(torch.from_numpy(a) for a in (emb, msk, nemb, nmsk)),
            4.0)
    with torch.no_grad():
        out = tsampler.sample_latents(*args, **tkw)
        seg = tsampler.sample_latents_segmented(*args, segment_steps=3, **tkw)
    assert torch.equal(seg, out)
    n = 2 if nv is None else nv
    tol = INT8_TOL if bsa_kw and bsa_kw.get("qk_int8") else TOL
    np.testing.assert_allclose(out[:, :, :n].numpy(), np.asarray(ref)[:, :, :n], **tol)


GEN_CASES = {
    # quantize_decode, bsa kwargs, bucket_gen
    "int8": ("int8", None, False),
    "int8qk": ("int8qk", None, False),
    "bsa": ("none", dict(), False),
    "bucket_gen": ("none", None, True),
    "bucket_gen_bsa_int8qk": ("int8qk", dict(), True),
}


@pytest.mark.parametrize("case", list(GEN_CASES))
def test_generate_vc_levers_match_jax(bundles, case):
    jb, tb = bundles
    qd, bsa_kw, bucket = GEN_CASES[case]
    rng = np.random.default_rng(3)
    cond = rng.uniform(-1, 1, (1, 3, 5, 64, 96)).astype(np.float32)
    # 9 frames -> 3 latents (bucket 4) of 8 x 12
    n_lat = bucket_len(3) if bucket else 3
    noise = rng.standard_normal((1, 16, n_lat, 8, 12)).astype(np.float32)
    kw = dict(num_frames=9, num_inference_steps=2, guidance_scale=4.0,
              quantize_decode=qd, bucket_gen=bucket)
    ref = jax_generate_vc(jb, jnp.asarray(cond), "a ball moving",
                          bsa_cfg=None if bsa_kw is None else _bsa(True, **bsa_kw),
                          init_noise=jnp.asarray(noise), **kw)
    out = generate_vc(tb, cond, "a ball moving",
                      bsa_cfg=None if bsa_kw is None else _bsa(False, **bsa_kw),
                      init_noise=torch.from_numpy(noise), **kw)
    assert out.shape == np.asarray(ref).shape == (9, 64, 96, 3)
    atol = 2e-3 if qd != "none" else 1e-4
    np.testing.assert_allclose(out, np.asarray(ref), atol=atol, rtol=0)


def test_generate_vc_delta_with_levers_matches_jax(bundles):
    """delta_a's generation: the trained delta reaches forward_with_cache
    under W8A8, int8-QK BSA, PAB and CFG reuse at once."""
    jb, tb = bundles
    rng = np.random.default_rng(4)
    cond = rng.uniform(-1, 1, (1, 3, 5, 64, 96)).astype(np.float32)
    noise = rng.standard_normal((1, 16, 3, 8, 12)).astype(np.float32)
    delta = 10 * rng.standard_normal((TCFG.dit.adaln_tembed_dim,)).astype(np.float32)
    kw = dict(num_frames=9, num_inference_steps=4, guidance_scale=4.0,
              quantize_decode="int8qk")
    ref = jax_generate_vc(jb, jnp.asarray(cond), "a ball moving", bsa_cfg=_bsa(True),
                          pab_cfg=jconfig.PABConfig(every=2, start_frac=0.0),
                          cfgr_cfg=jconfig.CFGReuseConfig(every=2, start_frac=0.0),
                          init_noise=jnp.asarray(noise),
                          adapters={"delta_t": jnp.asarray(delta)}, **kw)
    tkw = dict(kw, bsa_cfg=_bsa(False), pab_cfg=tconfig.PABConfig(every=2, start_frac=0.0),
               cfgr_cfg=tconfig.CFGReuseConfig(every=2, start_frac=0.0),
               init_noise=torch.from_numpy(noise))
    out = generate_vc(tb, cond, "a ball moving",
                      adapters={"delta_t": torch.from_numpy(delta)}, **tkw)
    base = generate_vc(tb, cond, "a ball moving", **tkw)
    np.testing.assert_allclose(out, np.asarray(ref), atol=2e-3, rtol=0)
    assert float(np.abs(out - base).max()) > 1e-2  # the delta moved the video


def test_runner_delta_a_generates_with_levers(tmp_path):
    summary = run_tta.main(
        ["--method", "delta_a", "--preset", "longcat_tiny", "--synthetic", "1",
         "--device", "cpu", "--output-dir", str(tmp_path), "--height", "16",
         "--width", "32", "--num-cond-frames", "5", "--num-frames", "9",
         "--gen-start-frame", "16", "--tta-total-frames", "13", "--steps", "4",
         "--es-check-every", "2", "--num-inference-steps", "4",
         "--caption-guard-mode", "off", "--no-save-videos", "--fast-decode",
         "--quantize-decode", "int8qk"])
    assert summary["num_success"] == 1
    r = summary["results"][0]
    assert r["adapter_norm"] > 0 and np.isfinite(r["psnr"]) and np.isfinite(r["ssim"])
    cfg = summary["config"]
    assert (cfg["method"], cfg["quantize_decode"], cfg["pab_every"]) == ("delta_a",
                                                                        "int8qk", 4)


def test_quantized_dit_is_cached_per_source(bundles):
    _, tb = bundles
    from longcat_video_tta_tpu_torch.pipeline.pipeline import _quantized_cached

    q1 = _quantized_cached(tb, tb.dit)
    assert _quantized_cached(tb, tb.dit) is q1 and len(tb.int8_cache) == 1
    other = ModelBundle.init_random(TCFG, seed=5, device="cpu").dit
    assert _quantized_cached(tb, other) is not q1 and len(tb.int8_cache) == 1


def test_bucket_ladder_matches_jax():
    from longcat_video_tta_tpu.tta import bucket as jbucket

    assert DEFAULT_BUCKETS == jbucket.DEFAULT_BUCKETS
    assert [bucket_len(t) for t in range(0, 40)] == [jbucket.bucket_len(t)
                                                     for t in range(0, 40)]


# ---------------------------------------------------------------------------
# Runner
# ---------------------------------------------------------------------------

LEVER_KEYS = ("quantize_decode", "bsa_keep_ratio", "pab_every", "pab_start_frac",
              "pab_end_frac", "cfg_reuse_every", "cfg_reuse_start_frac",
              "cfg_reuse_end_frac", "gen_segment_steps", "bucket_gen")


@pytest.mark.parametrize("argv", [
    ["--fast-decode"],
    ["--fast-decode", "--num-frames", "93", "--num-inference-steps", "50"],
    ["--fast-decode", "--num-frames", "93", "--num-inference-steps", "10"],
    ["--fast-decode", "--no-kv-cache", "--num-frames", "93"],
    ["--fast-decode", "--pab-every", "3", "--bsa-keep-ratio", "0.2",
     "--quantize-decode", "int8qk", "--cfg-reuse-start-frac", "0.2"],
    ["--fast-decode", "--preset", "longcat_tiny"],
    ["--pab-every", "2", "--bucket-gen"],
])
def test_fast_decode_defaults_match_jax(argv, tmp_path):
    argv = argv + ["--output-dir", str(tmp_path)]
    ja = jax_run_tta.build_arg_parser().parse_args(argv)
    jax_run_tta.apply_fast_decode_defaults(ja)
    ta = run_tta.build_arg_parser().parse_args(argv)
    run_tta.apply_fast_decode_defaults(ta)
    assert {k: getattr(ta, k) for k in LEVER_KEYS} == {k: getattr(ja, k) for k in LEVER_KEYS}


TINY_RUN = ["--method", "none", "--preset", "longcat_tiny", "--synthetic", "1",
            "--height", "16", "--width", "32", "--num-cond-frames", "5",
            "--num-frames", "9", "--gen-start-frame", "16", "--num-inference-steps", "4",
            "--caption-guard-mode", "off", "--device", "cpu", "--no-save-videos"]


@pytest.mark.parametrize("flags,match", [
    (["--fast-decode-verify", "1"], "no decode lever"),
    (["--fast-decode-verify", "1", "--fast-decode", "--skip-generation"],
     "needs generation"),
    (["--no-kv-cache", "--pab-every", "2"], "--pab-every"),
    (["--no-kv-cache", "--bsa-keep-ratio", "0.5"], "--bsa-keep-ratio"),
    (["--no-kv-cache", "--quantize-decode", "int8qk"], "int8qk"),
])
def test_runner_refuses_bad_lever_combinations(tmp_path, flags, match):
    with pytest.raises(SystemExit, match=match):
        run_tta.main(TINY_RUN + ["--output-dir", str(tmp_path)] + flags)
    assert not os.path.exists(tmp_path / "summary.json")


def test_runner_fast_decode_verify_record(tmp_path):
    summary = run_tta.main(TINY_RUN + ["--output-dir", str(tmp_path), "--fast-decode",
                                       "--fast-decode-verify", "1"])
    assert summary["num_success"] == 1
    rec = summary["results"][0]["fast_decode_verify"]
    assert rec["same_noise"] is True and np.isfinite(rec["psnr_fast_vs_dense"])
    assert {"psnr_dense", "ssim_dense", "psnr_delta", "ssim_delta",
            "dense_gen_time"} <= set(rec)
    # without --lpips-model-path: lpips_dense NaN and no delta, as the reference
    assert np.isnan(rec["lpips_dense"]) and "lpips_delta" not in rec
    agg = summary["fast_decode_verify"]
    assert agg["num_verified"] == 1 and agg["same_noise"] is True
    assert agg["psnr_fast_vs_dense_mean"] == pytest.approx(rec["psnr_fast_vs_dense"])
    with open(tmp_path / "summary.json") as f:
        assert json.load(f)["fast_decode_verify"]["num_verified"] == 1
    cfg = summary["config"]
    assert (cfg["quantize_decode"], cfg["bsa_keep_ratio"], cfg["pab_every"],
            cfg["cfg_reuse_every"]) == ("int8", 0.35, 4, 2)


def test_runner_keeps_reference_lever_flags():
    """Every decode-lever flag of the JAX runner exists in the port's with
    the same default."""
    jp, tp = jax_run_tta.build_arg_parser(), run_tta.build_arg_parser()
    jd = {a.dest: a.default for a in jp._actions if isinstance(a, argparse.Action)}
    td = {a.dest: a.default for a in tp._actions if isinstance(a, argparse.Action)}
    for key in LEVER_KEYS + ("fast_decode", "fast_decode_verify"):
        assert td[key] == jd[key], key
