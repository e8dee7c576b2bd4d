"""The port's demo pretrainer (longcat_video_tta_tpu_torch/scripts/
pretrain_demo.py) against the reference script (scripts/pretrain_demo.py)
and the JAX package at longcat_tiny, fp32, on weights carried across with
the existing converters and with the reference's own draws injected.

Tolerances (fp32 on the CPU, summation order only): the clip stream
1e-5 abs; step losses 1e-4 relative; updated parameters 2e-4 relative /
1e-3 absolute (two AdamW steps amplify summation-order differences in
the gradient through the first step's g / sqrt(g^2)); the latent
statistics 1e-4 relative.
"""

import dataclasses
import functools
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from longcat_video_tta_tpu.config import AdapterConfig as JaxAdapterConfig
from longcat_video_tta_tpu.config import OptimConfig as JaxOptimConfig
from longcat_video_tta_tpu.config import longcat_tiny as jax_tiny
from longcat_video_tta_tpu.models import vae as jvae
from longcat_video_tta_tpu.pipeline import ModelBundle as JaxBundle
from longcat_video_tta_tpu.tta.adapters import build_scheme as jax_build_scheme
from longcat_video_tta_tpu.tta.engine import build_optimizer as jax_build_optimizer
from longcat_video_tta_tpu.tta.engine import make_train_step
from longcat_video_tta_tpu_torch.config import AdapterConfig, longcat_tiny
from longcat_video_tta_tpu_torch.models.weights import load_dit_from_numpy, load_vae_from_numpy
from longcat_video_tta_tpu_torch.pipeline.pipeline import ModelBundle
from longcat_video_tta_tpu_torch.scripts import pretrain_demo as tpd
from longcat_video_tta_tpu_torch.tta.adapters import build_scheme

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                "scripts"))
import pretrain_demo as jpd  # noqa: E402  (the reference script)

torch.set_num_threads(1)

JCFG = jax_tiny()
TCFG = longcat_tiny()
STEP_RTOL = 1e-4
PARAM_TOL = dict(rtol=2e-4, atol=1e-3)
H, W = 16, 32


@pytest.fixture(scope="module")
def bundles():
    jb = JaxBundle.init_random(JCFG, seed=0)
    tonp = lambda t: jax.tree.map(np.asarray, t)
    tb = ModelBundle.from_numpy(TCFG, tonp(jb.dit_params), tonp(jb.vae_params),
                                tonp(jb.text_params), device="cpu")
    return jb, tb


def _named(module):
    return {k: p.detach() for k, p in module.named_parameters()}


def _assert_params_close(ours, theirs):
    assert set(ours) == set(theirs)
    for k in ours:
        np.testing.assert_allclose(ours[k].float().numpy(), theirs[k].float().numpy(),
                                   err_msg=k, **PARAM_TOL)


def test_clip_stream_matches_the_reference():
    """draw_params and sample_clip are the reference's numpy stream; the
    device generator equals the reference's jitted one on those draws."""
    a, b = np.random.RandomState(5), np.random.RandomState(5)
    for x, y in zip(tpd.draw_params(a, 3), jpd.draw_params(b, 3)):
        np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(tpd.batch_clips(a, 2, 5, H, W),
                                  jpd.batch_clips(b, 2, 5, H, W))
    params = tpd.draw_params(np.random.RandomState(9), 2)
    ours = tpd.make_clip_gen(9, H, W, "cpu")(*params).numpy()
    ref = np.asarray(jpd.make_device_clip_gen(9, H, W)(*map(jnp.asarray, params)))
    assert ours.shape == ref.shape == (2, 3, 9, H, W)
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-5)
    # and the device generator is sample_clip's formula on the same draws
    np.testing.assert_allclose(ours, jpd.batch_clips(np.random.RandomState(9), 2, 9, H, W),
                               rtol=0, atol=1e-5)


@functools.lru_cache(maxsize=None)
def _jax_vae_step(lr):
    """The reference's vae_step (scripts/pretrain_demo.py:172-191) with the
    KL draw taken from a given noise array and the clip limit an argument
    (one compile for both cases; optax's clip reads it as a value)."""
    chain = lambda max_norm: optax.chain(optax.clip_by_global_norm(max_norm),
                                         optax.adamw(lr, weight_decay=1e-5))

    @jax.jit
    def step(params, state, x, noise, max_norm):
        def loss_fn(p):
            mean, logvar = jvae.vae_encode_moments(p, JCFG.vae, x)
            lv = jnp.clip(logvar, -30.0, 20.0)
            z = mean + jnp.exp(0.5 * lv) * noise
            recon = jvae._vae_decode_core(p, JCFG.vae, z)
            mse = jnp.mean((recon - x) ** 2)
            kl = 0.5 * jnp.mean(mean ** 2 + jnp.exp(lv) - 1.0 - lv)
            return mse + 1e-6 * kl, mse

        (loss, mse), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
        upd, state = chain(max_norm).update(grads, state, params)
        return optax.apply_updates(params, upd), state, loss, mse, optax.global_norm(grads)

    return chain(1.0), step


@pytest.mark.parametrize("clip_norm", [1.0, 1e6], ids=["clip_active", "clip_idle"])
def test_vae_step_matches_the_reference(bundles, clip_norm):
    """Two VAE steps (optax's adamw defaults, the global-norm clip) on the
    same clips and KL noise: MSE, loss and the updated VAE."""
    jb, tb = bundles
    lr = 3e-4
    vopt_j, step_j = _jax_vae_step(lr)
    vopt = tpd.vae_optimizer(lr)
    vopt.cfg = dataclasses.replace(vopt.cfg, grad_clip_norm=clip_norm)
    assert (vopt.cfg.eps, vopt.cfg.betas, vopt.cfg.warmup_steps) == (1e-8, (0.9, 0.999), 0)
    gen = tpd.make_clip_gen(9, H, W, "cpu")
    rng = np.random.RandomState(0)
    pj, sj = jb.vae_params, vopt_j.init(jb.vae_params)
    pt = _named(tb.vae)
    st = vopt.init(pt)
    norms = []
    for i in range(2):
        x = gen(*tpd.draw_params(rng, 1))
        noise = np.array(jax.random.normal(jax.random.PRNGKey(i),
                                             tpd.latent_shape(TCFG.vae, x.shape)))
        pj, sj, loss_j, mse_j, norm = step_j(pj, sj, jnp.asarray(x.numpy()),
                                             jnp.asarray(noise), clip_norm)
        norms.append(float(norm))
        with torch.no_grad():
            loss_t = tpd.vae_loss(_with(tb.vae, pt), x, torch.from_numpy(noise))[0]
        pt, st, mse = tpd.vae_step(tb.vae, pt, vopt, st, x, torch.from_numpy(noise))
        np.testing.assert_allclose(float(mse), float(mse_j), rtol=STEP_RTOL)
        np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=STEP_RTOL)
    # the case names hold: the gradient norm passes the limit only when clipping
    assert all((n > clip_norm) == (clip_norm == 1.0) for n in norms)
    ref = load_vae_from_numpy(jax.tree.map(np.asarray, pj), TCFG.vae, "cpu")
    _assert_params_close(pt, _named(ref))
    assert float(max((pt[k] - p).abs().max() for k, p in _named(tb.vae).items())) > 1e-5


def _with(module, params):
    from longcat_video_tta_tpu_torch.tta.adapters import with_tensors

    return with_tensors(module, params)


@pytest.mark.parametrize("clip_norm", [1.0, 1e6], ids=["clip_active", "clip_idle"])
def test_dit_step_matches_the_reference(bundles, clip_norm):
    """Two DiT pretraining steps (FullScheme, AdamW eps 1e-15, warmup 1 so
    the second step runs at the full rate) on the same latents, caption and
    injected sigma/noise: losses and the updated DiT."""
    jb, tb = bundles
    lr, steps = 2e-4, 4
    tx = jax_build_optimizer(JaxOptimConfig(
        optimizer="adamw", lr=lr, steps=steps, warmup_steps=min(100, steps // 4),
        weight_decay=1e-4, grad_clip_norm=clip_norm))
    step_j = make_train_step(jax_build_scheme(JCFG.dit, JaxAdapterConfig(method="full")),
                             JCFG.dit, tx, attn_impl="xla")
    opt = tpd.dit_optimizer(lr, steps)
    opt.cfg = dataclasses.replace(opt.cfg, grad_clip_norm=clip_norm)
    scheme = build_scheme(TCFG.dit, AdapterConfig(method="full"))
    rng = np.random.default_rng(3)
    cond = rng.standard_normal((1, 16, 2, 4, 8)).astype(np.float32)
    tgt = rng.standard_normal((1, 16, 2, 4, 8)).astype(np.float32)
    emb_t, mask_t = tb.encode_prompt(tpd.CAPTIONS[1])
    emb_j, mask_j = jb.encode_prompt(jpd.CAPTIONS[1])
    np.testing.assert_allclose(emb_t.numpy(), np.asarray(emb_j), rtol=1e-4, atol=1e-5)
    pj, sj = jb.dit_params, tx.init(jb.dit_params)
    pt = scheme.init("cpu", dit=tb.dit)
    st = opt.init(pt)
    for i in range(2):
        key = jax.random.PRNGKey(20 + i)
        k_sig, k_noise = jax.random.split(key)
        sigma = np.array(jax.random.uniform(k_sig, (1,), minval=0.001, maxval=1.0))
        noise = np.array(jax.random.normal(k_noise, tgt.shape, jnp.float32))
        pj, sj, loss_j = step_j(pj, sj, jb.dit_params, jnp.asarray(cond), jnp.asarray(tgt),
                                emb_j, mask_j, key)
        pt, st, loss = tpd.dit_step(scheme, tb.dit, opt, pt, st, torch.from_numpy(cond),
                                    torch.from_numpy(tgt), emb_t, mask_t,
                                    torch.from_numpy(sigma), torch.from_numpy(noise))
        np.testing.assert_allclose(float(loss), float(loss_j), rtol=STEP_RTOL)
    ref = load_dit_from_numpy(jax.tree.map(np.asarray, pj), TCFG.dit, "cpu")
    _assert_params_close(pt, _named(ref))
    moved = max(float((pt[k] - p).abs().max()) for k, p in _named(tb.dit).items())
    assert moved > 1e-5


def test_latent_statistics_match_the_reference(bundles):
    jb, tb = bundles
    gen = tpd.make_clip_gen(17, H, W, "cpu")
    rng = np.random.RandomState(4)
    clips = [gen(*tpd.draw_params(rng, 1)) for _ in range(2)]
    mean, std = tpd.latent_statistics(tb.vae, clips)
    zs = np.concatenate([np.asarray(jvae.vae_encode(jb.vae_params, JCFG.vae,
                                                    jnp.asarray(x.numpy()),
                                                    normalize=False), np.float64)
                         for x in clips], 0)
    np.testing.assert_allclose(mean, zs.mean(axis=(0, 2, 3, 4)), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(std, zs.std(axis=(0, 2, 3, 4)) + 1e-6, rtol=1e-4)


def test_smoke_pretrain_writes_a_checkpoint_the_runner_reads(tmp_path):
    """The --smoke run (the reference test's asserts): both phases logged,
    PROVENANCE.json, and a folder that from_checkpoint_dir reads with the
    re-estimated latent statistics in force."""
    out = str(tmp_path / "ckpt")
    hist = tpd.main(["--smoke", "--out-dir", out, "--device", "cpu"])
    assert {h["phase"] for h in hist} == {"vae", "dit"}
    assert all(np.isfinite(h.get("mse", h.get("loss"))) for h in hist)
    with open(os.path.join(out, "PROVENANCE.json")) as f:
        prov = json.load(f)
    assert prov["device"] == "cpu" and prov["history"] == hist
    bundle = ModelBundle.from_checkpoint_dir(TCFG, out, device="cpu")
    assert bundle.cfg.vae.latents_mean != TCFG.vae.latents_mean
    with open(os.path.join(out, "vae", "config.json")) as f:
        meta = json.load(f)
    np.testing.assert_allclose(bundle.cfg.vae.latents_std, meta["latents_std"])
    assert bundle.vae.cfg.latents_std == bundle.cfg.vae.latents_std
    x = tpd.batch_clips(np.random.RandomState(3), 1, 5, H, W)
    with torch.no_grad():
        z = bundle.encode_video(torch.from_numpy(x)).numpy()
    assert np.isfinite(z).all()
    assert 0.2 < np.abs(z).mean() < 3.0


def test_entry_point_defaults_to_the_card():
    args = tpd.parse_args([])
    assert args.device == "cuda" and args.out_dir == "campaign/demo_ckpt_torch"
    assert (args.vae_steps, args.dit_steps, args.batch, args.seed) == (1200, 4000, 2, 0)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA GPU"):
            tpd.main(["--smoke", "--out-dir", "/nonexistent"])
