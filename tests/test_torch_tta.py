"""PyTorch port delta_a TTA (tta/, the DiT's adapter and remat hooks, the
sampler's adapter pass-through, the runner) vs the JAX package on the
same weights (longcat_tiny, fp32, JAX random init loaded through
models/weights.py) and the same draws.

JAX and torch draw different numbers from the same seed, so the tests
recompute the reference's own sigma and noise from its PRNG keys and
hand them to the port. Tolerances (fp32 on the CPU, summation order
only): DiT outputs 1e-4 abs/rel as in test_torch_models.py; losses
1e-5 rel; gradients and trained deltas 1e-4 rel / 1e-6 abs; the
optimizer against optax 1e-6 rel / 1e-7 abs.
"""

import copy
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from longcat_video_tta_tpu.config import EarlyStoppingConfig as JaxESConfig
from longcat_video_tta_tpu.config import FrameConfig as JaxFrameConfig
from longcat_video_tta_tpu.config import OptimConfig as JaxOptimConfig
from longcat_video_tta_tpu.config import longcat_tiny as jax_tiny
from longcat_video_tta_tpu.models import dit as jdit
from longcat_video_tta_tpu.pipeline import ModelBundle as JaxBundle
from longcat_video_tta_tpu.pipeline import generate_vc as jax_generate_vc
from longcat_video_tta_tpu.tta import early_stopping as jes
from longcat_video_tta_tpu.tta import losses as jlosses
from longcat_video_tta_tpu.tta import split as jsplit
from longcat_video_tta_tpu.tta.engine import build_optimizer as jax_build_optimizer
from longcat_video_tta_tpu_torch.config import (
    AdapterConfig,
    EarlyStoppingConfig,
    FrameConfig,
    OptimConfig,
    longcat_tiny,
)
from longcat_video_tta_tpu_torch.ops import flash_attention as fa
from longcat_video_tta_tpu_torch.pipeline.pipeline import ModelBundle, generate_vc
from longcat_video_tta_tpu_torch.runners import run_tta
from longcat_video_tta_tpu_torch.tta import early_stopping as tes
from longcat_video_tta_tpu_torch.tta import split as tsplit
from longcat_video_tta_tpu_torch.tta.adapters import build_scheme
from longcat_video_tta_tpu_torch.tta.engine import build_optimizer, train_chunk
from longcat_video_tta_tpu_torch.tta.losses import (
    flow_matching_loss_conditioned,
    flow_matching_loss_conditioned_fixed,
)

torch.set_num_threads(1)

TOL = dict(atol=1e-4, rtol=1e-4)
GRAD_TOL = dict(atol=1e-6, rtol=1e-4)
JCFG = jax_tiny()
TCFG = longcat_tiny()
SIGMAS = (0.25, 0.5, 0.75)


@pytest.fixture(scope="module")
def bundles():
    jb = JaxBundle.init_random(JCFG, seed=0)
    tonp = lambda t: jax.tree.map(np.asarray, t)
    tb = ModelBundle.from_numpy(TCFG, tonp(jb.dit_params), tonp(jb.vae_params),
                                tonp(jb.text_params), device="cpu")
    return jb, tb


@pytest.fixture(scope="module")
def data():
    """A TTA window of 2 cond + 1 train + 1 val latents of 4 x 6, text,
    and a non-zero delta."""
    rng = np.random.default_rng(0)
    f32 = lambda *s: rng.standard_normal(s).astype(np.float32)
    mask = np.ones((1, 16), np.int32)
    mask[:, 10:] = 0
    return dict(cond=f32(1, 16, 2, 4, 6), train=f32(1, 16, 1, 4, 6),
                val=f32(1, 16, 1, 4, 6), text=f32(1, 16, 48), mask=mask,
                delta=0.1 * f32(TCFG.dit.adaln_tembed_dim))


def _t(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


def _jax_draws(key, target_shape):
    """The sigma and noise flow_matching_loss_conditioned draws from
    ``key`` (tta/losses.py:152-154)."""
    k_sig, k_noise = jax.random.split(key)
    sigma = jax.random.uniform(k_sig, (target_shape[0],), minval=0.001, maxval=1.0)
    noise = jax.random.normal(k_noise, target_shape, jnp.float32)
    return np.array(sigma), np.array(noise)


# ---------------------------------------------------------------------------
# DiT adapters and remat
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("entry", ["forward", "precompute_cond_cache",
                                   "forward_with_cache"])
def test_dit_delta_t_matches_jax(bundles, data, entry):
    jb, tb = bundles
    lat = np.concatenate([data["cond"], data["train"], data["val"]], axis=2)
    text, mask, delta = data["text"], data["mask"], data["delta"]
    jad, tad = {"delta_t": jnp.asarray(delta)}, {"delta_t": torch.from_numpy(delta)}
    with torch.no_grad():
        if entry == "forward":
            ts = np.array([[0.0, 0.0, 640.0, 640.0]], np.float32)
            ref = jdit.dit_forward(jb.dit_params, JCFG.dit, *_j(lat, ts, text, mask),
                                   num_cond_latents=2, adapters=jad)
            out = tb.dit(*_t(lat, ts, text, mask), num_cond_latents=2, adapters=tad)
            refs, outs = [ref], [out]
        else:
            cache = jdit.dit_precompute_cond_cache(
                jb.dit_params, JCFG.dit, *_j(lat[:, :, :2], text, mask), adapters=jad)
            tcache = tb.dit.precompute_cond_cache(*_t(lat[:, :, :2], text, mask),
                                                  adapters=tad)
            refs, outs = list(cache), list(tcache)
            if entry == "forward_with_cache":
                refs = [jdit.dit_forward_with_cache(
                    jb.dit_params, JCFG.dit, jnp.asarray(lat[:, :, 2:]),
                    jnp.full((1,), 640.0), *_j(text, mask), cache,
                    num_cond_latents=2, adapters=jad)]
                outs = [tb.dit.forward_with_cache(
                    torch.from_numpy(lat[:, :, 2:]), torch.full((1,), 640.0),
                    *_t(text, mask), tcache, num_cond_latents=2, adapters=tad)]
    for o, r in zip(outs, refs):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), **TOL)
    # the adapter moved the output: the test is not vacuous
    with torch.no_grad():
        base = (tb.dit(*_t(lat, ts, text, mask), num_cond_latents=2)
                if entry == "forward" else None)
    if base is not None:
        assert float((base - outs[0]).abs().max()) > 1e-4


def test_dit_rejects_unported_adapters(bundles, data):
    """An adapter key no LongCat scheme produces (the MMDiT backbone's
    double-stream LoRA) raises instead of being ignored."""
    _, tb = bundles
    lat = np.concatenate([data["cond"], data["train"]], axis=2)
    with pytest.raises(NotImplementedError, match="not yet ported"):
        tb.dit(*_t(lat, np.zeros((1,), np.float32), data["text"]),
               adapters={"lora_double": torch.zeros(1)})


def test_remat_gives_the_same_gradients(bundles, data):
    """cfg.remat checkpoints every block (ops/layers.py::remat_wrap): the
    same loss and delta gradient, with each attention run twice (forward
    and recompute)."""
    _, tb = bundles
    dit_r = copy.deepcopy(tb.dit)
    dit_r.cfg = dataclasses.replace(tb.dit.cfg, remat=True)
    cond, train, text, mask = _t(data["cond"], data["train"], data["text"],
                                 data["mask"])
    sigma, noise = torch.tensor([0.4]), torch.from_numpy(
        np.random.default_rng(1).standard_normal(train.shape).astype(np.float32))
    calls = {"n": 0}
    orig = fa.FlashAttentionFunction.forward

    def counting(ctx, *a):
        calls["n"] += 1
        return orig(ctx, *a)

    results = []
    for dit in (tb.dit, dit_r):
        delta = torch.from_numpy(data["delta"]).requires_grad_(True)
        calls["n"] = 0
        fa.FlashAttentionFunction.forward = staticmethod(counting)
        try:
            loss = flow_matching_loss_conditioned(
                dit, cond, train, text, mask, adapters={"delta_t": delta},
                sigma=sigma, noise=noise)
            (grad,) = torch.autograd.grad(loss, [delta])
        finally:
            fa.FlashAttentionFunction.forward = staticmethod(orig)
        results.append((loss.detach(), grad, calls["n"]))
    (l0, g0, n0), (l1, g1, n1) = results
    depth = TCFG.dit.depth
    assert (n0, n1) == (2 * depth, 4 * depth)
    torch.testing.assert_close(l1, l0, rtol=1e-6, atol=0)
    torch.testing.assert_close(g1, g0, rtol=1e-6, atol=1e-9)


# ---------------------------------------------------------------------------
# Losses
# ---------------------------------------------------------------------------


def test_conditioned_loss_and_grad_match_jax_with_injected_draws(bundles, data):
    jb, tb = bundles
    key = jax.random.PRNGKey(7)
    args_j = _j(data["cond"], data["train"], data["text"], data["mask"])

    def jloss(d):
        return jlosses.flow_matching_loss_conditioned(
            jb.dit_params, JCFG.dit, *args_j, key, adapters={"delta_t": d})

    loss_j, grad_j = jax.value_and_grad(jloss)(jnp.asarray(data["delta"]))
    sigma, noise = _jax_draws(key, data["train"].shape)
    delta = torch.from_numpy(data["delta"]).requires_grad_(True)
    loss = flow_matching_loss_conditioned(
        tb.dit, *_t(data["cond"], data["train"], data["text"], data["mask"]),
        adapters={"delta_t": delta}, sigma=torch.from_numpy(sigma),
        noise=torch.from_numpy(noise))
    (grad,) = torch.autograd.grad(loss, [delta])
    np.testing.assert_allclose(float(loss.detach()), float(loss_j), rtol=1e-5)
    np.testing.assert_allclose(grad.numpy(), np.asarray(grad_j), **GRAD_TOL)


def test_fixed_anchor_loss_matches_jax(bundles, data):
    """The G = |sigmas| x |draws| batched anchor forward, in the
    reference's row order."""
    jb, tb = bundles
    noises = np.random.default_rng(2).standard_normal(
        (2,) + data["val"].shape).astype(np.float32)
    ref = jlosses.flow_matching_loss_conditioned_fixed(
        jb.dit_params, JCFG.dit, *_j(data["cond"], data["val"], data["text"],
                                     data["mask"], noises),
        fixed_sigmas=SIGMAS, adapters={"delta_t": jnp.asarray(data["delta"])})
    with torch.no_grad():
        out = flow_matching_loss_conditioned_fixed(
            tb.dit, *_t(data["cond"], data["val"], data["text"], data["mask"],
                        noises),
            fixed_sigmas=SIGMAS, adapters={"delta_t": torch.from_numpy(data["delta"])})
    np.testing.assert_allclose(float(out), float(ref), rtol=1e-5)


def test_loss_draws_from_the_generator_when_not_given(bundles, data):
    _, tb = bundles
    args = _t(data["cond"], data["train"], data["text"], data["mask"])
    with torch.no_grad():
        a = flow_matching_loss_conditioned(
            tb.dit, *args, generator=torch.Generator().manual_seed(3))
        b = flow_matching_loss_conditioned(
            tb.dit, *args, generator=torch.Generator().manual_seed(3))
        c = flow_matching_loss_conditioned(
            tb.dit, *args, generator=torch.Generator().manual_seed(4))
    assert float(a) == float(b) != float(c)


# ---------------------------------------------------------------------------
# Optimizer and the train loop
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("ocfg", [
    dict(optimizer="adamw", lr=2e-3, warmup_steps=3),
    dict(optimizer="adamw", lr=1e-3, weight_decay=0.1, grad_clip_norm=0.5),
    dict(optimizer="sgd", lr=1e-2, warmup_steps=2),
    dict(optimizer="sgd", lr=1e-2, momentum=0.9),
], ids=["adamw_warmup", "adamw_wd_clip", "sgd_warmup", "sgd_momentum"])
def test_optimizer_matches_optax_step_by_step(ocfg):
    """Global-norm clip (scaled only when the norm exceeds the limit),
    linear warmup from lr 0, AdamW with eps outside the sqrt and
    decoupled weight decay, SGD with and without momentum."""
    tx = jax_build_optimizer(JaxOptimConfig(**ocfg))
    opt = build_optimizer(OptimConfig(**ocfg))
    rng = np.random.default_rng(5)
    p0 = {"a": rng.standard_normal(32).astype(np.float32),
          "b": rng.standard_normal((3, 4)).astype(np.float32)}
    pj = jax.tree.map(jnp.asarray, p0)
    pt = {k: torch.from_numpy(v) for k, v in p0.items()}
    sj, st = tx.init(pj), opt.init(pt)
    for step in range(6):
        # norms above and below the clip limit
        scale = 3.0 if step % 2 == 0 else 0.01
        g = {k: (scale * rng.standard_normal(v.shape)).astype(np.float32)
             for k, v in p0.items()}
        upd, sj = tx.update(jax.tree.map(jnp.asarray, g), sj, pj)
        pj = optax.apply_updates(pj, upd)
        pt, st = opt.update({k: torch.from_numpy(v) for k, v in g.items()}, st, pt)
        for k in p0:
            np.testing.assert_allclose(pt[k].numpy(), np.asarray(pj[k]),
                                       rtol=1e-6, atol=1e-7)


def test_first_adamw_step_is_lr_times_sign():
    opt = build_optimizer(OptimConfig(lr=1e-3, weight_decay=0.0))
    p = {"d": torch.zeros(8)}
    g = {"d": torch.tensor([1e-6, -2.0, 0.3, -1e-4, 5.0, -0.5, 1e-8, -7.0])}
    new, _ = opt.update(g, opt.init(p), p)
    torch.testing.assert_close(new["d"], -1e-3 * torch.sign(g["d"]), rtol=1e-6,
                               atol=1e-12)


def test_delta_a_trajectory_matches_a_jax_loop(bundles, data):
    """Five delta_a steps (AdamW, eps 1e-15, warmup 2, clip 1.0) then the
    anchor eval: the loss trajectory, the final delta and the anchor
    loss of a JAX loop built from jax.value_and_grad of the reference
    loss and its build_optimizer, with the JAX draws injected."""
    jb, tb = bundles
    ocfg = dict(lr=3e-3, warmup_steps=2)
    tx = jax_build_optimizer(JaxOptimConfig(**ocfg))
    args_j = _j(data["cond"], data["train"], data["text"], data["mask"])
    tp_j = {"delta": jnp.zeros((JCFG.dit.adaln_tembed_dim,), jnp.float32)}
    state = tx.init(tp_j)
    keys = [jax.random.PRNGKey(100 + i) for i in range(5)]
    losses_j = []
    for key in keys:
        def jloss(tp, key=key):
            return jlosses.flow_matching_loss_conditioned(
                jb.dit_params, JCFG.dit, *args_j, key,
                adapters={"delta_t": tp["delta"]})

        loss, grads = jax.value_and_grad(jloss)(tp_j)
        upd, state = tx.update(grads, state, tp_j)
        tp_j = optax.apply_updates(tp_j, upd)
        losses_j.append(float(loss))
    noises = np.random.default_rng(6).standard_normal(
        (2,) + data["val"].shape).astype(np.float32)
    anchor_j = jlosses.flow_matching_loss_conditioned_fixed(
        jb.dit_params, JCFG.dit, *_j(data["cond"], data["val"], data["text"],
                                     data["mask"], noises),
        fixed_sigmas=SIGMAS, adapters={"delta_t": tp_j["delta"]})

    scheme = build_scheme(TCFG.dit, AdapterConfig())
    opt = build_optimizer(OptimConfig(**ocfg))
    tp = scheme.init()
    draws = [tuple(torch.from_numpy(a) for a in _jax_draws(k, data["train"].shape))
             for k in keys]
    phases = []
    tp, _, losses, anchor = train_chunk(
        scheme, tb.dit, opt, tp, opt.init(tp),
        *_t(data["cond"], data["train"], data["text"], data["mask"]), steps=5,
        draws=draws, val_latents=torch.from_numpy(data["val"]),
        fixed_noises=torch.from_numpy(noises), anchor_sigmas=SIGMAS,
        on_phase=phases.append)
    assert phases == ["train_chunk", "anchor_check"]
    np.testing.assert_allclose(losses.numpy(), np.asarray(losses_j), rtol=1e-5)
    np.testing.assert_allclose(tp["delta"].numpy(), np.asarray(tp_j["delta"]),
                               **GRAD_TOL)
    assert float(tp["delta"].abs().max()) > 1e-3  # the adapter moved
    np.testing.assert_allclose(float(anchor), float(anchor_j), rtol=1e-5)


# ---------------------------------------------------------------------------
# Early stopping
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("strategy", ["patience", "first_rise"])
def test_early_stopper_decisions_match_jax(strategy):
    anchors = [2.0, 1.8, 1.85, 1.7, 1.75, 1.9, 1.95, 1.6, 1.65, 1.66, 1.67]
    jstop = jes.AnchoredEarlyStopper(JaxESConfig(strategy=strategy, patience=2),
                                     None, JCFG.dit)
    tstop = tes.AnchoredEarlyStopper(EarlyStoppingConfig(strategy=strategy,
                                                         patience=2), None, TCFG.dit)
    for i, a in enumerate(anchors):
        step = 5 * (i + 1)
        got = tstop.step_with_loss(step, {"delta": step}, a)
        assert got == jstop.step_with_loss(step, {"delta": step}, a)
        if got[0]:
            break
    assert tstop.state == jstop.state
    assert tstop.restore() == jstop.restore()


def test_early_stopper_setup_matches_jax(bundles, data):
    """setup's initial anchor loss and snapshot, with the reference's own
    md5-seeded fixed noises injected; the check cadence of ``step``."""
    jb, tb = bundles
    vid = "clip_007.npy"
    assert tes.fixed_noise_seed(vid) == jes.fixed_noise_seed(vid)
    jscheme_tp = {"delta": jnp.zeros((JCFG.dit.adaln_tembed_dim,), jnp.float32)}
    from longcat_video_tta_tpu.tta.adapters import DeltaAScheme as JaxDeltaA
    from longcat_video_tta_tpu.config import AdapterConfig as JaxAdapterConfig

    jstop = jes.AnchoredEarlyStopper(JaxESConfig(check_every=2),
                                     JaxDeltaA(JCFG.dit, JaxAdapterConfig()), JCFG.dit)
    jstop.setup(jb.dit_params, *_j(data["cond"], data["val"], data["text"],
                                   data["mask"]), vid, jscheme_tp)
    scheme = build_scheme(TCFG.dit, AdapterConfig())
    tstop = tes.build_early_stopper(EarlyStoppingConfig(check_every=2), scheme,
                                    TCFG.dit)
    tp = scheme.init()
    tstop.setup(tb.dit, *_t(data["cond"], data["val"], data["text"], data["mask"]),
                vid, tp, fixed_noises=torch.from_numpy(np.array(jstop.fixed_noises)))
    np.testing.assert_allclose(tstop.best_loss, jstop.best_loss, rtol=1e-5)
    assert tstop.restore() is tp and tstop.loss_history[0][0] == 0
    assert tstop.step(1, tp) == (False, {})
    stop, info = tstop.step(2, tp)
    assert not stop and info["checks_without_improvement"] == 1
    # without injected noises: one draw per generator seeded seed + d
    noises = tes.draw_fixed_noises(torch.zeros((1, 2, 3)), 5, 2)
    assert noises.shape == (2, 1, 2, 3)
    torch.testing.assert_close(noises[1][None], tes.draw_fixed_noises(
        torch.zeros((1, 2, 3)), 6, 1))
    assert tes.build_early_stopper(EarlyStoppingConfig(enabled=False), scheme,
                                   TCFG.dit) is None


# ---------------------------------------------------------------------------
# Split helpers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("t_total,n_ctx,holdout", [(8, 4, 0.25), (4, 2, 0.25),
                                                    (2, 4, 0.25), (6, 1, 0.5),
                                                    (3, 2, 0.0)])
def test_split_tta_latents_matches_jax(t_total, n_ctx, holdout):
    lat = np.arange(t_total, dtype=np.float32).reshape(1, 1, t_total, 1, 1)
    ref = jsplit.split_tta_latents(jnp.asarray(lat), n_ctx, holdout)
    out = tsplit.split_tta_latents(torch.from_numpy(lat), n_ctx, holdout)
    for o, r in zip(out, ref):
        assert (o is None) == (r is None)
        if o is not None:
            np.testing.assert_array_equal(o.numpy(), np.asarray(r))


def test_frame_helpers_match_jax():
    for n in range(0, 40):
        assert tsplit.round_frames_4k1_down(n) == jsplit.round_frames_4k1_down(n)
        assert tsplit.estimate_latent_len(n) == jsplit.estimate_latent_len(n)
    for total, ctx, h in [(29, 13, 0.25), (13, 13, 0.25), (9, 5, 0.5), (5, 9, 0.25)]:
        assert (tsplit.estimate_tta_split_budget(total, ctx, h)
                == jsplit.estimate_tta_split_budget(total, ctx, h))
    for kw in [dict(num_cond_frames=14), dict(num_cond_frames=13, tta_total_frames=29),
               dict(num_cond_frames=5, tta_total_frames=40, gen_start_frame=32),
               dict(num_cond_frames=9, tta_total_frames=13, tta_context_frames=20),
               dict(num_cond_frames=9, tta_total_frames=30, tta_context_frames=5)]:
        t = tsplit.resolve_frame_window(FrameConfig(**kw))
        j = jsplit.resolve_frame_window(JaxFrameConfig(**kw))
        assert dataclasses.asdict(t) == dataclasses.asdict(j)


def test_feature_budget_guard():
    frames = tsplit.resolve_frame_window(FrameConfig(num_cond_frames=13))
    with pytest.raises(RuntimeError, match="val_latents=0"):
        tsplit.validate_tta_feature_budget(frames, EarlyStoppingConfig())
    out = tsplit.validate_tta_feature_budget(frames, EarlyStoppingConfig(), "warn")
    assert out["split_budget"]["val_latents"] == 0


# ---------------------------------------------------------------------------
# Generation with the adapter, and the runner
# ---------------------------------------------------------------------------


def test_generate_vc_with_adapter_matches_jax(bundles, data):
    jb, tb = bundles
    rng = np.random.default_rng(8)
    cond = rng.uniform(-1, 1, (1, 3, 5, 16, 32)).astype(np.float32)
    noise = rng.standard_normal((1, 16, 2, 2, 4)).astype(np.float32)
    kw = dict(num_frames=5, num_inference_steps=2, guidance_scale=4.0)
    ref = jax_generate_vc(jb, jnp.asarray(cond), "a ball moving",
                          init_noise=jnp.asarray(noise),
                          adapters={"delta_t": jnp.asarray(10 * data["delta"])}, **kw)
    out = generate_vc(tb, cond, "a ball moving", init_noise=torch.from_numpy(noise),
                      adapters={"delta_t": torch.from_numpy(10 * data["delta"])}, **kw)
    base = generate_vc(tb, cond, "a ball moving", init_noise=torch.from_numpy(noise),
                       **kw)
    np.testing.assert_allclose(out, np.asarray(ref), atol=1e-4)
    assert float(np.abs(out - base).max()) > 1e-3


def test_runner_delta_a_writes_a_finite_summary(tmp_path):
    out = str(tmp_path / "run")
    phases = []
    summary = run_tta.main(
        ["--method", "delta_a", "--preset", "longcat_tiny", "--synthetic", "1",
         "--device", "cpu", "--output-dir", out, "--height", "16", "--width", "32",
         "--num-cond-frames", "5", "--num-frames", "5", "--gen-start-frame", "16",
         "--tta-total-frames", "13", "--steps", "4", "--es-check-every", "2",
         "--num-inference-steps", "2", "--caption-guard-mode", "off",
         "--no-save-videos"], on_phase=phases.append)
    assert summary["num_success"] == 1
    with open(os.path.join(out, "summary.json")) as f:
        r = json.load(f)["results"][0]
    assert len(r["losses"]) == 4 and np.isfinite(r["losses"]).all()
    assert r["adapter_norm"] > 0 and r["trainable_params"] == TCFG.dit.adaln_tembed_dim
    es = r["early_stopping_info"]
    assert es["total_checks"] == 3 and [s for s, _ in es["loss_history"]] == [0, 2, 4]
    assert np.isfinite([loss for _, loss in es["loss_history"]]).all()
    assert r["es_check_time"] > 0 and r["train_time"] > 0
    assert np.isfinite(r["psnr"]) and np.isfinite(r["ssim"])
    assert phases[:4] == ["video", "encode_window", "setup_anchor", "train_chunk"]
    assert phases.count("anchor_check") == 2 and phases[-1] == "video_end"
    assert "generation" in phases and "cond_cache" in phases


def test_runner_rejects_unported_options(tmp_path):
    base = ["--output-dir", str(tmp_path), "--device", "cpu", "--synthetic", "1"]
    with pytest.raises(SystemExit):
        run_tta.main(["--method", "lora", "--video-parallel"] + base)
    with pytest.raises(SystemExit):
        run_tta.main(["--method", "delta_a", "--data-mesh", "2"] + base)
    assert run_tta.build_arg_parser().parse_args(base).method == "delta_a"
    assert run_tta.build_arg_parser().parse_args(base + ["--clip-gate-enabled"]) \
        .clip_gate_enabled
