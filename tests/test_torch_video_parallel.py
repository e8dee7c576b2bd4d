"""--video-parallel on the port (tta/engine.py::train_chunk_batched, the
lane axis of the adapter hooks and the losses, the runner's group phase)
against the JAX package and against the port's own sequential runs.

- The batched chunk at V 2 against JAX's make_batched_train_chunk on the
  same weights (longcat_tiny, fp32, JAX's init loaded through
  models/weights.py), each lane's own data and JAX's draws injected, for
  every adapter method the JAX runner allows with --video-parallel, and a
  case where the clip binds for one lane and not the other: losses
  [V, k], anchors [V] and the trained tensors within rtol 1e-4 (full: the
  close-but-few rule of test_torch_methods.py). One tiny Open-Sora v2 and
  one tiny CogVideoX batched step the same way.
- The port runner's --video-parallel 2 (with --native-prefetch) against
  its sequential run on 3 synthetic videos: psnr, losses, the early
  stopper's best_step / stopped_early and loss_history within 1e-4; a
  one-video group that early-stops ends its loop; a broken video fails
  only itself; the refusals.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from longcat_video_tta_tpu.config import AdapterConfig as JaxAdapterConfig
from longcat_video_tta_tpu.config import OptimConfig as JaxOptimConfig
from longcat_video_tta_tpu.config import longcat_tiny as jax_tiny
from longcat_video_tta_tpu.models.backbones import cogvideox_tiny as jax_cog_tiny
from longcat_video_tta_tpu.models.backbones import opensora_v2_tiny as jax_os_tiny
from longcat_video_tta_tpu.pipeline import ModelBundle as JaxBundle
from longcat_video_tta_tpu.tta import losses as jlosses
from longcat_video_tta_tpu.tta.adapters import build_scheme as jax_build_scheme
from longcat_video_tta_tpu.tta.engine import build_optimizer as jax_build_optimizer
from longcat_video_tta_tpu.tta.engine import make_batched_train_chunk
from longcat_video_tta_tpu_torch.config import AdapterConfig, OptimConfig, longcat_tiny
from longcat_video_tta_tpu_torch.models.backbones import cogvideox_tiny, opensora_v2_tiny
from longcat_video_tta_tpu_torch.models.weights import train_params_from_numpy
from longcat_video_tta_tpu_torch.pipeline.pipeline import ModelBundle
from longcat_video_tta_tpu_torch.runners import run_tta
from longcat_video_tta_tpu_torch.tta import losses as tlosses
from longcat_video_tta_tpu_torch.tta.adapters import build_scheme
from longcat_video_tta_tpu_torch.tta.engine import (
    build_optimizer,
    lane_norms,
    train_chunk_batched,
)

torch.set_num_threads(1)

V, K = 2, 2
SIGMAS = (0.25, 0.5)
GRAD_TOL = dict(atol=1e-6, rtol=1e-4)
JCFG, TCFG = jax_tiny(), longcat_tiny()

# every method the JAX runner lets through --video-parallel (an adapter
# method: TTA and not DNO), in test_torch_methods.py's configurations
METHODS = {
    "delta_a": dict(method="delta_a"),
    "delta_b": dict(method="delta_b", num_groups=2, delta_target="hidden", delta_dim=16),
    "delta_c": dict(method="delta_c"),
    "film": dict(method="film", num_groups=2, film_mode="shift_scale"),
    "lora": dict(method="lora", lora_rank=2, lora_alpha=4.0, target_blocks="last_1"),
    "norm_tune": dict(method="norm_tune", norm_target="all_norm"),
    "full": dict(method="full"),
}


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _stack_trees(trees):
    return jax.tree.map(lambda *xs: jnp.stack(xs), *trees)


def _jax_draws(key, shape):
    """The sigma and noise the reference's conditioned losses draw from key
    (the target's shape; CogVideoX's whole window)."""
    k_sig, k_noise = jax.random.split(key)
    sigma = jax.random.uniform(k_sig, (shape[0],), minval=0.001, maxval=1.0)
    noise = jax.random.normal(k_noise, shape, jnp.float32)
    return torch.from_numpy(np.array(sigma)), torch.from_numpy(np.array(noise))


@pytest.fixture(scope="module")
def bundles():
    jb = JaxBundle.init_random(JCFG, seed=0)
    tb = ModelBundle.from_numpy(TCFG, _np_tree(jb.dit_params), _np_tree(jb.vae_params),
                                _np_tree(jb.text_params), device="cpu")
    return jb, tb


def _lanes(seed, scales, shapes):
    """Per-lane arrays [V, ...]: lane v's data drawn at its own scale."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, shape in shapes.items():
        out[name] = np.stack([(s * rng.standard_normal(shape)).astype(np.float32)
                              for s in scales])
    return out


LONGCAT_SHAPES = dict(cond=(1, 16, 2, 4, 6), train=(1, 16, 1, 4, 6), val=(1, 16, 1, 4, 6),
                      text=(1, 16, 48), noises=(2, 1, 16, 1, 4, 6))


def _longcat_lanes(scales=(1.0, 1.0)):
    d = _lanes(0, scales, LONGCAT_SHAPES)
    mask = np.ones((V, 1, 16), np.int32)
    mask[0, :, 10:] = 0
    mask[1, :, 12:] = 0
    d["mask"] = mask
    return d


def _run_both(jb, tb, acfg, ocfg, d, *, loss_j=None, anchor_j=None, loss_t=None,
              anchor_t=None, jcfg=JCFG, mask=True, draw_shape=None):
    """K steps plus the anchor through JAX's batched chunk and the port's,
    from the same per-lane inits, JAX's draws injected. Returns (JAX out,
    port out, port initial params, port scheme)."""
    loss_j = loss_j or jlosses.flow_matching_loss_conditioned
    anchor_j = anchor_j or jlosses.flow_matching_loss_conditioned_fixed
    loss_t = loss_t or tlosses.flow_matching_loss_conditioned
    anchor_t = anchor_t or tlosses.flow_matching_loss_conditioned_fixed
    scheme_j = jax_build_scheme(jcfg.dit, JaxAdapterConfig(**acfg))
    scheme = build_scheme(tb.cfg.dit, AdapterConfig(**acfg))
    tx = jax_build_optimizer(JaxOptimConfig(**ocfg))
    tps_j = [scheme_j.init(jax.random.PRNGKey(3 + v), base_params=jb.dit_params)
             for v in range(V)]
    rngs = jnp.stack([jax.random.split(jax.random.PRNGKey(100 + v), K) for v in range(V)])
    chunk = make_batched_train_chunk(scheme_j, jcfg.dit, tx, anchor_sigmas=SIGMAS,
                                     loss_fn=loss_j, anchor_fn=anchor_j)
    m_j = jnp.asarray(d["mask"]) if mask else None
    out_j = chunk(_stack_trees(tps_j), _stack_trees([tx.init(t) for t in tps_j]),
                  jb.dit_params, jnp.asarray(d["cond"]), jnp.asarray(d["train"]),
                  jnp.asarray(d["text"]), m_j, rngs, val_latents=jnp.asarray(d["val"]),
                  fixed_noises=jnp.asarray(d["noises"]))

    tp0 = [train_params_from_numpy(scheme, _np_tree(t), device="cpu") for t in tps_j]
    tps = {k: torch.stack([t[k] for t in tp0]) for k in tp0[0]}
    opt = build_optimizer(OptimConfig(**ocfg))
    shape = draw_shape or d["train"].shape[1:]
    draws = [[_jax_draws(rngs[v, i], shape) for v in range(V)] for i in range(K)]
    t = lambda name: torch.from_numpy(d[name])
    out_t = train_chunk_batched(
        scheme, tb.dit, opt, tps, opt.init(tps), t("cond"), t("train"), t("text"),
        t("mask") if mask else None, steps=K, draws=draws, val_latents=t("val"),
        fixed_noises=t("noises"), anchor_sigmas=SIGMAS, loss_fn=loss_t, anchor_fn=anchor_t)
    return out_j, out_t, tps, scheme


def _assert_matches(out_j, out_t, tps0, scheme, full=False, lr=1e-2):
    tps_j, _, losses_j, anchors_j = out_j
    tps, _, losses, anchors = out_t
    np.testing.assert_allclose(losses.numpy(), np.asarray(losses_j), rtol=1e-4)
    np.testing.assert_allclose(anchors.numpy(), np.asarray(anchors_j), rtol=1e-4)
    assert losses.shape == (V, K) and anchors.shape == (V,)
    for v in range(V):
        ref = train_params_from_numpy(scheme, _np_tree(jax.tree.map(lambda x: x[v], tps_j)),
                                      device="cpu")
        got = {k: x[v] for k, x in tps.items()}
        assert set(got) == set(ref)
        if full:
            out = np.concatenate([got[k].numpy().ravel() for k in sorted(got)])
            want = np.concatenate([ref[k].numpy().ravel() for k in sorted(ref)])
            diff = np.abs(out - want)
            off = diff > GRAD_TOL["atol"] + GRAD_TOL["rtol"] * np.abs(want)
            assert off.mean() <= 1e-2 and diff.max() <= lr, (off.sum(), diff.max())
        else:
            for k in got:
                np.testing.assert_allclose(got[k].numpy(), ref[k].numpy(), err_msg=k,
                                           **GRAD_TOL)
        moved = max(float((got[k] - tps0[k][v]).abs().max()) for k in got)
        assert moved > 1e-4, v


@pytest.mark.parametrize("name", list(METHODS))
def test_batched_chunk_matches_jax(bundles, name):
    jb, tb = bundles
    ocfg = dict(lr=1e-2, warmup_steps=1)
    out_j, out_t, tps0, scheme = _run_both(jb, tb, METHODS[name], ocfg, _longcat_lanes())
    _assert_matches(out_j, out_t, tps0, scheme, full=name == "full", lr=ocfg["lr"])


def test_batched_chunk_clips_each_lane_by_its_own_norm(bundles):
    """Lane 1's data 4x lane 0's: its gradient norm is larger. A clip
    threshold between the two, and above half of lane 1's, binds for lane 1
    and not for lane 0; one norm over both lanes, or one mean over the
    batch (half of each lane's gradient), would each change the result
    (AdamW and SGD)."""
    jb, tb = bundles
    d = _longcat_lanes(scales=(1.0, 4.0))
    scheme = build_scheme(TCFG.dit, AdapterConfig(method="delta_a"))
    tp = {"delta": torch.zeros(V, TCFG.dit.adaln_tembed_dim, requires_grad=True)}
    dit, ad = scheme.to_forward(tp, tb.dit)
    draws = [_jax_draws(jax.random.split(jax.random.PRNGKey(100 + v), K)[0],
                        d["train"].shape[1:]) for v in range(V)]
    t = lambda name: tlosses.fold_lanes(list(torch.from_numpy(d[name])))
    loss = tlosses.flow_matching_loss_conditioned(
        dit, t("cond"), t("train"), t("text"), t("mask"), adapters=ad,
        sigma=tlosses.fold_lanes([x[0] for x in draws]),
        noise=tlosses.fold_lanes([x[1] for x in draws]), lanes=V)
    (g,) = torch.autograd.grad(loss.sum(), [tp["delta"]])
    n0, n1 = (float(x) for x in lane_norms({"delta": g}))
    assert n1 > 1.5 * n0, (n0, n1)
    clip = (max(n0, n1 / 2) + n1) / 2
    assert n0 < clip < n1 and n1 / 2 < clip
    # SGD's step is lr * g: at these gradients lr 10 moves the delta by ~1e-3
    for ocfg in (dict(optimizer="adamw", lr=1e-2), dict(optimizer="sgd", lr=10.0)):
        out_j, out_t, tps0, scheme = _run_both(jb, tb, dict(method="delta_a"),
                                               dict(ocfg, grad_clip_norm=clip), d)
        _assert_matches(out_j, out_t, tps0, scheme)


# ---------------------------------------------------------------------------
# the other backbones: one batched step each
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("backbone", ["opensora", "cogvideox"])
def test_batched_step_of_the_other_backbones_matches_jax(backbone):
    if backbone == "opensora":
        jcfg, tcfg = jax_os_tiny(), opensora_v2_tiny()
        shapes = dict(cond=(1, 16, 2, 4, 6), train=(1, 16, 2, 4, 6), val=(1, 16, 1, 4, 6),
                      text=(1, 16, 32), mask=(1, 16), noises=(2, 1, 16, 1, 4, 6))
        fns = dict(loss_j=jlosses.mmdit_flow_matching_loss_conditioned,
                   anchor_j=jlosses.mmdit_flow_matching_loss_conditioned_fixed,
                   loss_t=tlosses.mmdit_flow_matching_loss_conditioned,
                   anchor_t=tlosses.mmdit_flow_matching_loss_conditioned_fixed)
        draw_shape = None
    else:
        jcfg, tcfg = jax_cog_tiny(), cogvideox_tiny()
        shapes = dict(cond=(1, 16, 2, 4, 6), train=(1, 16, 2, 4, 6), val=(1, 16, 1, 4, 6),
                      text=(1, 16, 32), noises=(2, 1, 16, 1, 4, 6))
        fns = dict(loss_j=jlosses.cogvideox_flow_matching_loss_conditioned,
                   anchor_j=jlosses.cogvideox_flow_matching_loss_conditioned_fixed,
                   loss_t=tlosses.cogvideox_flow_matching_loss_conditioned,
                   anchor_t=tlosses.cogvideox_flow_matching_loss_conditioned_fixed)
        draw_shape = (1, 16, 4, 4, 6)  # the loss noises the whole window
    jb = JaxBundle.init_random(jcfg, seed=0)
    extra = ({"clip_params": _np_tree(jb.clip_params)} if backbone == "opensora" else {})
    tb = ModelBundle.from_numpy(tcfg, _np_tree(jb.dit_params), _np_tree(jb.vae_params),
                                _np_tree(jb.text_params), device="cpu", **extra)
    d = _lanes(1, (1.0, 1.0), shapes)  # the MMDiT's mask slot carries y_vec
    out_j, out_t, tps0, scheme = _run_both(
        jb, tb, dict(method="lora", lora_rank=2, lora_alpha=4.0), dict(lr=1e-2), d,
        jcfg=jcfg, mask=backbone == "opensora", draw_shape=draw_shape, **fns)
    _assert_matches(out_j, out_t, tps0, scheme)


# ---------------------------------------------------------------------------
# the runner's group phase
# ---------------------------------------------------------------------------


def _run(out, *extra):
    argv = ["--method", "delta_a", "--preset", "longcat_tiny", "--synthetic", "3",
            "--device", "cpu", "--output-dir", str(out), "--height", "16", "--width", "32",
            "--num-cond-frames", "5", "--num-frames", "5", "--gen-start-frame", "16",
            "--tta-total-frames", "13", "--tta-context-frames", "5", "--steps", "4",
            "--num-inference-steps", "2", "--es-check-every", "1", "--es-noise-draws",
            "1", "--es-anchor-sigmas", "0.5", "--caption-guard-mode", "off",
            "--no-save-videos", *extra]
    return run_tta.main(argv)


def test_runner_video_parallel_matches_sequential(tmp_path):
    """3 videos at V 2: a group of 2, then a group of 1 at its real width."""
    seq = _run(tmp_path / "seq")
    vp = _run(tmp_path / "vp", "--video-parallel", "2", "--native-prefetch")
    assert seq["num_success"] == vp["num_success"] == 3
    for a, b in zip(vp["results"], seq["results"]):
        np.testing.assert_allclose(a["psnr"], b["psnr"], rtol=1e-4)
        np.testing.assert_allclose(a["losses"], b["losses"], rtol=1e-4, atol=1e-6)
        ea, eb = a["early_stopping_info"], b["early_stopping_info"]
        assert ea["best_step"] == eb["best_step"]
        assert ea["stopped_early"] == eb["stopped_early"]
        np.testing.assert_allclose([x[1] for x in ea["loss_history"]],
                                   [x[1] for x in eb["loss_history"]], rtol=1e-4)
        assert a["adapter_norm"] == pytest.approx(b["adapter_norm"], rel=1e-4)
        assert set(b) - {"vp_steps_executed"} <= set(a)
        assert a["vp_steps_executed"] <= 4 and a["train_time"] >= 0
    assert vp["config"]["video_parallel"] == 2 and vp["config"]["native_prefetch"]


def test_video_parallel_group_stops_on_es(tmp_path):
    """A group whose every lane early-stops ends its loop before --steps."""
    vp = _run(tmp_path / "es", "--synthetic", "1", "--video-parallel", "2", "--steps",
              "40", "--es-patience", "1")
    r = vp["results"][0]
    assert r["early_stopping_info"]["stopped_early"]
    assert r["vp_steps_executed"] < 40


def test_video_parallel_bad_video_fails_only_itself(tmp_path):
    data = run_tta.make_synthetic_dataset(str(tmp_path / "data"), 2, 16, 32)
    with open(os.path.join(data, "clip_001.npy"), "wb") as f:
        f.write(b"not an npy file")
    summary = _run(tmp_path / "bad", "--synthetic", "0", "--data-dir", data,
                   "--video-parallel", "2", "--native-prefetch")
    by_vid = {r["video"]: r for r in summary["results"]}
    assert by_vid["clip_000.npy"]["success"] and by_vid["clip_000.npy"]["losses"]
    assert not by_vid["clip_001.npy"]["success"]
    assert "native prefetch failed" in by_vid["clip_001.npy"]["error"]
    assert summary["num_success"] == 1


@pytest.mark.parametrize("method,graph", [("delta_a", "t_embed"), ("lora", "cross_kv")])
def test_group_attention_calls_match_the_launch_derivation(tmp_path, monkeypatch, method,
                                                          graph):
    """A V 2 group with full remat, its attention forwards, dQ and dK/dV
    backwards counted on the CPU path, against chip_smoke's ``vp_launches``
    that [vp]'s launch gate uses: each batched step launches what one
    video's step launches."""
    import dataclasses

    import chip_smoke
    from longcat_video_tta_tpu_torch import config
    from longcat_video_tta_tpu_torch.ops import flash_attention as fa

    tiny = config.get_model_config("longcat_tiny")
    monkeypatch.setattr(config, "get_model_config", lambda name: dataclasses.replace(
        tiny, dit=dataclasses.replace(tiny.dit, remat=True)))
    calls = {"flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0}
    ref_fwd, ref_bwd = fa.attention_reference, fa.FlashAttentionFunction.backward

    def fwd(*a, **k):
        calls["flash_fwd"] += 1
        return ref_fwd(*a, **k)

    def bwd(ctx, do):
        need = ctx.needs_input_grad
        calls["flash_bwd_dq"] += int(need[0])
        calls["flash_bwd_dkv"] += int(need[1] or need[2])
        return ref_bwd(ctx, do)

    monkeypatch.setattr(fa, "attention_reference", fwd)
    monkeypatch.setattr(fa.FlashAttentionFunction, "backward", staticmethod(bwd))
    s = _run(tmp_path / "n", "--method", method, "--synthetic", "2", "--video-parallel", "2",
             "--steps", "3", "--es-check-every", "3", "--es-patience", "3")
    assert s["num_success"] == 2
    assert calls == chip_smoke.vp_launches(graph, tiny.dit.depth, lanes=2, steps=3, checks=1,
                                           inference_steps=2)


@pytest.mark.parametrize("extra,match", [
    (["--method", "dno"], "video-parallel requires an adapter"),
    (["--method", "none"], "video-parallel requires an adapter"),
    (["--aug-enabled", "--aug-hflip"], "does not compose with augmentation"),
    (["--bucket-shapes"], "does not compose with --bucket-shapes"),
    (["--batch-videos", "2", "--retrieval-pool-dir", "/x"], "--batch-videos"),
    (["--data-mesh", "2"], "launch with torchrun"),
], ids=["dno", "none", "aug", "bucket", "batch", "data_mesh"])
def test_video_parallel_refusals(tmp_path, extra, match):
    with pytest.raises(SystemExit, match=match):
        _run(tmp_path / "r", "--video-parallel", "2", *extra)
