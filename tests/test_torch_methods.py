"""PyTorch port of the TTA methods (tta/adapters.py, the DiT's adapter
hooks, LoRA in ops/layers.py and ops/quant.py, comparisons/noise_opt.py,
the runner's --method flags) vs the JAX package on the same weights
(longcat_tiny, fp32, JAX random init loaded through models/weights.py)
and the same draws: LoRA's init is carried over with
``train_params_from_numpy``, sigma, noise and DNO's draws are recomputed
from the reference's PRNG keys and injected.

Tolerances (fp32 on the CPU, summation order only, as in
test_torch_tta.py): DiT outputs and linears 1e-4 abs/rel; losses 1e-5
rel; trained tensors 1e-4 rel / 1e-6 abs (full: all but 1% of its
weights, and those within lr: AdamW's step is about lr for every weight,
also one whose gradient is near its summation noise); bf16 linears 2
bf16 ulps of the output scale. The bf16 ``full`` case (bf16 weights and AdamW state,
fp32 compute): losses 1e-4 rel, weights within one bf16 ulp plus 2 lr.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import chip_smoke
from longcat_video_tta_tpu.comparisons import noise_opt as jnoise
from longcat_video_tta_tpu.config import AdapterConfig as JaxAdapterConfig
from longcat_video_tta_tpu.config import OptimConfig as JaxOptimConfig
from longcat_video_tta_tpu.config import longcat_tiny as jax_tiny
from longcat_video_tta_tpu.models import dit as jdit
from longcat_video_tta_tpu.ops import layers as jlayers
from longcat_video_tta_tpu.ops import quant as jquant
from longcat_video_tta_tpu.pipeline import ModelBundle as JaxBundle
from longcat_video_tta_tpu.tta import losses as jlosses
from longcat_video_tta_tpu.tta.adapters import build_scheme as jax_build_scheme
from longcat_video_tta_tpu.tta.engine import build_optimizer as jax_build_optimizer
from longcat_video_tta_tpu_torch.comparisons import noise_opt as tnoise
from longcat_video_tta_tpu_torch.config import AdapterConfig, OptimConfig, longcat_tiny
from longcat_video_tta_tpu_torch.models.weights import (
    load_dit_from_numpy,
    train_params_from_numpy,
)
from longcat_video_tta_tpu_torch.ops import flash_attention as fa
from longcat_video_tta_tpu_torch.ops.layers import linear
from longcat_video_tta_tpu_torch.ops.quant import Int8Linear
from longcat_video_tta_tpu_torch.pipeline.pipeline import ModelBundle, generate_vc
from longcat_video_tta_tpu_torch.runners import run_tta
from longcat_video_tta_tpu_torch.tta.adapters import build_scheme, with_tensors
from longcat_video_tta_tpu_torch.tta.engine import build_optimizer, train_chunk, train_step

torch.set_num_threads(1)

TOL = dict(atol=1e-4, rtol=1e-4)
GRAD_TOL = dict(atol=1e-6, rtol=1e-4)
JCFG = jax_tiny()
TCFG = longcat_tiny()
D, L = TCFG.dit.hidden_size, TCFG.dit.depth

# the reference's own method configs (tests/test_tta.py::ALL_METHODS)
METHOD_CONFIGS = [
    dict(method="delta_a"),
    dict(method="delta_b", num_groups=2, delta_target="timestep"),
    dict(method="delta_b", num_groups=2, delta_target="hidden", delta_dim=16),
    dict(method="delta_c"),
    dict(method="film", num_groups=2, film_mode="shift_scale"),
    dict(method="lora", lora_rank=2, lora_alpha=4.0, target_blocks="last_1"),
    dict(method="norm_tune", norm_target="all_norm"),
    dict(method="full"),
]
METHOD_IDS = ["delta_a", "delta_b-timestep", "delta_b-hidden", "delta_c", "film",
              "lora", "norm_tune", "full"]


@pytest.fixture(scope="module")
def bundles():
    jb = JaxBundle.init_random(JCFG, seed=0)
    tonp = lambda t: jax.tree.map(np.asarray, t)
    tb = ModelBundle.from_numpy(TCFG, tonp(jb.dit_params), tonp(jb.vae_params),
                                tonp(jb.text_params), device="cpu")
    return jb, tb


@pytest.fixture(scope="module")
def data():
    """A TTA window of 2 cond + 1 train + 1 val latents of 4 x 6 and text."""
    rng = np.random.default_rng(0)
    f32 = lambda *s: rng.standard_normal(s).astype(np.float32)
    mask = np.ones((1, 16), np.int32)
    mask[:, 10:] = 0
    return dict(cond=f32(1, 16, 2, 4, 6), train=f32(1, 16, 1, 4, 6),
                val=f32(1, 16, 1, 4, 6), text=f32(1, 16, 48), mask=mask)


def _t(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _jax_draws(key, target_shape):
    """The sigma and noise flow_matching_loss_conditioned draws from key."""
    k_sig, k_noise = jax.random.split(key)
    sigma = jax.random.uniform(k_sig, (target_shape[0],), minval=0.001, maxval=1.0)
    noise = jax.random.normal(k_noise, target_shape, jnp.float32)
    return torch.from_numpy(np.array(sigma)), torch.from_numpy(np.array(noise))


# ---------------------------------------------------------------------------
# DiT adapter hooks
# ---------------------------------------------------------------------------


def _adapter(key, rng):
    f = lambda *s: (0.1 * rng.standard_normal(s)).astype(np.float32)
    if key == "lora":
        dims = {"qkv": (D, 3 * D), "attn_proj": (D, D), "xattn_q": (D, D),
                "xattn_kv": (D, 2 * D), "xattn_proj": (D, D),
                "ffn_w1": (D, TCFG.dit.ffn_dim), "ffn_w2": (TCFG.dit.ffn_dim, D),
                "ffn_w3": (D, TCFG.dit.ffn_dim)}
        lora = {site: {"a": f(L, i, 2), "b": f(L, 2, o)} for site, (i, o) in dims.items()}
        return {"lora": lora, "lora_scale": 2.0}
    shape = {"delta_t_blocks": (L, TCFG.dit.adaln_tembed_dim), "film_blocks": (L, 6 * D),
             "delta_h_blocks": (L, D), "delta_h_final": (D,),
             "delta_out": (TCFG.dit.out_channels,)}[key]
    # the t-embedding reaches the output through the adaLN weights only:
    # a larger delta moves it as much as the others
    return {key: f(*shape) * (20.0 if key == "delta_t_blocks" else 1.0)}


@pytest.mark.parametrize("entry", ["forward", "precompute_cond_cache",
                                   "forward_with_cache"])
@pytest.mark.parametrize("key", ["delta_t_blocks", "film_blocks", "lora",
                                 "delta_h_blocks", "delta_h_final", "delta_out"])
def test_dit_adapter_key_matches_jax(bundles, data, key, entry):
    """Each adapter key alone, on the three entry points."""
    jb, tb = bundles
    ad = _adapter(key, np.random.default_rng(1))
    jad = jax.tree.map(jnp.asarray, ad)
    tad = jax.tree.map(lambda a: torch.from_numpy(a) if isinstance(a, np.ndarray) else a,
                       ad)
    lat = np.concatenate([data["cond"], data["train"], data["val"]], axis=2)
    text, mask = data["text"], data["mask"]
    with torch.no_grad():
        if entry == "forward":
            ts = np.array([[0.0, 0.0, 640.0, 640.0]], np.float32)
            refs = [jdit.dit_forward(jb.dit_params, JCFG.dit, *_j(lat, ts, text, mask),
                                     num_cond_latents=2, adapters=jad)]
            outs = [tb.dit(*_t(lat, ts, text, mask), num_cond_latents=2, adapters=tad)]
            base = tb.dit(*_t(lat, ts, text, mask), num_cond_latents=2)
        else:
            cache = jdit.dit_precompute_cond_cache(
                jb.dit_params, JCFG.dit, *_j(lat[:, :, :2], text, mask), adapters=jad)
            tcache = tb.dit.precompute_cond_cache(*_t(lat[:, :, :2], text, mask),
                                                  adapters=tad)
            refs, outs, base = list(cache), list(tcache), None
            if entry == "forward_with_cache":
                refs = [jdit.dit_forward_with_cache(
                    jb.dit_params, JCFG.dit, jnp.asarray(lat[:, :, 2:]),
                    jnp.full((1,), 640.0), *_j(text, mask), cache,
                    num_cond_latents=2, adapters=jad)]
                outs = [tb.dit.forward_with_cache(
                    torch.from_numpy(lat[:, :, 2:]), torch.full((1,), 640.0),
                    *_t(text, mask), tcache, num_cond_latents=2, adapters=tad)]
                base = tb.dit.forward_with_cache(
                    torch.from_numpy(lat[:, :, 2:]), torch.full((1,), 640.0),
                    *_t(text, mask), tb.dit.precompute_cond_cache(
                        *_t(lat[:, :, :2], text, mask)), num_cond_latents=2)
    for o, r in zip(outs, refs):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), **TOL)
    if base is not None:  # the adapter moved the output: the test is not vacuous
        assert float((base - outs[0]).abs().max()) > 1e-3


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("int8", [False, True], ids=["dense", "int8"])
def test_linear_lora_matches_jax(int8, dtype):
    """linear / int8_linear with the LoRA side branch, added in x's dtype
    (after the W8A8 product and its cast for int8)."""
    rng = np.random.default_rng(2)
    K, N, r = 48, 40, 4
    kernel = (0.1 * rng.standard_normal((K, N))).astype(np.float32)
    bias = (0.1 * rng.standard_normal(N)).astype(np.float32)
    x = rng.standard_normal((3, 5, K)).astype(np.float32)
    lora = {"a": (0.1 * rng.standard_normal((K, r))).astype(np.float32),
            "b": (0.1 * rng.standard_normal((r, N))).astype(np.float32)}
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jp = {"kernel": jnp.asarray(kernel), "bias": jnp.asarray(bias)}
    layer = torch.nn.Linear(K, N)
    with torch.no_grad():
        layer.weight.copy_(torch.from_numpy(kernel.T))
        layer.bias.copy_(torch.from_numpy(bias))
    if int8:
        jp = jquant.quantize_linear_params(jp)
        layer = Int8Linear.from_linear(layer)
    jl = jax.tree.map(jnp.asarray, lora)
    tl = {k: torch.from_numpy(v) for k, v in lora.items()}
    ref = jlayers.linear(jp, jnp.asarray(x).astype(jdt), lora=jl, lora_scale=2.0)
    base = jlayers.linear(jp, jnp.asarray(x).astype(jdt))
    with torch.no_grad():
        out = linear(layer, torch.from_numpy(x).to(tdt), lora=tl, lora_scale=2.0)
    ref = np.asarray(ref.astype(jnp.float32))
    assert out.dtype == tdt
    tol = (dict(**TOL) if dtype == "float32"
           else dict(atol=2 * 2.0 ** -7 * float(np.abs(ref).max()), rtol=0))
    np.testing.assert_allclose(out.float().numpy(), ref, **tol)
    assert float(np.abs(ref - np.asarray(base.astype(jnp.float32))).max()) > 1e-2


# ---------------------------------------------------------------------------
# Schemes: init, to_forward, num_params and a 3-step trajectory
# ---------------------------------------------------------------------------


def _jax_trajectory(dit_params, scheme_j, tp_j, data, keys, ocfg, jcfg=JCFG):
    """The reference's steps: jax.value_and_grad of its conditioned loss
    and its build_optimizer, one jitted step."""
    tx = jax_build_optimizer(JaxOptimConfig(**ocfg))
    args_j = _j(data["cond"], data["train"], data["text"], data["mask"])

    @jax.jit
    def step(tp, state, key):
        def jloss(tp):
            dp, ad = scheme_j.to_forward(tp, dit_params)
            return jlosses.flow_matching_loss_conditioned(dp, jcfg.dit, *args_j, key,
                                                          adapters=ad)

        loss, grads = jax.value_and_grad(jloss)(tp)
        upd, state = tx.update(grads, state, tp)
        return optax.apply_updates(tp, upd), state, loss

    state, losses = tx.init(tp_j), []
    for key in keys:
        tp_j, state, loss = step(tp_j, state, key)
        losses.append(float(loss))
    return tp_j, losses


def _assert_close_but_few(out, ref, lr):
    """full's weights: AdamW moves each weight by about lr whatever the size
    of its gradient, so a weight whose gradient is near its fp32 summation
    noise takes a step that differs by a share of lr. All but 1% of the
    elements of all weights together within 1e-4 rel / 1e-6 abs, and those
    within lr."""
    out = np.concatenate([out[k].numpy().ravel() for k in sorted(out)])
    ref = np.concatenate([ref[k].numpy().ravel() for k in sorted(ref)])
    diff = np.abs(out - ref)
    off = diff > GRAD_TOL["atol"] + GRAD_TOL["rtol"] * np.abs(ref)
    assert off.mean() <= 1e-2 and diff.max() <= lr, (off.sum(), diff.max())


@pytest.mark.parametrize("cfg", METHOD_CONFIGS, ids=METHOD_IDS)
def test_scheme_trajectory_matches_jax(bundles, data, cfg):
    """3 AdamW steps from the reference's own init (carried over with
    train_params_from_numpy), with its draws injected: the losses, the
    trained tensors, the adapted DiT's output on the trained tensors, and
    num_params. The base DiT is untouched."""
    jb, tb = bundles
    scheme_j = jax_build_scheme(JCFG.dit, JaxAdapterConfig(**cfg))
    scheme = build_scheme(TCFG.dit, AdapterConfig(**cfg))
    tp_j0 = scheme_j.init(jax.random.PRNGKey(3), base_params=jb.dit_params)
    tp0 = train_params_from_numpy(scheme, _np_tree(tp_j0), device="cpu")
    # the port's own init has the reference's keys, shapes and zeros
    own = scheme.init("cpu", dit=tb.dit, generator=torch.Generator().manual_seed(0))
    assert {k: tuple(v.shape) for k, v in own.items()} == \
        {k: tuple(v.shape) for k, v in tp0.items()}
    assert scheme.num_params(tp0) == scheme_j.num_params(tp_j0) == scheme.num_params(own)
    base_before = {k: v.clone() for k, v in tb.dit.state_dict().items()}

    ocfg = dict(lr=1e-2, warmup_steps=1)
    keys = [jax.random.PRNGKey(100 + i) for i in range(3)]
    tp_j, losses_j = _jax_trajectory(jb.dit_params, scheme_j, tp_j0, data, keys, ocfg)
    opt = build_optimizer(OptimConfig(**ocfg))
    tp, _, losses, _ = train_chunk(
        scheme, tb.dit, opt, tp0, opt.init(tp0),
        *_t(data["cond"], data["train"], data["text"], data["mask"]), steps=3,
        draws=[_jax_draws(k, data["train"].shape) for k in keys])
    np.testing.assert_allclose(losses.numpy(), np.asarray(losses_j), rtol=1e-5)
    ref = train_params_from_numpy(scheme, _np_tree(tp_j), device="cpu")
    assert set(tp) == set(ref)
    if cfg["method"] == "full":
        _assert_close_but_few(tp, ref, ocfg["lr"])
    moved = 0.0
    for k in tp:
        if cfg["method"] != "full":
            np.testing.assert_allclose(tp[k].numpy(), ref[k].numpy(), err_msg=k,
                                       **GRAD_TOL)
        moved = max(moved, float((tp[k] - tp0[k]).abs().max()))
    assert moved > 1e-3

    lat = np.concatenate([data["cond"], data["train"]], axis=2)
    ts = np.array([[0.0, 0.0, 500.0]], np.float32)
    dp_j, ad_j = scheme_j.to_forward(tp_j, jb.dit_params)
    ref_out = jdit.dit_forward(dp_j, JCFG.dit, *_j(lat, ts, data["text"], data["mask"]),
                               num_cond_latents=2, adapters=ad_j)
    with torch.no_grad():
        dit, ad = scheme.to_forward(tp, tb.dit)
        out = dit(*_t(lat, ts, data["text"], data["mask"]), num_cond_latents=2,
                  adapters=ad)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_out), **TOL)
    for k, v in tb.dit.state_dict().items():
        assert torch.equal(v, base_before[k]), k


def test_full_bf16_trajectory_matches_jax(data):
    """full with bf16 weights (fp32 compute): the gradients arrive in bf16
    and the AdamW state is bf16 in both packages."""
    jcfg = dataclasses.replace(JCFG, dit=dataclasses.replace(JCFG.dit, param_dtype="bfloat16"))
    tcfg = dataclasses.replace(TCFG, dit=dataclasses.replace(TCFG.dit, param_dtype="bfloat16"))
    params_j = jdit.init_dit(jax.random.PRNGKey(5), jcfg.dit, zero_init=False)
    dit = load_dit_from_numpy(_np_tree(params_j), tcfg.dit, device="cpu")
    scheme_j = jax_build_scheme(jcfg.dit, JaxAdapterConfig(method="full"))
    scheme = build_scheme(tcfg.dit, AdapterConfig(method="full"))
    ocfg = dict(lr=1e-3)
    keys = [jax.random.PRNGKey(200 + i) for i in range(2)]
    tp_j, losses_j = _jax_trajectory(params_j, scheme_j, params_j, data, keys, ocfg, jcfg)
    opt = build_optimizer(OptimConfig(**ocfg))
    tp = scheme.init("cpu", dit=dit)
    state = opt.init(tp)
    assert {v.dtype for v in state["mu"].values()} == {torch.bfloat16, torch.float32}
    losses = []
    for k in keys:
        sigma, noise = _jax_draws(k, data["train"].shape)
        tp, state, loss = train_step(
            scheme, dit, opt, tp, state,
            *_t(data["cond"], data["train"], data["text"], data["mask"]),
            sigma=sigma, noise=noise)
        losses.append(float(loss))
    np.testing.assert_allclose(losses, losses_j, rtol=1e-4)
    ref = {n: p.detach() for n, p in load_dit_from_numpy(
        _np_tree(tp_j), tcfg.dit, device="cpu").named_parameters()}
    for k, v in tp.items():
        assert v.dtype == ref[k].dtype
        r = ref[k].float()
        np.testing.assert_allclose(v.float().numpy(), r.numpy(), err_msg=k,
                                   atol=2 * 2 * ocfg["lr"], rtol=2.0 ** -8)


def test_delta_b_group1_equals_delta_a(bundles, data):
    """delta_b(G=1, timestep, all blocks) == delta_a with the final
    layer's adaLN kernel zeroed (the only place they differ)."""
    _, tb = bundles
    dit = with_tensors(tb.dit, {"final.adaln.weight": torch.zeros_like(
        tb.dit.final["adaln"].weight)})
    delta = 0.2 * torch.from_numpy(
        np.random.default_rng(9).standard_normal(TCFG.dit.adaln_tembed_dim).astype(np.float32))
    sa = build_scheme(TCFG.dit, AdapterConfig(method="delta_a"))
    sb = build_scheme(TCFG.dit, AdapterConfig(method="delta_b", num_groups=1))
    lat = np.concatenate([data["cond"], data["train"]], axis=2)
    args = _t(lat, np.full((1,), 500.0, np.float32), data["text"], data["mask"])
    with torch.no_grad():
        outs = [dit(*args, adapters=s.to_forward(tp, dit)[1]) for s, tp in (
            (sa, {"delta": delta}), (sb, {"deltas": delta[None]}))]
        base = tb.dit(*args)
    torch.testing.assert_close(outs[0], outs[1], atol=1e-5, rtol=0)
    assert float((outs[0] - base).abs().max()) > 1e-4


def test_lora_builtin_equals_side_branch(bundles, data):
    """Merged weights (W + scale * a @ b, transposed into [out, in]) ==
    the side branch, in the forward and over 2 SGD steps."""
    _, tb = bundles
    base = AdapterConfig(method="lora", lora_rank=2, lora_alpha=4.0, lora_target_ffn=True)
    s_side = build_scheme(TCFG.dit, base)
    s_merged = build_scheme(TCFG.dit, dataclasses.replace(base, lora_builtin=True))
    tp = {k: v + 0.01 for k, v in s_side.init(
        "cpu", generator=torch.Generator().manual_seed(3)).items()}
    lat = np.concatenate([data["cond"], data["train"]], axis=2)
    args = _t(lat, np.full((1,), 500.0, np.float32), data["text"], data["mask"])
    with torch.no_grad():
        dit_s, ad_s = s_side.to_forward(tp, tb.dit)
        dit_m, ad_m = s_merged.to_forward(tp, tb.dit)
        assert dit_s is tb.dit and ad_m is None and dit_m is not tb.dit
        torch.testing.assert_close(dit_m(*args), dit_s(*args, adapters=ad_s),
                                   atol=2e-5, rtol=1e-5)
    opt = build_optimizer(OptimConfig(optimizer="sgd", lr=1e-2))
    ends = []
    for scheme in (s_side, s_merged):
        tpi, state = tp, opt.init(tp)
        for s in range(2):
            sigma, noise = _jax_draws(jax.random.PRNGKey(10 + s), data["train"].shape)
            tpi, state, loss = train_step(
                scheme, tb.dit, opt, tpi, state,
                *_t(data["cond"], data["train"], data["text"], data["mask"]),
                sigma=sigma, noise=noise)
        ends.append((float(loss), tpi))
    np.testing.assert_allclose(ends[1][0], ends[0][0], rtol=1e-5)
    for k in tp:
        torch.testing.assert_close(ends[1][1][k], ends[0][1][k], atol=1e-6, rtol=1e-4)


def test_norm_tune_counts_and_delta_combo(bundles, data):
    """The three norm scopes select exactly the norm affines; with
    also_tune_delta a delta_a vector trains alongside and moves."""
    _, tb = bundles
    dh = TCFG.dit.head_dim
    n = {t: build_scheme(TCFG.dit, AdapterConfig(method="norm_tune", norm_target=t))
         for t in ("cross_attn_norm", "qk_norm", "all_norm")}
    counts = {t: s.num_params(s.init("cpu", dit=tb.dit)) for t, s in n.items()}
    assert counts == {"cross_attn_norm": L * D * 2, "qk_norm": L * dh * 4,
                      "all_norm": L * D * 2 + L * dh * 4}
    scheme = build_scheme(TCFG.dit, AdapterConfig(method="norm_tune", also_tune_delta=True))
    tp = scheme.init("cpu", dit=tb.dit)
    assert "delta_t" in tp and "blocks.1.pre_crs_norm.bias" in tp
    _, adapters = scheme.to_forward(tp, tb.dit)
    assert set(adapters) == {"delta_t"}
    opt = build_optimizer(OptimConfig(lr=1e-2, warmup_steps=2))
    state = opt.init(tp)
    for i in range(3):
        tp, state, loss = train_step(
            scheme, tb.dit, opt, tp, state,
            *_t(data["cond"], data["train"], data["text"], data["mask"]),
            generator=torch.Generator().manual_seed(i))
        assert np.isfinite(float(loss))
    assert float(tp["delta_t"].abs().max()) > 0


# ---------------------------------------------------------------------------
# DNO
# ---------------------------------------------------------------------------


def test_sample_from_noise_matches_jax(bundles, data):
    jb, tb = bundles
    noise = np.random.default_rng(4).standard_normal(data["train"].shape).astype(np.float32)
    ref = jnoise.sample_from_noise(jb.dit_params, JCFG.dit, JCFG.scheduler,
                                   *_j(noise, data["cond"], data["text"], data["mask"]),
                                   num_steps=3)
    with torch.no_grad():
        out = tnoise.sample_from_noise(tb.dit, TCFG.scheduler,
                                       *_t(noise, data["cond"], data["text"], data["mask"]),
                                       num_steps=3)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_optimize_noise_matches_jax(bundles, data):
    """Two Adam steps through a 2-step sampler with the interpolation after
    each: the reference's initial noise and interpolation draws (from its
    PRNG key) injected."""
    jb, tb = bundles
    rng = jax.random.PRNGKey(11)
    kw = dict(num_opt_steps=2, sampler_steps=2, lr=0.01, interp_p=0.9, interp_every=1)
    ref, info = jnoise.optimize_noise(
        jb.dit_params, JCFG.dit, JCFG.scheduler,
        *_j(data["cond"], data["train"], data["text"], data["mask"]), rng, **kw)
    k0, r = jax.random.split(rng)
    init = jax.random.normal(k0, data["train"].shape, jnp.float32)
    fresh = []
    for _ in range(2):
        r, k = jax.random.split(r)
        fresh.append(torch.from_numpy(np.array(jax.random.normal(k, init.shape))))
    out, tinfo = tnoise.optimize_noise(
        tb.dit, TCFG.scheduler, *_t(data["cond"], data["train"], data["text"],
                                    data["mask"]),
        init_noise=torch.from_numpy(np.array(init)), fresh_noises=fresh, **kw)
    np.testing.assert_allclose(tinfo["losses"], info["losses"], rtol=1e-5)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **GRAD_TOL)
    assert float((out - torch.from_numpy(np.array(init))).abs().max()) > 1e-3


# ---------------------------------------------------------------------------
# Kernel launch counts per method (chip_smoke's derivation)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("graph,cfg", [
    ("t_embed", dict(method="film", film_mode="shift_scale")),
    ("cross_kv", dict(method="lora", lora_target_ffn=True)),
    ("cross_kv", dict(method="norm_tune", norm_target="all_norm", also_tune_delta=True)),
    ("cross_kv", dict(method="full")),
    ("cross_norm", dict(method="norm_tune")),
    ("hidden", dict(method="delta_b", delta_target="hidden", delta_dim=32,
                    target_blocks="last_1")),
    ("output", dict(method="delta_c")),
    ("dno", None),
], ids=["film", "lora_ffn", "norm_all_delta", "full", "norm_cross", "delta_b_hidden",
        "delta_c", "dno"])
def test_attention_calls_per_train_step(bundles, data, monkeypatch, graph, cfg):
    """The attention forwards, dQ and dK/dV backwards one train step (or
    one DNO step through a 2-step sampler) runs with full remat, counted
    on the CPU path, against chip_smoke's ``train_step_launches`` that
    the card's launch gates use."""
    _, tb = bundles
    dit = with_tensors(tb.dit, {})
    dit.cfg = dataclasses.replace(tb.dit.cfg, remat=True)
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
    args = _t(data["cond"], data["train"], data["text"], data["mask"])
    if graph == "dno":
        step = tnoise.make_dno_step(TCFG.scheduler, tnoise.build_dno_optimizer(0.01), 2)
        noise = torch.randn(args[1].shape, generator=torch.Generator().manual_seed(0))
        step(noise, tnoise.build_dno_optimizer(0.01).init({"noise": noise}), dit, *args)
        expected = {k: 2 * n for k, n in chip_smoke.train_step_launches("t_embed", L).items()}
    else:
        scheme = build_scheme(TCFG.dit, AdapterConfig(**cfg))
        opt = build_optimizer(OptimConfig())
        tp = scheme.init("cpu", dit=dit, generator=torch.Generator().manual_seed(0))
        train_step(scheme, dit, opt, tp, opt.init(tp), *args,
                   generator=torch.Generator().manual_seed(1))
        expected = chip_smoke.train_step_launches(graph, L)
    assert calls == expected


# ---------------------------------------------------------------------------
# Generation with an adapted DiT, and the runner
# ---------------------------------------------------------------------------


def test_generate_vc_quantizes_an_adapted_dit_uncached(bundles):
    """A per-video adapted DiT (full here) under W8A8 is quantized for that
    call only: the bundle's int8 cache stays empty, and the result differs
    from the base model's."""
    _, tb = bundles
    scheme = build_scheme(TCFG.dit, AdapterConfig(method="full"))
    tp = {k: v * 2.0 for k, v in scheme.init("cpu", dit=tb.dit).items()}
    adapted, _ = scheme.to_forward(tp, tb.dit)
    rng = np.random.default_rng(8)
    cond = rng.uniform(-1, 1, (1, 3, 5, 16, 32)).astype(np.float32)
    noise = torch.from_numpy(rng.standard_normal((1, 16, 2, 2, 4)).astype(np.float32))
    kw = dict(num_frames=5, num_inference_steps=2, init_noise=noise,
              quantize_decode="int8")
    tb.int8_cache.clear()
    out = generate_vc(tb, cond, "a ball moving", dit=adapted, **kw)
    assert not tb.int8_cache
    base = generate_vc(tb, cond, "a ball moving", **kw)
    assert len(tb.int8_cache) == 1 and float(np.abs(out - base).max()) > 1e-3
    tb.int8_cache.clear()


RUNNER_FLAGS = {
    "lora": ["--lora-target-ffn", "--quantize-decode", "int8"],
    "delta_b": ["--delta-target", "hidden", "--delta-dim", "32", "--target-blocks",
                "last_1"],
    "delta_c": [],
    "film": ["--film-mode", "shift_scale"],
    "norm_tune": ["--norm-target", "all_norm", "--also-tune-delta"],
    "full": ["--optimizer", "sgd"],
    "dno": ["--dno-sampler-steps", "2", "--dno-interp-every", "1"],
}


@pytest.mark.parametrize("method", list(RUNNER_FLAGS))
def test_runner_method_writes_a_finite_summary(bundles, tmp_path, method):
    out = str(tmp_path / "run")
    steps = 2 if method == "dno" else 4
    argv = ["--method", method, "--preset", "longcat_tiny", "--synthetic", "1",
            "--device", "cpu", "--output-dir", out, "--height", "16", "--width", "32",
            "--num-cond-frames", "5", "--num-frames", "5", "--gen-start-frame", "16",
            "--tta-total-frames", "13", "--steps", str(steps), "--es-check-every", "2",
            "--num-inference-steps", "2", "--caption-guard-mode", "off",
            "--no-save-videos", *RUNNER_FLAGS[method]]
    summary = run_tta.main(argv)
    assert summary["num_success"] == 1
    with open(os.path.join(out, "summary.json")) as f:
        r = json.load(f)["results"][0]
    assert len(r["losses"]) == steps and np.isfinite(r["losses"]).all()
    assert np.isfinite(r["psnr"]) and np.isfinite(r["ssim"])
    if method == "dno":
        # the whole post-context window: 1 latent of 2 x 4
        assert r["trainable_params"] == 16 * 1 * 2 * 4 and r["noise_norm"] > 0
        return
    args = run_tta.build_arg_parser().parse_args(argv)
    jscheme = jax_build_scheme(JCFG.dit, JaxAdapterConfig(**dataclasses.asdict(
        run_tta.adapter_config(args))))
    n_ref = jscheme.num_params(jscheme.init(jax.random.PRNGKey(0),
                                            base_params=bundles[0].dit_params))
    assert r["trainable_params"] == n_ref
    es = r["early_stopping_info"]
    history = [loss for _, loss in es["loss_history"]]
    assert len(history) == 3 and np.isfinite(history).all()
    # the zero-initialised adapters moved unless the stopper restored step 0
    assert np.isfinite(r["adapter_norm"])
    if method in ("delta_b", "delta_c", "film") and es["best_step"] > 0:
        assert r["adapter_norm"] > 0
