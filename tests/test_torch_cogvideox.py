"""The port's CogVideoX-5B-I2V path against the JAX package on the CPU, at
cogvideox_tiny size (hidden 64, 4 heads of 16, 2 blocks, in_channels 32),
on the same weights (JAX ``init_random`` -> ``from_numpy``) and the same
draws (JAX's sigma, noise and initial volume injected into the port). JAX
runs its plain attention (``attn_impl="xla"``), the port the plain
version of its kernels.

Tolerances (fp32 throughout): the forward, the losses and the gradients
within 1e-5 relative (atol 1e-6 on O(1) values, 1e-5 abs on gradient
entries); the DDIM step indices exactly, the alphas within 1e-6 abs (XLA
folds jnp.linspace's division into a reciprocal product, which the port
mirrors, and runs cumprod as a parallel scan, whose association the
sequential product does not; 7.2e-7 measured); the sampler within 1e-4
abs on O(1) latents after 4 DDIM steps; generated pixels within 1e-4 abs
on [0, 1]; the W8A8 forward and the int8 lever run within 2e-3 (W8A8
rounds activations per token: a one-ulp difference before the rounding
can move one int8 step). The converter and the exact-equivalence checks
(PAB every 1, CFG reuse every 1, segmented sampling) are bit for bit.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from longcat_video_tta_tpu.config import AdapterConfig as JAdapterConfig
from longcat_video_tta_tpu.config import CFGReuseConfig as JCFGReuse
from longcat_video_tta_tpu.config import PABConfig as JPAB
from longcat_video_tta_tpu.models import cogvideox as jcv
from longcat_video_tta_tpu.models.backbones import cogvideox_tiny as jax_tiny
from longcat_video_tta_tpu.ops.quant import quantize_cogvideox_blocks_int8 as jax_quantize
from longcat_video_tta_tpu.pipeline import ModelBundle as JaxBundle
from longcat_video_tta_tpu.pipeline import generate_vc as jax_generate_vc
from longcat_video_tta_tpu.pipeline import sampler as jsampler
from longcat_video_tta_tpu.tta import losses as jlosses
from longcat_video_tta_tpu.tta.adapters import build_scheme as jax_build_scheme
from longcat_video_tta_tpu_torch.config import (
    AdapterConfig,
    CFGReuseConfig,
    OptimConfig,
    PABConfig,
)
from longcat_video_tta_tpu_torch.models import cogvideox, convert
from longcat_video_tta_tpu_torch.models.backbones import cogvideox_tiny
from longcat_video_tta_tpu_torch.models.weights import (
    load_cogvideox_from_numpy,
    train_params_from_numpy,
)
from longcat_video_tta_tpu_torch.ops import flash_attention as fa
from longcat_video_tta_tpu_torch.ops import quant
from longcat_video_tta_tpu_torch.pipeline import sampler
from longcat_video_tta_tpu_torch.pipeline.pipeline import ModelBundle, generate_vc
from longcat_video_tta_tpu_torch.tta import losses
from longcat_video_tta_tpu_torch.tta.adapters import build_scheme
from longcat_video_tta_tpu_torch.tta.engine import build_optimizer, train_step
from longcat_video_tta_tpu_torch.utils.safetensors import save_file
from test_cogvideox import _synthetic_cogvideox_state_dict

torch.set_num_threads(1)

JCFG, TCFG = jax_tiny(), cogvideox_tiny()
CFG = TCFG.dit


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _t(*arrays):
    return [torch.from_numpy(np.asarray(a, np.float32)) for a in arrays]


@pytest.fixture(scope="module")
def bundles():
    jb = JaxBundle.init_random(JCFG, seed=0)
    tb = ModelBundle.from_numpy(TCFG, _np_tree(jb.dit_params), _np_tree(jb.vae_params),
                                _np_tree(jb.text_params), device="cpu")
    return jb, tb


@pytest.fixture(scope="module")
def data():
    """2 cond + 2 target latents of 4 x 6 (6 tokens each), 16 text tokens."""
    rng = np.random.default_rng(0)
    f32 = lambda *s: rng.standard_normal(s).astype(np.float32)
    return dict(cond=f32(1, 16, 2, 4, 6), target=f32(1, 16, 2, 4, 6),
                val=f32(1, 16, 1, 4, 6), txt=f32(1, 16, 32), txt2=f32(2, 16, 32),
                delta=0.1 * f32(CFG.time_embed_dim))


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


def _lora_stacks(seed):
    """Random a and b on all six sites (b off zero, so each site acts)."""
    rng = np.random.default_rng(seed)
    D, F = CFG.hidden_size, CFG.ffn_dim
    dims = {"to_q": (D, D), "to_k": (D, D), "to_v": (D, D), "to_out": (D, D),
            "ff_in": (D, F), "ff_out": (F, D)}
    return {site: {"a": 0.1 * rng.standard_normal((CFG.depth, i, 2)).astype(np.float32),
                   "b": 0.1 * rng.standard_normal((CFG.depth, 2, o)).astype(np.float32)}
            for site, (i, o) in dims.items()}


FORWARD_CASES = ["t2v", "i2v", "delta_t", "lora", "pos_embed", "pab_write", "pab_reuse",
                 "cond_half_write", "cond_half_reuse"]


@pytest.mark.parametrize("case", FORWARD_CASES)
def test_forward_matches_jax(bundles, data, case):
    """CogVideX.forward against cogvideox_forward: without and with image
    latents, a learned pos_embed, delta_t, LoRA on all six sites, a PAB
    cache written and reused, and the CFG-reuse conditional half."""
    jb, tb = bundles
    jp, jcfg, dit = jb.dit_params, JCFG.dit, tb.dit
    lat = np.concatenate([data["cond"], data["target"]], axis=2)
    img = losses.cogvideox_image_latents(torch.from_numpy(data["cond"]), 4).numpy()
    ts = np.array([371.0], np.float32)
    kw, tkw = {}, {}
    if case != "t2v":
        kw["image_latents"], tkw["image_latents"] = jnp.asarray(img), torch.from_numpy(img)
    if case == "delta_t":
        kw["adapters"] = {"delta_t": jnp.asarray(data["delta"])}
        tkw["adapters"] = {"delta_t": torch.from_numpy(data["delta"])}
    if case == "lora":
        stacks = _lora_stacks(1)
        kw["adapters"] = {"lora": jax.tree.map(jnp.asarray, stacks), "lora_scale": 2.0}
        tkw["adapters"] = {"lora": jax.tree.map(torch.from_numpy, stacks), "lora_scale": 2.0}
    if case == "pos_embed":
        # 16 text + 4 x 6 video tokens = 40 rows of the table
        jcfg = dataclasses.replace(jcfg, learned_pos_embed_len=40)
        jp = jcv.init_cogvideox(jax.random.PRNGKey(4), jcfg, zero_init=False)
        dit = load_cogvideox_from_numpy(_np_tree(jp), dataclasses.replace(
            CFG, learned_pos_embed_len=40), "cpu")
    cache = None
    B = 2 if case.startswith("cond_half") else 1
    if case.startswith(("pab", "cond_half")):
        rng = np.random.default_rng(2)
        cache = rng.standard_normal((CFG.depth, B, 40, CFG.hidden_size)).astype(np.float32)
        if case == "pab_write":
            cache[:] = 0
        reuse = case.endswith("reuse")
        kw.update(pab_reuse=jnp.asarray(reuse), pab_cache=jnp.asarray(cache),
                  cache_cond_half=case.startswith("cond_half"))
        tcache = torch.from_numpy(cache.copy())
        tkw.update(pab_reuse=reuse, pab_cache=tcache,
                   cache_cond_half=case.startswith("cond_half"))
    ref = jcv.cogvideox_forward(jp, jcfg, jnp.asarray(lat), jnp.asarray(ts),
                                jnp.asarray(data["txt"]), attn_impl="xla", **kw)
    with torch.no_grad():
        out = dit(*_t(lat, ts, data["txt"]), **tkw)
    if cache is not None:
        ref, new_cache = ref
        # the port writes the slot in place: the whole cache, or its last
        # (conditional) rows under cache_cond_half
        got_cache = tcache[:, B - 1:] if case.startswith("cond_half") else tcache
        np.testing.assert_allclose(got_cache.numpy(), np.asarray(new_cache), rtol=1e-5,
                                   atol=1e-6)
        if case.endswith("reuse"):
            assert np.array_equal(tcache.numpy(), cache)
    assert out.shape == lat.shape and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-6)


def test_forward_refuses_what_it_does_not_take(bundles, data):
    _, tb = bundles
    x, ts, txt = _t(np.zeros((1, 16, 1, 4, 6)), [500.0], data["txt"])
    with pytest.raises(NotImplementedError, match="delta_out"):
        tb.dit(x, ts, txt, adapters={"delta_out": torch.zeros(16)})
    short = dataclasses.replace(CFG, learned_pos_embed_len=20)
    dit = cogvideox.CogVideoX(short)
    with pytest.raises(ValueError, match="exceeds learned pos-embed table 20"):
        dit(x, ts, txt)


def test_param_count_full_size_and_tiny(bundles):
    jb, tb = bundles
    assert cogvideox.count_params(tb.dit) == jcv.count_params(jb.dit_params)
    from longcat_video_tta_tpu_torch.models.backbones import cogvideox_5b

    with torch.device("meta"):
        full = cogvideox.count_params(cogvideox.CogVideoX(cogvideox_5b().dit))
    assert 5.5e9 < full < 5.6e9
    assert cogvideox_5b().dit.head_dim == 64 and cogvideox_5b().arch == "cogvideox"


# ---------------------------------------------------------------------------
# DDIM schedule, sampler, generate_vc
# ---------------------------------------------------------------------------


def test_alphas_and_step_indices_match_jax():
    ab = sampler.cogvideox_alphas_cumprod().numpy()
    ref = np.asarray(jsampler.cogvideox_alphas_cumprod())
    np.testing.assert_allclose(ab, ref, rtol=0, atol=1e-6)
    assert ab[-1] == 0.0 and ab.dtype == np.float32
    # 7, 13 and 19 steps put an index at x.5 in exact arithmetic, where
    # fp32's rounding of linspace decides it
    for n in (1, 2, 3, 4, 7, 13, 19, 50):
        _, _, (idx, ab_t, ab_prev) = jsampler._cogvideox_setup(
            JCFG.dit, jax.random.PRNGKey(0), jnp.zeros((2, 16, 32)), 1, n, 4, 6, None)
        t_idx, t_ab, t_prev = sampler.cogvideox_schedule(n)
        np.testing.assert_array_equal(t_idx.numpy(), np.asarray(idx), err_msg=str(n))
        np.testing.assert_allclose(t_ab.numpy(), np.asarray(ab_t), atol=1e-6)
        np.testing.assert_allclose(t_prev.numpy(), np.asarray(ab_prev), atol=1e-6)
        assert t_prev[-1] == 1.0


def _levers(pab=0, cfgr=0):
    j, t = {}, {}
    if pab:
        j["pab_cfg"] = JPAB(every=pab, start_frac=0.0, end_frac=1.0)
        t["pab_cfg"] = PABConfig(every=pab, start_frac=0.0, end_frac=1.0)
    if cfgr:
        j["cfgr_cfg"] = JCFGReuse(every=cfgr, start_frac=0.0, end_frac=1.0)
        t["cfgr_cfg"] = CFGReuseConfig(every=cfgr, start_frac=0.0, end_frac=1.0)
    return j, t


SAMPLER_CASES = {"plain": (0, 0, 0), "pab1": (1, 0, 0), "pab2": (2, 0, 0),
                 "cfgr2": (0, 2, 0), "pab2_cfgr2": (2, 2, 0),
                 "segmented_pab2_cfgr2": (2, 2, 2)}


@pytest.mark.parametrize("case", list(SAMPLER_CASES))
def test_sample_latents_cogvideox_matches_jax(bundles, data, case):
    """Both samplers from JAX's own initial draw, with delta_t, under PAB
    every 1 and 2, CFG reuse and both, one dispatch and segmented."""
    jb, tb = bundles
    pab, cfgr, seg = SAMPLER_CASES[case]
    jkw, tkw = _levers(pab, cfgr)
    rng = jax.random.PRNGKey(7)
    kw = dict(num_gen_latents=2, num_steps=4, lat_h=4, lat_w=6, guidance=6.0)
    jfn, tfn = jsampler.sample_latents_cogvideox, sampler.sample_latents_cogvideox
    if seg:
        jfn, tfn = jsampler.sample_latents_cogvideox_segmented, \
            sampler.sample_latents_cogvideox_segmented
        jkw["segment_steps"] = tkw["segment_steps"] = seg
    ref = jfn(jb.dit_params, JCFG.dit, rng, jnp.asarray(data["txt2"]),
              cond_latents=jnp.asarray(data["cond"]),
              adapters={"delta_t": jnp.asarray(data["delta"])}, attn_impl="xla", **kw, **jkw)
    x0 = jax.random.normal(rng, (1, 16, 4, 4, 6), jnp.float32)  # _cogvideox_setup's draw
    fa.reset_launches()
    with torch.no_grad():
        out = tfn(tb.dit, torch.from_numpy(data["txt2"]),
                  cond_latents=torch.from_numpy(data["cond"]),
                  adapters={"delta_t": torch.from_numpy(data["delta"])},
                  init_x=torch.from_numpy(np.array(x0)), **kw, **tkw)
    assert fa.launches == 0  # CPU tensors: the plain version, no kernel
    assert out.shape == (1, 16, 4, 4, 6)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4)


def test_pab_and_cfg_reuse_every1_exact_and_segments_equal(bundles, data):
    """PAB every 1 and CFG reuse every 1 reuse nothing: bit for bit the
    plain loop; segmented sampling equals one loop with the cache and the
    delta carried across segments."""
    _, tb = bundles
    x0 = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (1, 16, 4, 4, 6)).astype(np.float32))
    kw = dict(num_gen_latents=2, num_steps=4, lat_h=4, lat_w=6, init_x=x0,
              cond_latents=torch.from_numpy(data["cond"]))
    txt2 = torch.from_numpy(data["txt2"])
    run = lambda fn=sampler.sample_latents_cogvideox, **extra: fn(tb.dit, txt2, **kw,
                                                                  **extra)
    with torch.no_grad():
        plain = run()
        assert torch.equal(run(pab_cfg=PABConfig(every=1)), plain)
        assert torch.equal(run(cfgr_cfg=CFGReuseConfig(every=1)), plain)
        levers = _levers(2, 2)[1]
        one = run(**levers)
        seg = run(fn=sampler.sample_latents_cogvideox_segmented, segment_steps=1, **levers)
    assert torch.equal(one, seg) and not torch.equal(one, plain)


@pytest.mark.parametrize("lever", ["plain", "int8_pab_cfgr_segments"])
def test_generate_vc_matches_jax(bundles, lever):
    jb, tb = bundles
    rng = np.random.default_rng(4)
    cond = rng.uniform(-1, 1, (1, 3, 5, 32, 48)).astype(np.float32)
    kw = dict(num_frames=5, num_inference_steps=3, guidance_scale=6.0,
              negative_prompt="blurry", seed=5)
    tkw, jkw, atol = {}, {}, 1e-4
    if lever != "plain":
        jkw, tkw = _levers(2, 2)
        for d in (jkw, tkw):
            d.update(quantize_decode="int8", gen_segment_steps=1)
        atol = 2e-3
    ref = jax_generate_vc(jb, jnp.asarray(cond), "a ball moving", attn_impl="xla",
                          **kw, **jkw)
    # 5 cond frames -> 2 latents, 5 generated frames -> 2 latents of 4 x 6
    x0 = jax.random.normal(jax.random.PRNGKey(5), (1, 16, 4, 4, 6), jnp.float32)
    phases = []
    out = generate_vc(tb, cond, "a ball moving", init_x=torch.from_numpy(np.array(x0)),
                      on_phase=phases.append, **kw, **tkw)
    assert phases == ["vae_encode", "prompt_encode"] + ["step"] * 3 + ["vae_decode", "end"]
    assert out.shape == ref.shape == (5, 32, 48, 3)
    np.testing.assert_allclose(out, np.asarray(ref), atol=atol)


def test_generate_vc_refuses_what_jax_refuses(bundles):
    jb, tb = bundles
    cond = np.zeros((1, 3, 5, 32, 48), np.float32)
    from longcat_video_tta_tpu.config import BSAConfig as JBSA
    from longcat_video_tta_tpu_torch.config import BSAConfig

    for tkw, jkw in ((dict(bsa_cfg=BSAConfig()), dict(bsa_cfg=JBSA())),
                     (dict(bucket_gen=True), dict(bucket_gen=True)),
                     (dict(init_noise=torch.zeros(1, 16, 2, 4, 6)),
                      dict(init_noise=jnp.zeros((1, 16, 2, 4, 6)))),
                     (dict(quantize_decode="int8qk"), dict(quantize_decode="int8qk"))):
        with pytest.raises(NotImplementedError) as te:
            generate_vc(tb, cond, "x", num_frames=5, num_inference_steps=1, **tkw)
        with pytest.raises(NotImplementedError) as je:
            jax_generate_vc(jb, jnp.asarray(cond), "x", num_frames=5,
                            num_inference_steps=1, attn_impl="xla", **jkw)
        assert str(te.value) == str(je.value)


# ---------------------------------------------------------------------------
# losses and the three methods' gradients
# ---------------------------------------------------------------------------


def _jax_draws(key, shape):
    """cogvideox_flow_matching_loss_conditioned's own sigma and noise (the
    noise over the whole [cond | target] window)."""
    k_sig, k_noise = jax.random.split(key)
    sigma = jax.random.uniform(k_sig, (shape[0],), minval=0.001, maxval=1.0)
    return np.asarray(sigma), np.asarray(jax.random.normal(k_noise, shape, jnp.float32))


WINDOW = (1, 16, 4, 4, 6)


def test_losses_match_jax(bundles, data):
    jb, tb = bundles
    key = jax.random.PRNGKey(11)
    j = lambda *a: [jnp.asarray(x) for x in a]
    ad = {"delta_t": jnp.asarray(data["delta"])}
    tad = {"delta_t": torch.from_numpy(data["delta"])}
    ref = jlosses.cogvideox_flow_matching_loss_conditioned(
        jb.dit_params, JCFG.dit, *j(data["cond"], data["target"], data["txt"]), None, key,
        adapters=ad, attn_impl="xla")
    sigma, noise = _jax_draws(key, WINDOW)
    with torch.no_grad():
        got = losses.cogvideox_flow_matching_loss_conditioned(
            tb.dit, *_t(data["cond"], data["target"], data["txt"]), None, adapters=tad,
            sigma=torch.from_numpy(sigma), noise=torch.from_numpy(noise))
    np.testing.assert_allclose(float(got), float(ref), rtol=1e-5)
    noises = np.random.default_rng(6).standard_normal((2, 1, 16, 1, 4, 6)).astype(np.float32)
    ref = jlosses.cogvideox_flow_matching_loss_conditioned_fixed(
        jb.dit_params, JCFG.dit, *j(data["cond"], data["val"], data["txt"]), None,
        jnp.asarray(noises), fixed_sigmas=(0.25, 0.5, 0.75), adapters=ad, attn_impl="xla")
    with torch.no_grad():
        got = losses.cogvideox_flow_matching_loss_conditioned_fixed(
            tb.dit, *_t(data["cond"], data["val"], data["txt"]), None,
            torch.from_numpy(noises), fixed_sigmas=(0.25, 0.5, 0.75), adapters=tad)
    np.testing.assert_allclose(float(got), float(ref), rtol=1e-5)
    with pytest.raises(NotImplementedError, match="bucketing"):
        losses.cogvideox_flow_matching_loss_conditioned(
            tb.dit, *_t(data["cond"], data["target"], data["txt"]), None,
            num_valid_target=1)
    # without injected draws the noise covers the whole window
    g = torch.Generator().manual_seed(0)
    s, n = losses.draw_sigma_noise(torch.zeros(WINDOW), torch.Generator().manual_seed(0))
    with torch.no_grad():
        a = losses.cogvideox_flow_matching_loss_conditioned(
            tb.dit, *_t(data["cond"], data["target"], data["txt"]), None, generator=g)
        b = losses.cogvideox_flow_matching_loss_conditioned(
            tb.dit, *_t(data["cond"], data["target"], data["txt"]), None, sigma=s, noise=n)
    assert torch.equal(a, b)


METHODS = {"delta_a": dict(method="delta_a"),
           "lora": dict(method="lora", lora_target_ffn=True),
           "lora_last_1": dict(method="lora", target_blocks="last_1"),
           "full": dict(method="full")}


@pytest.mark.parametrize("name", list(METHODS))
def test_scheme_gradients_match_jax(bundles, data, name):
    """Loss and gradient of every trainable tensor of one train step, the
    JAX scheme's through jax.value_and_grad, the port's through autograd
    with remat on, on the same initial tensors and draws; and the
    trainable counts."""
    jb, tb = bundles
    acfg = METHODS[name]
    jscheme = jax_build_scheme(JCFG.dit, JAdapterConfig(**acfg))
    tscheme = build_scheme(TCFG.dit, AdapterConfig(**acfg))
    jtp = jscheme.init(jax.random.PRNGKey(3), jb.dit_params)
    if name.startswith("lora"):  # b starts at zero: move it so a gets a gradient
        jtp = jax.tree.map(lambda x: x + 0.01, jtp)
    if name == "delta_a":
        jtp = {"delta": jnp.asarray(data["delta"])}
    key = jax.random.PRNGKey(12)
    args = [jnp.asarray(data[k]) for k in ("cond", "target", "txt")]

    def jloss(tp):
        params, ad = jscheme.to_forward(tp, jb.dit_params)
        return jlosses.cogvideox_flow_matching_loss_conditioned(
            params, JCFG.dit, *args, None, key, adapters=ad, attn_impl="xla")

    jl, jg = jax.jit(jax.value_and_grad(jloss))(jtp)
    tp = train_params_from_numpy(tscheme, _np_tree(jtp), "cpu")
    want = train_params_from_numpy(tscheme, _np_tree(jg), "cpu")
    sigma, noise = _jax_draws(key, WINDOW)
    leaves = {k: v.detach().clone().requires_grad_(True) for k, v in tp.items()}
    dit, ad = tscheme.to_forward(leaves, tb.dit)
    loss = losses.cogvideox_flow_matching_loss_conditioned(
        dit, *_t(data["cond"], data["target"], data["txt"]), None, adapters=ad,
        sigma=torch.from_numpy(sigma), noise=torch.from_numpy(noise))
    grads = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-5)
    assert set(want) == set(leaves)
    for (k, _), g in zip(leaves.items(), grads):
        g = torch.zeros_like(want[k]) if g is None else g
        np.testing.assert_allclose(g.numpy(), want[k].numpy(), rtol=1e-4, atol=1e-5,
                                   err_msg=k)
    assert tscheme.num_params(tp) == jscheme.num_params(jtp)
    if name in ("delta_a", "full"):
        assert tscheme.num_params(tp) == chip_smoke.cogvideox_trainable(name, CFG)


def test_lora_scheme_sites_init_and_count():
    """Sites from the flags as JAX's scheme picks them; a U(+-1/sqrt(in)),
    b zero; every block counted (the reference's count); the default
    (qkv, proj) count equals chip_smoke's derivation."""
    for acfg, sites in ((dict(), ["to_q", "to_k", "to_v", "to_out"]),
                        (dict(lora_target_modules=("qkv",), lora_target_ffn=True),
                         ["to_q", "to_k", "to_v", "ff_in", "ff_out"])):
        ts = build_scheme(CFG, AdapterConfig(method="lora", **acfg))
        js = jax_build_scheme(JCFG.dit, JAdapterConfig(method="lora", **acfg))
        assert ts.sites == js.sites == sites and ts.scale == js.scale == 2.0
        tp = ts.init("cpu", generator=torch.Generator().manual_seed(0))
        jtp = js.init(jax.random.PRNGKey(0))
        assert ts.num_params(tp) == js.num_params(jtp)
        for site in sites:
            a, b = tp[f"{site}.a"], tp[f"{site}.b"]
            assert a.shape == jtp[site]["a"].shape and b.shape == jtp[site]["b"].shape
            assert float(a.abs().max()) <= a.shape[1] ** -0.5 and not b.any()
    tp = build_scheme(CFG, AdapterConfig(method="lora")).init("cpu")
    assert build_scheme(CFG, AdapterConfig(method="lora")).num_params(tp) == \
        chip_smoke.cogvideox_trainable("lora", CFG)


def test_unported_methods_refused_as_jax():
    for method in ("delta_b", "delta_c", "film", "norm_tune"):
        with pytest.raises(ValueError) as te:
            build_scheme(TCFG.dit, AdapterConfig(method=method))
        with pytest.raises(ValueError) as je:
            jax_build_scheme(JCFG.dit, JAdapterConfig(method=method))
        assert str(te.value) == str(je.value)


# ---------------------------------------------------------------------------
# W8A8 decode copy
# ---------------------------------------------------------------------------


def test_int8_quantizer_matches_jax(bundles, data):
    """quantize_cogvideox_blocks_int8 against JAX's quantizer + int8_linear:
    the six block linears int8, the LayerNormZero linears and embedders
    16-bit and shared; the forward within 2e-3."""
    jb, tb = bundles
    q = quant.quantize_cogvideox_blocks_int8(tb.dit)
    blk = q.blocks[0]
    for mod in (blk.attn.to_q, blk.attn.to_k, blk.attn.to_v, blk.attn.to_out, blk.ff.w_in,
                blk.ff.w_out):
        assert isinstance(mod, quant.Int8Linear)
    assert blk.norm1.lin is tb.dit.blocks[0].norm1.lin and q.patch_embed is tb.dit.patch_embed
    assert isinstance(tb.dit.blocks[0].attn.to_q, torch.nn.Linear)  # the 16-bit DiT untouched
    lat = np.concatenate([data["cond"], data["target"]], axis=2)
    img = losses.cogvideox_image_latents(torch.from_numpy(data["cond"]), 4)
    ts = np.array([640.0], np.float32)
    ref = jcv.cogvideox_forward(jax_quantize(jb.dit_params), JCFG.dit, jnp.asarray(lat),
                                jnp.asarray(ts), jnp.asarray(data["txt"]),
                                image_latents=jnp.asarray(img.numpy()), attn_impl="xla")
    with torch.no_grad():
        out = q(*_t(lat, ts, data["txt"]), img)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-3)


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------


def _write(folder, sd, split=30):
    folder.mkdir()
    items = list(sd.items())
    save_file({k: torch.from_numpy(v) for k, v in items[:split]}, str(folder / "a.safetensors"))
    save_file({k: torch.from_numpy(v) for k, v in items[split:]}, str(folder / "b.safetensors"))


def test_convert_cogvideox_state_bit_for_bit(tmp_path):
    """A diffusers CogVideoXTransformer3DModel state dict (the JAX tests'
    synthesized one) through the port's shard converter equals JAX's
    convert_torch_cogvideox_state through the numpy bridge, bit for bit:
    the Conv2d patch kernel as the packed dense, the per-head RoPE
    permutation of to_q / to_k rows and the q/k norm affines; with
    patch_embed.pos_embedding as pos_embed; unread keys and a missing
    table refused."""
    from longcat_video_tta_tpu.models.convert import convert_torch_cogvideox_state

    sd = _synthetic_cogvideox_state_dict(JCFG.dit)
    ref = load_cogvideox_from_numpy(_np_tree(convert_torch_cogvideox_state(sd, JCFG.dit)),
                                    CFG, "cpu")
    _write(tmp_path / "dit", sd)
    got = convert.load_cogvideox_checkpoint(str(tmp_path / "dit"), CFG, "cpu")
    want = ref.state_dict()
    assert set(got.state_dict()) == set(want)
    for k, v in got.state_dict().items():
        assert torch.equal(v, want[k]), k
    assert got.time_embed["w1"].weight.dtype == torch.float32

    pe_cfg = dataclasses.replace(JCFG.dit, learned_pos_embed_len=40)
    sd_pe = dict(sd)
    sd_pe["patch_embed.pos_embedding"] = np.random.RandomState(7).randn(
        1, 40, CFG.hidden_size).astype(np.float32)
    ref = convert_torch_cogvideox_state(sd_pe, pe_cfg)
    _write(tmp_path / "dit_pe", sd_pe)
    for cfg in (CFG, dataclasses.replace(CFG, learned_pos_embed_len=40)):
        # a table in the folder is applied, as JAX applies it, whatever the config says
        got = convert.load_cogvideox_checkpoint(str(tmp_path / "dit_pe"), cfg, "cpu")
        assert got.cfg.learned_pos_embed_len == 40
        assert torch.equal(got.pos_embed, torch.from_numpy(np.asarray(ref["pos_embed"])))
    with pytest.raises(ValueError, match="pos_embedding"):
        convert.load_cogvideox_checkpoint(str(tmp_path / "dit"), dataclasses.replace(
            CFG, learned_pos_embed_len=40), "cpu")
    save_file({"ofs_embedding.linear_1.weight": torch.zeros(2)},
              str(tmp_path / "dit" / "c.safetensors"))
    with pytest.raises(ValueError, match="unconsumed: ofs_embedding"):
        convert.load_cogvideox_checkpoint(str(tmp_path / "dit"), CFG, "cpu")


# ---------------------------------------------------------------------------
# the launch derivation chip_smoke gates the card's runs with
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["delta_a", "lora", "full"])
def test_attention_calls_per_train_step(bundles, data, monkeypatch, name):
    """The attention forwards, dQ and dK/dV backwards of one CogVideoX train
    step with full remat, counted on the CPU path, against chip_smoke's
    ``joint_step_launches``; and one anchor eval's and one sampler's
    forwards against its ``joint_gen_launches``."""
    _, tb = bundles
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
    scheme = build_scheme(CFG, AdapterConfig(**METHODS[name]))
    opt = build_optimizer(OptimConfig())
    tp = scheme.init("cpu", dit=tb.dit, generator=torch.Generator().manual_seed(0))
    args = _t(data["cond"], data["target"], data["txt"])
    train_step(scheme, tb.dit, opt, tp, opt.init(tp), *args, None,
               generator=torch.Generator().manual_seed(1),
               loss_fn=losses.cogvideox_flow_matching_loss_conditioned)
    assert calls == chip_smoke.joint_step_launches(CFG.depth)
    for k in calls:
        calls[k] = 0
    with torch.no_grad():
        losses.cogvideox_flow_matching_loss_conditioned_fixed(
            tb.dit, *_t(data["cond"], data["val"], data["txt"]), None,
            torch.zeros((2, 1, 16, 1, 4, 6)), fixed_sigmas=(0.25, 0.5, 0.75))
    assert calls == {"flash_fwd": 6 * CFG.depth, "flash_bwd_dq": 0, "flash_bwd_dkv": 0}
    calls["flash_fwd"] = 0
    with torch.no_grad():
        sampler.sample_latents_cogvideox(
            tb.dit, torch.zeros(2, 16, 32), num_gen_latents=1, num_steps=4, lat_h=4,
            lat_w=6, pab_cfg=PABConfig(every=2), cfgr_cfg=CFGReuseConfig(every=2),
            generator=torch.Generator().manual_seed(0))
    assert calls["flash_fwd"] == chip_smoke.joint_gen_launches(CFG.depth, steps=4,
                                                               pab_every=2)


def test_small_head64_config_is_the_published_rope_split():
    """chip_smoke's card-vs-CPU CogVideoX: the published rope_dims at
    head_dim 64 with a small width, and the kernel shapes of its runs."""
    small = chip_smoke.cogvideox_small_config()
    assert small.dit.head_dim == 64 and small.dit.rope_dims == (16, 24, 24)
    assert small.dit.hidden_size < 1024 and small.arch == "cogvideox"
    assert chip_smoke.cogvideox_shapes() == (8026, 11146, 8026)
    cut = chip_smoke.depth_cut_config(chip_smoke.COGVIDEOX["full_depth"], "cogvideox_5b")
    assert cut.dit.depth == 16 and cut.dit.hidden_size == 3072
