"""The port's Open-Sora v2 MMDiT path against the JAX package on the CPU,
at opensora_v2_tiny size (hidden 64, 4 heads of 16, 2 double + 2 single
blocks), on the same weights (JAX ``init_random`` -> ``from_numpy``) and
the same draws (JAX's sigma, noise and initial volume injected into the
port). JAX runs its plain attention (``attn_impl="xla"``), the port the
plain version of its kernels.

Tolerances (fp32 throughout): the forward, the losses and the gradients
within 1e-5 relative (atol 1e-6 on O(1) values, 1e-5 abs on gradient
entries of 1e-2..1e1); the sampler within 1e-4 abs on O(1) latents
after 3 Euler steps of a 3-batch forward (rounding grows with the CFG
combine's scale 7.5); generated pixels within 1e-4 abs on [0, 1] (the
VAE decode adds its own rounding); the int8 lever run within 2e-3 (W8A8
rounds activations per token: a one-ulp difference before the rounding
can move one int8 step). The converter and the exact-equivalence checks
(PAB every 1, CFG reuse every 1, segmented sampling) are bit for bit.
"""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from longcat_video_tta_tpu.config import AdapterConfig as JAdapterConfig
from longcat_video_tta_tpu.config import CFGReuseConfig as JCFGReuse
from longcat_video_tta_tpu.config import PABConfig as JPAB
from longcat_video_tta_tpu.models import mmdit as jmm
from longcat_video_tta_tpu.models.backbones import opensora_v2_tiny as jax_tiny
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
from longcat_video_tta_tpu_torch.models import convert, mmdit
from longcat_video_tta_tpu_torch.models.backbones import opensora_v2_tiny
from longcat_video_tta_tpu_torch.models.weights import (
    load_mmdit_from_numpy,
    train_params_from_numpy,
)
from longcat_video_tta_tpu_torch.ops import flash_attention as fa
from longcat_video_tta_tpu_torch.pipeline import sampler
from longcat_video_tta_tpu_torch.pipeline.pipeline import ModelBundle, generate_vc
from longcat_video_tta_tpu_torch.tta import losses
from longcat_video_tta_tpu_torch.tta.adapters import build_scheme
from longcat_video_tta_tpu_torch.tta.engine import build_optimizer, train_step
from longcat_video_tta_tpu_torch.utils.safetensors import save_file

torch.set_num_threads(1)

JCFG, TCFG = jax_tiny(), opensora_v2_tiny()
CFG = TCFG.dit
NATTN = CFG.depth_double + CFG.depth_single


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _t(*arrays):
    return [torch.from_numpy(np.asarray(a, np.float32)) for a in arrays]


@pytest.fixture(scope="module")
def bundles():
    jb = JaxBundle.init_random(JCFG, seed=0)
    tb = ModelBundle.from_numpy(TCFG, _np_tree(jb.dit_params), _np_tree(jb.vae_params),
                                _np_tree(jb.text_params), device="cpu",
                                clip_params=_np_tree(jb.clip_params))
    return jb, tb


@pytest.fixture(scope="module")
def data():
    """2 cond + 2 target latents of 4 x 6 (6 tokens each), 16 text tokens."""
    rng = np.random.default_rng(0)
    f32 = lambda *s: rng.standard_normal(s).astype(np.float32)
    return dict(cond=f32(1, 16, 2, 4, 6), target=f32(1, 16, 2, 4, 6),
                val=f32(1, 16, 1, 4, 6), txt=f32(1, 16, 32), yv=f32(1, 16),
                delta=0.1 * f32(CFG.hidden_size))


# ---------------------------------------------------------------------------
# packing, RoPE
# ---------------------------------------------------------------------------


def test_pack_unpack_and_joint_rope_match_jax():
    x = np.random.default_rng(1).standard_normal((2, 16, 3, 4, 6)).astype(np.float32)
    tok = mmdit.pack_latents(torch.from_numpy(x), 2)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jmm.pack_latents(jnp.asarray(x), 2)))
    np.testing.assert_array_equal(mmdit.unpack_tokens(tok, 3, 4, 6, 2).numpy(), x)
    cos, sin = mmdit.rope_joint(CFG, 5, 3, 2, 3)
    jcos, jsin = jmm._rope_joint(JCFG.dit, 5, 3, 2, 3)
    np.testing.assert_allclose(cos.numpy(), np.asarray(jcos), atol=1e-6)
    np.testing.assert_allclose(sin.numpy(), np.asarray(jsin), atol=1e-6)
    assert (cos[:5] == 1).all() and (sin[:5] == 0).all()  # text: the identity
    q = np.random.default_rng(2).standard_normal((1, 23, 2, 16)).astype(np.float32)
    np.testing.assert_allclose(
        mmdit.apply_rope_flat(torch.from_numpy(q), cos, sin).numpy(),
        np.asarray(jmm._apply_rope_flat(jnp.asarray(q), jcos, jsin)), atol=1e-6)


def test_rope_half_split_permutation_equals_interleaved():
    """The converter's claim: the half-split rotation of rope_perm-permuted
    q and k gives the logits of the interleaved-pair rotation of the
    originals (tests/test_mmdit.py's check, on the port's functions)."""
    S, dh = 6, 8
    rng = np.random.RandomState(0)
    q, k = (rng.randn(1, S, 1, dh).astype(np.float32) for _ in range(2))
    ang = rng.rand(S, dh // 2).astype(np.float32)
    cos, sin = np.cos(ang), np.sin(ang)

    def interleaved(x):
        xp = x.reshape(1, S, 1, dh // 2, 2)
        c, s = cos[None, :, None, :], sin[None, :, None, :]
        return np.stack([xp[..., 0] * c - xp[..., 1] * s,
                         xp[..., 1] * c + xp[..., 0] * s], axis=-1).reshape(1, S, 1, dh)

    ref = np.einsum("bqhd,bkhd->bhqk", interleaved(q), interleaved(k))
    perm = convert.rope_perm(dh).numpy()
    rot = lambda x: mmdit.apply_rope_flat(torch.from_numpy(x[..., perm]),
                                          torch.from_numpy(cos), torch.from_numpy(sin))
    got = torch.einsum("bqhd,bkhd->bhqk", rot(q), rot(k)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("with_cond", [False, True], ids=["t2v", "cond"])
def test_forward_matches_jax(bundles, data, with_cond):
    jb, tb = bundles
    lat = np.concatenate([data["cond"], data["target"]], axis=2)
    cond = losses.mmdit_cond_input(torch.from_numpy(data["cond"]), 4).numpy()
    sig = np.array([0.37], np.float32)
    ad = {"delta_t": data["delta"]}
    ref = jmm.mmdit_forward(jb.dit_params, JCFG.dit, jnp.asarray(lat), jnp.asarray(sig),
                            jnp.asarray(data["txt"]), jnp.asarray(data["yv"]),
                            cond=jnp.asarray(cond) if with_cond else None,
                            adapters={"delta_t": jnp.asarray(data["delta"])},
                            attn_impl="xla")
    with torch.no_grad():
        out = tb.dit(*_t(lat, sig, data["txt"], data["yv"]),
                     cond=torch.from_numpy(cond) if with_cond else None,
                     adapters={k: torch.from_numpy(v) for k, v in ad.items()})
    assert out.shape == lat.shape and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-6)


def test_param_count_full_size_and_tiny(bundles):
    _, tb = bundles
    jcount = jmm.count_params(bundles[0].dit_params)
    assert mmdit.count_params(tb.dit) == jcount
    from longcat_video_tta_tpu_torch.models.backbones import opensora_v2

    with torch.device("meta"):
        full = mmdit.count_params(mmdit.MMDiT(opensora_v2().dit))
    assert 11.8e9 < full < 11.9e9


# ---------------------------------------------------------------------------
# sampler and generate_vc
# ---------------------------------------------------------------------------


def _texts(jb, tb):
    """[prompt, neg, neg] T5 tokens and CLIP y_vecs of both bundles."""
    je, jy = jb.encode_prompt("a ball moving across the scene")
    jne, jny = jb.encode_prompt("blurry")
    te, ty = tb.encode_prompt("a ball moving across the scene")
    tne, tny = tb.encode_prompt("blurry")
    np.testing.assert_allclose(te.numpy(), np.asarray(je), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy), rtol=1e-5, atol=1e-6)
    return ((jnp.concatenate([je, jne, jne]), jnp.concatenate([jy, jny, jny])),
            (torch.cat([te, tne, tne]), torch.cat([ty, tny, tny]).detach()))


LEVERS = {"plain": ({}, {}),
          "pab2_cfgr2": (dict(pab_cfg=JPAB(every=2, start_frac=0.0, end_frac=1.0),
                              cfgr_cfg=JCFGReuse(every=2, start_frac=0.0, end_frac=1.0)),
                         dict(pab_cfg=PABConfig(every=2, start_frac=0.0, end_frac=1.0),
                              cfgr_cfg=CFGReuseConfig(every=2, start_frac=0.0,
                                                      end_frac=1.0)))}


@pytest.mark.parametrize("lever", list(LEVERS))
def test_sample_latents_mmdit_matches_jax(bundles, data, lever):
    jb, tb = bundles
    (jtxt3, jyv3), (ttxt3, tyv3) = _texts(jb, tb)
    jkw, tkw = LEVERS[lever]
    rng = jax.random.PRNGKey(7)
    kw = dict(num_gen_latents=2, num_steps=4, lat_h=4, lat_w=6, guidance=7.5)
    ref = jsampler.sample_latents_mmdit(
        jb.dit_params, JCFG.dit, rng, jtxt3, jyv3, cond_latents=jnp.asarray(data["cond"]),
        adapters={"delta_t": jnp.asarray(data["delta"])}, attn_impl="xla", **kw, **jkw)
    x0 = jax.random.normal(rng, (1, 16, 4, 4, 6), jnp.float32)  # _mmdit_setup's draw
    fa.reset_launches()
    with torch.no_grad():
        out = sampler.sample_latents_mmdit(
            tb.dit, ttxt3, tyv3, cond_latents=torch.from_numpy(data["cond"]),
            adapters={"delta_t": torch.from_numpy(data["delta"])},
            init_x=torch.from_numpy(np.array(x0)), **kw, **tkw)
    assert fa.launches == 0  # CPU tensors: the plain version, no kernel
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4)


def test_pab_and_cfg_reuse_every1_exact_and_segments_equal(bundles, data):
    """PAB every 1 and CFG reuse every 1 reuse nothing: bit for bit the
    plain loop; segmented sampling equals one loop with the caches and
    deltas carried across segments."""
    jb, tb = bundles
    _, (txt3, yv3) = _texts(jb, tb)
    x0 = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (1, 16, 4, 4, 6)).astype(np.float32))
    kw = dict(num_gen_latents=2, num_steps=4, lat_h=4, lat_w=6, init_x=x0,
              cond_latents=torch.from_numpy(data["cond"]))
    run = lambda fn=sampler.sample_latents_mmdit, **extra: fn(tb.dit, txt3, yv3, **kw,
                                                              **extra)
    with torch.no_grad():
        plain = run()
        assert torch.equal(run(pab_cfg=PABConfig(every=1)), plain)
        assert torch.equal(run(cfgr_cfg=CFGReuseConfig(every=1)), plain)
        levers = dict(pab_cfg=PABConfig(every=2, start_frac=0.0, end_frac=1.0),
                      cfgr_cfg=CFGReuseConfig(every=2, start_frac=0.0, end_frac=1.0))
        one = run(**levers)
        seg = run(fn=sampler.sample_latents_mmdit_segmented, segment_steps=1, **levers)
    assert torch.equal(one, seg) and not torch.equal(one, plain)


def test_flux_time_shift_matches_jax():
    ts = jnp.linspace(1.0, 0.0, 9)
    ref = np.asarray(jsampler.flux_time_shift(ts, 7800))
    got = sampler.flux_time_shift(torch.from_numpy(np.asarray(ts)), 7800).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6)
    assert got[-1] == 0.0 and got[0] == 1.0


@pytest.mark.parametrize("lever", ["plain", "int8_pab_cfgr_segments"])
def test_generate_vc_matches_jax(bundles, lever):
    jb, tb = bundles
    rng = np.random.default_rng(4)
    cond = rng.uniform(-1, 1, (1, 3, 5, 32, 48)).astype(np.float32)
    kw = dict(num_frames=5, num_inference_steps=3, guidance_scale=4.0,
              negative_prompt="blurry", seed=5)
    tkw, jkw, atol = {}, {}, 1e-4
    if lever != "plain":
        tkw = dict(quantize_decode="int8", gen_segment_steps=1,
                   pab_cfg=PABConfig(every=2, start_frac=0.0, end_frac=1.0),
                   cfgr_cfg=CFGReuseConfig(every=2, start_frac=0.0, end_frac=1.0))
        jkw = dict(quantize_decode="int8", gen_segment_steps=1,
                   pab_cfg=JPAB(every=2, start_frac=0.0, end_frac=1.0),
                   cfgr_cfg=JCFGReuse(every=2, start_frac=0.0, end_frac=1.0))
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
    """mmdit_flow_matching_loss_conditioned's own sigma and noise."""
    k_sig, k_noise = jax.random.split(key)
    sigma = jax.random.uniform(k_sig, (shape[0],), minval=0.001, maxval=1.0)
    return np.asarray(sigma), np.asarray(jax.random.normal(k_noise, shape, jnp.float32))


def test_losses_match_jax(bundles, data):
    jb, tb = bundles
    key = jax.random.PRNGKey(11)
    j = lambda *a: [jnp.asarray(x) for x in a]
    ad = {"delta_t": jnp.asarray(data["delta"])}
    tad = {"delta_t": torch.from_numpy(data["delta"])}
    ref = jlosses.mmdit_flow_matching_loss_conditioned(
        jb.dit_params, JCFG.dit, *j(data["cond"], data["target"], data["txt"], data["yv"]),
        key, adapters=ad, attn_impl="xla")
    sigma, noise = _jax_draws(key, data["target"].shape)
    with torch.no_grad():
        got = losses.mmdit_flow_matching_loss_conditioned(
            tb.dit, *_t(data["cond"], data["target"], data["txt"], data["yv"]),
            adapters=tad, sigma=torch.from_numpy(sigma), noise=torch.from_numpy(noise))
    np.testing.assert_allclose(float(got), float(ref), rtol=1e-5)
    noises = np.random.default_rng(6).standard_normal((2, 1, 16, 1, 4, 6)).astype(np.float32)
    ref = jlosses.mmdit_flow_matching_loss_conditioned_fixed(
        jb.dit_params, JCFG.dit, *j(data["cond"], data["val"], data["txt"], data["yv"],
                                    noises), fixed_sigmas=(0.25, 0.5, 0.75), adapters=ad,
        attn_impl="xla")
    with torch.no_grad():
        got = losses.mmdit_flow_matching_loss_conditioned_fixed(
            tb.dit, *_t(data["cond"], data["val"], data["txt"], data["yv"], noises),
            fixed_sigmas=(0.25, 0.5, 0.75), adapters=tad)
    np.testing.assert_allclose(float(got), float(ref), rtol=1e-5)
    with pytest.raises(NotImplementedError):
        losses.mmdit_flow_matching_loss_conditioned(
            tb.dit, *_t(data["cond"], data["target"], data["txt"], data["yv"]),
            num_valid_target=1)


METHODS = {"delta_a": dict(method="delta_a"),
           "lora": dict(method="lora", lora_target_ffn=True),
           "lora_single": dict(method="lora", target_blocks="single"),
           "full": dict(method="full")}


@pytest.mark.parametrize("name", list(METHODS))
def test_scheme_gradients_match_jax(bundles, data, name):
    """Loss and gradient of every trainable tensor of one train step, the
    JAX scheme's through jax.value_and_grad, the port's through autograd
    with remat on, on the same initial tensors and draws."""
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
    args = [jnp.asarray(data[k]) for k in ("cond", "target", "txt", "yv")]

    def jloss(tp):
        params, ad = jscheme.to_forward(tp, jb.dit_params)
        return jlosses.mmdit_flow_matching_loss_conditioned(
            params, JCFG.dit, *args, key, adapters=ad, attn_impl="xla")

    jl, jg = jax.jit(jax.value_and_grad(jloss))(jtp)
    tp = train_params_from_numpy(tscheme, _np_tree(jtp), "cpu")
    want = train_params_from_numpy(tscheme, _np_tree(jg), "cpu")
    sigma, noise = _jax_draws(key, data["target"].shape)
    leaves = {k: v.detach().clone().requires_grad_(True) for k, v in tp.items()}
    dit, ad = tscheme.to_forward(leaves, tb.dit)
    loss = losses.mmdit_flow_matching_loss_conditioned(
        dit, *_t(data["cond"], data["target"], data["txt"], data["yv"]), adapters=ad,
        sigma=torch.from_numpy(sigma), noise=torch.from_numpy(noise))
    grads = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-5)
    assert set(want) == set(leaves)
    for (k, _), g in zip(leaves.items(), grads):
        g = torch.zeros_like(want[k]) if g is None else g
        np.testing.assert_allclose(g.numpy(), want[k].numpy(), rtol=1e-4, atol=1e-5,
                                   err_msg=k)
    assert tscheme.num_params(tp) == jscheme.num_params(jtp)


def test_unported_methods_refused_as_jax():
    for method in ("delta_b", "delta_c", "film", "norm_tune"):
        with pytest.raises(ValueError) as te:
            build_scheme(TCFG.dit, AdapterConfig(method=method))
        with pytest.raises(ValueError) as je:
            jax_build_scheme(JCFG.dit, JAdapterConfig(method=method))
        assert str(te.value) == str(je.value)


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------


def _synthetic_state(shapes, seed):
    rng = np.random.default_rng(seed)
    return {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}


def test_convert_mmdit_state_bit_for_bit_and_unread_key(tmp_path):
    from longcat_video_tta_tpu.models.convert import convert_torch_mmdit_state

    sd = _synthetic_state(convert.mmdit_state_shapes(CFG), 0)
    ref = load_mmdit_from_numpy(_np_tree(convert_torch_mmdit_state(sd, JCFG.dit)), CFG,
                                "cpu")
    folder = tmp_path / "dit"
    folder.mkdir()
    items = list(sd.items())
    save_file({k: torch.from_numpy(v) for k, v in items[:40]}, str(folder / "a.safetensors"))
    save_file({k: torch.from_numpy(v) for k, v in items[40:]}, str(folder / "b.safetensors"))
    got = convert.load_mmdit_checkpoint(str(folder), CFG, "cpu")
    want = ref.state_dict()
    assert set(got.state_dict()) == set(want)
    for k, v in got.state_dict().items():
        assert torch.equal(v, want[k]), k
    save_file({"extra.weight": torch.zeros(2)}, str(folder / "c.safetensors"))
    with pytest.raises(ValueError, match="unconsumed: extra.weight"):
        convert.load_mmdit_checkpoint(str(folder), CFG, "cpu")


def test_checkpoint_dir_with_clip_matches_jax_converters(tmp_path):
    """An Open-Sora v2 folder <dir>/{dit,vae,text_encoder,clip} through
    from_checkpoint_dir: the CLIP tower equals JAX's converted tower on
    the same ids, the bundle encodes a prompt, and an unread CLIP key
    raises."""
    from longcat_video_tta_tpu.models.clip_text import clip_text_pooled
    from longcat_video_tta_tpu.models.convert import convert_torch_clip_text_state

    for i, (comp, shapes_of) in enumerate(convert.MMDIT_STATE_SHAPES.items()):
        (tmp_path / comp).mkdir()
        sd = _synthetic_state(shapes_of(TCFG), i)
        if comp == "clip":
            clip_sd = sd
        save_file({k: torch.from_numpy(0.05 * v) for k, v in sd.items()},
                  str(tmp_path / comp / "model.safetensors"))
    tb = ModelBundle.from_checkpoint_dir(TCFG, str(tmp_path), "cpu")
    ids = np.array([[5, 9, 300, 2, 1, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0]], np.int32)
    jp = convert_torch_clip_text_state({k: 0.05 * v for k, v in clip_sd.items()}, JCFG.clip)
    ref = clip_text_pooled(jp, JCFG.clip, jnp.asarray(ids))
    with torch.no_grad():
        got = tb.clip.pooled(torch.from_numpy(ids.astype(np.int64)))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-6)
    txt, yv = tb.encode_prompt("a ball moving")
    assert txt.shape == (1, 16, 32) and yv.shape == (1, 16)
    save_file({"text_model.extra": torch.zeros(2)}, str(tmp_path / "clip" / "x.safetensors"))
    with pytest.raises(ValueError, match="unconsumed"):
        convert.load_clip_text_checkpoint(str(tmp_path / "clip"), TCFG.clip, "cpu")


# ---------------------------------------------------------------------------
# the launch derivation chip_smoke gates the card's runs with
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["delta_a", "lora", "full"])
def test_attention_calls_per_train_step(bundles, data, monkeypatch, name):
    """The attention forwards, dQ and dK/dV backwards of one MMDiT train
    step with full remat, counted on the CPU path, against chip_smoke's
    ``joint_step_launches``; and one anchor eval's and one sampler
    step's forwards."""
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
    args = _t(data["cond"], data["target"], data["txt"], data["yv"])
    train_step(scheme, tb.dit, opt, tp, opt.init(tp), *args,
               generator=torch.Generator().manual_seed(1),
               loss_fn=losses.mmdit_flow_matching_loss_conditioned)
    assert calls == chip_smoke.joint_step_launches(NATTN)
    for k in calls:
        calls[k] = 0
    with torch.no_grad():
        losses.mmdit_flow_matching_loss_conditioned_fixed(
            tb.dit, *_t(data["cond"], data["val"], data["txt"], data["yv"],
                        np.zeros((2, 1, 16, 1, 4, 6))), fixed_sigmas=(0.25, 0.5, 0.75))
    assert calls == {"flash_fwd": 6 * NATTN, "flash_bwd_dq": 0, "flash_bwd_dkv": 0}
    got = chip_smoke.joint_gen_launches(NATTN, steps=4, pab_every=2)
    for k in calls:
        calls[k] = 0
    txt3, yv3 = torch.zeros(3, 16, 32), torch.zeros(3, 16)
    with torch.no_grad():
        sampler.sample_latents_mmdit(
            tb.dit, txt3, yv3, num_gen_latents=1, num_steps=4, lat_h=4, lat_w=6,
            pab_cfg=PABConfig(every=2), cfgr_cfg=CFGReuseConfig(every=2),
            generator=torch.Generator().manual_seed(0))
    assert calls["flash_fwd"] == got


def test_small_head128_config_is_the_published_rope_split():
    """chip_smoke's card-vs-CPU MMDiT: the published axes_dims at head_dim
    128 with a small width."""
    small = chip_smoke.opensora_small_config()
    assert small.dit.head_dim == 128 and small.dit.axes_dims == (16, 56, 56)
    assert small.dit.hidden_size < 1024 and small.arch == "mmdit"
    assert small.dit.mlp_dim == 4 * small.dit.hidden_size
