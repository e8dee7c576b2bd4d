"""PyTorch port DiT / UMT5 / VAE vs the JAX models on the same weights
(``ModelBundle.init_random(longcat_tiny(), 0)`` turned into numpy and
loaded through models/weights.py) and the same numpy inputs.

fp32 on the CPU; tolerance 1e-4 abs / 1e-4 rel (measured differences are
~1e-6: summation order only). On the CPU the port's attention is the
plain version; the JAX DiT also takes its plain path on the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from longcat_video_tta_tpu.config import longcat_tiny as jax_tiny
from longcat_video_tta_tpu.models import dit as jdit
from longcat_video_tta_tpu.models import vae as jvae
from longcat_video_tta_tpu.models.umt5 import umt5_encode as jax_umt5
from longcat_video_tta_tpu.pipeline import ModelBundle as JaxBundle
from longcat_video_tta_tpu_torch.config import longcat_tiny
from longcat_video_tta_tpu_torch.models import vae as tvae
from longcat_video_tta_tpu_torch.models import weights
from longcat_video_tta_tpu_torch.models.umt5 import umt5_encode
from longcat_video_tta_tpu_torch.pipeline.pipeline import ModelBundle

torch.set_num_threads(1)

TOL = dict(atol=1e-4, rtol=1e-4)
JCFG = jax_tiny()
TCFG = longcat_tiny()


@pytest.fixture(scope="module")
def bundles():
    jb = JaxBundle.init_random(JCFG, seed=0)
    tonp = lambda t: jax.tree.map(np.asarray, t)
    trees = (tonp(jb.dit_params), tonp(jb.vae_params), tonp(jb.text_params))
    tb = ModelBundle.from_numpy(TCFG, *trees, device="cpu")
    return jb, tb, trees


@pytest.fixture(scope="module")
def dit_inputs():
    rng = np.random.default_rng(0)
    lat = rng.standard_normal((1, 16, 4, 4, 6)).astype(np.float32)
    text = rng.standard_normal((1, 16, 48)).astype(np.float32)
    mask = np.ones((1, 16), np.int32)
    mask[:, 10:] = 0
    return lat, text, mask


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


@pytest.mark.parametrize("ncond", [0, 2])
def test_dit_forward(bundles, dit_inputs, ncond):
    jb, tb, _ = bundles
    lat, text, mask = dit_inputs
    ts = np.array([[0.0] * ncond + [640.0] * (4 - ncond)], np.float32)
    ref = jdit.dit_forward(jb.dit_params, JCFG.dit, *_j(lat, ts, text, mask),
                           num_cond_latents=ncond)
    with torch.no_grad():
        out = tb.dit(*_t(lat, ts, text, mask), num_cond_latents=ncond)
    assert out.dtype == torch.float32 and out.shape == lat.shape
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_dit_precompute_cond_cache(bundles, dit_inputs):
    jb, tb, _ = bundles
    lat, text, mask = dit_inputs
    kj, vj = jdit.dit_precompute_cond_cache(jb.dit_params, JCFG.dit,
                                            *_j(lat[:, :, :2], text, mask))
    with torch.no_grad():
        kt, vt = tb.dit.precompute_cond_cache(*_t(lat[:, :, :2], text, mask))
    assert kt.shape == kj.shape == (2, 1, 12, 2, 32)  # depth, B, 2 frames x 6
    np.testing.assert_allclose(kt.numpy(), np.asarray(kj), **TOL)
    np.testing.assert_allclose(vt.numpy(), np.asarray(vj), **TOL)


def test_dit_forward_with_cache(bundles, dit_inputs):
    jb, tb, _ = bundles
    lat, text, mask = dit_inputs
    cache = jdit.dit_precompute_cond_cache(jb.dit_params, JCFG.dit,
                                           *_j(lat[:, :, :2], text, mask))
    ref = jdit.dit_forward_with_cache(
        jb.dit_params, JCFG.dit, jnp.asarray(lat[:, :, 2:]), jnp.full((1,), 640.0),
        *_j(text, mask), cache, num_cond_latents=2)
    with torch.no_grad():
        tc = tuple(torch.from_numpy(np.array(c)) for c in cache)
        out = tb.dit.forward_with_cache(
            torch.from_numpy(lat[:, :, 2:]), torch.full((1,), 640.0),
            *_t(text, mask), tc, num_cond_latents=2)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_kv_cache_decode_matches_full_forward(bundles, dit_inputs):
    """Torch re-proof of test_dit.py::test_kv_cache_decode_matches_full_forward:
    the two-phase cached forward equals the no-cache forward on the noise
    region (the exactness behind generate_vc's use_kv_cache)."""
    _, tb, _ = bundles
    lat, text, mask = dit_inputs
    ts = torch.zeros((1, 4))
    ts[:, 2:] = 640.0
    with torch.no_grad():
        full = tb.dit(*_t(lat), ts, *_t(text, mask), num_cond_latents=2)
        cache = tb.dit.precompute_cond_cache(*_t(lat[:, :, :2], text, mask))
        dec = tb.dit.forward_with_cache(
            torch.from_numpy(lat[:, :, 2:]), torch.full((1,), 640.0),
            *_t(text, mask), cache, num_cond_latents=2)
    np.testing.assert_allclose(dec.numpy(), full[:, :, 2:].numpy(),
                               atol=2e-4, rtol=1e-3)


def test_umt5_encode(bundles):
    """Random per-layer relative-position tables (init leaves them zero)
    so the bucket mapping is exercised."""
    _, _, (_, _, text_np) = bundles
    rng = np.random.default_rng(1)
    text_np = dict(text_np)
    text_np["blocks"] = dict(text_np["blocks"])
    text_np["blocks"]["rel_bias"] = rng.standard_normal(
        text_np["blocks"]["rel_bias"].shape).astype(np.float32)
    model = weights.load_umt5_from_numpy(text_np, TCFG.text, device="cpu")
    jparams = jax.tree.map(jnp.asarray, text_np)
    ids = rng.integers(2, 512, (2, 16)).astype(np.int32)
    mask = np.ones((2, 16), np.int32)
    mask[0, 9:] = 0
    ref = jax_umt5(jparams, JCFG.text, *_j(ids, mask))
    with torch.no_grad():
        out = umt5_encode(model, *_t(ids, mask))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


@pytest.fixture(scope="module")
def video():
    rng = np.random.default_rng(2)
    return rng.uniform(-1, 1, (1, 3, 13, 32, 48)).astype(np.float32)


def test_vae_encode(bundles, video):
    jb, tb, _ = bundles
    ref = jvae.vae_encode(jb.vae_params, JCFG.vae, jnp.asarray(video))
    with torch.no_grad():
        out = tvae.vae_encode(tb.vae, torch.from_numpy(video))
    assert out.shape == (1, 16, 4, 4, 6)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_vae_encode_streamed(bundles, video):
    jb, tb, _ = bundles
    ref = jvae.vae_encode_streamed(jb.vae_params, JCFG.vae, jnp.asarray(video),
                                   chunk_frames=4)
    with torch.no_grad():
        out = tvae.vae_encode_streamed(tb.vae, torch.from_numpy(video),
                                       chunk_frames=4)
        mono = tvae.vae_encode(tb.vae, torch.from_numpy(video))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    np.testing.assert_allclose(out.numpy(), mono.numpy(), **TOL)


@pytest.fixture(scope="module")
def latents():
    rng = np.random.default_rng(3)
    return rng.standard_normal((1, 16, 5, 4, 6)).astype(np.float32)


def test_vae_decode(bundles, latents):
    """5 latents: the sliding-window path of vae_decode."""
    jb, tb, _ = bundles
    ref = jvae.vae_decode(jb.vae_params, JCFG.vae, jnp.asarray(latents))
    with torch.no_grad():
        out = tvae.vae_decode(tb.vae, torch.from_numpy(latents))
    assert out.shape == (1, 3, 17, 32, 48)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_vae_decode_streamed(bundles, latents):
    jb, tb, _ = bundles
    ref = jvae.vae_decode_streamed(jb.vae_params, JCFG.vae, jnp.asarray(latents))
    with torch.no_grad():
        out = tvae.vae_decode_streamed(tb.vae, torch.from_numpy(latents))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_vae_streamed_equals_unstreamed(bundles, latents):
    """Streaming decode == monolithic decode (3 latents: vae_decode runs
    one window)."""
    _, tb, _ = bundles
    with torch.no_grad():
        z = torch.from_numpy(latents[:, :, :3])
        mono = tvae.vae_decode(tb.vae, z)
        for chunk in (1, 2):
            streamed = tvae.vae_decode_streamed(tb.vae, z, chunk_latents=chunk)
            np.testing.assert_allclose(streamed.numpy(), mono.numpy(), **TOL)


def test_latent_normalization_roundtrip():
    z = torch.randn(1, 16, 2, 3, 3, generator=torch.Generator().manual_seed(0))
    cfg = TCFG.vae
    back = tvae.denormalize_latents(cfg, tvae.normalize_latents(cfg, z))
    np.testing.assert_allclose(back.numpy(), z.numpy(), atol=1e-6)
    np.testing.assert_allclose(
        tvae.normalize_latents(cfg, z).numpy(),
        np.asarray(jvae.normalize_latents(JCFG.vae, jnp.asarray(z.numpy()))),
        atol=1e-6)
    assert tvae.latent_len(13) == jvae.latent_len(13) == 4


def test_bridge_loads_bf16_leaves():
    """bf16 reference arrays (ml_dtypes, as np.asarray of a jax bf16
    array) load bit-exactly."""
    a = np.asarray(jnp.asarray(np.linspace(-2, 2, 12, dtype=np.float32)
                               .reshape(3, 4), jnp.bfloat16))
    t = weights._to_torch(a)
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.float().numpy(), a.astype(np.float32))


def test_init_random_distributions():
    """Seeded on-device init (CPU here): reference shapes and the
    reference inits' distributions (N(0, 0.02) dense kernels, zero
    biases, unit norms, zero final adaLN, fan-in-scaled VAE convs)."""
    gen = torch.Generator().manual_seed(0)
    dit, vae, text = weights.init_random(TCFG, "cpu", gen)
    blk = dit.blocks[0]
    assert blk.attn.qkv.weight.shape == (192, 64)
    assert 0.015 < float(blk.ffn.w1.weight.std()) < 0.025
    assert float(blk.attn.qkv.bias.abs().max()) == 0.0
    assert float((blk.attn.q_norm - 1).abs().max()) == 0.0
    assert float(dit.final["adaln"].weight.abs().max()) == 0.0
    assert float(dit.final["proj"].weight.std()) > 0.0
    conv = vae.enc.scales[1].res[0].conv1.weight  # [16, 8, 3, 3, 3]
    assert abs(float(conv.std()) - (27 * 8) ** -0.5) < 0.25 * (27 * 8) ** -0.5
    assert 0.8 < float(text.embed.std()) < 1.2
    gen2 = torch.Generator().manual_seed(0)
    dit2, _, _ = weights.init_random(TCFG, "cpu", gen2)
    assert torch.equal(dit2.blocks[1].ffn.w2.weight, dit.blocks[1].ffn.w2.weight)
