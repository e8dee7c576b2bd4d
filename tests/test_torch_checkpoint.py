"""The port's checkpoint path (utils/safetensors.py, models/convert.py,
``ModelBundle.from_checkpoint_dir``, the runner's --checkpoint-dir) vs the
JAX package's converters on synthetic LongCat-layout state dicts
(tests/synth_checkpoints.py), written as shards and read back by the
port's reader.

Tolerances: the converted tensors are compared bit for bit (the same
transposes and casts on the same values); the DiT forward of the loaded
model against JAX ``dit_forward`` at fp32 to 1e-4 abs/rel, as in
test_torch_models.py.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import safetensors.numpy
import safetensors.torch
import torch

from longcat_video_tta_tpu.config import get_model_config as jax_config
from longcat_video_tta_tpu.models import dit as jdit
from longcat_video_tta_tpu.models.convert import (
    convert_torch_dit_state,
    convert_torch_umt5_state,
    convert_torch_vae_state,
)
from longcat_video_tta_tpu_torch.config import get_model_config
from longcat_video_tta_tpu_torch.models import convert
from longcat_video_tta_tpu_torch.models import weights
from longcat_video_tta_tpu_torch.pipeline.pipeline import HashTokenizer, ModelBundle
from longcat_video_tta_tpu_torch.runners import run_tta
from longcat_video_tta_tpu_torch.utils import safetensors as port_st

sys.path.insert(0, os.path.dirname(__file__))
from synth_checkpoints import make_dit_sd, make_umt5_sd, make_vae_sd  # noqa: E402

torch.set_num_threads(1)

# component: (maker, JAX converter, port numpy bridge, port checkpoint loader,
# config attribute)
COMPONENTS = {
    "dit": (make_dit_sd, convert_torch_dit_state, weights.load_dit_from_numpy,
            convert.load_dit_checkpoint, "dit"),
    "text_encoder": (make_umt5_sd, convert_torch_umt5_state, weights.load_umt5_from_numpy,
                     convert.load_umt5_checkpoint, "text"),
    "vae": (make_vae_sd, convert_torch_vae_state, weights.load_vae_from_numpy,
            convert.load_vae_checkpoint, "vae"),
}


def _write(folder, sd, n_shards=2, fmt="safetensors"):
    """``sd`` (numpy) as ``n_shards`` shards of ``fmt`` under ``folder``."""
    os.makedirs(folder, exist_ok=True)
    keys = list(sd)
    for i in range(n_shards):
        part = {k: sd[k] for k in keys[i::n_shards]}
        if fmt == "safetensors":
            safetensors.numpy.save_file(part, os.path.join(folder, f"m-{i}.safetensors"))
        else:
            torch.save({k: torch.from_numpy(v) for k, v in part.items()},
                       os.path.join(folder, f"pytorch_model-{i}.bin"))
    return folder


def _reference_module(component, preset, sd, **kw):
    make, jconv, bridge, _, attr = COMPONENTS[component]
    tree = jconv(sd, getattr(jax_config(preset), attr), **kw)
    return bridge(jax.tree.map(np.asarray, tree), getattr(get_model_config(preset), attr),
                  "cpu")


def _assert_modules_equal(got, ref):
    g, r = got.state_dict(), ref.state_dict()
    assert list(g) == list(r)
    for k in r:
        assert g[k].dtype == r[k].dtype, k
        assert torch.equal(g[k], r[k]), k


@pytest.mark.parametrize("preset", ["longcat_tiny", "longcat_demo"])
@pytest.mark.parametrize("component", list(COMPONENTS))
def test_converter_matches_jax_bit_for_bit(tmp_path, preset, component):
    make, _, _, load, attr = COMPONENTS[component]
    sd = make(getattr(jax_config(preset), attr), seed=3)
    folder = _write(str(tmp_path / component), sd)
    got = load(folder, getattr(get_model_config(preset), attr), "cpu")
    _assert_modules_equal(got, _reference_module(component, preset, sd))


def test_dit_rope_interleaved_matches_jax(tmp_path):
    sd = make_dit_sd(jax_config("longcat_tiny").dit, seed=4)
    # distinct q/k norm scales, so the permutation shows in them too
    rng = np.random.default_rng(0)
    for k in sd:
        if k.endswith(("q_norm.weight", "k_norm.weight")):
            sd[k] = rng.uniform(0.5, 1.5, sd[k].shape).astype(np.float32)
    folder = _write(str(tmp_path / "dit"), sd)
    got = convert.load_dit_checkpoint(folder, get_model_config("longcat_tiny").dit, "cpu",
                                      rope_interleaved=True)
    _assert_modules_equal(got, _reference_module("dit", "longcat_tiny", sd,
                                                 rope_interleaved=True))
    plain = convert.load_dit_checkpoint(folder, get_model_config("longcat_tiny").dit, "cpu")
    assert not torch.equal(plain.blocks[0].attn.qkv.weight, got.blocks[0].attn.qkv.weight)


def test_bf16_shards_match_jax(tmp_path):
    """bf16 shards (the real checkpoint's dtype): the reference converts
    the same bf16 values."""
    cfg = jax_config("longcat_demo")
    sd = {k: torch.from_numpy(v).to(torch.bfloat16) for k, v in make_umt5_sd(cfg.text).items()}
    os.makedirs(tmp_path / "te")
    safetensors.torch.save_file(sd, str(tmp_path / "te" / "model.safetensors"))
    got = convert.load_umt5_checkpoint(str(tmp_path / "te"), get_model_config(
        "longcat_demo").text, "cpu")
    ref = _reference_module("text_encoder", "longcat_demo",
                            {k: v.float().numpy() for k, v in sd.items()})
    _assert_modules_equal(got, ref)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32])
def test_reader_and_writer_match_the_safetensors_package(tmp_path, dtype):
    g = torch.Generator().manual_seed(0)
    tensors = {"a.weight": torch.randn(5, 7, generator=g).to(dtype),
               "b": torch.randn(3, generator=g).to(dtype),
               "c.scalar": torch.randn((), generator=g).to(dtype),
               "d.empty": torch.zeros((0, 4), dtype=dtype),
               "e.ints": torch.arange(6, dtype=torch.int64).reshape(2, 3)}
    theirs, ours = str(tmp_path / "theirs.safetensors"), str(tmp_path / "ours.safetensors")
    safetensors.torch.save_file(tensors, theirs, metadata={"format": "pt"})
    port_st.save_file(tensors, ours)
    for read in (port_st.load_file(theirs), safetensors.torch.load_file(ours),
                 port_st.load_file(ours)):
        assert set(read) == set(tensors)
        for k, t in tensors.items():
            assert read[k].dtype == t.dtype and read[k].shape == t.shape, k
            assert torch.equal(read[k], t), k


def test_bin_shards_load_like_safetensors(tmp_path):
    cfg = jax_config("longcat_tiny")
    sd = make_dit_sd(cfg.dit, seed=5)
    tcfg = get_model_config("longcat_tiny").dit
    a = convert.load_dit_checkpoint(_write(str(tmp_path / "st"), sd), tcfg, "cpu")
    b = convert.load_dit_checkpoint(_write(str(tmp_path / "bin"), sd, fmt="bin"), tcfg, "cpu")
    _assert_modules_equal(b, a)


@pytest.mark.parametrize("component", list(COMPONENTS))
def test_an_unconsumed_key_raises(tmp_path, component):
    make, _, _, load, attr = COMPONENTS[component]
    sd = make(getattr(jax_config("longcat_tiny"), attr))
    sd["extra.pos_embedding"] = np.zeros((4,), np.float32)
    folder = _write(str(tmp_path / component), sd)
    with pytest.raises(ValueError, match="unconsumed: extra.pos_embedding"):
        load(folder, getattr(get_model_config("longcat_tiny"), attr), "cpu")


def test_a_missing_key_raises(tmp_path):
    sd = make_dit_sd(jax_config("longcat_tiny").dit)
    del sd["blocks.1.ffn.w2.weight"]
    with pytest.raises(KeyError, match="blocks.1.ffn.w2.weight"):
        convert.load_dit_checkpoint(_write(str(tmp_path / "dit"), sd),
                                    get_model_config("longcat_tiny").dit, "cpu")


def test_a_tied_umt5_embedding_is_accepted_only_when_equal(tmp_path):
    cfg = jax_config("longcat_tiny").text
    sd = make_umt5_sd(cfg)
    sd["encoder.embed_tokens.weight"] = sd["shared.weight"].copy()
    tcfg = get_model_config("longcat_tiny").text
    got = convert.load_umt5_checkpoint(_write(str(tmp_path / "tied"), sd), tcfg, "cpu")
    assert torch.equal(got.embed, torch.from_numpy(sd["shared.weight"]))
    sd["encoder.embed_tokens.weight"] = sd["shared.weight"] + 1
    with pytest.raises(ValueError, match="untied"):
        convert.load_umt5_checkpoint(_write(str(tmp_path / "untied"), sd), tcfg, "cpu")


@pytest.mark.parametrize("preset", ["longcat_tiny", "longcat_demo"])
def test_state_shapes_are_the_synthetic_layout(preset):
    """``models/convert.py``'s key and shape lists (what chip_smoke writes)
    are the synthetic upstream layouts the JAX converters read."""
    j, t = jax_config(preset), get_model_config(preset)
    shapes = lambda sd: {k: tuple(v.shape) for k, v in sd.items()}
    assert convert.dit_state_shapes(t.dit, patch_conv=False) == shapes(make_dit_sd(j.dit))
    assert convert.umt5_state_shapes(t.text) == shapes(make_umt5_sd(j.text))
    assert convert.vae_state_shapes(t.vae) == shapes(make_vae_sd(j.vae))


def _checkpoint_dir(root, preset="longcat_tiny", seed=6, patch_conv=False):
    cfg = jax_config(preset)
    sds = {"dit": make_dit_sd(cfg.dit, seed), "vae": make_vae_sd(cfg.vae, seed),
           "text_encoder": make_umt5_sd(cfg.text, seed)}
    if patch_conv:  # the patch embedding as the upstream Conv3d
        d = cfg.dit
        w = sds["dit"]["x_embedder.proj.weight"]
        sds["dit"]["x_embedder.proj.weight"] = np.ascontiguousarray(
            w.reshape(d.hidden_size, *d.patch_size, d.in_channels).transpose(0, 4, 1, 2, 3))
    for name, sd in sds.items():
        _write(os.path.join(root, name), sd)
    return sds


def test_loaded_dit_forward_matches_jax(tmp_path):
    """A Conv3d patch embedding and the whole bundle through
    ``ModelBundle.from_checkpoint_dir``: the DiT forward against JAX
    ``dit_forward`` on the converted tree."""
    sds = _checkpoint_dir(str(tmp_path), patch_conv=True)
    jcfg = jax_config("longcat_tiny")
    bundle = ModelBundle.from_checkpoint_dir(get_model_config("longcat_tiny"),
                                             str(tmp_path), "cpu")
    assert isinstance(bundle.tokenize, HashTokenizer)
    params = convert_torch_dit_state(sds["dit"], jcfg.dit)
    rng = np.random.default_rng(0)
    lat = rng.standard_normal((1, 16, 3, 4, 6)).astype(np.float32)
    ts = np.array([[0.0, 300.0, 300.0]], np.float32)
    text = rng.standard_normal((1, 16, 48)).astype(np.float32)
    mask = np.ones((1, 16), np.int32)
    ref = jdit.dit_forward(params, jcfg.dit, jnp.asarray(lat), jnp.asarray(ts),
                           jnp.asarray(text), jnp.asarray(mask), num_cond_latents=1)
    with torch.no_grad():
        out = bundle.dit(torch.from_numpy(lat), torch.from_numpy(ts),
                         torch.from_numpy(text), torch.from_numpy(mask), num_cond_latents=1)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4, rtol=1e-4)


def test_a_tokenizer_folder_without_transformers_raises(tmp_path, monkeypatch):
    _checkpoint_dir(str(tmp_path))
    os.makedirs(tmp_path / "tokenizer")
    monkeypatch.setitem(sys.modules, "transformers", None)
    with pytest.raises(RuntimeError, match="transformers"):
        ModelBundle.from_checkpoint_dir(get_model_config("longcat_tiny"), str(tmp_path),
                                        "cpu")


def test_vae_latent_statistics_come_from_the_checkpoint(tmp_path):
    import json

    _checkpoint_dir(str(tmp_path))
    stats = {"latents_mean": [0.5] * 16, "latents_std": [2.0] * 16}
    with open(tmp_path / "vae" / "config.json", "w") as f:
        json.dump(stats, f)
    bundle = ModelBundle.from_checkpoint_dir(get_model_config("longcat_tiny"),
                                             str(tmp_path), "cpu")
    assert bundle.cfg.vae.latents_mean == (0.5,) * 16
    assert bundle.cfg.vae.latents_std == (2.0,) * 16


def test_runner_runs_on_a_checkpoint_dir(tmp_path):
    """The runner's --checkpoint-dir on a synthesized LongCat-layout folder
    (delta_a, longcat_tiny): the trained DiT is the checkpoint's."""
    ckpt = str(tmp_path / "ckpt")
    _checkpoint_dir(ckpt)
    argv = ["--method", "delta_a", "--preset", "longcat_tiny", "--synthetic", "1",
            "--device", "cpu", "--output-dir", str(tmp_path / "run"), "--height", "16",
            "--width", "32", "--num-cond-frames", "5", "--num-frames", "5",
            "--gen-start-frame", "16", "--tta-total-frames", "13", "--steps", "2",
            "--es-check-every", "2", "--num-inference-steps", "2",
            "--caption-guard-mode", "off", "--checkpoint-dir", ckpt, "--no-save-videos"]
    summary = run_tta.main(argv)
    r = summary["results"][0]
    assert r["success"], r.get("error")
    assert np.isfinite(r["losses"]).all() and np.isfinite(r["psnr"])
    assert summary["config"]["checkpoint_dir"] == ckpt
