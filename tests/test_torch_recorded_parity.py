"""The port against RECORDED reference activations (counterpart of
tests/test_recorded_parity.py).

``scripts/record_activations.py``, run where the upstream torch stack and
a LongCat checkpoint live, writes ``.npz`` probes (dit_forward,
vae_encode, vae_decode, text_encode) of fixed inputs and the upstream
modules' outputs. The replays below feed the recorded inputs to the
port's modules, loaded from the same upstream-layout checkpoint folder
through ``ModelBundle.from_checkpoint_dir`` (the runner's
``--checkpoint-dir`` loader; the port reads that layout directly, so no
converted bundle is needed), and compare in the recorded spaces:
latents un-normalized (the recorder keeps ``latent_dist.mode()``), pixels
mapped from the port's [0, 1] to the recorder's [-1, 1].

The real-weight cases are skipped unless LONGCAT_PARITY_DIR (the
recordings) and LONGCAT_CHECKPOINT_DIR (the checkpoint they were
recorded from, longcat_13b) are set; they run on the card when there is
one. No recordings or weights are in the repository, so they wait for
both. The plumbing case runs everywhere: it writes probes in the
recorder's format from the JAX reference's functions on the synthetic
upstream folder of tests/synth_checkpoints.py (converted for JAX as
tests/test_convert.py converts it), at longcat_tiny's shapes, and
replays them through the port.

Tolerances, each abs and rel: on real weights the reference test's, the
DiT 5e-2 (bf16 matmuls over 48 blocks), the VAE 1e-3, the text encoder
2e-2; the plumbing case 1e-4 for every probe (both packages in fp32 on
the CPU, as test_torch_models.py), which the reference's would not hold
a replay to at these small activations (the tiny DiT's outputs have a
standard deviation of 0.16).
"""

import os
import sys

import numpy as np
import pytest
import torch

from longcat_video_tta_tpu_torch.config import get_model_config, longcat_tiny
from longcat_video_tta_tpu_torch.models import vae as tvae
from longcat_video_tta_tpu_torch.models.umt5 import umt5_encode
from longcat_video_tta_tpu_torch.pipeline.pipeline import ModelBundle
from longcat_video_tta_tpu_torch.utils.safetensors import save_file

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tests"))
from synth_checkpoints import make_dit_sd, make_umt5_sd, make_vae_sd  # noqa: E402

torch.set_num_threads(1)

TOL = {"dit_forward": 5e-2, "vae_encode": 1e-3, "vae_decode": 1e-3, "text_encode": 2e-2}
PLUMBING_TOL = dict.fromkeys(TOL, 1e-4)
PARITY_DIR = os.environ.get("LONGCAT_PARITY_DIR")
CHECKPOINT_DIR = os.environ.get("LONGCAT_CHECKPOINT_DIR")


# ---------------------------------------------------------------------------
# Replays: the recorded inputs through the port, outputs in the recorded space
# ---------------------------------------------------------------------------


def _t(a, device, dtype=None):
    t = torch.from_numpy(np.array(a)).to(device)
    return t if dtype is None else t.to(dtype)


def replay_dit_forward(bundle, r):
    d = bundle.device
    with torch.no_grad():
        out = bundle.dit(_t(r["latents"], d, torch.float32), _t(r["timesteps"], d, torch.float32),
                         _t(r["text"], d, torch.float32), _t(r["mask"], d),
                         num_cond_latents=int(r["num_cond_latents"]))
    return out.float().cpu().numpy()


def _latent_stats(r, device):
    mean = _t(r["latents_mean"], device, torch.float32).reshape(1, -1, 1, 1, 1)
    std = _t(r["latents_std"], device, torch.float32).reshape(1, -1, 1, 1, 1)
    return mean, std


def replay_vae_encode(bundle, r):
    """The port's normalized latents, un-normalized with the recorded
    statistics (the recorder keeps ``latent_dist.mode()``)."""
    d = bundle.device
    mean, std = _latent_stats(r, d)
    with torch.no_grad():
        z = tvae.vae_encode(bundle.vae, _t(r["pixels"], d, torch.float32))
    return (z.float() * std + mean).cpu().numpy()


def replay_vae_decode(bundle, r, stats):
    """The recorded (un-normalized) latents normalized with ``stats``' (the
    encode probe's) statistics, decoded, mapped from [0, 1] to [-1, 1]."""
    d = bundle.device
    mean, std = _latent_stats(stats, d)
    with torch.no_grad():
        px = tvae.vae_decode(bundle.vae, (_t(r["latents"], d, torch.float32) - mean) / std)
    return (px.float() * 2 - 1).cpu().numpy()


def replay_text_encode(bundle, r):
    d = bundle.device
    with torch.no_grad():
        h = umt5_encode(bundle.text, _t(r["input_ids"], d, torch.long), _t(r["mask"], d))
    return h.float().cpu().numpy()


def check_probes(bundle, rec, tol=TOL):
    """Every probe ``rec(name)`` returns (None when it was not recorded)
    against its replay under ``tol``; returns the probes checked."""
    done = []
    r = rec("dit_forward.npz")
    if r is not None:
        np.testing.assert_allclose(replay_dit_forward(bundle, r), r["output"],
                                   atol=tol["dit_forward"], rtol=tol["dit_forward"])
        done.append("dit_forward")
    enc = rec("vae_encode.npz")
    if enc is not None:
        np.testing.assert_allclose(replay_vae_encode(bundle, enc), enc["latents"],
                                   atol=tol["vae_encode"], rtol=tol["vae_encode"])
        done.append("vae_encode")
        dec = rec("vae_decode.npz")
        if dec is not None:
            np.testing.assert_allclose(replay_vae_decode(bundle, dec, enc), dec["pixels"],
                                       atol=tol["vae_decode"], rtol=tol["vae_decode"])
            done.append("vae_decode")
    r = rec("text_encode.npz")
    if r is not None:
        np.testing.assert_allclose(replay_text_encode(bundle, r), r["hidden"],
                                   atol=tol["text_encode"], rtol=tol["text_encode"])
        done.append("text_encode")
    return done


# ---------------------------------------------------------------------------
# Real weights: gated on the two folders
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def real_bundle():
    if not (PARITY_DIR and CHECKPOINT_DIR and os.path.isdir(PARITY_DIR)
            and os.path.isdir(CHECKPOINT_DIR)):
        pytest.skip("set LONGCAT_PARITY_DIR + LONGCAT_CHECKPOINT_DIR to run "
                    "recorded-activation parity (see scripts/record_activations.py)")
    device = "cuda" if torch.cuda.is_available() else "cpu"
    return ModelBundle.from_checkpoint_dir(get_model_config("longcat_13b"), CHECKPOINT_DIR,
                                           device=device)


def _recorded(name):
    path = os.path.join(PARITY_DIR, name)
    if not os.path.exists(path):
        pytest.skip(f"{name} not recorded")
    return np.load(path)


def test_dit_forward_parity(real_bundle):
    r = _recorded("dit_forward.npz")
    np.testing.assert_allclose(replay_dit_forward(real_bundle, r), r["output"],
                               atol=TOL["dit_forward"], rtol=TOL["dit_forward"])


def test_vae_parity(real_bundle):
    enc = _recorded("vae_encode.npz")
    np.testing.assert_allclose(replay_vae_encode(real_bundle, enc), enc["latents"],
                               atol=TOL["vae_encode"], rtol=TOL["vae_encode"])
    dec = _recorded("vae_decode.npz")
    np.testing.assert_allclose(replay_vae_decode(real_bundle, dec, enc), dec["pixels"],
                               atol=TOL["vae_decode"], rtol=TOL["vae_decode"])


def test_text_encoder_parity(real_bundle):
    r = _recorded("text_encode.npz")
    np.testing.assert_allclose(replay_text_encode(real_bundle, r), r["hidden"],
                               atol=TOL["text_encode"], rtol=TOL["text_encode"])


# ---------------------------------------------------------------------------
# The harness's plumbing: probes written from the JAX reference on a
# synthetic upstream folder, replayed through the port
# ---------------------------------------------------------------------------


def _seeded(shape, seed, scale=1.0):
    """record_activations.py's draw."""
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(np.float32)


def write_jax_probes(sds, cfg, out_dir):
    """The recorder's four probes at ``cfg``'s sizes (its seeds, masks and
    layouts), with the JAX reference's functions on the converted ``sds``
    standing in for the upstream modules."""
    import jax.numpy as jnp

    from longcat_video_tta_tpu.config import longcat_tiny as jax_tiny
    from longcat_video_tta_tpu.models import convert as jconvert
    from longcat_video_tta_tpu.models import vae as jvae
    from longcat_video_tta_tpu.models.dit import dit_forward
    from longcat_video_tta_tpu.models.umt5 import umt5_encode as jax_umt5

    jcfg = jax_tiny()
    dit_p = jconvert.convert_torch_dit_state(sds["dit"], jcfg.dit)
    vae_p = jconvert.convert_torch_vae_state(sds["vae"], jcfg.vae)
    text_p = jconvert.convert_torch_umt5_state(sds["text_encoder"], jcfg.text)

    lat = _seeded((1, cfg.dit.in_channels, 3, 8, 12), 0)
    tsteps = np.array([[0.0, 0.0, 500.0]], np.float32)
    text = _seeded((1, cfg.dit.text_len, cfg.dit.text_dim), 1, 0.1)
    mask = np.ones((1, cfg.dit.text_len), np.int64)
    mask[:, cfg.dit.text_len * 5 // 8:] = 0
    out = dit_forward(dit_p, jcfg.dit, jnp.asarray(lat), jnp.asarray(tsteps),
                      jnp.asarray(text), jnp.asarray(mask), num_cond_latents=2)
    np.savez(os.path.join(out_dir, "dit_forward.npz"), latents=lat, timesteps=tsteps,
             text=text, mask=mask, num_cond_latents=2, output=np.asarray(out, np.float32))

    mean = np.asarray(cfg.vae.latents_mean, np.float32)
    std = np.asarray(cfg.vae.latents_std, np.float32)
    px = _seeded((1, 3, 9, 64, 96), 2, 0.5).clip(-1, 1)
    z = np.asarray(jvae.vae_encode(vae_p, jcfg.vae, jnp.asarray(px)), np.float32)
    lat_raw = z * std.reshape(1, -1, 1, 1, 1) + mean.reshape(1, -1, 1, 1, 1)
    dec = jvae.vae_decode(vae_p, jcfg.vae, jnp.asarray(z))
    np.savez(os.path.join(out_dir, "vae_encode.npz"), pixels=px, latents=lat_raw,
             latents_mean=mean, latents_std=std)
    np.savez(os.path.join(out_dir, "vae_decode.npz"), latents=lat_raw,
             pixels=np.asarray(dec, np.float32) * 2 - 1)

    L = cfg.text.max_length
    ids = np.random.RandomState(3).randint(2, cfg.text.vocab_size, (1, L))
    tmask = np.ones((1, L), np.int64)
    tmask[:, L * 5 // 8:] = 0
    ids = ids * tmask
    h = jax_umt5(text_p, jcfg.text, jnp.asarray(ids), jnp.asarray(tmask))
    np.savez(os.path.join(out_dir, "text_encode.npz"), input_ids=ids, mask=tmask,
             hidden=np.asarray(h, np.float32))


def test_replay_of_jax_probes_on_a_synthetic_checkpoint(tmp_path):
    cfg = longcat_tiny()
    ckpt, probes = tmp_path / "ckpt", tmp_path / "recordings"
    sds = {}
    for comp, make, sub in (("dit", make_dit_sd, "dit"), ("vae", make_vae_sd, "vae"),
                            ("text_encoder", make_umt5_sd, "text")):
        sds[comp] = make(getattr(cfg, sub))
        (ckpt / comp).mkdir(parents=True)
        save_file({k: torch.from_numpy(v) for k, v in sds[comp].items()},
                  str(ckpt / comp / "model.safetensors"))
    probes.mkdir()
    write_jax_probes(sds, cfg, str(probes))
    bundle = ModelBundle.from_checkpoint_dir(cfg, str(ckpt), device="cpu")

    def rec(name):
        path = probes / name
        return np.load(path) if path.exists() else None

    assert check_probes(bundle, rec, PLUMBING_TOL) == ["dit_forward", "vae_encode",
                                                       "vae_decode", "text_encode"]
    # a replay that loses the checkpoint's weights fails the harness
    bundle.dit.final.proj.weight.data.mul_(1.5)
    with pytest.raises(AssertionError):
        check_probes(bundle, rec, PLUMBING_TOL)
