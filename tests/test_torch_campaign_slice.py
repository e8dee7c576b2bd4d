"""The science loop as a whole on the CPU: the reference's pretrainer
(scripts/pretrain_demo.py --smoke) trains the tiny stack; its bundle's
parameters, carried into the port and written by
``models/convert.py::save_checkpoint_dir``, run the demo campaign's NOTTA
and FULL rows (2 distribution-B videos each) through the port's runner,
and the reference bundle runs the same rows through the reference's
runner. Each row's argv comes from its own driver's ``--smoke --dry-run``
(the two differ only by the checkpoint folder and the port's --device);
the tower flags are dropped from both (the smoke already turns VBench
off). JAX and torch draw different numbers from one seed, so the port's
generation gets the reference sampler's initial noise (``jax.random.normal``
of ``PRNGKey(seed)``) through ``generate_vc``'s ``init_noise``, and its
TTA gets the reference runner's draws: each step's sigma and noise from
``step_keys(seed, video, step)`` split as the reference loss splits it,
each video's anchor noises from ``PRNGKey(seed + d)``. So FULL's per-step
losses and anchor losses must agree with the reference's (relative
1e-4), and the anchors must move by more than that over the row's steps:
a port whose FULL row left the DiT as it was, or trained on another
target, fails. Per-video PSNR agrees within 1e-2 dB.
"""

import contextlib
import io
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from longcat_video_tta_tpu.config import get_model_config as jax_model_config
from longcat_video_tta_tpu.models.convert import load_converted_bundle
from longcat_video_tta_tpu.runners.run_tta import main as jax_run_tta
from longcat_video_tta_tpu.runners.run_tta import step_keys
from longcat_video_tta_tpu_torch.config import longcat_tiny
from longcat_video_tta_tpu_torch.models.convert import save_checkpoint_dir
from longcat_video_tta_tpu_torch.pipeline import pipeline as port_pipeline
from longcat_video_tta_tpu_torch.pipeline.pipeline import ModelBundle, round_frames_4k1
from longcat_video_tta_tpu_torch.runners import run_tta as port_runner
from longcat_video_tta_tpu_torch.runners.run_tta import main as port_run_tta
from longcat_video_tta_tpu_torch.scripts import pretrain_demo, run_demo_campaign
from longcat_video_tta_tpu_torch.tta import early_stopping as port_es
from longcat_video_tta_tpu_torch.tta import losses as port_losses

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "scripts"))
import pretrain_demo as jax_pretrain_demo  # noqa: E402  (the reference scripts)
import run_demo_campaign as jax_run_demo_campaign  # noqa: E402

PSNR_ATOL_DB = 1e-2
LOSS_RTOL = 1e-4
TOWER_VALUE_FLAGS = ("--lpips-model-path", "--clip-gate-model-path", "--i3d-model-path",
                     "--inception-model-path", "--vbench-towers-dir", "--clip-gate-scorer")
TOWER_SWITCHES = ("--clip-gate-enabled", "--clip-gate-hash-tokenizer", "--clip-gate-log-only",
                  "--fvd-enabled", "--compute-vbench")


def _dry_run(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert main(argv) == 0
    out = buf.getvalue()
    return {r["run_id"]: r["argv"] for r in json.loads(out[out.index("\n[\n") + 1:])}


def _without_towers(argv, out_dir):
    out, i = [], 0
    while i < len(argv):
        if argv[i] in TOWER_VALUE_FLAGS:
            i += 2
            continue
        if argv[i] not in TOWER_SWITCHES:
            out.append(argv[i])
        i += 1
    out[out.index("--output-dir") + 1] = out_dir
    return out


@pytest.fixture(scope="module")
def rows(tmp_path_factory):
    root = tmp_path_factory.mktemp("slice")
    jax_ckpt, port_ckpt = str(root / "jax_ckpt"), str(root / "port_ckpt")
    jax_pretrain_demo.main(["--smoke", "--out-dir", jax_ckpt])
    jb = load_converted_bundle(jax_ckpt, jax_model_config("longcat_tiny"))
    tonp = lambda t: jax.tree.map(np.asarray, t)
    tb = ModelBundle.from_numpy(longcat_tiny(), tonp(jb.dit_params), tonp(jb.vae_params),
                                tonp(jb.text_params), device="cpu")
    tb = pretrain_demo.with_latent_stats(tb, jb.cfg.vae.latents_mean, jb.cfg.vae.latents_std)
    save_checkpoint_dir(tb, port_ckpt)
    towers = root / "towers"  # present for both drivers; the flags are dropped below
    towers.mkdir()
    (towers / "lpips_alex.pth").touch()
    common = ["--smoke", "--dry-run", "--max-videos", "2", "--rows", "baseline,full",
              "--output-base", str(root / "campaign"), "--towers-dir", str(towers)]
    ref = _dry_run(jax_run_demo_campaign.main, common + ["--ckpt-dir", jax_ckpt])
    ours = _dry_run(run_demo_campaign.main, common + ["--ckpt-dir", port_ckpt,
                                                      "--device", "cpu"])
    return root, jb, ref, ours


def test_the_port_checkpoint_holds_the_reference_bundle(rows):
    root, jb, _, _ = rows
    back = ModelBundle.from_checkpoint_dir(longcat_tiny(), str(root / "port_ckpt"),
                                           device="cpu")
    np.testing.assert_allclose(back.cfg.vae.latents_mean, jb.cfg.vae.latents_mean)
    np.testing.assert_allclose(back.cfg.vae.latents_std, jb.cfg.vae.latents_std)
    assert back.cfg.vae.latents_mean != longcat_tiny().vae.latents_mean


def _with_reference_noise(generate_vc):
    """``generate_vc`` whose initial noise is the reference sampler's draw
    for the same seed and shape."""
    def run(bundle, cond_px, caption, *, num_frames, seed, init_noise=None, **kw):
        if init_noise is None:
            cfg, sf = bundle.cfg, bundle.cfg.vae.spatial_factor
            n_gen = (round_frames_4k1(num_frames) - 1) // cfg.vae.temporal_factor + 1
            shape = (1, cfg.dit.in_channels, n_gen, cond_px.shape[-2] // sf,
                     cond_px.shape[-1] // sf)
            init_noise = torch.from_numpy(np.asarray(
                jax.random.normal(jax.random.PRNGKey(seed), shape, jnp.float32)))
        return generate_vc(bundle, cond_px, caption, num_frames=num_frames, seed=seed,
                           init_noise=init_noise, **kw)
    return run


def _with_reference_draws(monkeypatch):
    """The port's TTA draws replaced by the reference runner's: a video's
    generator (made in ``prepare_video``) stands for its (seed, video) and
    counts its steps; each step's sigma and noise come from that step's
    ``step_keys`` key, split into the sigma and noise keys as the
    reference's conditioned loss splits it; the anchor noises of the fixed
    seed come from ``PRNGKey(seed + d)``."""
    steps = {}
    prepare = port_runner.prepare_video

    def prepare_video(args, *rest):
        v = prepare(args, *rest)
        steps[id(v["gen"])] = [args.seed, rest[7], 0]  # rest[7]: the video's index
        return v

    def draw_sigma_noise(target, generator, *, sigma_min=0.001, sigma_max=1.0):
        seed, video, t = steps[id(generator)]
        steps[id(generator)][2] += 1
        k_sig, k_noise = jax.random.split(step_keys(seed, video, t, t + 1)[0])
        sigma = jax.random.uniform(k_sig, (target.shape[0],), minval=sigma_min,
                                   maxval=sigma_max)
        noise = jax.random.normal(k_noise, tuple(target.shape), jnp.float32)
        return torch.from_numpy(np.array(sigma)), torch.from_numpy(np.array(noise))

    def draw_fixed_noises(val_latents, seed, noise_draws):
        return torch.from_numpy(np.stack([np.array(jax.random.normal(
            jax.random.PRNGKey(seed + d), tuple(val_latents.shape), jnp.float32))
            for d in range(noise_draws)]))

    monkeypatch.setattr(port_runner, "prepare_video", prepare_video)
    monkeypatch.setattr(port_losses, "draw_sigma_noise", draw_sigma_noise)
    monkeypatch.setattr(port_es, "draw_fixed_noises", draw_fixed_noises)
    return steps


@pytest.mark.parametrize("run_id", ["NOTTA", "FULL"])
def test_row_matches_the_reference_runner_per_video(rows, run_id, monkeypatch):
    root, _, ref, ours = rows
    # the same row: only the checkpoint folder and the port's --device differ
    ck = ref[run_id].index("--checkpoint-dir") + 1
    assert ours[run_id][-2:] == ["--device", "cpu"]
    assert (ours[run_id][:ck] + ours[run_id][ck + 1:-2]
            == ref[run_id][:ck] + ref[run_id][ck + 1:])
    argv_j = _without_towers(ref[run_id], str(root / "jax" / run_id))
    argv_t = _without_towers(ours[run_id], str(root / "port" / run_id))
    jax_run_tta(argv_j)
    monkeypatch.setattr(port_pipeline, "generate_vc",
                        _with_reference_noise(port_pipeline.generate_vc))
    drawn = _with_reference_draws(monkeypatch)
    port_run_tta(argv_t)
    with open(root / "jax" / run_id / "summary.json") as f:
        jres = json.load(f)["results"]
    with open(root / "port" / run_id / "summary.json") as f:
        tres = json.load(f)["results"]
    assert [r["video"] for r in tres] == [r["video"] for r in jres] and len(tres) == 2
    assert all(r["success"] for r in jres + tres)
    np.testing.assert_allclose([r["psnr"] for r in tres], [r["psnr"] for r in jres],
                               rtol=0, atol=PSNR_ATOL_DB)
    if run_id == "NOTTA":
        assert not drawn and all(not r.get("losses") for r in tres + jres)
        return
    # both trained, on the same draws: the same losses, anchors and best step
    assert sorted(v for _, v, _ in drawn.values()) == [0, 1]
    for t, j in zip(tres, jres):
        assert len(t["losses"]) == len(j["losses"]) > 0
        np.testing.assert_allclose(t["losses"], j["losses"], rtol=LOSS_RTOL)
        ht = [x for _, x in t["early_stopping_info"]["loss_history"]]
        hj = [x for _, x in j["early_stopping_info"]["loss_history"]]
        assert len(ht) == len(hj) > 1
        np.testing.assert_allclose(ht, hj, rtol=LOSS_RTOL)
        assert (t["early_stopping_info"]["best_step"]
                == j["early_stopping_info"]["best_step"])
        # the test sees TTA: the reference's anchors move past the tolerance
        assert max(abs(x - hj[0]) for x in hj[1:]) > 10 * LOSS_RTOL * abs(hj[0])
