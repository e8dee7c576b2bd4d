"""The port runner's single-video TTA paths (longcat_tiny, CPU plain path)
against the JAX package: --bucket-shapes (tta/bucket.py, the masked loss
of tta/losses.py), augmentation (data/augment.py), batch TTA's retrieval
(data/retrieval.py), the stop-file drain, --preflight-only,
--save-adapters and the composition gates.

Tolerances: the bucketed loss and gradients against JAX as
test_torch_tta.py (loss 1e-5 rel, gradients 1e-4 rel / 1e-6 abs); the
pad's content changes nothing (1e-6 rel: the masked keys weigh exactly 0,
the masked frames are not summed); hflip, speed variants and the
retrieval ranking exactly; rotation against cv2 within 2 * (1/64 +
1/1024) = 0.0332 per element of frames in [0, 1], the bound that follows
from cv2's 1/32-pixel coordinate table (data/augment.py).
"""

import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from longcat_video_tta_tpu.config import AugmentationConfig as JaxAugConfig
from longcat_video_tta_tpu.config import longcat_tiny as jax_tiny
from longcat_video_tta_tpu.data import augment as jaug
from longcat_video_tta_tpu.data import retrieval as jret
from longcat_video_tta_tpu.pipeline import ModelBundle as JaxBundle
from longcat_video_tta_tpu.tta import bucket as jbucket
from longcat_video_tta_tpu.tta import losses as jlosses
from longcat_video_tta_tpu_torch.config import AugmentationConfig, longcat_tiny
from longcat_video_tta_tpu_torch.data import augment, retrieval
from longcat_video_tta_tpu_torch.pipeline.pipeline import ModelBundle
from longcat_video_tta_tpu_torch.runners import run_tta
from longcat_video_tta_tpu_torch.tta.bucket import pad_target_latents
from longcat_video_tta_tpu_torch.tta.losses import flow_matching_loss_conditioned
from longcat_video_tta_tpu_torch.utils.checkpoint import load_adapter_state, \
    save_adapter_state

torch.set_num_threads(1)

JCFG = jax_tiny()
TCFG = longcat_tiny()
ROT_TOL = 2 * (1 / 64 + 1 / 1024)


@pytest.fixture(scope="module")
def bundles():
    jb = JaxBundle.init_random(JCFG, seed=0)
    tonp = lambda t: jax.tree.map(np.asarray, t)
    tb = ModelBundle.from_numpy(TCFG, tonp(jb.dit_params), tonp(jb.vae_params),
                                tonp(jb.text_params), device="cpu")
    return jb, tb


# ---------------------------------------------------------------------------
# --bucket-shapes
# ---------------------------------------------------------------------------


def _bucket_inputs(pad_value):
    """2 cond latents, a 3-latent target padded to its bucket (4) with
    ``pad_value``, text, and the JAX key's own sigma and noise (drawn at
    the padded shape, as the reference's loss draws them)."""
    rng = np.random.default_rng(0)
    f32 = lambda *s: rng.standard_normal(s).astype(np.float32)
    cond, target = f32(1, 16, 2, 4, 6), f32(1, 16, 3, 4, 6)
    padded, valid = pad_target_latents(torch.from_numpy(target))
    jpadded, jvalid = jbucket.pad_target_latents(jnp.asarray(target))
    assert (valid, padded.shape[2]) == (int(jvalid), 4)
    np.testing.assert_array_equal(padded.numpy(), np.asarray(jpadded))
    padded[:, :, valid:] = pad_value
    key = jax.random.PRNGKey(7)
    k_sig, k_noise = jax.random.split(key)
    sigma = np.array(jax.random.uniform(k_sig, (1,), minval=0.001, maxval=1.0))
    noise = np.array(jax.random.normal(k_noise, padded.shape, jnp.float32))
    noise[:, :, valid:] = pad_value
    mask = np.ones((1, 16), np.int32)
    return dict(cond=cond, target=padded.numpy(), valid=valid, key=key, sigma=sigma,
                noise=noise, text=f32(1, 16, 48), mask=mask,
                delta=0.1 * f32(TCFG.dit.adaln_tembed_dim))


def _port_loss_grad(tb, x, valid, t_target=None):
    t = lambda k: torch.from_numpy(np.asarray(x[k]))
    target, noise = t("target"), t("noise")
    if t_target is not None:
        target, noise = target[:, :, :t_target], noise[:, :, :t_target]
    delta = t("delta").requires_grad_(True)
    loss = flow_matching_loss_conditioned(
        tb.dit, t("cond"), target, t("text"), t("mask"), adapters={"delta_t": delta},
        sigma=t("sigma"), noise=noise, num_valid_target=valid)
    (grad,) = torch.autograd.grad(loss, [delta])
    return loss.detach(), grad


def test_bucketed_loss_matches_jax(bundles):
    jb, tb = bundles
    x = _bucket_inputs(pad_value=0.0)
    j = lambda k: jnp.asarray(x[k])

    def jloss(delta):
        return jlosses.flow_matching_loss_conditioned(
            jb.dit_params, JCFG.dit, j("cond"), j("target"), j("text"), j("mask"),
            x["key"], adapters={"delta_t": delta}, num_valid_target=jnp.int32(x["valid"]))

    ref_loss, ref_grad = jax.value_and_grad(jloss)(j("delta"))
    loss, grad = _port_loss_grad(tb, x, x["valid"])
    np.testing.assert_allclose(float(loss), float(ref_loss), rtol=1e-5)
    np.testing.assert_allclose(grad.numpy(), np.asarray(ref_grad), rtol=1e-4, atol=1e-6)


def test_bucketed_loss_ignores_the_pad(bundles):
    """Zeros or 1e3 in the padded frames (latents and noise) give the same
    loss and gradients, equal to the unpadded step's."""
    _, tb = bundles
    zero, big = _bucket_inputs(0.0), _bucket_inputs(1e3)
    l0, g0 = _port_loss_grad(tb, zero, zero["valid"])
    l1, g1 = _port_loss_grad(tb, big, big["valid"])
    torch.testing.assert_close(l1, l0, rtol=1e-6, atol=0)
    torch.testing.assert_close(g1, g0, rtol=1e-6, atol=1e-9)
    lu, gu = _port_loss_grad(tb, zero, None, t_target=zero["valid"])
    torch.testing.assert_close(l0, lu, rtol=1e-5, atol=0)
    torch.testing.assert_close(g0, gu, rtol=1e-4, atol=1e-6)


# ---------------------------------------------------------------------------
# Augmentation and retrieval
# ---------------------------------------------------------------------------


def _frames(t=5, h=12, w=20, seed=0):
    return np.random.default_rng(seed).uniform(0, 1, (t, h, w, 3)).astype(np.float32)


def test_flip_and_speed_variants_match_jax():
    frames = _frames()
    kw = dict(enabled=True, hflip=True, speed_factors=(2.0, 0.5, 3.0))
    ours = augment.build_augmented_pixel_variants(frames, AugmentationConfig(**kw))
    ref = jaug.build_augmented_pixel_variants(frames, JaxAugConfig(**kw))
    assert [v["name"] for v in ours] == [v["name"] for v in ref]
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a["frames"], b["frames"])
    assert augment.parse_speed_factors("2, 0.5,") == jaug.parse_speed_factors("2, 0.5,")


@pytest.mark.parametrize("deg", [5.0, -12.5, 30.0])
def test_rotation_matches_cv2(deg):
    pytest.importorskip("cv2")
    frames = _frames(t=2, h=16, w=28, seed=1)
    ours, ref = augment.rotate_clip(frames, deg), jaug.rotate_clip(frames, deg)
    assert ours.shape == ref.shape and ours.dtype == ref.dtype
    assert float(np.abs(ours - ref).max()) <= ROT_TOL


def test_identity_warp_and_reflect_border():
    frames = _frames(t=1, h=6, w=7)
    eye = np.array([[1.0, 0, 0], [0, 1.0, 0]])
    np.testing.assert_array_equal(augment.warp_affine(frames, eye), frames)
    # a shift by one pixel to the right reads column -1, reflected to column 0
    shift = np.array([[1.0, 0, 1.0], [0, 1.0, 0]])
    out = augment.warp_affine(frames, shift)
    np.testing.assert_allclose(out[:, :, 0], frames[:, :, 0], rtol=0, atol=1e-7)
    np.testing.assert_allclose(out[:, :, 1:], frames[:, :, :-1], rtol=0, atol=1e-7)


def test_augmented_latent_variants_match_jax(bundles):
    jb, tb = bundles
    frames = _frames(t=13, h=16, w=32, seed=2)
    kw = dict(enabled=True, hflip=True, speed_factors=(2.0,))
    ours = augment.build_augmented_latent_variants(tb, frames, AugmentationConfig(**kw),
                                                   2, 0.25)
    ref = jaug.build_augmented_latent_variants(jb, frames, JaxAugConfig(**kw), 2, 0.25)
    assert [v["name"] for v in ours] == [v["name"] for v in ref]
    for a, b in zip(ours, ref):
        for k in ("cond", "train", "val"):
            np.testing.assert_allclose(a[k].numpy(), np.asarray(b[k]), atol=1e-4, rtol=1e-4)


def test_retrieval_neighbors_match_jax():
    captions = ["a ball moving across the scene", "waves rolling over a beach",
                "a car driving down a road", "a bird flying in the sky",
                "a red ball rolling on grass", "a car on a wet road at night"]
    entries = [{"path": f"/data/v{i}.npy", "caption": c} for i, c in enumerate(captions)]
    np.testing.assert_array_equal(retrieval.hashed_bow_embed(captions),
                                  jret.hashed_bow_embed(captions))
    ours, ref = retrieval.build_retrieval_pool(entries), jret.build_retrieval_pool(entries)
    assert ours.embedder == ref.embedder == "hashed_bow"
    for e in entries:
        got = [n["path"] for n in ours.neighbors(e["caption"], e["path"], 3)]
        assert got == [n["path"] for n in ref.neighbors(e["caption"], e["path"], 3)]
        assert e["path"] not in got


def test_sbert_path_without_sentence_transformers_raises(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "sentence_transformers", None)
    with pytest.raises(ImportError, match="sentence_transformers"):
        retrieval.build_retrieval_pool([{"path": "a", "caption": "x"}], str(tmp_path))


# ---------------------------------------------------------------------------
# The runner
# ---------------------------------------------------------------------------


def _argv(out, *extra, method="delta_a", videos=1, steps=2):
    return ["--method", method, "--preset", "longcat_tiny", "--synthetic", str(videos),
            "--device", "cpu", "--output-dir", str(out), "--height", "16", "--width", "32",
            "--num-cond-frames", "5", "--num-frames", "5", "--gen-start-frame", "16",
            "--tta-total-frames", "13", "--steps", str(steps), "--es-check-every", "2",
            "--num-inference-steps", "2", "--caption-guard-mode", "off",
            "--no-save-videos", *extra]


def test_runner_bucket_augment_save_adapters(tmp_path):
    """--bucket-shapes with every augmentation (hflip, a rotation, a
    speed variant) and --save-adapters: the adapter loads back to the
    run's tensors."""
    summary = run_tta.main(_argv(
        tmp_path, "--bucket-shapes", "--aug-enabled", "--aug-hflip",
        "--aug-rotate-degrees", "5", "--aug-speed-factors", "2", "--save-adapters",
        steps=4))
    r = summary["results"][0]
    assert r["success"], r.get("error")
    assert len(r["losses"]) == 4 and np.isfinite(r["losses"]).all()
    assert r["adapter_path"] == os.path.join(str(tmp_path), "adapters",
                                             "0000_clip_000.npy.pt")
    state = load_adapter_state(r["adapter_path"])
    assert list(state) == ["delta"]
    assert float(torch.sqrt((state["delta"].float() ** 2).sum())) == pytest.approx(
        r["adapter_norm"], rel=1e-6)


def test_train_inputs_stack_variants_and_pad(bundles):
    """What the runner trains on with augmentation and buckets: one stack
    per variant, each target padded to its bucket with the valid count,
    and the variant of each step drawn from RandomState(seed + video)."""
    _, tb = bundles
    args = run_tta.build_arg_parser().parse_args(_argv(
        "/unused", "--bucket-shapes", "--aug-enabled", "--aug-hflip",
        "--aug-speed-factors", "2", steps=6))
    from longcat_video_tta_tpu_torch.config import EarlyStoppingConfig

    inputs = run_tta.TrainInputs(args, tb, EarlyStoppingConfig(),
                                 run_tta.augmentation_config(args), None, 2, None)
    px = np.random.default_rng(0).uniform(-1, 1, (1, 3, 13, 16, 32)).astype(np.float32)
    with torch.no_grad():
        lat = tb.encode_video(torch.from_numpy(px))
    from longcat_video_tta_tpu_torch.tta.split import split_tta_latents

    cond, train, _ = split_tta_latents(lat, 2, 0.25)
    emb, mask = torch.zeros(1, 16, 48), torch.ones(1, 16, dtype=torch.int32)
    stacks, select = inputs.build(px, cond, train, emb, mask, {"caption": "x"}, 3)
    assert len(stacks) == 3  # orig, hflip, speed2
    assert all(d["train"].shape[2] == 1 and d["valid"] == 1 for d in stacks)
    rng = np.random.RandomState(args.seed + 3)
    assert select == [int(rng.randint(3)) for _ in range(6)]


def test_runner_batch_videos(tmp_path):
    pool = run_tta.make_synthetic_dataset(str(tmp_path / "pool"), 3, 16, 32, seed=1)
    summary = run_tta.main(_argv(tmp_path / "run", "--batch-videos", "2",
                                 "--retrieval-pool-dir", pool))
    r = summary["results"][0]
    assert r["success"], r.get("error")
    assert summary["config"]["retrieval_embedder"] == "hashed_bow"


@pytest.mark.parametrize("policy", ["dots", "dots_attn"])
def test_runner_remat_policy(tmp_path, policy, monkeypatch):
    """--remat-policy reaches the DiT's config (longcat_tiny trains with
    remat off unless a policy's block is checkpointed; the run succeeds
    either way)."""
    seen = {}
    load = run_tta.load_bundle

    def spy(args):
        bundle = load(args)
        seen["policy"] = bundle.cfg.dit.remat_policy
        return bundle

    monkeypatch.setattr(run_tta, "load_bundle", spy)
    r = run_tta.main(_argv(tmp_path, "--remat-policy", policy))["results"][0]
    assert r["success"], r.get("error")
    assert seen["policy"] == policy


@pytest.mark.parametrize("how", ["flag", "env", "default"])
def test_stop_file_drains_then_resumes(tmp_path, monkeypatch, how):
    stop = str(tmp_path / "STOP") if how == "default" else str(tmp_path / "stop-here")
    extra = ["--stop-file", stop] if how == "flag" else []
    if how == "env":
        monkeypatch.setenv("LONGCAT_STOP_FILE", stop)
    open(stop, "w").close()
    out = run_tta.main(_argv(tmp_path, *extra, videos=2))
    assert out == {"drained": True, "next_idx": 0, "num_videos": 0}
    with open(tmp_path / "DRAINED") as f:
        assert json.load(f) == {"next_idx": 0, "stop_file": stop}
    with open(tmp_path / "checkpoint.json") as f:
        assert json.load(f)["next_idx"] == 0
    assert not os.path.exists(tmp_path / "summary.json")
    if how != "flag":
        return
    os.remove(stop)
    summary = run_tta.main(_argv(tmp_path, *extra, videos=2))
    assert summary["num_videos"] == 2 and summary["num_success"] == 2
    assert os.path.exists(tmp_path / "summary.json")
    assert not os.path.exists(tmp_path / "DRAINED")


def test_preflight_only_loads_no_model(tmp_path, monkeypatch):
    def no_load(args):
        raise AssertionError("preflight loaded the model")

    monkeypatch.setattr(run_tta, "load_bundle", no_load)
    out = run_tta.main(_argv(tmp_path, "--preflight-only", videos=2))
    assert out == {"preflight": True, "num_videos": 2}
    assert not os.path.exists(tmp_path / "checkpoint.json")


def test_adapter_state_round_trip(tmp_path):
    g = torch.Generator().manual_seed(0)
    state = {"delta": torch.randn(8, generator=g),
             "blocks.0.attn.q_norm": torch.randn(4, generator=g).to(torch.bfloat16)}
    path = save_adapter_state(str(tmp_path / "a" / "0001_v.pt"), state)
    back = load_adapter_state(path)
    assert list(back) == list(state)
    for k in state:
        assert back[k].dtype == state[k].dtype and torch.equal(back[k], state[k])


@pytest.mark.parametrize("extra,match", [
    (["--method", "dno", "--aug-enabled"], "dno does not compose with augmentation"),
    (["--method", "dno", "--bucket-shapes"], "dno does not compose with --bucket-shapes"),
    (["--method", "dno", "--save-adapters"], "dno does not compose with --save-adapters"),
    (["--method", "dno", "--batch-videos", "2", "--retrieval-pool-dir", "/x"],
     "dno does not compose with --batch-videos"),
    (["--batch-videos", "2", "--retrieval-pool-dir", "/x", "--aug-enabled"],
     "does not compose with augmentation"),
    (["--batch-videos", "2"], "--retrieval-pool-dir required"),
    (["--batch-videos", "2", "--retrieval-pool-dir", "/x", "--retrieval-sbert-path",
      "/no/such/model"], "does not exist"),
], ids=["dno_aug", "dno_bucket", "dno_save", "dno_batch", "batch_aug", "batch_no_pool",
        "sbert_missing"])
def test_composition_gates_raise(tmp_path, monkeypatch, extra, match):
    monkeypatch.setattr(run_tta, "load_bundle", lambda args: pytest.fail("loaded"))
    with pytest.raises(SystemExit, match=match):
        run_tta.main(_argv(tmp_path) + extra)
