"""The port's VBench pair (eval/vbench.py, eval/vbench_native.py,
eval/musiq.py) against the JAX package's.

Tower files come from chip_smoke's ``write_vbench_tower_files`` at tiny
geometries (config sidecars), read by both packages from the same
files. Tolerances: DINO CLS features, the aesthetic head and MUSIQ
scores within relative L2 1e-5 of JAX's (fp32 on both sides; the CLIP
and evaluation towers reached 1.05e-6); preprocess_imagenet and MUSIQ's bilinear
``_arp_resize`` (XLA's antialiased resize weights rebuilt on the host)
within 1e-5 abs at the 480x832 -> 224 / 384 downscales; the three
weight-free formulas exactly; the native scores of a folder within 1e-5.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from longcat_video_tta_tpu.eval import musiq as jmusiq
from longcat_video_tta_tpu.eval import vbench_native as jvb
from longcat_video_tta_tpu_torch.eval import musiq as tmusiq
from longcat_video_tta_tpu_torch.eval import vbench as tvbench
from longcat_video_tta_tpu_torch.eval import vbench_native as tvb
from longcat_video_tta_tpu_torch.runners import run_tta

torch.set_num_threads(2)

TINY_DINO = dict(width=32, num_layers=2, num_heads=2, patch_size=8, image_size=16)
TINY_MUSIQ = dict(width=32, num_layers=2, num_heads=2, patch_size=8, grid_size=4,
                  longer_sides=[16, 24], max_tokens=64)
TINY_CLIP = dict(vocab=100, max_len=16, text_width=32, text_layers=2, text_heads=4,
                 vision_width=32, vision_layers=2, vision_heads=4, patch=8, image=16,
                 proj=24)
TINY_HEAD = (16, 8, 4, 2, 1)
RTOL = 1e-5


def rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.fixture(scope="module")
def towers(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("vbench_towers"))
    chip_smoke.write_vbench_tower_files(d, 5, "cpu", dino=TINY_DINO, musiq=TINY_MUSIQ,
                                        clip_geometry=TINY_CLIP, aesthetic_dims=TINY_HEAD)
    return d


def test_dino_matches_jax(towers):
    path = os.path.join(towers, "dino_vits16.pth")
    jcfg = jvb.DINOViTConfig(**TINY_DINO)
    jparams = jvb.load_dino_params(path, jcfg)
    model = tvb.load_dino_params(path)  # geometry from the sidecar
    assert model.cfg == tvb.DINOViTConfig(**TINY_DINO)
    pixels = np.random.default_rng(0).standard_normal((3, 16, 16, 3)).astype(np.float32)
    ref = np.asarray(jvb.dino_cls_features(jparams, jcfg, jnp.asarray(pixels)))
    with torch.no_grad():
        out = model(torch.from_numpy(pixels)).numpy()
    assert out.shape == ref.shape == (3, 32)
    assert rel_l2(out, ref) <= RTOL


def test_converters_refuse_unknown_keys(towers):
    sd = torch.load(os.path.join(towers, "dino_vits16.pth"), weights_only=True)
    sd["head.weight"] = torch.zeros(2, 32)
    with pytest.raises(ValueError, match="unconsumed"):
        tvb.convert_torch_dino_state(sd, tvb.DINOViTConfig(**TINY_DINO))
    sd = torch.load(os.path.join(towers, "musiq_spaq.pth"), weights_only=True)
    sd["extra.bias"] = torch.zeros(1)
    with pytest.raises(ValueError, match="unconsumed"):
        tmusiq.convert_torch_musiq_state(sd, tmusiq.MUSIQConfig.from_dict(TINY_MUSIQ))


def test_aesthetic_head_matches_jax_and_sequential(towers):
    path = os.path.join(towers, "aesthetic_l14.pth")
    sd = torch.load(path, weights_only=True)
    dims = (TINY_CLIP["proj"],) + TINY_HEAD
    lin = [torch.nn.Linear(a, b) for a, b in zip(dims[:-1], dims[1:])]
    seq = torch.nn.Sequential(lin[0], torch.nn.Dropout(0.2), lin[1], torch.nn.Dropout(0.2),
                              lin[2], torch.nn.Dropout(0.1), lin[3], lin[4]).eval()
    seq.load_state_dict({k.replace("layers.", ""): v for k, v in sd.items()})
    head = tvb.load_aesthetic_head(path)
    assert len(head.linears) == 5
    feats = np.random.default_rng(1).standard_normal((6, dims[0])).astype(np.float32)
    with torch.no_grad():
        out = head(torch.from_numpy(feats)).numpy()
        want = seq(torch.from_numpy(feats))[:, 0].numpy()
    ref = np.asarray(jvb.aesthetic_mlp(jvb.load_aesthetic_head(path), jnp.asarray(feats)))
    assert rel_l2(out, want) <= RTOL and rel_l2(out, ref) <= RTOL


def test_musiq_matches_jax(towers):
    path = os.path.join(towers, "musiq_spaq.pth")
    jparams, jcfg = jmusiq.load_musiq_params(path)
    model, cfg = tmusiq.load_musiq_params(path)
    assert cfg.as_dict() == jcfg.as_dict() == TINY_MUSIQ
    frames = np.random.default_rng(2).random((3, 40, 56, 3), dtype=np.float32)
    toks = [tmusiq.build_multiscale_tokens(f, cfg) for f in frames]
    args = [np.stack([t[j] for t in toks]) for j in range(4)]
    n = np.asarray([t[4] for t in toks], np.int32)
    assert (n < cfg.max_tokens).all()  # the padding mask is exercised
    ref = np.asarray(jmusiq.musiq_score(jparams, jcfg, *map(jnp.asarray, args),
                                        jnp.asarray(n)))
    out = tmusiq.musiq_score(model, *args, n).numpy()
    assert rel_l2(out, ref) <= RTOL
    iq = tmusiq.imaging_quality(model, cfg, frames)
    assert abs(iq - jmusiq.imaging_quality(jparams, jcfg, frames)) <= 1e-5


def test_preprocess_imagenet_matches_jax_at_480x832():
    frames = np.random.default_rng(3).random((2, 480, 832, 3), dtype=np.float32)
    ref = np.asarray(jvb.preprocess_imagenet(frames, 224))
    out = tvb.preprocess_imagenet(frames, 224).numpy()
    assert out.shape == ref.shape == (2, 224, 224, 3)
    np.testing.assert_allclose(out, ref, atol=1e-5)


@pytest.mark.parametrize("longer", [224, 384])
def test_arp_resize_matches_jax_at_480x832(longer):
    frame = np.random.default_rng(4).random((480, 832, 3), dtype=np.float32)
    ref = jmusiq._arp_resize(frame, longer)
    out = tmusiq._arp_resize(frame, longer)
    assert out.shape == ref.shape and out.dtype == np.float32
    np.testing.assert_allclose(out, ref, atol=1e-5)


@pytest.mark.parametrize("size,n_valid", [((480, 832), 509), ((720, 1280), 512)])
def test_multiscale_tokens_match_jax_at_published_geometry(size, n_valid):
    """480x832: 390 native + 35 + 84 resized patches, under the cap;
    720x1280: the native scale's 920 patches trimmed to fill the 512."""
    frame = np.random.default_rng(5).random((*size, 3), dtype=np.float32)
    ref = jmusiq.build_multiscale_tokens(frame, jmusiq.MUSIQConfig())
    out = tmusiq.build_multiscale_tokens(frame, tmusiq.MUSIQConfig())
    assert out[4] == ref[4] == n_valid
    np.testing.assert_allclose(out[0], ref[0], atol=1e-5)
    for a, b in zip(out[1:4], ref[1:4]):
        np.testing.assert_array_equal(a, b)


def test_formulas_exact():
    rng = np.random.default_rng(6)
    for frames in (rng.random((9, 8, 12, 3), dtype=np.float32),
                   rng.integers(0, 256, (6, 8, 12, 3), dtype=np.uint8),
                   rng.random((2, 4, 4, 3), dtype=np.float32)):
        assert tvb.temporal_flickering(frames) == jvb.temporal_flickering(frames)
        assert tvb.motion_smoothness(frames) == jvb.motion_smoothness(frames)
    blend = lambda a, b: np.maximum(a, b)
    assert tvb.motion_smoothness(frames, blend) == jvb.motion_smoothness(frames, blend)
    feats = rng.standard_normal((7, 16))
    assert tvb.consistency_score_from_features(feats) == \
        jvb.consistency_score_from_features(feats)
    assert tvb.consistency_score_from_features(feats[:1]) == 1.0


def test_native_scores_dispatch_and_skip_reasons():
    frames = np.random.default_rng(7).random((5, 8, 12, 3), dtype=np.float32)
    loads = []

    def loader():
        loads.append(1)
        return frames

    dims = list(tvbench.VBENCH_DIMENSIONS) + ["bogus"]
    out = tvb.native_vbench_scores({"a": loader, "b": frames}, {}, dims)
    ref = jvb.native_vbench_scores({"a": frames, "b": frames}, {}, dims)
    assert loads == [1]
    assert set(out["unavailable"]) == set(ref["unavailable"]) == {
        "subject_consistency", "aesthetic_quality", "imaging_quality", "bogus"}
    assert out["unavailable"]["bogus"] == "unknown dimension"
    assert out["results"] == ref["results"]
    assert set(out["results"]) == {"motion_smoothness", "motion_smoothness_variant",
                                   "temporal_flickering"}
    assert out["per_video"] == ref["per_video"]


def test_run_vbench_over_saved_clips(towers, tmp_path):
    rng = np.random.default_rng(8)
    clips = {f"{i:04d}_clip.npy": rng.random((5, 16, 32, 3)) for i in range(2)}
    for name, c in clips.items():
        np.save(tmp_path / name, (np.clip(c, 0, 1) * 255).astype(np.uint8))
    (tmp_path / "notes.txt").write_text("not a clip")
    out = tvbench.run_vbench(str(tmp_path), towers_dir=towers, device="cpu")
    assert out["backend"] == "torch-native" and not out["skipped"]
    assert set(out["per_video"]) == set(clips) and not out["unavailable"]
    frames = {n: np.load(tmp_path / n).astype(np.float32) / 255.0 for n in clips}
    ref = jvb.native_vbench_scores(frames, jvb.load_native_towers(towers),
                                   list(tvbench.VBENCH_DIMENSIONS))
    for dim in tvbench.VBENCH_DIMENSIONS:
        assert 0.0 <= out["results"][dim] <= 1.0
        assert abs(out["results"][dim] - ref["results"][dim]) <= 1e-5, dim
    empty = tmp_path / "empty"
    empty.mkdir()
    assert tvbench.run_vbench(str(empty))["skipped"]
    assert tvbench.run_vbench(str(tmp_path), native="off")["skipped"]


BASE = ["--preset", "longcat_tiny", "--synthetic", "1", "--device", "cpu", "--height", "16",
        "--width", "32", "--num-cond-frames", "5", "--num-frames", "5",
        "--gen-start-frame", "16", "--num-inference-steps", "2",
        "--caption-guard-mode", "off", "--method", "none"]


@pytest.mark.parametrize("flag", ["--no-save-videos", "--skip-generation"])
def test_runner_refuses_vbench_without_saved_clips(tmp_path, flag):
    with pytest.raises(SystemExit, match="compute-vbench"):
        run_tta.main(BASE + ["--output-dir", str(tmp_path), "--compute-vbench", flag])
    assert not os.path.exists(tmp_path / "config.json")


def test_runner_amends_summary_with_vbench(towers, tmp_path):
    summary = run_tta.main(BASE + ["--output-dir", str(tmp_path), "--compute-vbench",
                                   "--vbench-towers-dir", towers])
    vb = summary["online_eval"]["vbench"]
    assert "error" not in vb and vb["backend"] == "torch-native"
    assert set(vb["results"]) >= set(tvbench.VBENCH_DIMENSIONS)
    for dim in tvbench.VBENCH_DIMENSIONS:
        assert np.isfinite(vb["results"][dim]) and 0.0 <= vb["results"][dim] <= 1.0
    import json

    with open(tmp_path / "summary.json") as f:
        assert json.load(f)["online_eval"]["vbench"] == json.loads(json.dumps(vb))
