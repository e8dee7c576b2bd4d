"""The port's evaluation towers against the JAX package on the same
checkpoints: LPIPS (eval/lpips.py), I3D (eval/i3d.py), InceptionV3
(eval/inception.py), the Fréchet accumulator (eval/frechet.py), the LPIPS
hook of eval/metrics.py and the offline FVD/FID over saved clips
(eval/offline.py).

The checkpoints are drawn from a seed in each tower's published key layout
by chip_smoke.py's writers (``*_state_shapes``, ``tower_value``), the same
files the card's [eval] phase writes; the reference's converters read
every key of them, which holds those layouts to what the reference reads.

Tolerances (relative = max |port - jax| / max |jax|): LPIPS distances
1e-5; I3D logits 1e-4 at 16 x 224 x 224; Inception features 1e-4 at the
75-pixel minimum and at 299; the Pillow-free resize at most 1 level of 255
from Pillow's and at least 99% of pixels identical at 480 x 832 -> 299;
Fréchet distances 1e-9 relative (float64 host maths on equal features);
the offline FVD over two saved clip pairs 1e-3 relative (features from
the two I3D towers, 1e-4 apart).
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from longcat_video_tta_tpu.eval import frechet as jfrechet
from longcat_video_tta_tpu.eval import i3d as ji3d
from longcat_video_tta_tpu.eval import inception as jinc
from longcat_video_tta_tpu.eval import lpips as jlpips
from longcat_video_tta_tpu.eval import metrics as jmetrics
from longcat_video_tta_tpu.eval import offline as joffline
from longcat_video_tta_tpu_torch.eval import frechet, i3d, inception, lpips, metrics, offline

torch.set_num_threads(2)


def _drawn(shapes, seed):
    gen = torch.Generator().manual_seed(seed)
    return {k: chip_smoke.tower_value(k, s, gen, "cpu") for k, s in shapes.items()}


def _np(sd):
    return {k: v.numpy() for k, v in sd.items()}


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


def _with_unknown(sd, key):
    return {**sd, key: torch.zeros(3)}


# ---------------------------------------------------------------------------
# LPIPS
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def lpips_sd():
    return _drawn(chip_smoke.lpips_state_shapes(), 1)


@pytest.mark.parametrize("hw", [(64, 64), (67, 93)], ids=["small", "odd"])
def test_lpips_distances_match_jax(lpips_sd, hw):
    rng = np.random.default_rng(2)
    a = rng.random((3,) + hw + (3,), dtype=np.float32)
    b = np.clip(a + 0.2 * rng.standard_normal(a.shape, dtype=np.float32), 0, 1)
    port = lpips.lpips_alex(lpips.convert_torch_lpips_state(lpips_sd), a, b).numpy()
    ref = np.asarray(jlpips.lpips_alex(jlpips.convert_torch_lpips_state(_np(lpips_sd)),
                                       jnp.asarray(a), jnp.asarray(b)))
    assert port.shape == (3,) and _rel(port, ref) <= 1e-5
    same = lpips.lpips_alex(lpips.convert_torch_lpips_state(lpips_sd), a, a).numpy()
    assert np.abs(same).max() == 0.0


def test_lpips_without_scaling_layer_uses_published_constants(lpips_sd):
    full = lpips.convert_torch_lpips_state(lpips_sd)
    lin_only = {k: v for k, v in lpips_sd.items() if not k.startswith("scaling_layer.")}
    m = lpips.convert_torch_lpips_state(lin_only)
    ref = jlpips.convert_torch_lpips_state(_np(lin_only))
    assert torch.equal(m.shift, full.shift) and torch.equal(m.scale, full.scale)
    a = np.random.default_rng(3).random((2, 64, 80, 3), dtype=np.float32)
    b = a[::-1].copy()
    assert _rel(lpips.lpips_alex(m, a, b).numpy(),
                np.asarray(jlpips.lpips_alex(ref, jnp.asarray(a), jnp.asarray(b)))) <= 1e-5


def test_lpips_converter_refuses_unknown_and_missing_keys(lpips_sd):
    with pytest.raises(ValueError, match="unconsumed"):
        lpips.convert_torch_lpips_state(_with_unknown(lpips_sd, "net.slice6.12.weight"))
    with pytest.raises(ValueError, match="unconsumed"):
        jlpips.convert_torch_lpips_state(_np(_with_unknown(lpips_sd, "net.slice6.12.weight")))
    with pytest.raises(KeyError):
        lpips.convert_torch_lpips_state({k: v for k, v in lpips_sd.items()
                                         if k != "lin4.model.1.weight"})


def test_lpips_file_hook_and_metrics_match_jax(lpips_sd, tmp_path):
    path = str(tmp_path / "alex.pth")
    torch.save(lpips_sd, path)
    hook = lpips.make_lpips_feature_fn(lpips.load_lpips_params(path, "cpu"))
    jhook = jlpips.make_lpips_feature_fn(jlpips.load_lpips_params(path))
    rng = np.random.default_rng(4)
    gen, gt = rng.random((2, 4, 64, 64, 3), dtype=np.float32)
    mp = metrics.evaluate_generation_metrics(gen, gt, lpips_feature_fn=hook)
    mj = jmetrics.evaluate_generation_metrics(gen, gt, lpips_feature_fn=jhook)
    assert abs(mp["lpips"] - mj["lpips"]) <= 1e-5 * abs(mj["lpips"])
    assert np.isnan(metrics.evaluate_generation_metrics(gen, gt)["lpips"])
    if not torch.cuda.is_available():  # the loaders default to the card
        with pytest.raises(RuntimeError, match="no CUDA GPU"):
            lpips.load_lpips_params(path)


# ---------------------------------------------------------------------------
# I3D
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def i3d_pair():
    sd = _drawn(chip_smoke.i3d_state_shapes(), 5)
    return sd, i3d.convert_torch_i3d_state(sd), ji3d.convert_torch_i3d_state(_np(sd))


def test_i3d_logits_match_jax(i3d_pair):
    _, model, params = i3d_pair
    x = np.random.default_rng(6).random((1, 16, 224, 224, 3), dtype=np.float32) * 2 - 1
    port = i3d.i3d_logits(model, x).numpy()
    ref = np.asarray(ji3d.i3d_logits(params, jnp.asarray(x)))
    assert port.shape == (1, 400) and _rel(port, ref) <= 1e-4


def test_i3d_feature_fn_pads_and_crops_as_jax(i3d_pair):
    _, model, params = i3d_pair
    frames = np.random.default_rng(7).random((5, 120, 250, 3), dtype=np.float32)
    port = i3d.make_i3d_feature_fn(model)(frames)
    ref = ji3d.make_i3d_feature_fn(params)(frames)
    assert port.shape == (400,) and _rel(port, ref) <= 1e-4
    np.testing.assert_array_equal(frechet.pad_for_i3d(frechet.center_crop(frames)),
                                  jfrechet.pad_for_i3d(jfrechet.center_crop(frames)))


class _ScriptedHolder(torch.nn.Module):
    """A TorchScript-able module holding a state dict under its own names
    (the form of the DFoT ``i3d_torchscript.pt``)."""

    def __init__(self, sd):
        super().__init__()
        for key, value in sd.items():
            owner = self
            *path, leaf = key.split(".")
            for name in path:
                if not hasattr(owner, name):
                    owner.add_module(name, torch.nn.Module())
                owner = getattr(owner, name)
            if value.is_floating_point():
                owner.register_parameter(leaf, torch.nn.Parameter(value))
            else:
                owner.register_buffer(leaf, value)

    def forward(self, x):
        return x


def test_i3d_converter_and_loader(i3d_pair, tmp_path):
    """A plain state-dict file and a TorchScript archive load alike."""
    sd, model, _ = i3d_pair
    with pytest.raises(ValueError, match="unconsumed"):
        i3d.convert_torch_i3d_state(_with_unknown(sd, "Mixed_6b.b0.conv3d.weight"))
    with pytest.raises(RuntimeError):  # a shape that is not the published one
        i3d.convert_torch_i3d_state({**sd, "logits.conv3d.bias": torch.zeros(401)})
    plain, scripted = str(tmp_path / "i3d.pt"), str(tmp_path / "i3d_torchscript.pt")
    torch.save(sd, plain)
    torch.jit.save(torch.jit.script(_ScriptedHolder(sd)), scripted)
    for path in (plain, scripted):
        loaded = i3d.load_i3d_params(path, "cpu")
        for (k, a), b in zip(model.state_dict().items(), loaded.state_dict().values()):
            assert torch.equal(a, b), k


# ---------------------------------------------------------------------------
# InceptionV3
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def inception_pair():
    sd = _drawn(chip_smoke.inception_state_shapes(), 8)
    return sd, inception.convert_torch_inception_state(sd), \
        jinc.convert_torch_inception_state(_np(sd))


@pytest.mark.parametrize("size", [75, 299])
def test_inception_features_match_jax(inception_pair, size):
    _, model, params = inception_pair
    x = np.random.default_rng(9).standard_normal((2, size, size, 3), dtype=np.float32)
    port = inception.inception_features(model, x).numpy()
    ref = np.asarray(jinc.inception_features(params, jnp.asarray(x)))
    assert port.shape == (2, 2048) and _rel(port, ref) <= 1e-4


def test_inception_preprocess_matches_pillow():
    """The reference resizes with Pillow's uint8 BILINEAR (its
    preprocess_frames); the port's host reimplementation against it."""
    rng = np.random.default_rng(10)
    yy, xx = np.meshgrid(np.linspace(0, 1, 480), np.linspace(0, 1, 832), indexing="ij")
    smooth = 0.5 + 0.5 * np.sin(12 * xx + 7 * yy)[None, ..., None] * np.ones((1, 1, 1, 3))
    frames = np.concatenate([rng.random((2, 480, 832, 3), dtype=np.float32),
                             smooth.astype(np.float32)])
    port, ref = inception.preprocess_frames(frames), jinc.preprocess_frames(frames)
    assert port.shape == ref.shape == (3, 299, 299, 3)
    levels = np.abs(port - ref) * np.asarray([0.229, 0.224, 0.225]) * 255
    assert levels.max() <= 1.0 + 1e-3 and (port == ref).mean() >= 0.99


def test_inception_converter_feature_fn_and_loader(inception_pair, tmp_path):
    sd, model, params = inception_pair
    assert any(k.startswith("AuxLogits.") for k in sd) and "fc.weight" in sd
    with pytest.raises(ValueError, match="unconsumed"):
        inception.convert_torch_inception_state(_with_unknown(sd, "Mixed_8a.branch1x1.x"))
    frames = np.random.default_rng(11).random((3, 90, 120, 3), dtype=np.float32)
    port = inception.make_inception_feature_fn(model, batch=2)(frames)
    ref = jinc.make_inception_feature_fn(params)(frames)
    assert port.dtype == np.float64 and port.shape == (3, 2048) and _rel(port, ref) <= 1e-4
    path = str(tmp_path / "inception_v3.pth")
    torch.save(sd, path)
    loaded = inception.load_inception_params(str(tmp_path), "cpu")
    assert torch.equal(loaded.Mixed_7c.branch_pool.conv.weight,
                       model.Mixed_7c.branch_pool.conv.weight)


# ---------------------------------------------------------------------------
# Fréchet accumulator and offline FVD/FID
# ---------------------------------------------------------------------------


def _stub_features(seed):
    """Deterministic video (400-d) and frame (T x 2048) features."""
    def video(frames):
        return np.random.default_rng([seed, int(frames.sum() * 1e3) % 2**31]) \
            .standard_normal(400)

    def frame(frames):
        return np.random.default_rng([seed + 1, int(frames.sum() * 1e3) % 2**31]) \
            .standard_normal((frames.shape[0], 2048))
    return video, frame


def _clips(n, seed=12):
    rng = np.random.default_rng(seed)
    return [(rng.random((3, 8, 8, 3)), rng.random((3, 8, 8, 3))) for _ in range(n)]


def _moments(acc):
    return [(m.n, m.s, m.ss) for m in (acc._gen_v, acc._gt_v, acc._gen_f, acc._gt_f)]


def test_frechet_distance_and_accumulator_match_jax():
    """The same float64 moments as the reference accumulator, and the same
    distance from them (the 2048-d FID is computed once, in
    test_fid_only_mode: its sqrtm takes seconds)."""
    rng = np.random.default_rng(13)
    a, b = rng.standard_normal((40, 16)), rng.standard_normal((40, 16)) + 0.3
    args = (a.mean(0), np.cov(a, rowvar=False), b.mean(0), np.cov(b, rowvar=False))
    assert frechet.frechet_distance(*args) == pytest.approx(
        jfrechet.frechet_distance(*args), rel=1e-9)
    video, frame = _stub_features(0)
    port = frechet.OnlineFrechetAccumulator(video, frame, min_videos=2)
    ref = jfrechet.OnlineFrechetAccumulator(video, frame, min_videos=2)
    for g, t in _clips(4):
        port.update(g, t)
        ref.update(g, t)
    for (n, s, ss), (jn, js, jss) in zip(_moments(port), _moments(ref)):
        assert n == jn and np.array_equal(s, js) and np.array_equal(ss, jss)
    fvd = frechet.frechet_distance(*port._gen_v.mean_cov(), *port._gt_v.mean_cov())
    assert fvd == pytest.approx(jfrechet.frechet_distance(
        *ref._gen_v.mean_cov(), *ref._gt_v.mean_cov()), rel=1e-9)


def test_frechet_state_round_trip_and_reference_file(tmp_path):
    video, _ = _stub_features(1)
    port = frechet.OnlineFrechetAccumulator(video)
    clips = _clips(3)
    for g, t in clips[:2]:
        port.update(g, t)
    path = str(tmp_path / "fvd_state.npz")
    port.save_state(path, next_idx=2)
    resumed = frechet.OnlineFrechetAccumulator(video)
    assert resumed.load_state(path) == 2
    ref = jfrechet.OnlineFrechetAccumulator(video)
    assert ref.load_state(path) == 2  # the reference reads the port's file
    with np.load(path) as z:
        port_keys = set(z.files)
    ref.save_state(str(tmp_path / "ref.npz"), next_idx=2)
    with np.load(str(tmp_path / "ref.npz")) as z:
        assert port_keys == set(z.files)
    for acc in (resumed, ref, port):
        acc.update(*clips[2])
    assert resumed.compute() == port.compute()
    assert ref.compute()["fvd"] == pytest.approx(port.compute()["fvd"], rel=1e-9)
    assert frechet.OnlineFrechetAccumulator(video).load_state(str(tmp_path / "none")) is None


def test_fid_only_mode(monkeypatch):
    """Frame features alone (no I3D): FID, no FVD. At 64-d frame features
    (both modules' dimension patched) so the sqrtm stays fast."""
    for mod in (frechet, jfrechet):
        monkeypatch.setattr(mod, "INCEPTION_FEATURE_DIM", 64)

    def frame(frames):
        return np.random.default_rng(int(frames.sum() * 1e3) % 2**31) \
            .standard_normal((frames.shape[0], 64))

    port = frechet.OnlineFrechetAccumulator(frame_feature_fn=frame)
    ref = jfrechet.OnlineFrechetAccumulator(frame_feature_fn=frame)
    assert port.enabled and not frechet.OnlineFrechetAccumulator().enabled
    for g, t in _clips(30):
        port.update(g, t)
        ref.update(g, t)
    p, r = port.compute(), ref.compute()
    assert p["fvd"] is None and p["num_videos"] == 30 and np.isfinite(p["fid"])
    assert ref._gen_v.n == port._gen_v.n == 0
    assert p["fid"] == pytest.approx(r["fid"], rel=1e-9)


def test_offline_fvd_over_saved_npy_clips_matches_jax(i3d_pair, tmp_path):
    sd, _, _ = i3d_pair
    path = str(tmp_path / "i3d.pt")
    torch.save(sd, path)
    rng = np.random.default_rng(14)
    for d, stems in (("gen", ["0000_clip_a", "0001_clip_b"]), ("gt", ["clip_a", "clip_b"])):
        os.makedirs(tmp_path / d)
        for s in stems:
            np.save(tmp_path / d / f"{s}.npy",
                    (rng.random((6, 64, 80, 3)) * 255).astype(np.uint8))
    port = offline.evaluate_fvd_dirs(str(tmp_path / "gen"), str(tmp_path / "gt"), path,
                                     device="cpu")
    ref = joffline.evaluate_fvd_dirs(str(tmp_path / "gen"), str(tmp_path / "gt"), path)
    assert port["num_pairs"] == ref["num_pairs"] == 2 and port["num_videos"] == 2
    assert np.isfinite(port["fvd"])
    assert port["fvd"] == pytest.approx(ref["fvd"], rel=1e-3)
    assert offline.evaluate_fvd_dirs(str(tmp_path / "gen"), str(tmp_path / "gt"),
                                     device="cpu")["skipped"]
