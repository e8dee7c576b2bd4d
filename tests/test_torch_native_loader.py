"""The port's C++ prefetch loader (data/native_loader.py over its copy of
native/prefetch.cpp): the build, order and shape, the plain version
(corr > 0.98 against the port's video_io, as the JAX test holds its own),
the JAX loader's build of its own source bit for bit, pad-last-frame,
target_fps with the stride rounding, per-clip faults, a window past the
end, and a failed build that raises (the JAX loader falls back to Python;
the port does not). The JAX cases of tests/test_native_loader.py, without
mp4 (the port reads .npy clips only)."""

import numpy as np
import pytest

from longcat_video_tta_tpu.data import native_loader as jnl
from longcat_video_tta_tpu_torch.data import native_loader as tnl
from longcat_video_tta_tpu_torch.data.native_loader import ClipPrefetcher
from longcat_video_tta_tpu_torch.data.video_io import load_video_frames


@pytest.fixture(scope="module")
def clips(tmp_path_factory):
    d = tmp_path_factory.mktemp("clips")
    rng = np.random.RandomState(0)
    paths = []
    for i in range(5):
        p = str(d / f"c{i}.npy")
        np.save(p, (rng.rand(10, 24, 40, 3) * 255).astype(np.uint8))
        paths.append(p)
    return paths


def _ramp(tmp_path):
    """A clip whose frame t is the constant t: frame identity is checkable."""
    p = str(tmp_path / "ramp.npy")
    np.save(p, np.arange(20, dtype=np.uint8)[:, None, None, None]
            * np.ones((1, 16, 32, 3), np.uint8))
    return p


def test_build_order_and_shape(clips):
    path = tnl.build_library()
    assert path.startswith(tnl.BUILD_DIR) and path.endswith(".so")
    pf = ClipPrefetcher(clips, num_frames=6, start_frame=2, height=16, width=32, workers=3)
    assert pf.native
    out = list(pf)
    assert [i for i, _ in out] == list(range(5))
    for _, clip in out:
        assert clip.shape == (3, 6, 16, 32) and clip.dtype == np.float32
        assert -1.0 <= clip.min() and clip.max() <= 1.0


def test_native_matches_plain_version(clips):
    native = dict(ClipPrefetcher(clips, 6, 2, 16, 32))
    plain = dict(ClipPrefetcher(clips, 6, 2, 16, 32, force_python=True))
    for i in range(5):
        a, b = native[i], plain[i]
        assert a.shape == b.shape
        corr = np.corrcoef(a.ravel(), b.ravel())[0, 1]
        assert corr > 0.98, f"clip {i} corr {corr}"


@pytest.fixture
def jax_loader(monkeypatch, tmp_path_factory):
    """The JAX loader, building its library into a folder of this test's
    (its own tests build into its package folder, maybe at the same time
    in another worker)."""
    so = tmp_path_factory.mktemp("jax_native") / "libprefetch.so"
    monkeypatch.setattr(jnl, "_SO", str(so))
    monkeypatch.setattr(jnl, "_lib", None)
    monkeypatch.setattr(jnl, "_lib_failed", False)
    return jnl


@pytest.mark.parametrize("window", [(6, 2, 16, 32, None), (6, 8, 16, 32, None),
                                    (4, 1, 24, 40, 9.6), (5, 0, 12, 20, 12.0)],
                         ids=["resize", "pad", "same_size_fps", "fps"])
def test_port_build_equals_jax_build_bit_for_bit(clips, jax_loader, window):
    n, start, h, w, fps = window
    ours = list(ClipPrefetcher(clips, n, start, h, w, target_fps=fps))
    ref = jax_loader.ClipPrefetcher(clips, n, start, h, w, target_fps=fps)
    assert ref._native, "the JAX loader fell back to Python"
    ref = list(ref)
    assert [i for i, _ in ours] == [i for i, _ in ref]
    for (_, a), (_, b) in zip(ours, ref):
        np.testing.assert_array_equal(a, b)


def test_pad_last_frame(clips):
    _, clip = next(iter(ClipPrefetcher(clips[:1], num_frames=6, start_frame=8,
                                       height=16, width=32)))
    np.testing.assert_array_equal(clip[:, 2], clip[:, 5])


@pytest.mark.parametrize("fps,start", [(12.0, 2), (9.6, 1)], ids=["12fps", "half_stride"])
def test_target_fps_matches_video_io(tmp_path, fps, start):
    """The stride is round(24 / fps) with Python's half-to-even rounding
    (9.6 fps: 2.5 -> 2) and start counts subsampled frames, in both loaders."""
    p = _ramp(tmp_path)
    ref = load_video_frames(p, 4, 16, 32, start_frame=start, target_fps=fps)[0]
    for force_python in (False, True):
        _, clip = next(iter(ClipPrefetcher([p], num_frames=4, start_frame=start, height=16,
                                           width=32, target_fps=fps,
                                           force_python=force_python)))
        np.testing.assert_allclose(clip, ref, atol=1e-5, err_msg=f"python={force_python}")


def test_per_clip_faults(clips, tmp_path):
    bad = str(tmp_path / "bad.npy")
    with open(bad, "wb") as f:
        f.write(b"not a numpy file at all")
    for force_python in (False, True):
        out = list(ClipPrefetcher([clips[0], bad, clips[1]], 6, 2, 16, 32,
                                  force_python=force_python))
        assert [i for i, _ in out] == [0, 1, 2]
        assert out[0][1] is not None and out[2][1] is not None
        assert out[1][1] is None, f"python={force_python}"


def test_start_beyond_eof_fails_the_clip(tmp_path):
    """Start 12 at stride 2 is source frame 24: past the 20-frame ramp's
    end (the clip fails), inside a 40-frame clip (it loads)."""
    p = _ramp(tmp_path)
    long = str(tmp_path / "long.npy")
    np.save(long, np.zeros((40, 16, 32, 3), np.uint8))
    for force_python in (False, True):
        out = list(ClipPrefetcher([p, long], 4, 12, 16, 32, target_fps=12.0,
                                  force_python=force_python))
        assert out[0] == (0, None) and out[1][1] is not None, f"python={force_python}"


def test_failed_build_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(tnl, "CXX", "no-such-compiler-lc")
    monkeypatch.setattr(tnl, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(tnl, "_lib", None)
    with pytest.raises(RuntimeError, match="no-such-compiler-lc"):
        ClipPrefetcher(["x.npy"], 4, 0, 16, 32)
    # a compiler that runs and fails: its own output comes with the error
    bad = tmp_path / "bad.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(tnl, "CXX", "g++")
    with pytest.raises(RuntimeError, match="error"):
        tnl.build_library(str(bad))
    # the plain version needs no build
    assert ClipPrefetcher(["x.npy"], 4, 0, 16, 32, force_python=True).native is False
