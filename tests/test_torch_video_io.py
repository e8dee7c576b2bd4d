"""The port's clip IO (data/video_io.py) against the JAX package's.

- ``resize_frames`` computes cv2's uint8 INTER_LINEAR in integer numpy;
  the JAX ``resize_frames`` calls cv2. Held bit for bit on random and
  smooth frames at the sizes a clip is resized from to 480x832 (the
  fault's sizes), odd sizes, exact 2x downscales and upscales.
- ``decode_all_frames``, ``count_frames``, ``native_fps`` and
  ``validate_decodable`` on .npy clips (uint8 and float) equal the JAX
  helpers'; a container file raises in the port (no decoder).
"""

import numpy as np
import pytest

from longcat_video_tta_tpu.data import video_io as jio
from longcat_video_tta_tpu_torch.data import video_io as tio

SHAPES = [
    ((480, 640), (480, 832)), ((240, 416), (480, 832)), ((720, 1280), (480, 832)),
    ((1080, 1920), (480, 832)),                              # Queue C sizes
    ((37, 53), (480, 832)), ((31, 17), (13, 29)), ((1, 5), (3, 7)),  # odd
    ((960, 1664), (480, 832)), ((100, 100), (50, 50)),       # exact 2x down
    ((64, 64), (128, 128)), ((7, 9), (20, 31)), ((480, 832), (960, 1664)),  # up
]


def _frames(kind, h, w, seed=0):
    rng = np.random.default_rng(seed)
    if kind == "random":
        return rng.integers(0, 256, (2, h, w, 3), dtype=np.uint8)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    out = [np.stack([127.5 + 127.5 * np.sin(xx / (5.3 + t) + yy / 9.1 + c)
                     for c in range(3)], -1) for t in range(2)]
    return np.clip(np.round(np.stack(out)), 0, 255).astype(np.uint8)


@pytest.mark.parametrize("kind", ["random", "smooth"])
@pytest.mark.parametrize("src,dst", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_resize_frames_bit_exact_against_cv2(src, dst, kind):
    frames = _frames(kind, *src)
    ref = jio.resize_frames(frames, *dst)
    out = tio.resize_frames(frames, *dst)
    assert out.dtype == np.uint8 and out.shape == ref.shape == (2, *dst, 3)
    np.testing.assert_array_equal(out, ref)


def test_resize_frames_keeps_a_clip_at_its_size():
    frames = _frames("random", 16, 32)
    assert tio.resize_frames(frames, 16, 32) is frames


@pytest.fixture
def clips(tmp_path):
    rng = np.random.default_rng(3)
    u8 = tmp_path / "u8.npy"
    np.save(u8, rng.integers(0, 256, (11, 8, 12, 3), dtype=np.uint8))
    f32 = tmp_path / "f32.npy"
    np.save(f32, rng.random((7, 8, 12, 3), dtype=np.float32) * 1.2 - 0.1)
    return str(u8), str(f32)


@pytest.mark.parametrize("target_fps", [None, 12.0, 8.0])
def test_decode_all_frames_matches(clips, target_fps):
    for path in clips:
        ref = jio.decode_all_frames(path, target_fps=target_fps)
        out = tio.decode_all_frames(path, target_fps=target_fps)
        assert out.dtype == np.uint8
        np.testing.assert_array_equal(out, ref)


def test_count_fps_and_decodable_match(clips, tmp_path):
    for path in clips:
        assert tio.count_frames(path) == jio.count_frames(path)
        assert tio.native_fps(path) == jio.native_fps(path) == 24.0
        assert tio.validate_decodable(path) is jio.validate_decodable(path) is True
    empty = tmp_path / "empty.npy"
    np.save(empty, np.zeros((0, 4, 4, 3), np.uint8))
    assert tio.validate_decodable(str(empty)) is jio.validate_decodable(str(empty)) is False
    with pytest.raises(ValueError):
        tio.decode_all_frames(str(empty))


def test_container_files_raise(tmp_path):
    mp4 = str(tmp_path / "clip.mp4")
    open(mp4, "wb").close()
    for fn in (tio.decode_all_frames, tio.count_frames, tio.native_fps):
        with pytest.raises(ValueError, match="only .npy"):
            fn(mp4)
    assert tio.validate_decodable(mp4) is False
