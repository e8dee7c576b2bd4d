"""ctypes binding of the C++ prefetch loader (``native/prefetch.cpp``, the
port's npy-only copy of the reference's), counterpart of
``longcat_video_tta_tpu/data/native_loader.py``:

    for idx, clip in ClipPrefetcher(paths, num_frames, start, h, w):
        # clip: np.float32 [3, T, H, W] in [-1, 1], or None for a clip
        # that failed to decode

The shared library is built with ``g++ -O3 -march=native -std=c++17
-shared -fPIC -pthread`` (the reference's npy-only build line) at first
use into ``native/build/`` (listed in .gitignore), named after the hash
of the source and the flags. ``-march=native`` lets GCC contract the
resize's multiply-adds into FMAs where the host has them, as the
reference's build does; without it the clips differ from the
reference loader's in the last bit. A failed build or load
raises with the compiler's output: unlike the reference there is no
fallback to Python behind the caller's back. ``force_python=True`` runs
the plain version (``video_io.load_video_frames`` per clip) on purpose,
as the tests do.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import sys
from typing import Iterator, List, Optional, Tuple

import numpy as np

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                           "native")
SOURCE = os.path.join(_NATIVE_DIR, "prefetch.cpp")
BUILD_DIR = os.path.join(_NATIVE_DIR, "build")
CXX = "g++"
CXX_FLAGS = ("-O3", "-march=native", "-std=c++17", "-shared", "-fPIC", "-pthread")

_lib = None


def library_path(source: str = SOURCE) -> str:
    h = hashlib.sha256()
    with open(source, "rb") as f:
        h.update(f.read())
    h.update(" ".join(CXX_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"libprefetch-{h.hexdigest()[:16]}.so")


def build_library(source: str = SOURCE) -> str:
    """Compile ``source`` unless its library exists; returns its path.
    Raises RuntimeError with the compiler's output when the build fails."""
    path = library_path(source)
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    cmd = [CXX, *CXX_FLAGS, source, "-o", tmp]
    try:
        r = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as e:
        raise RuntimeError(f"native prefetch: cannot run {CXX!r}: {e}") from e
    if r.returncode != 0:
        raise RuntimeError(f"native prefetch: {' '.join(cmd)} failed "
                           f"({r.returncode}):\n{r.stderr}")
    os.replace(tmp, path)
    return path


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build_library())
        lib.pf_create.restype = ctypes.c_void_p
        lib.pf_create.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_long, ctypes.c_long,
            ctypes.c_long, ctypes.c_long, ctypes.c_long, ctypes.c_int,
            ctypes.c_long, ctypes.c_double,
        ]
        lib.pf_next.restype = ctypes.c_int
        lib.pf_next.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_float),
                                ctypes.POINTER(ctypes.c_long)]
        lib.pf_destroy.argtypes = [ctypes.c_void_p]
        _lib = lib
    return _lib


class ClipPrefetcher:
    """Iterate (index, clip [3, T, H, W] float32 in [-1, 1]) over .npy clip
    paths, decoded and resized ahead of time by C++ worker threads, in
    path order.

    A clip that fails to decode yields ``(index, None)`` and the stream
    goes on: the caller attributes the failure to that video. ``target_fps``
    subsamples with ``start_frame`` in the subsampled timebase (the
    contract of ``video_io.decode_frames``). The library is built when the
    prefetcher is made, so a toolchain fault shows before the loop."""

    def __init__(self, paths: List[str], num_frames: int, start_frame: int,
                 height: int, width: int, workers: int = 3, queue_cap: int = 4,
                 force_python: bool = False, target_fps: Optional[float] = None):
        self.paths = list(paths)
        self.num_frames = num_frames
        self.start_frame = start_frame
        self.height = height
        self.width = width
        self.workers = workers
        self.queue_cap = queue_cap
        self.target_fps = float(target_fps) if target_fps else 0.0
        self.native = not force_python
        if self.native:
            _library()

    def __iter__(self) -> Iterator[Tuple[int, Optional[np.ndarray]]]:
        return self._iter_native() if self.native else self._iter_python()

    def _iter_native(self):
        lib = _library()
        arr = (ctypes.c_char_p * len(self.paths))(*[p.encode() for p in self.paths])
        handle = lib.pf_create(arr, len(self.paths), self.num_frames, self.start_frame,
                               self.height, self.width, self.workers, self.queue_cap,
                               self.target_fps)
        try:
            out = np.empty((3, self.num_frames, self.height, self.width), np.float32)
            idx = ctypes.c_long(-1)
            while True:
                rc = lib.pf_next(handle, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                                 ctypes.byref(idx))
                if rc == 1:
                    return
                if rc == -2:  # this clip failed; the stream goes on
                    yield int(idx.value), None
                    continue
                if rc != 0:
                    raise RuntimeError(f"native prefetch error rc={rc}")
                yield int(idx.value), out.copy()
        finally:
            lib.pf_destroy(handle)

    def _iter_python(self):
        from .video_io import load_video_frames

        for i, p in enumerate(self.paths):
            try:
                clip = load_video_frames(p, self.num_frames, self.height, self.width,
                                         self.start_frame,
                                         target_fps=self.target_fps or None)[0]
            except Exception:
                # the root cause stays in the log: the caller sees only (i, None)
                import traceback

                print(f"[prefetch] decode failed for {p}:", file=sys.stderr)
                traceback.print_exc()
                yield i, None
                continue
            yield i, clip.astype(np.float32)
