"""Flash-attention forward with LongCat conditioning-prefix semantics:
the hand-written CUDA kernel (``csrc/flash_fwd.cu``), its ctypes
binding, and its plain PyTorch version.

The kernel replaces the reference's Pallas TPU kernel
``longcat_video_tta_tpu/ops/flash_attention.py::_fwd_kernel``. For a
CUDA tensor ``flash_attention`` launches the kernel or raises; for a CPU
tensor it runs ``attention_reference``. There is no fallback from one to
the other.

Masking (``ops/attention.py`` of the reference): with a conditioning
prefix of ``num_cond_tokens``, queries in the noise region attend to all
keys and queries in the prefix attend only within the prefix. The prefix
rule applies only when ``Sq == Sk`` (training / no-cache path); with
``Sq != Sk`` (KV-cache decode, cross-attention) no query is a
conditioning query. Keys at index ``>= kv_valid_len`` are masked for
every query.

The shared library is built with ``nvcc`` at first use, from this
package's sources only, into ``csrc/build/`` (listed in .gitignore).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from typing import Optional, Tuple

import torch

NEG_INF = -1e30
HEAD_DIMS = (32, 64, 128)
_KERNEL_DTYPES = {torch.bfloat16: 0, torch.float16: 1}

_CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                     "csrc")
_SOURCE = os.path.join(_CSRC, "flash_fwd.cu")
BUILD_DIR = os.path.join(_CSRC, "build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# Number of kernel launches since the last reset; incremented only where
# the kernel is launched (never by the plain version).
launches = 0
_lib = None


def reset_launches() -> None:
    global launches
    launches = 0


# ---------------------------------------------------------------------------
# Plain PyTorch version (CPU path, and the reference the kernel is held to)
# ---------------------------------------------------------------------------


def _allowed_mask(Sq: int, Sk: int, ncond: int, kv_valid: Optional[int],
                  q_offset: int, k_offset: int, device) -> Optional[torch.Tensor]:
    """[Sq, Sk] boolean allowed-mask over global indices, or None when
    everything is allowed."""
    need_pad = kv_valid is not None and k_offset + Sk > kv_valid
    if ncond <= 0 and not need_pad:
        return None
    q_idx = torch.arange(Sq, device=device)[:, None] + q_offset
    k_idx = torch.arange(Sk, device=device)[None, :] + k_offset
    allowed = torch.ones((Sq, Sk), dtype=torch.bool, device=device)
    if ncond > 0:
        allowed = (q_idx >= ncond) | (k_idx < ncond)
    if need_pad:
        allowed = allowed & (k_idx < kv_valid)
    return allowed


def attention_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    num_cond_tokens: int = 0,
    kv_valid_len: Optional[int] = None,
    scale: Optional[float] = None,
    q_offset: int = 0,
    k_offset: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain attention with an fp32 softmax, the kernel's arithmetic:
    S = (q k^T) * scale in fp32, P rounded to v's dtype before P V.

    q: [B, Sq, H, D]; k, v: [B, Sk, H, D]. Returns (o [B, Sq, H, D] in
    q's dtype, lse [B, Sq, H] fp32). A query row that sees no key gives
    o = 0 and lse = -1e30 (the reference kernel's l_safe rule).
    ``q_offset``/``k_offset`` shift the global indices that the prefix
    rule and ``kv_valid_len`` are read against (0 outside ring
    attention)."""
    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    if scale is None:
        scale = D ** -0.5
    ncond = int(num_cond_tokens) if Sq == Sk else 0
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    allowed = _allowed_mask(Sq, Sk, ncond, kv_valid_len, q_offset, k_offset,
                            q.device)
    if allowed is not None:
        s = s.masked_fill(~allowed, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    if allowed is not None:
        p = p.masked_fill(~allowed, 0.0)
    l = p.sum(dim=-1, keepdim=True)
    l_safe = torch.where(l == 0.0, torch.ones_like(l), l)
    pv = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), v.float())
    o = pv / l_safe.squeeze(-1).permute(0, 2, 1)[..., None]
    lse = (m + torch.log(l_safe)).squeeze(-1).permute(0, 2, 1)
    return o.to(q.dtype), lse.contiguous()


# ---------------------------------------------------------------------------
# Build and binding
# ---------------------------------------------------------------------------


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                           "csrc/flash_fwd.cu")
    return path


def build_library(source: str = _SOURCE) -> Tuple[str, str, float]:
    """Compile ``source`` (default csrc/flash_fwd.cu) into a shared
    library named after the source's hash (a changed source rebuilds).
    Returns (path, nvcc log, seconds spent building; 0 when the library
    already existed)."""
    with open(source, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()
    lib_path = os.path.join(BUILD_DIR, f"flash_fwd-{digest[:16]}.so")
    if os.path.exists(lib_path):
        return lib_path, "", 0.0
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{lib_path}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, source]
    t0 = time.time()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.time() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{log}")
    os.replace(tmp, lib_path)
    return lib_path, log, seconds


def load_library(source: str = _SOURCE) -> str:
    """Build ``source`` if needed and bind it; every later launch uses
    it. Returns the library's path."""
    global _lib
    path, _, _ = build_library(source)
    lib = ctypes.CDLL(path)
    fn = lib.lc_flash_fwd
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
                   + [ctypes.c_longlong] * 6 + [ctypes.c_int] * 4
                   + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    _lib = lib
    return path


def _library():
    if _lib is None:
        load_library()
    return _lib


def _check_operand(name: str, x: torch.Tensor, D: int) -> None:
    if x.stride(-1) != 1 or x.stride(-2) != D:
        raise ValueError(f"flash_fwd: {name} must have contiguous [H, D] rows, "
                         f"got strides {tuple(x.stride())}")
    if x.stride(1) % 8 or x.stride(0) % 8 or x.data_ptr() % 16:
        raise ValueError(f"flash_fwd: {name} needs 16-byte aligned rows "
                         f"(strides {tuple(x.stride())}, ptr {x.data_ptr()})")


def _kernel_forward(q, k, v, ncond: int, kv_valid: Optional[int],
                    q_offset: int, k_offset: int, scale: float):
    """Launch csrc/flash_fwd.cu on the current stream. Raises on any
    input the kernel does not take."""
    global launches
    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    if q.dtype not in _KERNEL_DTYPES:
        raise TypeError(f"flash_fwd kernel takes bf16 or fp16, got {q.dtype}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("flash_fwd: q, k, v must share one dtype")
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_fwd kernel takes head_dim in {HEAD_DIMS}, got {D}")
    if k.shape != (B, Sk, H, D) or v.shape != k.shape:
        raise ValueError(f"flash_fwd: shape mismatch q {tuple(q.shape)} "
                         f"k {tuple(k.shape)} v {tuple(v.shape)}")
    if not (q.device == k.device == v.device):
        raise ValueError("flash_fwd: q, k, v must be on one device")
    if B * H > 65535:
        raise ValueError(f"flash_fwd: B*H = {B * H} exceeds the grid limit")
    for name, x in (("q", q), ("k", k), ("v", v)):
        _check_operand(name, x, D)
    o = torch.empty((B, Sq, H, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, Sq, H), dtype=torch.float32, device=q.device)
    if B * H * Sq == 0:
        return o, lse
    lib = _library()
    kv_bound = 2 ** 31 - 1 if kv_valid is None else int(kv_valid)
    # the launch goes to the current device's context and stream: make
    # them q's
    with torch.cuda.device(q.device):
        rc = lib.lc_flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
            B, H, Sq, Sk, D, _KERNEL_DTYPES[q.dtype],
            q.stride(0), q.stride(1), k.stride(0), k.stride(1),
            v.stride(0), v.stride(1),
            int(ncond), kv_bound, int(q_offset), int(k_offset), float(scale),
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash_fwd launch failed: cudaError {rc}")
    launches += 1
    return o, lse


# ---------------------------------------------------------------------------
# Public entry
# ---------------------------------------------------------------------------


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    num_cond_tokens: int = 0,
    kv_valid_len: Optional[int] = None,
    scale: Optional[float] = None,
    q_offset: int = 0,
    k_offset: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """q: [B, Sq, H, D]; k, v: [B, Sk, H, D] -> (o [B, Sq, H, D],
    lse [B, Sq, H] fp32). CUDA tensors go through the kernel, CPU
    tensors through ``attention_reference`` (same semantics)."""
    if not q.is_cuda:
        return attention_reference(
            q, k, v, num_cond_tokens=num_cond_tokens, kv_valid_len=kv_valid_len,
            scale=scale, q_offset=q_offset, k_offset=k_offset)
    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    if scale is None:
        scale = D ** -0.5
    ncond = int(num_cond_tokens) if Sq == Sk else 0
    return _kernel_forward(q, k, v, ncond, kv_valid_len, q_offset, k_offset,
                           scale)
