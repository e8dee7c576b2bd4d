"""Flash attention with LongCat conditioning-prefix semantics: the
hand-written CUDA kernels (``csrc/flash_fwd.cu`` forward,
``csrc/flash_bwd.cu`` dQ and dK/dV backward), their ctypes bindings, their
plain PyTorch versions, and the ``torch.autograd.Function`` that joins
them.

The kernels replace the reference's Pallas TPU kernels
``longcat_video_tta_tpu/ops/flash_attention.py::_fwd_kernel``,
``_bwd_dq_kernel`` and ``_bwd_dkv_kernel``. For CUDA tensors each wrapper
launches its kernel or raises; for CPU tensors it runs the plain version.
There is no fallback from one to the other.

Masking (``ops/attention.py`` of the reference): with a conditioning
prefix of ``num_cond_tokens``, queries in the noise region attend to all
keys and queries in the prefix attend only within the prefix. The prefix
rule applies only when ``Sq == Sk`` (training / no-cache path); with
``Sq != Sk`` (KV-cache decode, cross-attention) no query is a
conditioning query. Keys at index ``>= kv_valid_len`` are masked for
every query.

The shared libraries are built with ``nvcc`` at first use, one per
source, from this package's sources only, into ``csrc/build/`` (listed in
.gitignore).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from typing import List, Optional, Sequence, Tuple

import torch

NEG_INF = -1e30
HEAD_DIMS = (32, 64, 128)
_KERNEL_DTYPES = {torch.bfloat16: 0, torch.float16: 1}

_CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                     "csrc")
_SOURCE = os.path.join(_CSRC, "flash_fwd.cu")
_BWD_SOURCE = os.path.join(_CSRC, "flash_bwd.cu")
BSA_SOURCE = os.path.join(_CSRC, "bsa.cu")  # bound in ops/bsa.py
SOURCES = (_SOURCE, _BWD_SOURCE, BSA_SOURCE)
_HEADERS = (os.path.join(_CSRC, "flash_common.cuh"),)
BUILD_DIR = os.path.join(_CSRC, "build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# Launches of each kernel since the last reset; each is incremented only
# where its kernel is launched (never by a plain version).
launches = 0           # flash_fwd
bwd_dq_launches = 0    # flash_bwd_dq
bwd_dkv_launches = 0   # flash_bwd_dkv
_lib = None      # the library holding lc_flash_fwd
_bwd_lib = None  # the library holding lc_flash_bwd_dq / lc_flash_bwd_dkv


def reset_launches() -> None:
    global launches, bwd_dq_launches, bwd_dkv_launches
    launches = bwd_dq_launches = bwd_dkv_launches = 0


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


def _backward_reference_from_delta(q, k, v, do, lse, delta, *, num_cond_tokens=0,
                                   kv_valid_len=None, scale=None, q_offset=0,
                                   k_offset=0):
    """(dq, dk, dv) from the forward's lse and delta = rowsum(dO * O)
    ([B, Sq, H] fp32 each), with the TPU kernels' arithmetic: P =
    exp(S - lse) set to 0 where masked (a row with no visible key has
    lse = -1e30: selected to 0, never inf * 0), P rounded to dO's dtype
    before P^T dO, dS = P (dP - delta) rounded to q's / k's dtype before
    dS^T Q and dS K."""
    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    if scale is None:
        scale = D ** -0.5
    ncond = int(num_cond_tokens) if Sq == Sk else 0
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    p = torch.exp(s - lse.permute(0, 2, 1)[..., None])
    allowed = _allowed_mask(Sq, Sk, ncond, kv_valid_len, q_offset, k_offset,
                            q.device)
    if allowed is not None:
        p = p.masked_fill(~allowed, 0.0)
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), v.float())
    ds = p * (dp - delta.permute(0, 2, 1)[..., None])
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(do.dtype).float(), do.float())
    dk = torch.einsum("bhqk,bqhd->bkhd", ds.to(q.dtype).float(), q.float()) * scale
    dq = torch.einsum("bhqk,bkhd->bqhd", ds.to(k.dtype).float(), k.float()) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def attention_backward_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    o: torch.Tensor,
    lse: torch.Tensor,
    do: torch.Tensor,
    *,
    num_cond_tokens: int = 0,
    kv_valid_len: Optional[int] = None,
    scale: Optional[float] = None,
    q_offset: int = 0,
    k_offset: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain backward of ``attention_reference``: (dq, dk, dv) in the
    inputs' dtypes, given the forward's o and lse and the output
    gradient do. delta = rowsum(dO * O) in fp32, as the reference
    computes it outside its kernels (``_flash_bwd_impl``)."""
    delta = (do.float() * o.float()).sum(-1)
    return _backward_reference_from_delta(
        q, k, v, do, lse, delta, num_cond_tokens=num_cond_tokens,
        kv_valid_len=kv_valid_len, scale=scale, q_offset=q_offset,
        k_offset=k_offset)


# ---------------------------------------------------------------------------
# Build and binding
# ---------------------------------------------------------------------------


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                           "the kernels in csrc/")
    return path


def _lib_path(source: str) -> str:
    """The library of ``source``, named after the hash of the source, the
    shared header and the flags (a changed source rebuilds)."""
    h = hashlib.sha256()
    for path in (source, *_HEADERS):
        with open(path, "rb") as f:
            h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    stem = os.path.splitext(os.path.basename(source))[0]
    return os.path.join(BUILD_DIR, f"{stem}-{h.hexdigest()[:16]}.so")


def build_libraries(sources: Sequence[str] = SOURCES) -> List[Tuple[str, str, float]]:
    """Compile each source into its own shared library, one ``nvcc`` per
    source, all started together. Returns (path, nvcc log, seconds spent
    building; 0 when the library already existed or is built for an
    earlier entry of ``sources``) per source."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    jobs = []
    for source in sources:
        lib_path = _lib_path(source)
        if os.path.exists(lib_path) or any(job[0] == lib_path for job in jobs):
            jobs.append((lib_path, None, None, 0.0))
            continue
        tmp = f"{lib_path}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS, "-I", _CSRC, "-o", tmp, source]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        jobs.append((lib_path, tmp, proc, time.time()))
    results, failed = [], []
    for lib_path, tmp, proc, t0 in jobs:  # wait for every build first
        if proc is None:
            results.append((lib_path, "", 0.0))
            continue
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}) for {lib_path}:\n{log}")
            continue
        os.replace(tmp, lib_path)
        results.append((lib_path, log, time.time() - t0))
    if failed:
        raise RuntimeError("\n".join(failed))
    return results


_PTR, _INT, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_FWD_ARGTYPES = ([_PTR] * 5 + [_INT] * 6 + [_I64] * 6 + [_INT] * 4
                 + [ctypes.c_float, _PTR])
# q, k, v, do, lse, delta, outputs (1 or 2), B, H, Sq, Sk, D, dtype,
# 8 strides, ncond, kv_valid, q_off, k_off, scale, stream
_BWD_TAIL = [_INT] * 6 + [_I64] * 8 + [_INT] * 4 + [ctypes.c_float, _PTR]


def load_library(source: str = _SOURCE) -> str:
    """Build ``source`` if needed and bind the entry points it holds
    (forward, or the two backward kernels); every later launch uses them.
    Returns the library's path."""
    global _lib, _bwd_lib
    path = build_libraries((source,))[0][0]
    lib = ctypes.CDLL(path)
    bound = False
    if hasattr(lib, "lc_flash_fwd"):
        lib.lc_flash_fwd.argtypes = _FWD_ARGTYPES
        lib.lc_flash_fwd.restype = ctypes.c_int
        _lib, bound = lib, True
    if hasattr(lib, "lc_flash_bwd_dq"):
        lib.lc_flash_bwd_dq.argtypes = [_PTR] * 7 + _BWD_TAIL
        lib.lc_flash_bwd_dkv.argtypes = [_PTR] * 8 + _BWD_TAIL
        lib.lc_flash_bwd_dq.restype = lib.lc_flash_bwd_dkv.restype = ctypes.c_int
        _bwd_lib, bound = lib, True
    if not bound:
        raise RuntimeError(f"{source} exports no flash-attention entry point")
    return path


def _library():
    if _lib is None:
        load_library(_SOURCE)
    return _lib


def _bwd_library():
    if _bwd_lib is None:
        load_library(_BWD_SOURCE)
    return _bwd_lib


def _check_operand(name: str, x: torch.Tensor, D: int) -> None:
    if x.stride(-1) != 1 or x.stride(-2) != D:
        raise ValueError(f"flash kernels: {name} must have contiguous [H, D] rows, "
                         f"got strides {tuple(x.stride())}")
    if x.stride(1) % 8 or x.stride(0) % 8 or x.data_ptr() % 16:
        raise ValueError(f"flash kernels: {name} needs 16-byte aligned rows "
                         f"(strides {tuple(x.stride())}, ptr {x.data_ptr()})")


def _check_inputs(q, k, v) -> None:
    """Raise on any q, k, v the kernels do not take."""
    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    if q.dtype not in _KERNEL_DTYPES:
        raise TypeError(f"flash kernels take bf16 or fp16, got {q.dtype}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("flash kernels: q, k, v must share one dtype")
    if D not in HEAD_DIMS:
        raise ValueError(f"flash kernels take head_dim in {HEAD_DIMS}, got {D}")
    if k.shape != (B, Sk, H, D) or v.shape != k.shape:
        raise ValueError(f"flash kernels: shape mismatch q {tuple(q.shape)} "
                         f"k {tuple(k.shape)} v {tuple(v.shape)}")
    if not (q.device == k.device == v.device):
        raise ValueError("flash kernels: q, k, v must be on one device")
    if B * H > 65535:
        raise ValueError(f"flash kernels: B*H = {B * H} exceeds the grid limit")
    for name, x in (("q", q), ("k", k), ("v", v)):
        _check_operand(name, x, D)


def _kv_bound(kv_valid: Optional[int]) -> int:
    return 2 ** 31 - 1 if kv_valid is None else int(kv_valid)


def _kernel_forward(q, k, v, ncond: int, kv_valid: Optional[int],
                    q_offset: int, k_offset: int, scale: float):
    """Launch csrc/flash_fwd.cu on the current stream. Raises on any
    input the kernel does not take."""
    global launches
    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    _check_inputs(q, k, v)
    o = torch.empty((B, Sq, H, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, Sq, H), dtype=torch.float32, device=q.device)
    if B * H * Sq == 0:
        return o, lse
    lib = _library()
    kv_bound = _kv_bound(kv_valid)
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


def _kernel_backward(dkv: bool, q, k, v, do, lse, delta, ncond: int,
                     kv_valid: Optional[int], q_offset: int, k_offset: int,
                     scale: float):
    """Launch the dQ (``dkv`` False) or the dK/dV kernel of
    csrc/flash_bwd.cu on the current stream. Raises on any input the
    kernels do not take."""
    global bwd_dq_launches, bwd_dkv_launches
    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    _check_inputs(q, k, v)
    if do.shape != q.shape or do.dtype != q.dtype or do.device != q.device:
        raise ValueError(f"flash_bwd: do {tuple(do.shape)} {do.dtype} must match q")
    if lse.shape != (B, Sq, H) or delta.shape != (B, Sq, H):
        raise ValueError("flash_bwd: lse and delta must be [B, Sq, H]")
    do = do.contiguous()
    _check_operand("do", do, D)
    lse = lse.float().contiguous()
    delta = delta.float().contiguous()
    if dkv:
        outs = (torch.empty((B, Sk, H, D), dtype=k.dtype, device=k.device),
                torch.empty((B, Sk, H, D), dtype=v.dtype, device=v.device))
    else:
        outs = (torch.empty((B, Sq, H, D), dtype=q.dtype, device=q.device),)
    if B * H * Sq * Sk == 0:
        return tuple(x.zero_() for x in outs)
    lib = _bwd_library()
    fn = lib.lc_flash_bwd_dkv if dkv else lib.lc_flash_bwd_dq
    with torch.cuda.device(q.device):
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                lse.data_ptr(), delta.data_ptr(), *(x.data_ptr() for x in outs),
                B, H, Sq, Sk, D, _KERNEL_DTYPES[q.dtype],
                q.stride(0), q.stride(1), k.stride(0), k.stride(1),
                v.stride(0), v.stride(1), do.stride(0), do.stride(1),
                int(ncond), _kv_bound(kv_valid), int(q_offset), int(k_offset),
                float(scale), torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash_bwd_{'dkv' if dkv else 'dq'} launch failed: "
                           f"cudaError {rc}")
    if dkv:
        bwd_dkv_launches += 1
    else:
        bwd_dq_launches += 1
    return outs


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


def _bwd_args(q, k, num_cond_tokens, scale):
    Sq, D = q.shape[1], q.shape[3]
    ncond = int(num_cond_tokens) if Sq == k.shape[1] else 0
    return ncond, (D ** -0.5 if scale is None else scale)


def flash_attention_bwd_dq(q, k, v, do, lse, delta, *, num_cond_tokens: int = 0,
                           kv_valid_len: Optional[int] = None,
                           scale: Optional[float] = None, q_offset: int = 0,
                           k_offset: int = 0) -> torch.Tensor:
    """dq [B, Sq, H, D] from the forward's lse and delta = rowsum(dO * O)
    ([B, Sq, H] fp32). CUDA tensors go through the dQ kernel, CPU tensors
    through the plain version."""
    if not q.is_cuda:
        return _backward_reference_from_delta(
            q, k, v, do, lse, delta, num_cond_tokens=num_cond_tokens,
            kv_valid_len=kv_valid_len, scale=scale, q_offset=q_offset,
            k_offset=k_offset)[0]
    ncond, scale = _bwd_args(q, k, num_cond_tokens, scale)
    return _kernel_backward(False, q, k, v, do, lse, delta, ncond, kv_valid_len,
                            q_offset, k_offset, scale)[0]


def flash_attention_bwd_dkv(q, k, v, do, lse, delta, *, num_cond_tokens: int = 0,
                            kv_valid_len: Optional[int] = None,
                            scale: Optional[float] = None, q_offset: int = 0,
                            k_offset: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dk, dv) [B, Sk, H, D] from the forward's lse and delta. CUDA
    tensors go through the dK/dV kernel, CPU tensors through the plain
    version."""
    if not q.is_cuda:
        return _backward_reference_from_delta(
            q, k, v, do, lse, delta, num_cond_tokens=num_cond_tokens,
            kv_valid_len=kv_valid_len, scale=scale, q_offset=q_offset,
            k_offset=k_offset)[1:]
    ncond, scale = _bwd_args(q, k, num_cond_tokens, scale)
    return _kernel_backward(True, q, k, v, do, lse, delta, ncond, kv_valid_len,
                            q_offset, k_offset, scale)


class FlashAttentionFunction(torch.autograd.Function):
    """Differentiable ``flash_attention`` (the reference's ``_flash_core``
    custom VJP, :490-526). The forward saves q, k, v, o and lse; the
    backward computes delta = rowsum(dO * O) in fp32 with plain torch (the
    reference computes it outside its kernels too), then launches the dQ
    kernel, and the dK/dV kernel only when k or v needs a gradient
    (cross-attention's k and v come from the frozen text path). CPU
    tensors go through ``attention_backward_reference``."""

    @staticmethod
    def forward(ctx, q, k, v, num_cond_tokens, kv_valid_len, scale, q_offset,
                k_offset):
        o, lse = flash_attention(q, k, v, num_cond_tokens=num_cond_tokens,
                                 kv_valid_len=kv_valid_len, scale=scale,
                                 q_offset=q_offset, k_offset=k_offset)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.kw = dict(num_cond_tokens=num_cond_tokens, kv_valid_len=kv_valid_len,
                      scale=scale, q_offset=q_offset, k_offset=k_offset)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        need_q, need_k, need_v = ctx.needs_input_grad[:3]
        dq = dk = dv = None
        if not q.is_cuda:
            dq, dk, dv = attention_backward_reference(q, k, v, o, lse, do, **ctx.kw)
        else:
            delta = (do.float() * o.float()).sum(-1)
            if need_q:
                dq = flash_attention_bwd_dq(q, k, v, do, lse, delta, **ctx.kw)
            if need_k or need_v:
                dk, dv = flash_attention_bwd_dkv(q, k, v, do, lse, delta, **ctx.kw)
        return (dq if need_q else None, dk if need_k else None,
                dv if need_v else None, None, None, None, None, None)
