"""Flash attention with LongCat conditioning-prefix semantics: the
hand-written CUDA kernels (``csrc/flash_fwd.cu`` forward,
``csrc/flash_bwd.cu`` dQ and dK/dV backward; all on wgmma with TMA loads
and a producer warpgroup, from ``csrc/hopper_common.cuh``), their ctypes
bindings, their plain PyTorch versions, and the
``torch.autograd.Function`` that joins them. The backward kernels read
lse and delta as fp32 rows of one (batch, head) each
(``backward_rows``), the layout a TMA box takes.

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
.gitignore), or into the folder ``kernel_build_dir`` names for a run (the
runner's ``--compile-cache-dir``).
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from typing import List, Optional, Sequence, Tuple

import torch

NEG_INF = -1e30
LOG2E = 1.4426950408889634
HEAD_DIMS = (32, 64, 128)
_KERNEL_DTYPES = {torch.bfloat16: 0, torch.float16: 1}

_CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                     "csrc")
_SOURCE = os.path.join(_CSRC, "flash_fwd.cu")
_BWD_SOURCE = os.path.join(_CSRC, "flash_bwd.cu")
BSA_SOURCE = os.path.join(_CSRC, "bsa.cu")  # bound in ops/bsa.py
QK_NORM_SOURCE = os.path.join(_CSRC, "qk_norm_rope.cu")  # bound in ops/qk_norm.py
SOURCES = (_SOURCE, _BWD_SOURCE, BSA_SOURCE, QK_NORM_SOURCE)
_HEADERS = (os.path.join(_CSRC, "hopper_common.cuh"),)
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


DEFAULT_BUILD_DIR = BUILD_DIR


def _drop_libraries() -> None:
    """Forget the bound libraries: the next launch loads (or builds) them
    from ``BUILD_DIR``."""
    global _lib, _bwd_lib
    from . import bsa, qk_norm

    _lib = _bwd_lib = bsa._lib = qk_norm._lib = None


@contextlib.contextmanager
def kernel_build_dir(spec: str = "auto"):
    """Build and load the kernel libraries of the enclosed code in a folder
    of the caller's: "auto" is ``csrc/build/``, "off" a temporary folder
    removed at the end, any other value that path. Yields the folder."""
    global BUILD_DIR
    tmp = tempfile.mkdtemp(prefix="lc_kernels_") if spec == "off" else None
    path = tmp or (DEFAULT_BUILD_DIR if spec in (None, "", "auto")
                   else os.path.abspath(os.path.expanduser(spec)))
    prev = BUILD_DIR
    if path != prev:
        BUILD_DIR = path
        _drop_libraries()
    try:
        yield path
    finally:
        if path != prev:
            BUILD_DIR = prev
            _drop_libraries()
        if tmp:
            shutil.rmtree(tmp, ignore_errors=True)


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                           "the kernels in csrc/")
    return path


def _lib_path(source: str) -> str:
    """The library of ``source``, named after the hash of the source, the
    shared header and the flags (a changed source or header rebuilds)."""
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
# q, k, v, do, rows, outputs (1 or 2), B, H, Sq, Sk, D, dtype, ld,
# 8 byte strides, ncond, kv_valid, q_off, k_off, scale, stream
_BWD_TAIL = [_INT] * 7 + [_I64] * 8 + [_INT] * 4 + [ctypes.c_float, _PTR]


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
        lib.lc_flash_bwd_dq.argtypes = [_PTR] * 6 + _BWD_TAIL
        lib.lc_flash_bwd_dkv.argtypes = [_PTR] * 7 + _BWD_TAIL
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


TMA_ROWS = 128  # tokens per TMA box: the forward kernels' query and key tiles


def tma_map_args(x: torch.Tensor, name: str = "x") -> dict:
    """The tensor map that csrc/hopper_common.cuh's ``encode_rows`` makes
    of a [B, S, H, D] operand with contiguous [H, D] rows: ``dims`` (D,
    H, S, B), byte ``strides`` of H, S and B (the batch stride of a
    single batch is S token strides, since it is never stepped), a
    ``box`` of one swizzle span of a row (at most 128 bytes) by
    ``TMA_ROWS`` tokens, and that ``swizzle`` in bytes. Raises ValueError
    on what TMA cannot take: rows that are not contiguous, or a base
    address or a stride that is not a multiple of 16 bytes or not below
    2^40."""
    B, S, H, D = x.shape
    esz = x.element_size()
    if x.stride(-1) != 1 or x.stride(-2) != D:
        raise ValueError(f"attention kernels: {name} must have contiguous [H, D] rows, "
                         f"got strides {tuple(x.stride())}")
    row = D * esz
    ts = x.stride(1) * esz
    bs = x.stride(0) * esz if B > 1 else S * ts
    if x.data_ptr() % 16 or row % 16 or ts % 16 or bs % 16 or min(ts, bs) <= 0:
        raise ValueError(f"attention kernels: TMA needs {name}'s base address and byte "
                         f"strides to be positive multiples of 16 (strides "
                         f"{tuple(x.stride())} x {esz} bytes, ptr {x.data_ptr()})")
    if max(ts, bs) >= 2 ** 40:
        raise ValueError(f"attention kernels: {name}'s strides exceed TMA's 2^40 bytes")
    sw = min(row, 128)
    return {"dims": (D, H, S, B), "strides": (row, ts, bs),
            "box": (sw // esz, 1, TMA_ROWS, 1), "swizzle": sw}


def _check_operand(name: str, x: torch.Tensor, D: int) -> None:
    if x.stride(-1) != 1 or x.stride(-2) != D:
        raise ValueError(f"flash kernels: {name} must have contiguous [H, D] rows, "
                         f"got strides {tuple(x.stride())}")
    if x.stride(1) % 8 or x.stride(0) % 8 or x.data_ptr() % 16:
        raise ValueError(f"flash kernels: {name} needs 16-byte aligned rows: a base "
                         f"address and batch and token strides that are multiples of "
                         f"16 bytes, as TMA and 16-byte loads require (strides "
                         f"{tuple(x.stride())}, ptr {x.data_ptr()})")


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
    if Sk == 0:  # no key: the l_safe rule, and no tensor map of 0 rows
        return o.zero_(), lse.fill_(NEG_INF)
    maps = [tma_map_args(x, name=n) for n, x in (("q", q), ("k", k), ("v", v))]
    strides = [m["strides"][i] for m in maps for i in (2, 1)]  # bs, ts of q, k, v
    lib = _library()
    kv_bound = _kv_bound(kv_valid)
    # the launch goes to the current device's context and stream: make
    # them q's
    with torch.cuda.device(q.device):
        rc = lib.lc_flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
            B, H, Sq, Sk, D, _KERNEL_DTYPES[q.dtype], *strides,
            int(ncond), kv_bound, int(q_offset), int(k_offset), float(scale),
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash_fwd launch failed: cudaError {rc}")
    launches += 1
    return o, lse


def backward_rows(lse: torch.Tensor, delta: Optional[torch.Tensor] = None, *,
                  do: Optional[torch.Tensor] = None,
                  o: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, int]:
    """The lse and delta layout the backward kernels read: ``lse``
    [B, Sq, H] and either ``delta`` [B, Sq, H] or the ``do`` and ``o``
    [B, Sq, H, D] it comes from -> (``rows`` [2, B*H, ld] fp32, ``ld``).
    Row b*H + h of ``rows[0]`` holds lse * log2(e) of (b, h) with query i
    at column i, the same row of ``rows[1]`` its delta; ``ld`` is Sq
    rounded up to 4 (16-byte rows, what a TMA box takes: the [B, Sq, H]
    tensors are strided by H floats), the padding zero. From ``do`` and
    ``o``, delta = rowsum(dO * O) in fp32 is summed straight into its
    rows."""
    B, Sq, H = lse.shape
    ld = -(-Sq // 4) * 4
    rows = torch.empty((2, B, H, ld), dtype=torch.float32, device=lse.device)
    if ld > Sq:
        rows[..., Sq:] = 0.0
    torch.mul(lse.permute(0, 2, 1), LOG2E, out=rows[0, ..., :Sq])
    if delta is None:
        torch.sum(do.float().mul_(o), -1, out=rows[1, ..., :Sq].permute(0, 2, 1))
    else:
        rows[1, ..., :Sq] = delta.permute(0, 2, 1)
    return rows.view(2, B * H, ld), ld


def _kernel_backward(dkv: bool, q, k, v, do, rows: torch.Tensor, ld: int, *,
                     num_cond_tokens: int = 0, kv_valid_len: Optional[int] = None,
                     scale: Optional[float] = None, q_offset: int = 0,
                     k_offset: int = 0):
    """Launch the dQ (``dkv`` False) or the dK/dV kernel of
    csrc/flash_bwd.cu on the current stream, with lse and delta as
    ``backward_rows``: the one entry into each kernel, for the public
    wrappers and the autograd backward alike. Raises on any input the
    kernels do not take."""
    global bwd_dq_launches, bwd_dkv_launches
    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    ncond = int(num_cond_tokens) if Sq == Sk else 0
    if scale is None:
        scale = D ** -0.5
    _check_inputs(q, k, v)
    if do.shape != q.shape or do.dtype != q.dtype or do.device != q.device:
        raise ValueError(f"flash_bwd: do {tuple(do.shape)} {do.dtype} must match q")
    if (rows.shape != (2, B * H, ld) or rows.dtype != torch.float32 or ld % 4
            or ld < Sq or not rows.is_contiguous() or rows.device != q.device):
        raise ValueError(f"flash_bwd: lse and delta rows must be a contiguous fp32 "
                         f"[2, B*H, ld] tensor with ld >= Sq a multiple of 4 on q's "
                         f"device, got {tuple(rows.shape)} {rows.dtype} ld {ld}")
    do = do.contiguous()
    _check_operand("do", do, D)
    if dkv:
        outs = (torch.empty((B, Sk, H, D), dtype=k.dtype, device=k.device),
                torch.empty((B, Sk, H, D), dtype=v.dtype, device=v.device))
    else:
        outs = (torch.empty((B, Sq, H, D), dtype=q.dtype, device=q.device),)
    if B * H * Sq * Sk == 0:
        return tuple(x.zero_() for x in outs)
    maps = [tma_map_args(x, name=n) for n, x in (("q", q), ("k", k), ("v", v), ("do", do))]
    strides = [m["strides"][i] for m in maps for i in (2, 1)]  # bs, ts of q, k, v, do
    lib = _bwd_library()
    fn = lib.lc_flash_bwd_dkv if dkv else lib.lc_flash_bwd_dq
    with torch.cuda.device(q.device):
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), rows.data_ptr(),
                *(x.data_ptr() for x in outs), B, H, Sq, Sk, D, _KERNEL_DTYPES[q.dtype],
                ld, *strides, ncond, _kv_bound(kv_valid_len), int(q_offset),
                int(k_offset), float(scale), torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash_bwd_{'dkv' if dkv else 'dq'} launch failed: "
                           f"error {rc}")
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


@torch.library.custom_op("lc_port::flash_fwd", mutates_args=())
def flash_fwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 num_cond_tokens: int, kv_valid_len: Optional[int],
                 scale: Optional[float], q_offset: int,
                 k_offset: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``flash_attention`` as a dispatcher op, so that a selective
    checkpoint policy (``ops/layers.py::remat_wrap``, "dots_attn") can
    save its o and lse: the recompute then returns them instead of
    launching the kernel again. CUDA tensors launch csrc/flash_fwd.cu,
    CPU tensors run ``attention_reference``."""
    return flash_attention(q, k, v, num_cond_tokens=num_cond_tokens,
                           kv_valid_len=kv_valid_len, scale=scale,
                           q_offset=q_offset, k_offset=k_offset)


@flash_fwd_op.register_fake
def _(q, k, v, num_cond_tokens, kv_valid_len, scale, q_offset, k_offset):
    B, Sq, H, D = q.shape
    return q.new_empty((B, Sq, H, D)), q.new_empty((B, Sq, H), dtype=torch.float32)


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
    return _kernel_backward(False, q, k, v, do, *backward_rows(lse, delta),
                            num_cond_tokens=num_cond_tokens, kv_valid_len=kv_valid_len,
                            scale=scale, q_offset=q_offset, k_offset=k_offset)[0]


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
    return _kernel_backward(True, q, k, v, do, *backward_rows(lse, delta),
                            num_cond_tokens=num_cond_tokens, kv_valid_len=kv_valid_len,
                            scale=scale, q_offset=q_offset, k_offset=k_offset)


# ---------------------------------------------------------------------------
# Chunk entry points for ring context parallelism
# ---------------------------------------------------------------------------
#
# The ring (parallel/context_attention.py) runs one (local q x K/V chunk)
# pass per step with global offsets, so that the prefix rule and the key
# bound hold across shards: the reference's flash_chunk_fwd / _dq / _dkv
# (:640, :673, :705). They are the B1-B3 launches above with q_offset and
# k_offset set; the ring owns the autograd. A query row that sees no key
# of a chunk gives o = 0 and lse = -1e30, which the ring's logaddexp
# combine treats as an empty partial.


def _chunk_ncond(q, k, num_cond_tokens: int) -> int:
    ncond = int(num_cond_tokens)
    if ncond > 0 and q.shape[1] != k.shape[1]:
        raise ValueError(f"flash chunks: the prefix rule needs square chunks, got Sq "
                         f"{q.shape[1]} and Sk {k.shape[1]} with {ncond} cond tokens "
                         f"(decode chunks run with num_cond_tokens=0)")
    return ncond


def flash_chunk_fwd(q, k, v, q_offset: int, k_offset: int, *, num_cond_tokens: int,
                    scale: Optional[float] = None, kv_valid: Optional[int] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One ring step: local q [B, Sq, H, D] against a K/V chunk
    [B, Sk, H, D] whose global indices start at ``k_offset`` (the
    queries' at ``q_offset``) -> (o normalised [B, Sq, H, D], lse
    [B, Sq, H] fp32). ``kv_valid``: the global key bound. CUDA tensors
    launch csrc/flash_fwd.cu, CPU tensors run ``attention_reference``."""
    ncond = _chunk_ncond(q, k, num_cond_tokens)
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if not q.is_cuda:
        return attention_reference(q, k, v, num_cond_tokens=ncond, kv_valid_len=kv_valid,
                                   scale=scale, q_offset=q_offset, k_offset=k_offset)
    return _kernel_forward(q, k, v, ncond, kv_valid, q_offset, k_offset, scale)


def flash_chunk_dq(q, k, v, do, lse, delta, q_offset: int, k_offset: int, *,
                   num_cond_tokens: int, scale: Optional[float] = None,
                   kv_valid: Optional[int] = None) -> torch.Tensor:
    """dq [B, Sq, H, D] of the local queries against one chunk, from the
    globally combined ``lse`` and ``delta`` [B, Sq, H] fp32 (laid out as
    ``backward_rows`` for the dQ kernel). CPU tensors run the plain
    version."""
    ncond = _chunk_ncond(q, k, num_cond_tokens)
    kw = dict(num_cond_tokens=ncond, kv_valid_len=kv_valid, scale=scale,
              q_offset=q_offset, k_offset=k_offset)
    if not q.is_cuda:
        return _backward_reference_from_delta(q, k, v, do, lse, delta, **kw)[0]
    return _kernel_backward(False, q, k, v, do, *backward_rows(lse, delta), **kw)[0]


def flash_chunk_dkv(q, k, v, do, lse, delta, q_offset: int, k_offset: int, *,
                    num_cond_tokens: int, scale: Optional[float] = None,
                    kv_valid: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """This rank's (dk, dv) [B, Sk, H, D] contribution to one chunk, from
    the globally combined ``lse`` and ``delta``. CPU tensors run the plain
    version."""
    ncond = _chunk_ncond(q, k, num_cond_tokens)
    kw = dict(num_cond_tokens=ncond, kv_valid_len=kv_valid, scale=scale,
              q_offset=q_offset, k_offset=k_offset)
    if not q.is_cuda:
        return _backward_reference_from_delta(q, k, v, do, lse, delta, **kw)[1:]
    return _kernel_backward(True, q, k, v, do, *backward_rows(lse, delta), **kw)


class FlashAttentionFunction(torch.autograd.Function):
    """Differentiable ``flash_attention`` (the reference's ``_flash_core``
    custom VJP, :490-526). The forward saves q, k, v, o and lse; the
    backward lays lse out once as ``backward_rows`` and sums delta =
    rowsum(dO * O) in fp32 straight into its rows with plain torch (the
    reference computes it outside its kernels too), then launches the dQ
    kernel, and the dK/dV kernel only when k or v needs a gradient
    (cross-attention's k and v come from the frozen text path), through
    the same entry as the public wrappers. CPU tensors go through
    ``attention_backward_reference``. The forward runs ``flash_fwd_op``,
    the one op a remat policy can save (the reference names its o and lse
    "flash_out" and "flash_lse", :501-511)."""

    @staticmethod
    def forward(ctx, q, k, v, num_cond_tokens, kv_valid_len, scale, q_offset,
                k_offset):
        o, lse = flash_fwd_op(q, k, v, int(num_cond_tokens), kv_valid_len, scale,
                              int(q_offset), int(k_offset))
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
            rows = backward_rows(lse, do=do, o=o)
            if need_q:
                (dq,) = _kernel_backward(False, q, k, v, do, *rows, **ctx.kw)
            if need_k or need_v:
                dk, dv = _kernel_backward(True, q, k, v, do, *rows, **ctx.kw)
        return (dq if need_q else None, dk if need_k else None,
                dv if need_v else None, None, None, None, None, None)
