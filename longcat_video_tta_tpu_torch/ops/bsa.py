"""Block-sparse attention (BSA) for the decode loop: block selection, the
hand-written CUDA kernels of ``csrc/bsa.cu`` (the token-block sum that
feeds the selection, and the gathered flash-attention forward over the
selected key blocks on the forward kernel's wgmma/TMA mainloop, in
16-bit and with int8 QK^T), their ctypes bindings and their plain
PyTorch versions.

Counterpart of ``longcat_video_tta_tpu/ops/bsa.py``; the kernels replace
its Pallas TPU kernels ``_block_sum_kernel`` and ``_bsa_kernel``.

1. Selection (plain tensor ops around the block-sum kernel): mean-pool q
   and k into blocks of ``block_q`` / ``block_k`` tokens, score every
   (q-block, k-block) pair by the pooled dot product in fp32, force-keep
   the conditioning-prefix blocks and each q-block's own (diagonal)
   block, demote blocks that start at or past ``kv_valid``, take the
   ``top_k`` best per q-block (ties to the lower index, as ``lax.top_k``)
   and sort them.
2. Compute: attention of each query over the keys of its q-block's
   selected blocks only; keys at index >= min(Sk, kv_valid) are masked.
   There is no conditioning-query rule (queries are noise tokens).

For CUDA tensors each wrapper launches its kernel or raises; for CPU
tensors it runs the plain version. There is no fallback from one to the
other. The library is built by ``flash_attention.build_libraries`` with
the other kernels, at first use.
"""

from __future__ import annotations

import ctypes
import math
import os
from typing import Optional, Tuple

import torch

from ..utils.spans import span
from . import flash_attention as fa

NEG_INF = fa.NEG_INF
SOURCE = fa.BSA_SOURCE
_BIG = 3e38  # score of a forced block (demoted blocks get -_BIG)

# Launches of each kernel since the last reset; each is incremented only
# where its kernel is launched (never by a plain version).
bsa_block_sum_launches = 0  # bsa_block_sum
bsa_launches = 0            # bsa_fwd (16-bit)
bsa_int8_launches = 0       # bsa_fwd_qk_int8
_lib = None


def reset_launches() -> None:
    global bsa_block_sum_launches, bsa_launches, bsa_int8_launches
    bsa_block_sum_launches = bsa_launches = bsa_int8_launches = 0


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


# ---------------------------------------------------------------------------
# Plain PyTorch versions (CPU path, and the references the kernels are held to)
# ---------------------------------------------------------------------------


def block_sum_reference(x: torch.Tensor, bs: int) -> torch.Tensor:
    """[B, S, H, D] -> fp32 [B, ceil(S/bs), H, D] token-block sums; the
    last block sums only its real tokens."""
    B, S, H, D = x.shape
    nb = _cdiv(S, bs)
    xf = x.float()
    if nb * bs > S:
        xf = torch.cat([xf, xf.new_zeros((B, nb * bs - S, H, D))], dim=1)
    return xf.reshape(B, nb, bs, H, D).sum(2)


def _quantize_tokens(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """[B, S, H, D] -> (int8 [B, S, H, D], fp32 per-(token, head) scale
    [B, S, H, 1]): symmetric abs-max quantization with a 1e-8 floor (the
    W8A8 activation recipe of ``ops/quant.py``)."""
    xf = x.float()
    s = (xf.abs().amax(dim=-1, keepdim=True) / 127.0).clamp_min(1e-8)
    return torch.round(xf / s).to(torch.int8), s


def _heads_first(x: torch.Tensor) -> torch.Tensor:
    B, S, H = x.shape[:3]
    return x.transpose(1, 2).reshape(B * H, S, *x.shape[3:])


def bsa_reference(q, k, v, idx, *, block_q: int, block_k: int,
                  kv_valid: Optional[int] = None, scale: Optional[float] = None,
                  qk_int8: bool = False) -> torch.Tensor:
    """Plain block-sparse attention over the selection ``idx`` (int
    [B*H, nQb, top_k]), one q-block at a time over its gathered keys.
    q: [B, Sq, H, D]; k, v: [B, Sk, H, D] -> o [B, Sq, H, D] in q's dtype.

    16-bit arithmetic (the kernel's): S = (q k^T) * scale in fp32, masked
    keys set to -1e30, p = exp(S - max) with masked p set to 0, l = sum p,
    P rounded to v's dtype before P V, o = PV / l (l = 0 gives o = 0).
    ``qk_int8``: q and k quantized per (token, head) (``_quantize_tokens``),
    S = (int32(q_i8 k_i8^T) * (q_scale * scale)) * k_scale, and
    p = bf16(exp(bf16(S - max))) with l summed in fp32 from the bf16 p.
    The max is the row's maximum over all its selected keys (the kernel
    keeps a running maximum; the two differ only by rounding)."""
    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    if scale is None:
        scale = D ** -0.5
    bound = Sk if kv_valid is None else max(0, min(Sk, int(kv_valid)))
    nQb, top_k = idx.shape[1], idx.shape[2]
    if qk_int8:
        (qi, qs), (ki, ks) = _quantize_tokens(q), _quantize_tokens(k)
        qh, kh = _heads_first(qi).float(), _heads_first(ki).float()
        qsh, ksh = _heads_first(qs)[..., 0], _heads_first(ks)[..., 0]
    else:
        qh, kh = _heads_first(q), _heads_first(k)
    vh = _heads_first(v)
    BH = B * H
    out = torch.empty((BH, Sq, D), dtype=q.dtype, device=q.device)
    tok = torch.arange(block_k, device=q.device)
    for i in range(nQb):
        r0, r1 = i * block_q, min(Sq, (i + 1) * block_q)
        keys = (idx[:, i, :, None].long() * block_k + tok).reshape(BH, top_k * block_k)
        valid = keys < bound
        keys = keys.clamp(0, max(Sk - 1, 0))
        gather = lambda t: torch.gather(t, 1, keys[..., None].expand(-1, -1, t.shape[-1]))
        kg, vg = gather(kh), gather(vh)
        s = torch.bmm(qh[:, r0:r1].float(), kg.float().transpose(1, 2))
        if qk_int8:
            ksg = torch.gather(ksh, 1, keys)
            s = s * (qsh[:, r0:r1, None] * scale) * ksg[:, None, :]
        else:
            s = s * scale
        s = s.masked_fill(~valid[:, None, :], NEG_INF)
        m = s.amax(dim=-1, keepdim=True)
        if qk_int8:
            p = torch.exp((s - m).to(torch.bfloat16))
            p = p.masked_fill(~valid[:, None, :], 0.0).float()
        else:
            p = torch.exp(s - m).masked_fill(~valid[:, None, :], 0.0)
        l = p.sum(dim=-1, keepdim=True)
        pv = torch.bmm(p.to(v.dtype).float(), vg.float())
        out[:, r0:r1] = (pv / torch.where(l == 0.0, torch.ones_like(l), l)).to(q.dtype)
    return out.reshape(B, H, Sq, D).transpose(1, 2)


# ---------------------------------------------------------------------------
# Binding and launches
# ---------------------------------------------------------------------------

_PTR, _INT, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# x, out, B, S, HD, bs, nb, dtype, x_bs, x_ts, stream
_SUM_ARGTYPES = [_PTR, _PTR] + [_INT] * 6 + [_I64] * 2 + [_PTR]
# q, k, v, qs, ks, idx, o, B, H, Sq, Sk, D, dtype, qk_int8, 6 byte
# strides, nQb, top_k, block_q, block_k, bound, ks_ld, scale, stream
_FWD_ARGTYPES = ([_PTR] * 7 + [_INT] * 7 + [_I64] * 6 + [_INT] * 6
                 + [ctypes.c_float, _PTR])


def load_library(source: str = SOURCE) -> str:
    """Build ``source`` if needed and bind its two entry points; every
    later launch uses them. Returns the library's path."""
    global _lib
    path = fa.build_libraries((source,))[0][0]
    lib = ctypes.CDLL(path)
    if not (hasattr(lib, "lc_bsa_block_sum") and hasattr(lib, "lc_bsa_fwd")):
        raise RuntimeError(f"{source} exports no block-sparse entry point")
    lib.lc_bsa_block_sum.argtypes = _SUM_ARGTYPES
    lib.lc_bsa_fwd.argtypes = _FWD_ARGTYPES
    lib.lc_bsa_block_sum.restype = lib.lc_bsa_fwd.restype = ctypes.c_int
    _lib = lib
    return path


def _library():
    if _lib is None:
        load_library(SOURCE)
    return _lib


def _key_scales(ks: torch.Tensor) -> Tuple[torch.Tensor, int]:
    """[B, Sk, H, 1] fp32 key scales -> ([B*H, ld] rows, one per (b, h),
    key j at column j, ld = Sk rounded up to 4 so a row is a multiple of
    16 bytes: the layout a TMA box can take), ld."""
    B, Sk, H = ks.shape[:3]
    ld = _cdiv(Sk, 4) * 4
    rows = ks[..., 0].permute(0, 2, 1).reshape(B * H, Sk)
    return torch.nn.functional.pad(rows, (0, ld - Sk)).contiguous(), ld


def _check_rows(name: str, x: torch.Tensor) -> None:
    """[H, D] rows contiguous and 16-byte aligned (the kernels read 16
    bytes per thread)."""
    esz = x.element_size()
    D = x.shape[-1]
    if x.stride(-1) != 1 or x.stride(-2) != D:
        raise ValueError(f"bsa kernels: {name} must have contiguous [H, D] rows, "
                         f"got strides {tuple(x.stride())}")
    if (x.stride(0) * esz) % 16 or (x.stride(1) * esz) % 16 or x.data_ptr() % 16 \
            or (D * esz) % 16:
        raise ValueError(f"bsa kernels: {name} needs 16-byte aligned rows "
                         f"(strides {tuple(x.stride())}, ptr {x.data_ptr()})")


def _kernel_block_sum(x: torch.Tensor, bs: int) -> torch.Tensor:
    """Launch csrc/bsa.cu's block sum on the current stream."""
    global bsa_block_sum_launches
    B, S, H, D = x.shape
    if x.dtype not in fa._KERNEL_DTYPES:
        raise TypeError(f"bsa_block_sum takes bf16 or fp16, got {x.dtype}")
    if bs <= 0:
        raise ValueError(f"bsa_block_sum: block size {bs}")
    _check_rows("x", x)
    nb = _cdiv(S, bs)
    out = torch.empty((B, nb, H, D), dtype=torch.float32, device=x.device)
    if B * nb * H * D == 0:
        return out.zero_()
    if nb > 65535 or B > 65535:
        raise ValueError(f"bsa_block_sum: grid ({nb}, {B}) too large")
    lib = _library()
    with torch.cuda.device(x.device):
        rc = lib.lc_bsa_block_sum(x.data_ptr(), out.data_ptr(), B, S, H * D, bs, nb,
                                  fa._KERNEL_DTYPES[x.dtype], x.stride(0), x.stride(1),
                                  torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"bsa_block_sum launch failed: cudaError {rc}")
    bsa_block_sum_launches += 1
    return out


def _kernel_bsa(q, k, v, idx, block_q: int, block_k: int, kv_valid: Optional[int],
                scale: float, qk_int8: bool) -> torch.Tensor:
    """Launch csrc/bsa.cu's gathered attention (16-bit, or with int8
    QK^T after ``quantize_qk``). Raises on any input the kernel does not
    take."""
    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    if q.dtype not in fa._KERNEL_DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"bsa_fwd takes one dtype of bf16 or fp16, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if D not in fa.HEAD_DIMS:
        raise ValueError(f"bsa_fwd takes head_dim in {fa.HEAD_DIMS}, got {D}")
    if k.shape != (B, Sk, H, D) or v.shape != k.shape:
        raise ValueError(f"bsa_fwd: shape mismatch q {tuple(q.shape)} "
                         f"k {tuple(k.shape)} v {tuple(v.shape)}")
    nQb = _cdiv(Sq, block_q)
    if block_q % 32 or block_k <= 0:
        raise ValueError(f"bsa_fwd: block_q {block_q} must be a multiple of 32, "
                         f"block_k {block_k} positive")
    if (idx.dtype != torch.int32 or idx.dim() != 3 or idx.shape[:2] != (B * H, nQb)
            or not idx.is_contiguous()):
        raise ValueError(f"bsa_fwd: idx must be contiguous int32 [{B * H}, {nQb}, "
                         f"top_k], got {idx.dtype} {tuple(idx.shape)}")
    if not (q.device == k.device == v.device == idx.device):
        raise ValueError("bsa_fwd: q, k, v, idx must be on one device")
    if B * H > 65535:
        raise ValueError(f"bsa_fwd: B*H = {B * H} exceeds the grid limit")
    if qk_int8:
        return _launch_bsa(*quantize_qk(q, k), v, idx, block_q, block_k, kv_valid, scale)
    return _launch_bsa(q, None, k, None, 0, v, idx, block_q, block_k, kv_valid, scale)


def quantize_qk(q: torch.Tensor, k: torch.Tensor):
    """q, k [B, S, H, D] -> (int8 q, fp32 query scales [B, Sq, H], int8
    k, key scales as ``_key_scales`` rows, their row length): what the
    int8-QK kernel reads, made with plain tensor ops outside it, as the
    reference does."""
    (q8, qs), (k8, ks) = _quantize_tokens(q), _quantize_tokens(k)
    return (q8, qs[..., 0].contiguous(), k8, *_key_scales(ks))


def _launch_bsa(q, qs, k, ks, ks_ld: int, v, idx, block_q: int, block_k: int,
                kv_valid: Optional[int], scale: float) -> torch.Tensor:
    """One launch of csrc/bsa.cu's gathered attention on checked inputs:
    16-bit q, k (qs, ks None), or int8 q, k with their scales."""
    global bsa_launches, bsa_int8_launches
    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    qk_int8 = qs is not None
    nQb, top_k = idx.shape[1], idx.shape[2]
    o = torch.empty((B, Sq, H, D), dtype=v.dtype, device=v.device)
    if B * H * Sq == 0:
        return o
    if Sk == 0:  # no key: o = 0, and no tensor map of 0 rows
        return o.zero_()
    maps = [fa.tma_map_args(x, name=n) for n, x in (("q", q), ("k", k), ("v", v))]
    strides = [m["strides"][i] for m in maps for i in (2, 1)]  # bs, ts of q, k, v
    bound = Sk if kv_valid is None else max(0, min(Sk, int(kv_valid)))
    lib = _library()
    with torch.cuda.device(q.device):
        rc = lib.lc_bsa_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            0 if qs is None else qs.data_ptr(), 0 if ks is None else ks.data_ptr(),
            idx.data_ptr(), o.data_ptr(), B, H, Sq, Sk, D,
            fa._KERNEL_DTYPES[v.dtype], int(qk_int8), *strides,
            nQb, top_k, block_q, block_k, bound, ks_ld, float(scale),
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"bsa_fwd{'_qk_int8' if qk_int8 else ''} launch failed: "
                           f"cudaError {rc}")
    if qk_int8:
        bsa_int8_launches += 1
    else:
        bsa_launches += 1
    return o


# ---------------------------------------------------------------------------
# Public entries
# ---------------------------------------------------------------------------


def _block_sum(x: torch.Tensor, bs: int) -> torch.Tensor:
    """[B, S, H, D] -> fp32 [B, ceil(S/bs), H, D] token-block sums: the
    kernel for a CUDA tensor, the plain version for a CPU tensor."""
    if not x.is_cuda:
        return block_sum_reference(x, bs)
    return _kernel_block_sum(x, bs)


def select_blocks(q: torch.Tensor, k: torch.Tensor, *, block_q: int, block_k: int,
                  top_k: int, num_cond_tokens: int = 0, q_token_offset: int = 0,
                  kv_valid: Optional[int] = None) -> torch.Tensor:
    """-> int32 [B*H, nQb, top_k] selected k-block indices, sorted.

    ``q_token_offset`` is the global position of q[0] (decode: the number
    of cached conditioning tokens). Blocks that start at or past
    ``kv_valid`` are demoted after the force-keep, so a padded q-block's
    forced diagonal can be dropped (its outputs are discarded)."""
    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    nQb, nKb = _cdiv(Sq, block_q), _cdiv(Sk, block_k)
    if top_k > nKb:
        raise ValueError(f"top_k {top_k} > {nKb} k-blocks")

    def pool(x, bs, nb):
        cnt = (x.shape[1] - torch.arange(nb, device=x.device) * bs).clamp(0, bs)
        return _block_sum(x, bs) / cnt.float().clamp_min(1.0)[None, :, None, None]

    qb, kb = pool(q, block_q, nQb), pool(k, block_k, nKb)
    scores = torch.einsum("bqhd,bkhd->bhqk", qb, kb)  # [B, H, nQb, nKb] fp32
    kb_idx = torch.arange(nKb, device=q.device)
    n_cond_blocks = _cdiv(num_cond_tokens, block_k) if num_cond_tokens else 0
    diag = (q_token_offset + torch.arange(nQb, device=q.device) * block_q) // block_k
    keep = (kb_idx[None, :] < n_cond_blocks) | (kb_idx[None, :] == diag[:, None])
    scores = scores.masked_fill(keep[None, None], _BIG)
    if kv_valid is not None:
        scores = scores.masked_fill((kb_idx * block_k >= int(kv_valid))[None, None, None],
                                    -_BIG)
    # a stable descending sort keeps the lower index first among equal
    # scores (forced blocks all score 3e38), as lax.top_k does
    order = torch.sort(scores, dim=-1, descending=True, stable=True).indices[..., :top_k]
    idx = torch.sort(order, dim=-1).values
    return idx.reshape(B * H, nQb, top_k).to(torch.int32).contiguous()


def bsa_forward(q, k, v, idx, *, block_q: int, block_k: int,
                kv_valid: Optional[int] = None, scale: Optional[float] = None,
                qk_int8: bool = False) -> torch.Tensor:
    """Attention over the selection ``idx``: the kernel for CUDA tensors
    (``bsa_fwd``, or ``bsa_fwd_qk_int8``), ``bsa_reference`` for CPU
    tensors."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if not q.is_cuda:
        return bsa_reference(q, k, v, idx, block_q=block_q, block_k=block_k,
                             kv_valid=kv_valid, scale=scale, qk_int8=qk_int8)
    return _kernel_bsa(q, k, v, idx, block_q, block_k, kv_valid, scale, qk_int8)


def clamp_top_k(top_k: int, Sk: int, block_k: int, num_cond_tokens: int) -> int:
    """The forced set (cond-prefix blocks + the diagonal) must fit in
    top_k, or the cond attention stops being exact: clamp up, at most
    all blocks."""
    n_cond_blocks = _cdiv(num_cond_tokens, block_k) if num_cond_tokens else 0
    return min(_cdiv(Sk, block_k), max(top_k, n_cond_blocks + 1))


def bsa_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, top_k: int,
                  block_q: int = 512, block_k: int = 512, num_cond_tokens: int = 0,
                  q_token_offset: Optional[int] = None, scale: Optional[float] = None,
                  kv_valid: Optional[int] = None, qk_int8: bool = False) -> torch.Tensor:
    """Block-sparse decode attention: selection, then the gathered
    attention. q: [B, Sq, H, D]; k, v: [B, Sk, H, D] -> [B, Sq, H, D].
    The queries follow the keys' cache (``q_token_offset`` defaults to
    Sk - Sq); conditioning-prefix key blocks are always kept.
    ``qk_int8`` quantizes q and k for QK^T only: the selection scores the
    original tensors and PV stays 16-bit."""
    with span("op.bsa"):
        Sq, Sk = q.shape[1], k.shape[1]
        if q_token_offset is None:
            q_token_offset = Sk - Sq
        top_k = clamp_top_k(top_k, Sk, block_k, num_cond_tokens)
        idx = select_blocks(q, k, block_q=block_q, block_k=block_k, top_k=top_k,
                            num_cond_tokens=num_cond_tokens,
                            q_token_offset=q_token_offset, kv_valid=kv_valid)
        return bsa_forward(q, k, v, idx, block_q=block_q, block_k=block_k,
                           kv_valid=kv_valid, scale=scale, qk_int8=qk_int8)


def decode_top_k(n_kb: int, keep_ratio: float, min_blocks: int) -> int:
    """Blocks kept per q-block at a keep ratio (the reference DiT's rule):
    ceil(n_kb * keep_ratio), at least ``min_blocks``, at most n_kb."""
    return min(n_kb, max(min_blocks, math.ceil(n_kb * keep_ratio)))
