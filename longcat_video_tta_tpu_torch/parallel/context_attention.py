"""Context-parallel self-attention over the token axis (counterpart of
``longcat_video_tta_tpu/parallel/context_attention.py``).

Video tokens shard contiguously over the mesh's context axis: rank r of
P holds global tokens [r * S / P, (r + 1) * S / P) of q, k and v. The
conditioning-prefix rule and the key bound ``kv_valid`` are applied to
global indices, so they hold across shards.

- ``ring_self_attention``: ring flash attention. K/V chunks rotate around
  the ring (rank j sends to j - 1) while each rank runs the B1 chunk
  launch (``ops/flash_attention.flash_chunk_fwd``) of its queries against
  the chunk it holds, combining the (o, lse) partials with logaddexp.
  The backward is a second ring: dQ accumulates locally, each chunk's
  fp32 dK/dV accumulators travel with it and are home after P
  rotations (the B3 and B2 chunk launches). CUDA tensors launch the
  kernels, CPU tensors run their plain versions; there is no other
  fallback.
- ``cp_self_attention``: the all-gather formulation, O(S) K/V per rank:
  the oracle the ring is held against.

The cached decode's keys are [cond cache; noise] in global order, each
part sharded on its own (rank r holds cache tokens r * Sc / P ... and
noise tokens r * Sn / P ...). Concatenated locally they would not be one
contiguous range of the global order, so the cache rides as a second
piece of every chunk: each ring step launches the cache piece and the
noise piece, each with its own global offset, and a global ``kv_valid``
(bucketing) masks the right keys.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..ops.flash_attention import (
    NEG_INF,
    attention_reference,
    flash_chunk_dkv,
    flash_chunk_dq,
    flash_chunk_fwd,
)
from .collectives import gather_from_group, group_rank, group_size, ring_shift


def _context_group(mesh):
    """The context axis' process group of a ``Mesh``, or ``mesh`` itself
    when it is already a group (None: one rank)."""
    return mesh.group("context") if hasattr(mesh, "group") else mesh


def _combine(o_acc, lse_acc, o_i, lse_i):
    lse_new = torch.logaddexp(lse_acc, lse_i)
    o_acc = (o_acc * torch.exp(lse_acc - lse_new)[..., None]
             + o_i.float() * torch.exp(lse_i - lse_new)[..., None])
    return o_acc, lse_new


class _Ring(torch.autograd.Function):
    """The ring forward and its exact backward (the reference's
    ``_ring_core`` custom VJP). ``pieces``: the number of key pieces, each
    a (k, v) pair of the inputs after q, with its global base in
    ``bases``."""

    @staticmethod
    def forward(ctx, group, ncond, scale, kv_valid, bases, q, *kv):
        n, me = group_size(group), group_rank(group)
        pieces = [(kv[2 * i], kv[2 * i + 1]) for i in range(len(kv) // 2)]
        B, Sq, H, D = q.shape
        q_off = me * Sq
        o = torch.zeros((B, Sq, H, D), dtype=torch.float32, device=q.device)
        lse = torch.full((B, Sq, H), NEG_INF, dtype=torch.float32, device=q.device)
        cur = [t for p in pieces for t in p]
        for i in range(n):
            src = (me + i) % n
            for j, base in enumerate(bases):
                k, v = cur[2 * j], cur[2 * j + 1]
                o_i, lse_i = flash_chunk_fwd(q, k, v, q_off, base + src * k.shape[1],
                                             num_cond_tokens=ncond, scale=scale,
                                             kv_valid=kv_valid)
                o, lse = _combine(o, lse, o_i, lse_i)
            if i < n - 1:  # the last chunk's rotation would feed nothing
                cur = ring_shift(cur, group)
        o = o.to(q.dtype)
        ctx.save_for_backward(q, o, lse, *kv)
        ctx.cfg = (group, ncond, scale, kv_valid, bases)
        return o, lse

    @staticmethod
    def backward(ctx, do, _dlse):
        group, ncond, scale, kv_valid, bases = ctx.cfg
        q, o, lse, *kv = ctx.saved_tensors
        n, me = group_size(group), group_rank(group)
        q_off = me * q.shape[1]
        do = do.contiguous()
        delta = (do.float() * o.float()).sum(-1)
        need_kv = any(ctx.needs_input_grad[6:])
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        cur = list(kv)
        acc = [torch.zeros(t.shape, dtype=torch.float32, device=t.device) for t in kv] \
            if need_kv else []
        for i in range(n):
            src = (me + i) % n
            for j, base in enumerate(bases):
                k, v = cur[2 * j], cur[2 * j + 1]
                k_off = base + src * k.shape[1]
                kw = dict(num_cond_tokens=ncond, scale=scale, kv_valid=kv_valid)
                dq += flash_chunk_dq(q, k, v, do, lse, delta, q_off, k_off, **kw).float()
                if need_kv:
                    dk, dv = flash_chunk_dkv(q, k, v, do, lse, delta, q_off, k_off, **kw)
                    acc[2 * j] += dk.float()
                    acc[2 * j + 1] += dv.float()
            if n > 1:
                # the accumulators travel with their chunk and are home
                # after n rotations; the chunks themselves need n - 1
                if i < n - 1:
                    moved = ring_shift(cur + acc, group)
                    cur, acc = moved[:len(cur)], moved[len(cur):]
                elif need_kv:
                    acc = ring_shift(acc, group)
        grads = [a.to(t.dtype) for a, t in zip(acc, kv)] if need_kv else [None] * len(kv)
        return (None, None, None, None, None, dq.to(q.dtype), *grads)


def ring_self_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mesh, *,
                        num_cond_tokens: int = 0, scale: Optional[float] = None,
                        kv_valid: Optional[int] = None,
                        cache: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                        return_lse: bool = False):
    """Ring flash attention of q, k, v [B, S_local, H, D], token-sharded
    over the context axis of ``mesh`` (a ``Mesh`` or its context group).
    Sq may differ from Sk (decode); then no query is a conditioning query
    and the prefix rule is dropped, as in ``flash_attention``.
    ``cache``: (k, v) shards of keys that come before ``k`` in the global
    order (the decode's cond cache), run as a second piece of each chunk.
    ``kv_valid``: the global key bound (bucketing). Returns o [B, S_local,
    H, D] in q's dtype (and the fp32 lse [B, S_local, H] with
    ``return_lse``)."""
    group = _context_group(mesh)
    n = group_size(group)
    if scale is None:
        scale = q.shape[-1] ** -0.5
    kv = [k, v]
    bases = [0]
    sk_global = n * k.shape[1]
    if cache is not None:
        sc_global = n * cache[0].shape[1]
        kv = [cache[0].to(k.dtype), cache[1].to(v.dtype), k, v]
        bases = [0, sc_global]
        sk_global += sc_global
    ncond = int(num_cond_tokens) if n * q.shape[1] == sk_global else 0
    o, lse = _Ring.apply(group, ncond, float(scale),
                         None if kv_valid is None else int(kv_valid), tuple(bases), q, *kv)
    return (o, lse) if return_lse else o


def cp_self_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mesh, *,
                      num_cond_tokens: int = 0, scale: Optional[float] = None,
                      kv_valid: Optional[int] = None) -> torch.Tensor:
    """The all-gather oracle: each rank gathers the whole K/V and runs the
    plain attention of its queries at their global offset."""
    group = _context_group(mesh)
    kg = gather_from_group(k, group, 1)
    vg = gather_from_group(v, group, 1)
    ncond = int(num_cond_tokens) if q.shape[1] * group_size(group) == kg.shape[1] else 0
    q_off = group_rank(group) * q.shape[1]
    if ncond > 0 or kv_valid is not None:
        return _masked_reference(q, kg, vg, ncond, kv_valid, scale, q_off)
    return attention_reference(q, kg, vg, scale=scale)[0]


def _masked_reference(q, k, v, ncond, kv_valid, scale, q_off):
    """Plain attention of local queries at ``q_off`` against the whole
    K/V under the global prefix rule and key bound (the prefix rule
    applies to the rectangular local block, which the square-only guard
    of ``attention_reference`` would drop)."""
    from ..ops.flash_attention import _allowed_mask

    B, Sq, H, D = q.shape
    if scale is None:
        scale = D ** -0.5
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    allowed = _allowed_mask(Sq, k.shape[1], ncond, kv_valid, q_off, 0, q.device)
    if allowed is not None:
        s = s.masked_fill(~allowed, NEG_INF)
    p = torch.softmax(s, dim=-1)
    if allowed is not None:
        p = p.masked_fill(~allowed, 0.0)
    return torch.einsum("bhqk,bkhd->bqhd", p, v.float()).to(q.dtype)


def shard_tokens(x: torch.Tensor, mesh, dim: int = 1) -> torch.Tensor:
    """This rank's contiguous shard of ``x`` along ``dim`` (the token
    axis), a view."""
    group = _context_group(mesh)
    n = group_size(group)
    if x.shape[dim] % n:
        raise ValueError(f"{x.shape[dim]} tokens do not shard over {n} context ranks")
    m = x.shape[dim] // n
    return x.narrow(dim, group_rank(group) * m, m)

