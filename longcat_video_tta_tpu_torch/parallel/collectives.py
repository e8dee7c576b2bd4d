"""The explicit collectives of the mesh (the reference lets XLA insert
them from sharding annotations): all-reduce (sum, max), all-gather along
a dimension, the ring's send/receive, and Megatron's f/g pair as
autograd functions.

A ``group`` of None is an axis of size 1: every operation is then the
identity. Under gloo every CUDA tensor goes through a pinned host buffer:
gloo has no CUDA all-gather, send or receive, and its CUDA all-reduce
stages through host memory itself. The choice is made by the group's
backend, before the operation, and nothing runs on the CPU unasked.

Gloo moves a message over one TCP stream per pair of ranks. The all-reduce
and the ring's rotation cut a message of ``STRIPE_MIN_BYTES`` or more into
pieces, one on each of the group's stripes (``add_stripes``: process
groups over the same ranks, made with the mesh), all in flight at once;
the sum of each element is the same as without stripes at two ranks.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import torch
import torch.distributed as dist

_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}
STRIPES = 4
STRIPE_MIN_BYTES = 1 << 20
_stripes: Dict[object, List[object]] = {}


def add_stripes(group, stripes: Sequence) -> None:
    """Carry ``group``'s large gloo messages over ``group`` and
    ``stripes`` (process groups over the same ranks) at once."""
    _stripes[group] = [group, *stripes]


def _pieces(x: torch.Tensor, group) -> list:
    """(group, piece) pairs of the contiguous ``x``: one per stripe of
    ``group`` when ``x`` is large enough, else ``x`` whole on ``group``."""
    groups = _stripes.get(group, [group])
    if len(groups) == 1 or x.numel() * x.element_size() < STRIPE_MIN_BYTES:
        return [(group, x)]
    return list(zip(groups, x.view(-1).chunk(len(groups))))


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def group_rank(group) -> int:
    return 0 if group is None else dist.get_rank(group)


def _staged(x: torch.Tensor, group) -> bool:
    """True when ``x`` goes through host memory for ``group``: a CUDA
    tensor under gloo."""
    return x.is_cuda and dist.get_backend(group) == "gloo"


def _host(x: torch.Tensor) -> torch.Tensor:
    h = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    h.copy_(x)
    return h


def all_reduce(x: torch.Tensor, group, op: str = "sum") -> torch.Tensor:
    """The ``op`` ("sum" or "max") of ``x`` over ``group``, as a new
    tensor on ``x``'s device (no autograd)."""
    if group is None:
        return x
    buf = _host(x) if _staged(x, group) else x.detach().clone().contiguous()
    works = [dist.all_reduce(piece, op=_OPS[op], group=g, async_op=True)
             for g, piece in _pieces(buf, group)]
    for w in works:
        w.wait()
    return buf.to(x.device, non_blocking=False) if buf.device != x.device else buf


def all_gather(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The group's ``x`` concatenated along ``dim`` in group-rank order (no
    autograd); every rank's ``x`` has one shape."""
    if group is None:
        return x
    n = group_size(group)
    src = _host(x) if _staged(x, group) else x.detach().contiguous()
    bufs = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(bufs, src, group=group)
    out = torch.cat(bufs, dim=dim)
    return out.to(x.device) if out.device != x.device else out


def broadcast(x: torch.Tensor, group, src_rank: int = 0) -> torch.Tensor:
    """``x`` of the group's rank ``src_rank`` on every rank of ``group``."""
    if group is None:
        return x
    buf = _host(x) if _staged(x, group) else x.detach().clone().contiguous()
    dist.broadcast(buf, src=dist.get_global_rank(group, src_rank), group=group)
    return buf.to(x.device) if buf.device != x.device else buf


def ring_shift(tensors: Sequence[torch.Tensor], group) -> List[torch.Tensor]:
    """One rotation of the ring: this rank sends ``tensors`` to the group's
    rank i - 1 and receives its rank i + 1's (the reference's ``_ring_perm``:
    after one rotation rank m holds the chunk that was on m + 1). One
    ``batch_isend_irecv`` for all of them on each stripe of the group."""
    n = group_size(group)
    if n == 1:
        return list(tensors)
    me = group_rank(group)
    to = dist.get_global_rank(group, (me - 1) % n)
    frm = dist.get_global_rank(group, (me + 1) % n)
    staged = [_staged(t, group) for t in tensors]
    send = [_host(t) if s else t.contiguous() for t, s in zip(tensors, staged)]
    recv = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True) if s
            else torch.empty_like(t) for t, s in zip(send, staged)]
    ops: Dict[object, list] = {}
    for s_t, r_t in zip(send, recv):
        for (g, s_p), (_, r_p) in zip(_pieces(s_t, group), _pieces(r_t, group)):
            ops.setdefault(g, []).extend([dist.P2POp(dist.isend, s_p, to, g),
                                          dist.P2POp(dist.irecv, r_p, frm, g)])
    reqs = [req for batch in ops.values() for req in dist.batch_isend_irecv(batch)]
    for req in reqs:
        req.wait()
    return [r.to(t.device) if s else r for r, t, s in zip(recv, tensors, staged)]


def all_gather_object(obj, group=None) -> list:
    """Every rank's ``obj`` (picklable), in rank order; [obj] without a
    process group."""
    if not dist.is_initialized():
        return [obj]
    out = [None] * dist.get_world_size(group)
    dist.all_gather_object(out, obj, group=group)
    return out


def broadcast_object(obj, src: int = 0):
    """Rank ``src``'s ``obj`` on every rank; ``obj`` without a process
    group."""
    if not dist.is_initialized():
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=src)
    return box[0]


class _CopyToGroup(torch.autograd.Function):
    """Megatron's f: the identity forward, the sum of the group's
    gradients backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.group), None


class _ReduceFromGroup(torch.autograd.Function):
    """Megatron's g: the sum over the group forward, the identity
    backward."""

    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromGroup(torch.autograd.Function):
    """All-gather along ``dim`` forward; backward this rank's slice of the
    gradient, which every rank holds whole (what follows the gather runs
    the same on every rank)."""

    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim, ctx.n = group, dim, x.shape[dim]
        return all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        lo = group_rank(ctx.group) * ctx.n
        return g.narrow(ctx.dim, lo, ctx.n).contiguous(), None, None


def copy_to_group(x: torch.Tensor, group) -> torch.Tensor:
    """f: ``x`` as it is; its gradient summed over ``group``."""
    if group is None or not (torch.is_grad_enabled() and x.requires_grad):
        return x
    return _CopyToGroup.apply(x, group)


def reduce_from_group(x: torch.Tensor, group) -> torch.Tensor:
    """g: the sum of ``x`` over ``group``; the gradient passes as it is."""
    if group is None:
        return x
    if torch.is_grad_enabled() and x.requires_grad:
        return _ReduceFromGroup.apply(x, group)
    return all_reduce(x, group)


def gather_from_group(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The group's ``x`` concatenated along ``dim``; the gradient is
    sliced back (every rank holds it whole)."""
    if group is None:
        return x
    if torch.is_grad_enabled() and x.requires_grad:
        return _GatherFromGroup.apply(x, group, dim)
    return all_gather(x, group, dim)


def all_reduce_grads(grads: dict, group, mean: bool = False) -> dict:
    """Each gradient summed (or averaged) over ``group``: the gradient of a
    replicated tensor from each rank's share of the tokens or rows."""
    if group is None:
        return grads
    n = group_size(group)
    out = {}
    for k, g in grads.items():
        r = all_reduce(g, group)
        out[k] = r / n if mean else r
    return out

