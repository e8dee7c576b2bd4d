"""Primitive layers shared across models: norms, modulation, linear,
sinusoidal embeddings, 3D RoPE, and the per-block gradient-checkpoint
wrapper. Plain tensor functions; each computes in the same precision as
its reference counterpart (``longcat_video_tta_tpu/ops/layers.py``).

Lanes (``--video-parallel``): V videos' adapters train in one batch, the
lanes folded into the batch axis lane-minor (row r belongs to lane
r % V). A weight or adapter tensor then carries a leading lane axis, one
more axis than its own rank, and the functions here apply lane r % V to
row r (``lane_rows``); a tensor of its own rank applies to every row."""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from ..utils.spans import span
from .quant import Int8Linear, int8_linear, lora_term


def lane_rows(t: torch.Tensor, ndim: int, rows: int) -> torch.Tensor:
    """``t`` as per-row values for a batch of ``rows``: [1, *t.shape] when
    it has its own rank ``ndim``; with a leading lane axis ([V, *shape]),
    [rows, *shape] with row r taking lane r % V."""
    if t.ndim == ndim:
        return t[None]
    V = t.shape[0]
    if t.ndim != ndim + 1 or rows % V:
        raise ValueError(f"a tensor of rank {ndim} with lanes is [V, ...] with V "
                         f"dividing the batch; got {tuple(t.shape)} for {rows} rows")
    return t.repeat((rows // V,) + (1,) * ndim)


def _row_affine(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """A norm's [D] or lane [V, D] affine as a tensor that broadcasts
    against x [B, ..., D]."""
    r = lane_rows(w.float(), 1, x.shape[0])
    return r.reshape((r.shape[0],) + (1,) * (x.ndim - 2) + (r.shape[-1],))


def rms_norm(x: torch.Tensor, weight: Optional[torch.Tensor], eps: float = 1e-6):
    """RMSNorm over the last axis in fp32, optional learned scale (a lane
    scale [V, D] applies per row)."""
    with span("op.rms_norm"):
        dtype = x.dtype
        x = x.float()
        x = x * torch.rsqrt(x.square().mean(dim=-1, keepdim=True) + eps)
        if weight is not None:
            x = x * (weight.float() if weight.ndim == 1 else _row_affine(weight, x))
        return x.to(dtype)


def layer_norm(x: torch.Tensor, weight=None, bias=None, eps: float = 1e-6):
    """LayerNorm over the last axis in fp32; affine optional (a lane affine
    [V, D] applies per row, after the normalization)."""
    with span("op.layer_norm"):
        dtype = x.dtype
        if (weight is not None and weight.ndim > 1) or (bias is not None and bias.ndim > 1):
            x = F.layer_norm(x.float(), (x.shape[-1],), None, None, eps)
            if weight is not None:
                x = x * _row_affine(weight, x)
            if bias is not None:
                x = x + _row_affine(bias, x)
            return x.to(dtype)
        x = F.layer_norm(x.float(), (x.shape[-1],),
                         None if weight is None else weight.float(),
                         None if bias is None else bias.float(), eps)
        return x.to(dtype)


def modulate(x: torch.Tensor, shift: torch.Tensor, scale: torch.Tensor):
    """adaLN modulation x * (1 + scale) + shift."""
    with span("op.modulate"):
        return x * (1.0 + scale) + shift


def lane_linear(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor]):
    """F.linear with an [out, in] weight, or with lane weights [V, out, in]
    (the bias [out] or [V, out]): x [B, ..., in] is taken as [B / V, V, N, in] and
    multiplied lane by lane in one batched product."""
    if w.ndim == 2:
        return F.linear(x, w, b)
    V, out, K = w.shape
    B = x.shape[0]
    y = torch.matmul(x.reshape(B // V, V, -1, K), w.transpose(1, 2))
    if b is not None:
        y = y + (b if b.ndim == 1 else b[:, None, :])
    return y.reshape(x.shape[:-1] + (out,))


def linear(layer: nn.Module, x: torch.Tensor,
           lora: Optional[Dict[str, torch.Tensor]] = None,
           lora_scale=None) -> torch.Tensor:
    """Dense layer computed in x's dtype (weights cast as in the
    reference's ``linear``), plus the LoRA side branch when ``lora`` is
    given; an ``Int8Linear`` runs W8A8 (the reference dispatches on its
    'kernel_i8' key). Lane weights and lane LoRA pairs apply per row. A
    tensor-parallel linear (``layer.tp``, ``parallel/sharding.py``) runs
    its collectives here."""
    with span("op.linear"):
        tp = getattr(layer, "tp", None)
        if tp is not None:
            return _tp_linear(layer, tp, x, lora, lora_scale)
        if isinstance(layer, Int8Linear):
            return int8_linear(layer, x, lora=lora, lora_scale=lora_scale)
        w = layer.weight.to(x.dtype)
        b = None if layer.bias is None else layer.bias.to(x.dtype)
        y = lane_linear(x, w, b)
        if lora is not None:
            y = y + lora_term(x, lora, lora_scale)
        return y


def shared_in_group(t: Optional[torch.Tensor], layer: nn.Module):
    """``t`` through f over ``layer``'s tensor group (``layer.tp``): a
    replicated tensor used on head-sharded activations (a per-head norm
    scale) gets its gradient summed over the group. ``t`` as it is when
    ``layer`` is whole."""
    tp = getattr(layer, "tp", None)
    if t is None or tp is None:
        return t
    from ..parallel.collectives import copy_to_group

    return copy_to_group(t, tp.group)


def _tp_linear(layer, tp, x, lora, lora_scale):
    """A column- or row-parallel linear (Megatron's f and g): column
    modes take x whole through f and give this rank's output features
    (gathered whole for "col_gather"); "row" takes this rank's input
    features and sums the partial products over the group, adding the
    bias after the sum. A LoRA pair stays whole on every rank and passes
    through f: column modes keep b's columns of this rank's features, row
    adds (x_r a_r) b to the partial sum (sum_r x_r a_r = x a)."""
    from ..parallel.collectives import copy_to_group, gather_from_group, reduce_from_group

    g, idx = tp.group, tp.index.to(x.device)
    if lora is not None:
        a, b = copy_to_group(lora["a"], g), copy_to_group(lora["b"], g)
        lora = ({"a": a, "b": b.index_select(b.ndim - 1, idx)} if tp.mode != "row"
                else {"a": a.index_select(a.ndim - 2, idx), "b": b})
    if tp.mode == "row":
        if isinstance(layer, Int8Linear):  # the fp32 partials summed, then the bias
            y = reduce_from_group(int8_linear(layer, x, amax_group=g), g)
            if layer.bias is not None:
                y = y + layer.bias.float()
            y = y.to(x.dtype)
            if lora is not None:
                y = y + reduce_from_group(lora_term(x, lora, lora_scale), g)
            return y
        y = lane_linear(x, layer.weight.to(x.dtype), None)
        if lora is not None:
            y = y + lora_term(x, lora, lora_scale)
        y = reduce_from_group(y, g)
        return y if layer.bias is None else y + layer.bias.to(y.dtype)
    x = copy_to_group(x, g)
    if isinstance(layer, Int8Linear):
        y = int8_linear(layer, x, lora=lora, lora_scale=lora_scale)
    else:
        w = layer.weight.to(x.dtype)
        y = lane_linear(x, w, None if layer.bias is None else layer.bias.to(x.dtype))
        if lora is not None:
            y = y + lora_term(x, lora, lora_scale)
    return gather_from_group(y, g, -1) if tp.mode == "col_gather" else y


def timestep_embedding(t: torch.Tensor, dim: int, max_period: float = 10000.0):
    """Sinusoidal timestep features in fp32: [..., dim] = [cos | sin]."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32, device=t.device)
                      / half)
    args = t.float()[..., None] * freqs
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


def mlp_embedder(w1: nn.Linear, w2: nn.Linear, feats: torch.Tensor):
    """2-layer SiLU MLP (the fp32 t_embedder)."""
    return lane_linear(F.silu(lane_linear(feats, w1.weight, w1.bias)), w2.weight, w2.bias)


# ---------------------------------------------------------------------------
# 3D rotary position embedding
# ---------------------------------------------------------------------------


def rope_3d_angles(
    n_t: int, n_h: int, n_w: int,
    rope_dims: Tuple[int, int, int],
    theta: float = 10000.0,
    t_offset: int = 0,
    device=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables [n_t, n_h*n_w, head_dim//2] for factored (t, h, w)
    RoPE. ``t_offset`` shifts temporal positions (the KV-cache decode
    places noise frames after the conditioning frames)."""
    def axis_angles(n, d, offset=0):
        freqs = 1.0 / (theta ** (torch.arange(0, d, 2, dtype=torch.float32,
                                              device=device) / d))
        pos = torch.arange(n, dtype=torch.float32, device=device) + offset
        return pos[:, None] * freqs[None, :]

    dt, dh, dw = rope_dims
    at = axis_angles(n_t, dt, t_offset)[:, None, None, :].expand(n_t, n_h, n_w, dt // 2)
    ah = axis_angles(n_h, dh)[None, :, None, :].expand(n_t, n_h, n_w, dh // 2)
    aw = axis_angles(n_w, dw)[None, None, :, :].expand(n_t, n_h, n_w, dw // 2)
    ang = torch.cat([at, ah, aw], dim=-1).reshape(n_t, n_h * n_w, -1)
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor):
    """Half-split rotary embedding. x: [B, n_t, n_hw, heads, head_dim];
    cos/sin: [n_t, n_hw, head_dim//2] (cast to x's dtype first)."""
    with span("op.rope"):
        half = x.shape[-1] // 2
        xa, xb = x[..., :half], x[..., half:]
        c = cos[None, :, :, None, :].to(x.dtype)
        s = sin[None, :, :, None, :].to(x.dtype)
        return torch.cat([xa * c - xb * s, xb * c + xa * s], dim=-1)


REMAT_POLICIES = ("full", "dots", "dots_attn")


def remat_saved_ops(policy: str) -> Tuple:
    """The ops whose outputs a remat policy keeps for the backward:
      - "full": none (the block keeps only its inputs);
      - "dots": the un-batched matmuls, ``aten.mm`` and ``aten.addmm``
        (the linears), the reference's ``dots_with_no_batch_dims_saveable``:
        no ``bmm``;
      - "dots_attn": those and ``lc_port::flash_fwd``'s o and lse (the
        reference's "flash_out"/"flash_lse" names), so the backward never
        runs the attention forward again."""
    if policy not in REMAT_POLICIES:
        raise ValueError(f"unknown remat policy {policy!r}; one of {REMAT_POLICIES}")
    if policy == "full":
        return ()
    dots = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)
    if policy == "dots":
        return dots
    from . import flash_attention  # registers lc_port::flash_fwd

    return dots + (flash_attention.flash_fwd_op._opoverload,)


def remat_wrap(body: Callable, remat: bool, policy: str = "full") -> Callable:
    """Per-block gradient checkpoint (the reference's ``remat_wrap``,
    :141), non-reentrant ``torch.utils.checkpoint`` as the LongCat
    reference's torch checkpoint. ``policy="full"`` keeps only the block's
    inputs and recomputes the block in the backward; "dots" and
    "dots_attn" keep the outputs of ``remat_saved_ops(policy)`` through a
    selective checkpoint context, and the recompute returns those instead
    of running them again."""
    if not remat:
        return body
    saved = remat_saved_ops(policy)
    if not saved:
        def wrapped(*args, **kwargs):
            return torch.utils.checkpoint.checkpoint(body, *args, use_reentrant=False,
                                                     **kwargs)

        return wrapped

    from torch.utils.checkpoint import CheckpointPolicy, \
        create_selective_checkpoint_contexts

    def choose(ctx, op, *args, **kwargs):
        return (CheckpointPolicy.MUST_SAVE if op in saved
                else CheckpointPolicy.PREFER_RECOMPUTE)

    def wrapped(*args, **kwargs):
        return torch.utils.checkpoint.checkpoint(
            body, *args, use_reentrant=False,
            context_fn=lambda: create_selective_checkpoint_contexts(choose), **kwargs)

    return wrapped
