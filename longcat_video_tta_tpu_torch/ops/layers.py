"""Primitive layers shared across models: norms, modulation, linear,
sinusoidal embeddings, 3D RoPE, and the per-block gradient-checkpoint
wrapper. Plain tensor functions; each computes in the same precision as
its reference counterpart (``longcat_video_tta_tpu/ops/layers.py``)."""

from __future__ import annotations

import math
from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from .quant import Int8Linear, int8_linear


def rms_norm(x: torch.Tensor, weight: Optional[torch.Tensor], eps: float = 1e-6):
    """RMSNorm over the last axis in fp32, optional learned scale."""
    dtype = x.dtype
    x = x.float()
    x = x * torch.rsqrt(x.square().mean(dim=-1, keepdim=True) + eps)
    if weight is not None:
        x = x * weight.float()
    return x.to(dtype)


def layer_norm(x: torch.Tensor, weight=None, bias=None, eps: float = 1e-6):
    """LayerNorm over the last axis in fp32; affine optional."""
    dtype = x.dtype
    x = F.layer_norm(x.float(), (x.shape[-1],),
                     None if weight is None else weight.float(),
                     None if bias is None else bias.float(), eps)
    return x.to(dtype)


def modulate(x: torch.Tensor, shift: torch.Tensor, scale: torch.Tensor):
    """adaLN modulation x * (1 + scale) + shift."""
    return x * (1.0 + scale) + shift


def linear(layer: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """Dense layer computed in x's dtype (weights cast as in the
    reference's ``linear``); an ``Int8Linear`` runs W8A8 (the reference
    dispatches on its 'kernel_i8' key)."""
    if isinstance(layer, Int8Linear):
        return int8_linear(layer, x)
    w = layer.weight.to(x.dtype)
    b = None if layer.bias is None else layer.bias.to(x.dtype)
    return F.linear(x, w, b)


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
    return F.linear(F.silu(F.linear(feats, w1.weight, w1.bias)), w2.weight, w2.bias)


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
    half = x.shape[-1] // 2
    xa, xb = x[..., :half], x[..., half:]
    c = cos[None, :, :, None, :].to(x.dtype)
    s = sin[None, :, :, None, :].to(x.dtype)
    return torch.cat([xa * c - xb * s, xb * c + xa * s], dim=-1)


def remat_wrap(body: Callable, remat: bool, policy: str = "full") -> Callable:
    """Per-block gradient checkpoint (the reference's ``remat_wrap``,
    :141): with ``policy="full"`` the block keeps only its inputs and is
    recomputed in the backward (``torch.utils.checkpoint``,
    non-reentrant, as the LongCat reference's torch checkpoint). The
    reference's "dots" / "dots_attn" policies, which also save matmul
    outputs and the flash o/lse, are not ported yet."""
    if not remat:
        return body
    if policy != "full":
        raise NotImplementedError(
            f"remat policy {policy!r} is not yet ported (only 'full' is)")

    def wrapped(*args, **kwargs):
        return torch.utils.checkpoint.checkpoint(body, *args, use_reentrant=False,
                                                 **kwargs)

    return wrapped
