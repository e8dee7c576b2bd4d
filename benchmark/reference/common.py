"""Plain float32 building blocks of the references: no kernel, no cache,
no batching trick, nothing of the program under test.

Every product runs in float32 with TF32 off (``fp32_matmuls``). With
``lowp`` the operands of every product (both sides of a linear; q, k and v
of an attention) are rounded to float8 e4m3 with one scale per row first:
the precision below bf16 that a later change could be tempted to take,
run as the control of the correctness check.
"""

from __future__ import annotations

import contextlib
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

FP8_MAX = 448.0  # largest finite float8 e4m3fn


@contextlib.contextmanager
def fp32_matmuls():
    """Full float32 products inside: TF32 off for cuBLAS and cuDNN."""
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
            torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev[:2]
        torch.set_float32_matmul_precision(prev[2])


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 with one scale per row of the last axis
    (absmax to 448), back in float32."""
    x = x.float()
    scale = x.abs().amax(dim=-1, keepdim=True).clamp_min(1e-30) / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


def linear(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor],
           lowp: bool = False) -> torch.Tensor:
    """x @ w.T + b in float32 (w [out, in])."""
    w = w.float()
    x = x.float()
    if lowp:
        x, w = fp8_round(x), fp8_round(w)
    return F.linear(x, w, None if b is None else b.float())


def layer_norm(x, weight=None, bias=None, eps: float = 1e-6):
    return F.layer_norm(x.float(), (x.shape[-1],), None if weight is None else weight.float(),
                        None if bias is None else bias.float(), eps)


def rms_norm(x, weight, eps: float = 1e-6):
    x = x.float()
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * weight.float()


def timestep_embedding(t: torch.Tensor, dim: int, max_period: float = 10000.0):
    """[..., dim] = [cos | sin] of t times the geometric frequencies."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32, device=t.device) / half)
    args = t.float()[..., None] * freqs
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


def rope_tables(n_t: int, n_h: int, n_w: int, dims: Tuple[int, int, int], theta: float,
                t_offset: int = 0, device=None):
    """cos, sin [n_t * n_h * n_w, head_dim / 2]: factored (t, h, w)
    angles, token order t-major, then h, then w."""
    def axis(n, d, off=0):
        freqs = 1.0 / theta ** (torch.arange(0, d, 2, dtype=torch.float32, device=device) / d)
        return (torch.arange(n, dtype=torch.float32, device=device) + off)[:, None] * freqs

    dt, dh, dw = dims
    at = axis(n_t, dt, t_offset)[:, None, None, :].expand(n_t, n_h, n_w, dt // 2)
    ah = axis(n_h, dh)[None, :, None, :].expand(n_t, n_h, n_w, dh // 2)
    aw = axis(n_w, dw)[None, None, :, :].expand(n_t, n_h, n_w, dw // 2)
    ang = torch.cat([at, ah, aw], dim=-1).reshape(n_t * n_h * n_w, -1)
    return torch.cos(ang), torch.sin(ang)


def rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Half-split rotation of x [B, S, H, D] by cos, sin [S, D / 2]."""
    half = x.shape[-1] // 2
    a, b = x[..., :half], x[..., half:]
    c, s = cos[None, :, None, :], sin[None, :, None, :]
    return torch.cat([a * c - b * s, b * c + a * s], dim=-1)


def allowed_mask(Sq: int, Sk: int, ncond: int, device) -> Optional[torch.Tensor]:
    """[Sq, Sk] bool, the conditioning-prefix rule of a square input:
    query i sees key j when i >= ncond or j < ncond; None when all pass."""
    if ncond <= 0 or Sq != Sk or ncond >= Sq:
        return None
    i = torch.arange(Sq, device=device)[:, None]
    j = torch.arange(Sk, device=device)[None, :]
    return (i >= ncond) | (j < ncond)


# bytes of one head group's fp32 score matrix (B x group x Sq x Sk)
SCORE_BYTES = 2 ** 31


def _groups(B: int, H: int, Sq: int, Sk: int):
    per_head = B * Sq * Sk * 4
    g = max(1, min(H, SCORE_BYTES // max(per_head, 1)))
    return [slice(h, min(H, h + g)) for h in range(0, H, g)]


def _scores(q, k, scale, mask):
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    if mask is not None:
        s = s.masked_fill(~mask, float("-inf"))
    return s


class _Attention(torch.autograd.Function):
    """Softmax attention over head groups, so that one group's scores
    exist at a time; the backward recomputes them from the saved
    log-sum-exp (the textbook gradient, in float32)."""

    @staticmethod
    def forward(ctx, q, k, v, ncond, scale):
        B, Sq, H, D = q.shape
        Sk = k.shape[1]
        mask = allowed_mask(Sq, Sk, ncond, q.device)
        o = torch.empty_like(q)
        lse = torch.empty((B, H, Sq), dtype=q.dtype, device=q.device)
        for sl in _groups(B, H, Sq, Sk):
            s = _scores(q[:, :, sl], k[:, :, sl], scale, mask)
            m = torch.logsumexp(s, dim=-1)
            lse[:, sl] = m
            p = torch.exp(s - m[..., None])
            del s
            o[:, :, sl] = torch.einsum("bhqk,bkhd->bqhd", p, v[:, :, sl])
            del p
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.ncond, ctx.scale = ncond, scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        B, Sq, H, D = q.shape
        Sk = k.shape[1]
        mask = allowed_mask(Sq, Sk, ctx.ncond, q.device)
        dq, dk, dv = torch.zeros_like(q), torch.zeros_like(k), torch.zeros_like(v)
        delta = (do * o).sum(-1).permute(0, 2, 1)  # [B, H, Sq]
        for sl in _groups(B, H, Sq, Sk):
            p = torch.exp(_scores(q[:, :, sl], k[:, :, sl], ctx.scale, mask)
                          - lse[:, sl][..., None])
            dv[:, :, sl] = torch.einsum("bhqk,bqhd->bkhd", p, do[:, :, sl])
            dp = torch.einsum("bqhd,bkhd->bhqk", do[:, :, sl], v[:, :, sl])
            ds = p * (dp - delta[:, sl][..., None]) * ctx.scale
            del p, dp
            dq[:, :, sl] = torch.einsum("bhqk,bkhd->bqhd", ds, k[:, :, sl])
            dk[:, :, sl] = torch.einsum("bhqk,bqhd->bkhd", ds, q[:, :, sl])
            del ds
        return dq, dk, dv, None, None


def attention(q, k, v, ncond: int = 0, lowp: bool = False) -> torch.Tensor:
    """softmax(q k^T / sqrt(D)) v with the prefix rule, q [B, Sq, H, D],
    k and v [B, Sk, H, D], all in float32."""
    q, k, v = q.float(), k.float(), v.float()
    if lowp:
        q, k, v = fp8_round(q), fp8_round(k), fp8_round(v)
    return _Attention.apply(q, k, v, int(ncond), q.shape[-1] ** -0.5)
