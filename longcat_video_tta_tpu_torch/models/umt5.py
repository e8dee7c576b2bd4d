"""UMT5 text encoder in PyTorch (counterpart of
``longcat_video_tta_tpu/models/umt5.py``).

UMT5 specifics vs vanilla T5: every layer owns its own relative position
bias table, gated-GELU FFN, RMSNorm, no attention-logit scaling. The
attention here is a plain fp32 einsum, as in the reference (512 text
tokens; it is not a kernel of either package).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..config import TextEncoderConfig, resolve_dtype
from ..ops.layers import rms_norm


def _relative_position_bucket(rel_pos: torch.Tensor, num_buckets: int,
                              max_distance: int) -> torch.Tensor:
    """Bidirectional T5 bucket mapping (half exact, half logarithmic)."""
    num_buckets = num_buckets // 2
    ret = torch.where(rel_pos > 0, num_buckets, 0)
    n = rel_pos.abs()
    max_exact = num_buckets // 2
    is_small = n < max_exact
    val_large = max_exact + (
        torch.log(n.float() / max_exact + 1e-6)
        / math.log(max_distance / max_exact)
        * (num_buckets - max_exact)
    ).to(torch.int32)
    val_large = torch.clamp(val_large, max=num_buckets - 1)
    return ret + torch.where(is_small, n, val_large)


def relative_position_bias(table: torch.Tensor, qlen: int, klen: int,
                           num_buckets: int, max_distance: int) -> torch.Tensor:
    """table: [num_buckets, heads] -> bias [1, heads, qlen, klen]."""
    ctx = torch.arange(qlen, device=table.device)[:, None]
    mem = torch.arange(klen, device=table.device)[None, :]
    buckets = _relative_position_bucket(mem - ctx, num_buckets, max_distance)
    return table[buckets].permute(2, 0, 1)[None]


class UMT5Layer(nn.Module):
    def __init__(self, cfg: TextEncoderConfig, dtype):
        super().__init__()
        d, inner, dff = cfg.d_model, cfg.num_heads * cfg.d_kv, cfg.d_ff
        self.ln1 = nn.Parameter(torch.empty(d, dtype=dtype))
        self.q = nn.Linear(d, inner, bias=False, dtype=dtype)
        self.k = nn.Linear(d, inner, bias=False, dtype=dtype)
        self.v = nn.Linear(d, inner, bias=False, dtype=dtype)
        self.o = nn.Linear(inner, d, bias=False, dtype=dtype)
        self.rel_bias = nn.Parameter(torch.empty(
            cfg.relative_attention_num_buckets, cfg.num_heads, dtype=torch.float32))
        self.ln2 = nn.Parameter(torch.empty(d, dtype=dtype))
        self.wi0 = nn.Linear(d, dff, bias=False, dtype=dtype)
        self.wi1 = nn.Linear(d, dff, bias=False, dtype=dtype)
        self.wo = nn.Linear(dff, d, bias=False, dtype=dtype)


class UMT5Encoder(nn.Module):
    def __init__(self, cfg: TextEncoderConfig):
        super().__init__()
        self.cfg = cfg
        pdtype = resolve_dtype(cfg.param_dtype)
        self.embed = nn.Parameter(torch.empty(cfg.vocab_size, cfg.d_model,
                                              dtype=pdtype))
        self.blocks = nn.ModuleList([UMT5Layer(cfg, pdtype)
                                     for _ in range(cfg.num_layers)])
        self.final_ln = nn.Parameter(torch.empty(cfg.d_model, dtype=pdtype))

    def forward(self, input_ids: torch.Tensor,
                attention_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """input_ids [B, L] -> last_hidden_state [B, L, d_model]."""
        return umt5_encode(self, input_ids, attention_mask)


def umt5_encode(model: UMT5Encoder, input_ids: torch.Tensor,
                attention_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    cfg = model.cfg
    cdtype = resolve_dtype(cfg.compute_dtype)
    B, L = input_ids.shape
    h, dkv = cfg.num_heads, cfg.d_kv
    x = model.embed[input_ids.long()].to(cdtype)
    if attention_mask is not None:
        neg = torch.where(attention_mask[:, None, None, :] > 0, 0.0, -1e9)
    else:
        neg = torch.zeros((B, 1, 1, L), device=x.device)
    neg = neg.float()

    for bp in model.blocks:
        hn = rms_norm(x, bp.ln1, eps=cfg.layer_norm_eps)
        q = F.linear(hn, bp.q.weight.to(cdtype)).reshape(B, L, h, dkv)
        k = F.linear(hn, bp.k.weight.to(cdtype)).reshape(B, L, h, dkv)
        v = F.linear(hn, bp.v.weight.to(cdtype)).reshape(B, L, h, dkv)
        bias = relative_position_bias(bp.rel_bias, L, L,
                                      cfg.relative_attention_num_buckets,
                                      cfg.relative_attention_max_distance)
        # T5 attention: no 1/sqrt(d) scaling
        logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) + bias + neg
        probs = torch.softmax(logits, dim=-1)
        o = torch.einsum("bhqk,bkhd->bqhd", probs, v.float())
        x = x + F.linear(o.reshape(B, L, h * dkv).to(cdtype), bp.o.weight.to(cdtype))

        hn = rms_norm(x, bp.ln2, eps=cfg.layer_norm_eps)
        g = F.gelu(F.linear(hn, bp.wi0.weight.to(cdtype)), approximate="tanh")
        u = F.linear(hn, bp.wi1.weight.to(cdtype))
        x = x + F.linear(g * u, bp.wo.weight.to(cdtype))
    return rms_norm(x, model.final_ln, eps=cfg.layer_norm_eps)
