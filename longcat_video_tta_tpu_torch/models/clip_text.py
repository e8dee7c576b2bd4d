"""CLIP transformer stack and text tower (counterpart of
``longcat_video_tta_tpu/models/clip_text.py``).

``CLIPEncoder`` is the pre-LN quick-GELU transformer both CLIP towers use
(text: causal; vision, X-CLIP's MIT: not), its layers a ``ModuleList``.
LayerNorm eps 1e-5; attention is a plain softmax product, the causal mask
filling -1e30. ``CLIPTextTower.pooled`` is the final-LN hidden state at
the end-of-text token, the argmax token id (the CLIP convention).

Parameters are fp32 in the Hugging Face linear layout ([out, in]); the
modules are built empty and filled by ``models/convert.py``.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from ..config import CLIPTextConfig

LN_EPS = 1e-5


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


def mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, num_heads: int,
        mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[B, Sq, D] x [B, Sk, D] -> [B, Sq, D] softmax attention; ``mask``
    [Sq, Sk] bool keeps the True logits and fills the others with -1e30."""
    B, Sq, D = q.shape
    dh = D // num_heads
    qh = q.reshape(B, Sq, num_heads, dh).transpose(1, 2)
    kh = k.reshape(B, k.shape[1], num_heads, dh).transpose(1, 2)
    vh = v.reshape(B, v.shape[1], num_heads, dh).transpose(1, 2)
    logits = (qh @ kh.transpose(-1, -2)) * (dh ** -0.5)
    if mask is not None:
        logits = logits.masked_fill(~mask, -1e30)
    o = torch.softmax(logits, dim=-1) @ vh
    return o.transpose(1, 2).reshape(B, Sq, D)


class CLIPLayer(nn.Module):
    """One pre-LN block: x += out(attn(ln1(x))); x += fc2(qgelu(fc1(ln2(x))))."""

    def __init__(self, width: int):
        super().__init__()
        self.ln1 = nn.LayerNorm(width, eps=LN_EPS)
        self.q = nn.Linear(width, width)
        self.k = nn.Linear(width, width)
        self.v = nn.Linear(width, width)
        self.out = nn.Linear(width, width)
        self.ln2 = nn.LayerNorm(width, eps=LN_EPS)
        self.fc1 = nn.Linear(width, 4 * width)
        self.fc2 = nn.Linear(4 * width, width)

    def forward(self, x: torch.Tensor, num_heads: int,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        h = self.ln1(x)
        x = x + self.out(mha(self.q(h), self.k(h), self.v(h), num_heads, mask))
        return x + self.fc2(quick_gelu(self.fc1(self.ln2(x))))


class CLIPEncoder(nn.Module):
    """The layer stack (the reference's ``clip_encoder``, unrolled)."""

    def __init__(self, width: int, num_layers: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.layers = nn.ModuleList(CLIPLayer(width) for _ in range(num_layers))

    def forward(self, x: torch.Tensor, causal: bool = False) -> torch.Tensor:
        S = x.shape[1]
        mask = (torch.ones(S, S, dtype=torch.bool, device=x.device).tril()
                if causal else None)
        for layer in self.layers:
            x = layer(x, self.num_heads, mask)
        return x


class CLIPTextTower(nn.Module):
    """Token + learned position embeddings, the causal encoder, final LN."""

    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.cfg = cfg
        W = cfg.width
        self.token_embedding = nn.Parameter(torch.empty(cfg.vocab_size, W))
        self.position_embedding = nn.Parameter(torch.empty(cfg.max_length, W))
        self.encoder = CLIPEncoder(W, cfg.num_layers, cfg.num_heads)
        self.final_ln = nn.LayerNorm(W, eps=LN_EPS)

    def pooled(self, input_ids: torch.Tensor) -> torch.Tensor:
        """[B, S] token ids -> [B, width] at each row's argmax token."""
        B, S = input_ids.shape
        x = self.token_embedding[input_ids] + self.position_embedding[None, :S]
        x = self.final_ln(self.encoder(x, causal=True))
        eot = torch.argmax(input_ids, dim=-1)
        return x[torch.arange(B, device=x.device), eot]
