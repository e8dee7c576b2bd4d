"""Attention entry point with LongCat conditioning semantics.

The LongCat DiT treats the first ``num_cond_tokens`` tokens as a clean
conditioning prefix. The rule that makes the conditioning KV cache exact
is prefix-block-causal:

    allowed(q_i, k_j) = (i >= num_cond_tokens) or (j < num_cond_tokens)

so conditioning activations (and their K/V) do not depend on the noise
tokens and can be computed once per video.

``attention`` runs the CUDA flash kernel for CUDA tensors and the plain
version for CPU tensors (``ops/flash_attention.py``), and nothing else.
Public arrays are [B, S, H, D].
"""

from __future__ import annotations

from typing import Optional

import torch

from .flash_attention import attention_reference, flash_attention  # noqa: F401


def attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    num_cond_tokens: int = 0,
    kv_valid_len: Optional[int] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """q: [B, Sq, H, D]; k, v: [B, Sk, H, D] -> o [B, Sq, H, D]."""
    o, _ = flash_attention(q, k, v, num_cond_tokens=num_cond_tokens,
                           kv_valid_len=kv_valid_len, scale=scale)
    return o
