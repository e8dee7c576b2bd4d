"""Attention entry point with LongCat conditioning semantics.

The LongCat DiT treats the first ``num_cond_tokens`` tokens as a clean
conditioning prefix. The rule that makes the conditioning KV cache exact
is prefix-block-causal:

    allowed(q_i, k_j) = (i >= num_cond_tokens) or (j < num_cond_tokens)

so conditioning activations (and their K/V) do not depend on the noise
tokens and can be computed once per video.

``attention`` runs the CUDA flash kernels for CUDA tensors and the plain
versions for CPU tensors (``ops/flash_attention.py``), and nothing else.
When autograd is recording and an input needs a gradient it goes through
``FlashAttentionFunction`` (forward kernel, then the dQ and dK/dV
kernels in the backward); otherwise it calls the forward alone. Public
arrays are [B, S, H, D].
"""

from __future__ import annotations

from typing import Optional

import torch

from .flash_attention import (  # noqa: F401
    FlashAttentionFunction,
    attention_reference,
    flash_attention,
)


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
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttentionFunction.apply(q, k, v, num_cond_tokens,
                                            kv_valid_len, scale, 0, 0)
    o, _ = flash_attention(q, k, v, num_cond_tokens=num_cond_tokens,
                           kv_valid_len=kv_valid_len, scale=scale)
    return o
