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

``attention_impl`` (the runner's ``--attn-impl``, the reference's names)
overrides that choice for a run: "xla" takes the plain version on every
device (a debugging aid: it materialises the S x S scores), "pallas" the
kernels, which need CUDA tensors; None keeps the rule above.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch

from ..utils.spans import span
from .flash_attention import (  # noqa: F401
    FlashAttentionFunction,
    attention_reference,
    flash_attention,
)


ATTN_IMPLS = (None, "xla", "pallas")
_impl: Optional[str] = None


@contextlib.contextmanager
def attention_impl(impl: Optional[str]):
    """Run the enclosed code with attention implementation ``impl`` (one
    of ``ATTN_IMPLS``)."""
    global _impl
    if impl not in ATTN_IMPLS:
        raise ValueError(f"attention implementation {impl!r}: one of {ATTN_IMPLS}")
    prev, _impl = _impl, impl
    try:
        yield
    finally:
        _impl = prev


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
    with span("op.attention"):
        if _impl == "xla":
            return attention_reference(q, k, v, num_cond_tokens=num_cond_tokens,
                                       kv_valid_len=kv_valid_len, scale=scale)[0]
        if _impl == "pallas" and not q.is_cuda:
            raise RuntimeError("attention implementation 'pallas' runs the Hopper kernels: "
                               "it needs CUDA tensors")
        if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                        or v.requires_grad):
            return FlashAttentionFunction.apply(q, k, v, num_cond_tokens,
                                                kv_valid_len, scale, 0, 0)
        o, _ = flash_attention(q, k, v, num_cond_tokens=num_cond_tokens,
                               kv_valid_len=kv_valid_len, scale=scale)
        return o
