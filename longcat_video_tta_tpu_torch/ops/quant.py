"""Int8 (W8A8) block linears for the decode loop (counterpart of
``longcat_video_tta_tpu/ops/quant.py``, LongCat layout).

The heavy per-block linears (fused qkv and proj, cross-attention q, kv
and proj, SwiGLU w1/w2/w3) get int8 weights with per-output-channel
scales; activations are quantized per token at run time, and the
product runs int8 x int8 -> int32. Embedders, adaLN, norms and the final
layer stay in the compute dtype. Decode only: training stays 16-bit.

The int8 product is a plain matrix product, as the reference leaves it
to XLA: ``torch._int_mm`` (cuBLASLt's int8 GEMM on the card; a CPU
implementation here). On the card it takes the activations row-major
[M, K] with M > 16 and the weight column-major [K, N], K and N multiples
of 8, so the int8 weight is stored once, at quantization, as [N, K]
row-major (``nn.Linear``'s layout) and passed transposed.
"""

from __future__ import annotations

import copy
from typing import Dict, Tuple

import torch
from torch import nn

_BLOCK_LINEARS: Dict[str, Tuple[str, ...]] = {
    "attn": ("qkv", "proj"),
    "cross_attn": ("q", "kv", "proj"),
    "ffn": ("w1", "w2", "w3"),
}
_INT_MM_MIN_ROWS = 17  # cuBLASLt int8 GEMM needs M > 16


def quantize_linear_params(weight: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """weight [N, K] -> (int8 [N, K], fp32 scale [N]): symmetric
    per-output-channel scales over the contraction axis."""
    w = weight.float()
    s = (w.abs().amax(dim=1) / 127.0).clamp_min(1e-8)
    wi = torch.clamp(torch.round(w / s[:, None]), -127, 127).to(torch.int8)
    return wi, s


class Int8Linear(nn.Module):
    """A quantized ``nn.Linear``: int8 weight [N, K], fp32 scale [N] and
    the original bias (shared, not copied)."""

    def __init__(self, weight_i8: torch.Tensor, scale: torch.Tensor, bias):
        super().__init__()
        self.register_buffer("weight_i8", weight_i8)
        self.register_buffer("scale", scale)
        self.bias = bias

    @classmethod
    def from_linear(cls, layer: nn.Linear) -> "Int8Linear":
        wi, s = quantize_linear_params(layer.weight.detach())
        return cls(wi, s, layer.bias)


def int8_linear(layer: Int8Linear, x: torch.Tensor) -> torch.Tensor:
    """W8A8 dense in x's dtype: per-token abs-max activation quantization
    (1e-8 floor), int32 accumulation, y = (int32 * x_scale) * w_scale + b
    in fp32."""
    dtype = x.dtype
    K = x.shape[-1]
    xf = x.float().reshape(-1, K)
    sx = (xf.abs().amax(dim=-1, keepdim=True) / 127.0).clamp_min(1e-8)
    xi = torch.round(xf / sx).to(torch.int8)
    M = xi.shape[0]
    if xi.is_cuda and M < _INT_MM_MIN_ROWS:
        xi = torch.cat([xi, xi.new_zeros((_INT_MM_MIN_ROWS - M, K))])
    yi = torch._int_mm(xi, layer.weight_i8.t())[:M]
    y = yi.float() * sx * layer.scale
    if layer.bias is not None:
        y = y + layer.bias.float()
    return y.to(dtype).reshape(*x.shape[:-1], -1)


def _shallow(mod: nn.Module) -> nn.Module:
    """A copy of ``mod`` that shares its parameters and buffers but whose
    submodule table can be changed without touching ``mod``."""
    new = copy.copy(mod)
    new._modules = dict(mod._modules)
    return new


def quantize_dit_blocks_int8(dit: nn.Module) -> nn.Module:
    """A LongCat DiT whose per-block heavy linears are ``Int8Linear``;
    every other parameter (embedders, adaLN, norms, the final layer, the
    biases) is the same tensor as in ``dit``, so no second 16-bit copy
    exists. ``ops.layers.linear`` dispatches on the layer type."""
    new = _shallow(dit)
    blocks = nn.ModuleList()
    for blk in dit.blocks:
        nb = _shallow(blk)
        for group, names in _BLOCK_LINEARS.items():
            sub = _shallow(getattr(blk, group))
            for name in names:
                sub._modules[name] = Int8Linear.from_linear(getattr(sub, name))
            nb._modules[group] = sub
        blocks.append(nb)
    new._modules["blocks"] = blocks
    return new
