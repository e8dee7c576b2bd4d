"""Int8 (W8A8) block linears for the decode loop (counterpart of
``longcat_video_tta_tpu/ops/quant.py``).

The heavy per-block linears (LongCat: fused qkv and proj, cross-attention
q, kv and proj, SwiGLU w1/w2/w3; MMDiT: the double blocks' img/txt qkv,
proj and mlp, the single blocks' linear1 and linear2; CogVideoX: to_q,
to_k, to_v, to_out and the feed-forward) get int8 weights with
per-output-channel scales; activations are quantized per token at run time, and the
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
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from ..utils.spans import span

_BLOCK_LINEARS: Dict[str, Tuple[str, ...]] = {
    "attn": ("qkv", "proj"),
    "cross_attn": ("q", "kv", "proj"),
    "ffn": ("w1", "w2", "w3"),
}
_INT_MM_MIN_ROWS = 17  # cuBLASLt int8 GEMM needs M > 16


def quantize_linear_params(weight: torch.Tensor, amax_group=None
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """weight [N, K] -> (int8 [N, K], fp32 scale [N]): symmetric
    per-output-channel scales over the contraction axis. ``amax_group``:
    the tensor group a row-parallel weight's K is split over; the channel
    max is then reduced over it (the scale of the whole K)."""
    w = weight.float()
    amax = w.abs().amax(dim=1)
    if amax_group is not None:
        from ..parallel.collectives import all_reduce

        amax = all_reduce(amax, amax_group, "max")
    s = (amax / 127.0).clamp_min(1e-8)
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
        """The int8 form of ``layer``; a tensor-parallel layer keeps its
        ``tp`` (a row-parallel one's channel scales over the whole K)."""
        tp = getattr(layer, "tp", None)
        group = tp.group if tp is not None and tp.mode == "row" else None
        wi, s = quantize_linear_params(layer.weight.detach(), group)
        new = cls(wi, s, layer.bias)
        if tp is not None:
            new.tp = tp
        return new


def lora_term(x: torch.Tensor, lora: Dict[str, torch.Tensor],
              lora_scale) -> torch.Tensor:
    """The LoRA side branch (x @ a) @ b * scale in x's dtype; ``lora`` is
    {'a': [in, r], 'b': [r, out]}, or one pair per lane ({'a': [V, in, r],
    'b': [V, r, out]}, x [B, ..., in] with row r in lane r % V: one batched
    product per factor)."""
    a, b = lora["a"].to(x.dtype), lora["b"].to(x.dtype)
    if a.ndim == 2:
        lx = (x @ a) @ b
    else:
        V = a.shape[0]
        lx = ((x.reshape(x.shape[0] // V, V, -1, x.shape[-1]) @ a) @ b).reshape(
            x.shape[:-1] + (b.shape[-1],))
    return lx * torch.as_tensor(lora_scale, dtype=x.dtype, device=x.device)


def int8_linear(layer: Int8Linear, x: torch.Tensor,
                lora: Optional[Dict[str, torch.Tensor]] = None,
                lora_scale=None, amax_group=None) -> torch.Tensor:
    """W8A8 dense in x's dtype: per-token abs-max activation quantization
    (1e-8 floor), int32 accumulation, y = (int32 * x_scale) * w_scale + b
    in fp32. A LoRA side branch is added after the cast, in x's dtype
    (the adapter stays 16-bit, as in the reference). Row-parallel
    (``amax_group``: x holds this rank's slice of K): the per-token max is
    reduced over the group before rounding, and the fp32 partial product
    comes back without bias, cast or LoRA (the caller sums it over the
    group first)."""
    dtype = x.dtype
    K = x.shape[-1]
    with span("op.quantize"):
        xf = x.float().reshape(-1, K)
        amax = xf.abs().amax(dim=-1, keepdim=True)
        if amax_group is not None:
            from ..parallel.collectives import all_reduce

            amax = all_reduce(amax, amax_group, "max")
        sx = (amax / 127.0).clamp_min(1e-8)
        xi = torch.round(xf / sx).to(torch.int8)
        M = xi.shape[0]
        if xi.is_cuda and M < _INT_MM_MIN_ROWS:
            xi = torch.cat([xi, xi.new_zeros((_INT_MM_MIN_ROWS - M, K))])
    yi = torch._int_mm(xi, layer.weight_i8.t())[:M]
    y = yi.float() * sx * layer.scale
    if amax_group is not None:
        return y.reshape(*x.shape[:-1], -1)
    if layer.bias is not None:
        y = y + layer.bias.float()
    y = y.to(dtype).reshape(*x.shape[:-1], -1)
    if lora is not None:
        y = y + lora_term(x, lora, lora_scale)
    return y


def shallow_module(mod: nn.Module) -> nn.Module:
    """A copy of ``mod`` that shares its parameters and buffers but whose
    submodule and parameter tables can be changed without touching
    ``mod``."""
    new = copy.copy(mod)
    new._modules = dict(mod._modules)
    new._parameters = dict(mod._parameters)
    return new


def _quantize_stack(blocks: nn.ModuleList, spec: Dict[str, Tuple[str, ...]]
                    ) -> nn.ModuleList:
    """Copies of ``blocks`` whose linears named by ``spec`` ({submodule:
    names}; "" for the block's own linears) are ``Int8Linear``."""
    out = nn.ModuleList()
    for blk in blocks:
        nb = shallow_module(blk)
        for group, names in spec.items():
            sub = nb if group == "" else shallow_module(getattr(blk, group))
            for name in names:
                sub._modules[name] = Int8Linear.from_linear(getattr(sub, name))
            if group:
                nb._modules[group] = sub
        out.append(nb)
    return out


def quantize_dit_blocks_int8(dit: nn.Module) -> nn.Module:
    """A LongCat DiT whose per-block heavy linears are ``Int8Linear``;
    every other parameter (embedders, adaLN, norms, the final layer, the
    biases) is the same tensor as in ``dit``, so no second 16-bit copy
    exists. ``ops.layers.linear`` dispatches on the layer type."""
    new = shallow_module(dit)
    new._modules["blocks"] = _quantize_stack(dit.blocks, _BLOCK_LINEARS)
    return new


_MMDIT_DOUBLE_LINEARS: Dict[str, Tuple[str, ...]] = {
    "img_attn": ("qkv", "proj"), "txt_attn": ("qkv", "proj"),
    "img_mlp": ("w_in", "w_out"), "txt_mlp": ("w_in", "w_out"),
}


def quantize_mmdit_blocks_int8(dit: nn.Module) -> nn.Module:
    """An MMDiT whose double blocks' img/txt attention and mlp linears and
    single blocks' linear1 / linear2 are ``Int8Linear``; the mods,
    embedders and the final layer stay 16-bit and shared."""
    new = shallow_module(dit)
    new._modules["double_blocks"] = _quantize_stack(dit.double_blocks, _MMDIT_DOUBLE_LINEARS)
    new._modules["single_blocks"] = _quantize_stack(dit.single_blocks, {"": ("linear1", "linear2")})
    return new


def quantize_cogvideox_blocks_int8(dit: nn.Module) -> nn.Module:
    """A CogVideoX whose blocks' to_q / to_k / to_v / to_out and ff w_in /
    w_out are ``Int8Linear``; the LayerNormZero linears, the embedders and
    the output layers stay 16-bit and shared."""
    new = shallow_module(dit)
    new._modules["blocks"] = _quantize_stack(
        dit.blocks, {"attn": ("to_q", "to_k", "to_v", "to_out"), "ff": ("w_in", "w_out")})
    return new
