"""Tensor parallelism: the DiT's linears over the mesh's tensor axis
(counterpart of ``longcat_video_tta_tpu/parallel/sharding.py``).

Megatron-style, as the reference's rule tables: column-parallel for qkv,
cross q and kv, the ffn's w1 / w3 (and the backbones' counterparts),
shard the output features; row-parallel for proj, cross proj, the ffn's
w2 (and counterparts), shard the input features; the adaLN and modulation
linears column-parallel. Norm scales, embedders and the final layer stay
whole on every rank. Where the reference lets XLA insert the collectives,
``ops/layers.linear`` runs them from the ``TPSpec`` that ``shard_params``
leaves on each sharded linear:

  col         f on the input (identity forward, its gradient summed over
              the tensor group), this rank's output features;
  col_gather  the same, then the output features gathered (an output the
              next op needs whole: the adaLN and modulation outputs);
  row         this rank's input features, the partial products summed
              over the group (g), the bias added once.

A column split of a fused output keeps whole heads on each rank: qkv's
rows [3, heads, head_dim] give each rank its heads of q, k and v, the
attention kernels run at heads / T, and the row-parallel proj takes those
heads' features. A replicated tensor that meets head-sharded activations
(the per-head q/k norm scales, a LoRA pair on a sharded linear) passes
through f, so its gradient comes out whole on every rank.

W8A8 (``ops/quant.py``): an int8 row-parallel linear sees only its K
slice, so the per-token activation scale (the max over K) and the
per-channel weight scale are reduced with MAX over the group before
rounding, as the reference's global max is.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Dict, Tuple

import torch
from torch import nn

COL, ROW, COL_B = ("tensor", None), (None, "tensor"), ("tensor",)

# (parameter-name suffix with the block index removed, spec over the
# torch [out, in] layout, layout of the sharded features, gathered)
_RULES = (  # reference: _RULES (blocks/attn/qkv/kernel ...)
    ("blocks.attn.qkv.weight", COL, "heads3", False),
    ("blocks.attn.qkv.bias", COL_B, "heads3", False),
    ("blocks.attn.proj.weight", ROW, "contig", False),
    ("blocks.cross_attn.q.weight", COL, "contig", False),
    ("blocks.cross_attn.q.bias", COL_B, "contig", False),
    ("blocks.cross_attn.kv.weight", COL, "heads2", False),
    ("blocks.cross_attn.kv.bias", COL_B, "heads2", False),
    ("blocks.cross_attn.proj.weight", ROW, "contig", False),
    ("blocks.ffn.w1.weight", COL, "contig", False),
    ("blocks.ffn.w3.weight", COL, "contig", False),
    ("blocks.ffn.w2.weight", ROW, "contig", False),
    ("blocks.adaln.weight", COL, "contig", True),
    ("blocks.adaln.bias", COL_B, "contig", True),
)

_RULES_COGVIDEOX = (  # reference: _RULES_COGVIDEOX
    ("blocks.attn.to_q.weight", COL, "contig", False),
    ("blocks.attn.to_q.bias", COL_B, "contig", False),
    ("blocks.attn.to_k.weight", COL, "contig", False),
    ("blocks.attn.to_k.bias", COL_B, "contig", False),
    ("blocks.attn.to_v.weight", COL, "contig", False),
    ("blocks.attn.to_v.bias", COL_B, "contig", False),
    ("blocks.attn.to_out.weight", ROW, "contig", False),
    ("blocks.ff.w_in.weight", COL, "contig", False),
    ("blocks.ff.w_in.bias", COL_B, "contig", False),
    ("blocks.ff.w_out.weight", ROW, "contig", False),
    ("blocks.norm1.lin.weight", COL, "contig", True),
    ("blocks.norm1.lin.bias", COL_B, "contig", True),
    ("blocks.norm2.lin.weight", COL, "contig", True),
    ("blocks.norm2.lin.bias", COL_B, "contig", True),
)

_RULES_MMDIT = (  # reference: _RULES_MMDIT
    ("double_blocks.img_attn.qkv.weight", COL, "heads3", False),
    ("double_blocks.img_attn.qkv.bias", COL_B, "heads3", False),
    ("double_blocks.img_attn.proj.weight", ROW, "contig", False),
    ("double_blocks.txt_attn.qkv.weight", COL, "heads3", False),
    ("double_blocks.txt_attn.qkv.bias", COL_B, "heads3", False),
    ("double_blocks.txt_attn.proj.weight", ROW, "contig", False),
    ("double_blocks.img_mlp.w_in.weight", COL, "contig", False),
    ("double_blocks.img_mlp.w_in.bias", COL_B, "contig", False),
    ("double_blocks.img_mlp.w_out.weight", ROW, "contig", False),
    ("double_blocks.txt_mlp.w_in.weight", COL, "contig", False),
    ("double_blocks.txt_mlp.w_in.bias", COL_B, "contig", False),
    ("double_blocks.txt_mlp.w_out.weight", ROW, "contig", False),
    ("double_blocks.img_mod.weight", COL, "contig", True),
    ("double_blocks.img_mod.bias", COL_B, "contig", True),
    ("double_blocks.txt_mod.weight", COL, "contig", True),
    ("double_blocks.txt_mod.bias", COL_B, "contig", True),
    ("single_blocks.mod.weight", COL, "contig", True),
    ("single_blocks.mod.bias", COL_B, "contig", True),
    ("single_blocks.linear1.weight", COL, "lin1", False),
    ("single_blocks.linear1.bias", COL_B, "lin1", False),
    ("single_blocks.linear2.weight", ROW, "lin2", False),
)

RULES_BY_ARCH = {"longcat": _RULES, "cogvideox": _RULES_COGVIDEOX, "mmdit": _RULES_MMDIT}


def _rule_key(name: str) -> str:
    """'blocks.3.attn.qkv.weight' -> 'blocks.attn.qkv.weight'."""
    return re.sub(r"\.\d+\.", ".", name)


def _find(rules, key: str):
    for suffix, spec, layout, gathered in rules:
        if key == suffix:
            return spec, layout, gathered
    return None


def param_specs(model: nn.Module, arch: str = "longcat") -> Dict[str, Tuple]:
    """{name: spec} for every parameter and buffer of ``model``: a tuple
    naming the mesh axis of each dimension ([out, in] for a weight), ()
    for a replicated tensor. An int8 linear's ``weight_i8`` takes its
    kernel's spec and its per-output ``scale`` that spec without the
    contraction axis (("tensor",) column-parallel, (None,) row-parallel).
    Raises when no rule matches any tensor (the wrong arch for this
    model)."""
    rules = RULES_BY_ARCH[arch]
    out, matched = {}, 0
    tensors = list(model.named_parameters()) + list(model.named_buffers())
    for name, _ in tensors:
        key = _rule_key(name)
        hit = _find(rules, key)
        if hit is None and key.endswith((".weight_i8", ".scale")):
            base = _find(rules, key.rsplit(".", 1)[0] + ".weight")
            if base is not None:
                spec = base[0] if key.endswith(".weight_i8") else base[0][:1]
                hit = (spec,) + base[1:]
        if hit is None:
            out[name] = ()
        else:
            matched += 1
            out[name] = hit[0]
    if matched == 0:
        raise ValueError(f"no {arch!r} tensor-parallel rule matched any tensor of the "
                         f"model: wrong arch for this model? (archs: "
                         f"{sorted(RULES_BY_ARCH)})")
    return out


@dataclass
class TPSpec:
    """How a sharded linear runs (``ops/layers.linear``): ``mode`` "col",
    "col_gather" or "row"; ``group`` the tensor axis' process group;
    ``index`` the global feature indices this rank holds (output features
    for col, input features for row); ``full_shape`` the unsharded
    [out, in]."""

    mode: str
    group: object
    index: torch.Tensor
    full_shape: Tuple[int, int]
    size: int = 1
    indices: Tuple[torch.Tensor, ...] = ()  # every rank's ``index``, in group order

    def slice_weight(self, w: torch.Tensor) -> torch.Tensor:
        idx = self.index.to(w.device)
        return w.index_select(0 if self.mode != "row" else 1, idx)

    def slice_bias(self, b: torch.Tensor) -> torch.Tensor:
        return b if self.mode == "row" else b.index_select(0, self.index.to(b.device))


def _feature_index(layout: str, n: int, T: int, t: int, heads: int, head_dim: int
                   ) -> torch.Tensor:
    """Rank t's share of ``n`` features of ``layout``: a contiguous T-th
    ("contig"); its heads of each of k fused [heads, head_dim] blocks
    ("heads3", "heads2"); the MMDiT single block's [qkv | mlp] output
    ("lin1") and [attention | mlp] input ("lin2"), heads and a contiguous
    T-th of the mlp features."""
    def contig(m, base=0):
        if m % T:
            raise ValueError(f"{m} features do not split over {T} tensor ranks")
        return torch.arange(base + t * m // T, base + (t + 1) * m // T)

    D = heads * head_dim
    if heads % T:
        raise ValueError(f"{heads} heads do not split over {T} tensor ranks")

    def fused(k):
        return torch.cat([contig(D, j * D) for j in range(k)])

    if layout == "contig":
        return contig(n)
    if layout == "heads3":
        return fused(3)
    if layout == "heads2":
        return fused(2)
    if layout == "lin1":
        return torch.cat([fused(3), contig(n - 3 * D, 3 * D)])
    if layout == "lin2":
        return torch.cat([fused(1), contig(n - D, D)])
    raise ValueError(f"unknown feature layout {layout!r}")


def _heads(cfg) -> Tuple[int, int]:
    return cfg.num_heads, cfg.head_dim


def plan_linears(model: nn.Module, mesh, arch: str = "longcat") -> Dict[str, TPSpec]:
    """{module name: TPSpec} for every linear the rules shard over the
    mesh's tensor axis (empty at one tensor rank)."""
    T = mesh.size("tensor")
    if T == 1:
        return {}
    t, group = mesh.index("tensor"), mesh.group("tensor")
    heads, head_dim = _heads(model.cfg)
    rules = RULES_BY_ARCH[arch]
    plans = {}
    for name, mod in model.named_modules():
        hit = _find(rules, _rule_key(name) + ".weight")
        if hit is None:
            continue
        spec, layout, gathered = hit
        w = mod.weight if hasattr(mod, "weight") else mod.weight_i8
        out_f, in_f = w.shape
        mode = "row" if spec == ROW else ("col_gather" if gathered else "col")
        n = in_f if mode == "row" else out_f
        every = tuple(_feature_index(layout, n, T, r, heads, head_dim) for r in range(T))
        plans[name] = TPSpec(mode, group, every[t], (out_f, in_f), T, every)
    if not plans:
        raise ValueError(f"no {arch!r} tensor-parallel rule matched a linear of the model")
    return plans



def shard_params(model: nn.Module, mesh, arch: str = "longcat") -> nn.Module:
    """Slice ``model``'s sharded linears to this rank's share, in place,
    tensor by tensor (each full tensor is freed once its slice exists),
    and leave each its ``TPSpec``. Works on a model on the meta device
    too (``models/weights.py`` then draws each full tensor and keeps its
    slice). Returns ``model``."""
    plans = plan_linears(model, mesh, arch)
    for name, plan in plans.items():
        mod = model.get_submodule(name)
        with torch.no_grad():
            for pname in ("weight", "bias", "weight_i8", "scale"):
                cur = getattr(mod, pname, None)
                if cur is None:
                    continue
                if pname == "scale":
                    new = cur if plan.mode == "row" else cur.index_select(
                        0, plan.index.to(cur.device))
                elif pname == "bias":
                    new = plan.slice_bias(cur)
                else:
                    new = plan.slice_weight(cur)
                if pname in mod._parameters:
                    mod._parameters[pname] = nn.Parameter(new.contiguous(),
                                                          requires_grad=cur.requires_grad)
                elif pname in mod._buffers:
                    mod._buffers[pname] = new.contiguous()
                else:
                    mod.__dict__[pname] = new.contiguous()
        mod.tp = plan
    model.mesh = mesh
    return model


def tp_size(layer: nn.Module) -> int:
    """The tensor ranks ``layer`` is split over (1 when it is whole)."""
    tp = getattr(layer, "tp", None)
    return 1 if tp is None else tp.size


def sharded_names(model: nn.Module) -> set:
    """Names of the parameters that hold a tensor-parallel slice (the
    global clip norm counts them once per shard)."""
    out = set()
    for name, mod in model.named_modules():
        if getattr(mod, "tp", None) is not None:
            for pname in ("weight", "bias"):
                p = getattr(mod, pname, None)
                if p is not None and not (pname == "bias" and mod.tp.mode == "row"):
                    out.add(f"{name}.{pname}" if name else pname)
    return out



def parallelize(model: nn.Module, mesh, arch: str = "longcat") -> nn.Module:
    """Put ``model`` on ``mesh``: its linears sharded over the tensor axis
    (``shard_params``), and ``model.mesh`` set, which the LongCat DiT
    reads for its context axis. Context parallelism is the LongCat DiT's
    only, as in the reference. Returns ``model``."""
    if mesh.size("context") > 1 and arch != "longcat":
        raise ValueError("context parallelism is wired for the LongCat backbone only "
                         "(ring decode needs the cond-KV/noise split)")
    if mesh.size("tensor") > 1:
        shard_params(model, mesh, arch)
    model.mesh = mesh
    return model


def unshard(model: nn.Module, tree: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """``tree`` (trainable tensors keyed by parameter name) with every
    tensor-parallel slice gathered whole, as one rank would hold it (the
    ``full`` method's saved state and counts); ``tree`` itself when
    nothing in it is sharded. Collective over the tensor group."""
    names = {k for k in sharded_names(model) if k in tree}
    if not names:
        return tree
    from .collectives import all_gather

    out = dict(tree)
    for key in sorted(names):
        mod = model.get_submodule(key.rsplit(".", 1)[0])
        tp, x = mod.tp, tree[key]
        dim = 1 if tp.mode == "row" and x.ndim == 2 else 0
        parts = all_gather(x.contiguous(), tp.group, dim).chunk(tp.size, dim)
        shape = list(x.shape)
        shape[dim] = tp.full_shape[1] if dim == 1 else tp.full_shape[0]
        whole = x.new_empty(shape)
        for idx, part in zip(tp.indices, parts):
            whole.index_copy_(dim, idx.to(x.device), part)
        out[key] = whole
    return out
