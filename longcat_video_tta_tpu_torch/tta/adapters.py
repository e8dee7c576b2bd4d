"""The seven TTA methods as adapter schemes (counterpart of
``longcat_video_tta_tpu/tta/adapters.py``, LongCat and MMDiT branches). A scheme
gives the trainable tensors (``init``) and maps them onto what every loss
and the sampler consume (``to_forward`` -> (dit, adapters dict or None)).

  delta_a    one fp32 delta on the t-embedding
  delta_b    G group deltas on the per-block t-embedding or block output
             (partial dims zero-padded, block scoping all/last_N/indices)
  delta_c    a per-channel residual on the output velocity
  film       per-group corrections of the adaLN output
  lora       rank-r side branch on the block linears (kaiming-uniform a,
             zero b, scale alpha / rank), or with ``lora_builtin`` the same
             update merged into the weights
  norm_tune  the norm affines (optionally with a delta_a vector)
  full       every DiT parameter

The adapter methods return the base DiT unchanged. The weight-training
methods (norm_tune, full, builtin LoRA) return a DiT built by
``with_tensors``: it shares every frozen tensor with the base DiT and
holds the trained tensors in place of the rest, so the base DiT is never
written. The port keeps one tensor per block where the reference stacks
a depth axis: a weight's key names its block ("blocks.3.pre_crs_norm.weight").
LoRA's a and b keep the reference's [depth, in, r] / [depth, r, out]
layout (keys "<site>.a", "<site>.b").

``to_forward`` also takes train params with a leading lane axis V on
every tensor (``--video-parallel``: V videos' states stacked), and then
returns the adapters and the swapped-in weights with that axis in front,
which the models apply per batch row (``ops/layers.py::lane_rows``).

The Open-Sora v2 MMDiT takes the three methods the reference ports to it
(``MMDIT_SCHEMES``): delta_a on the hidden-sized vec, LoRA on the
double-stream img/txt attention (and optionally mlp) linears and the
single-stream linear1/linear2 (keys "double.<site>.a" ...), full. So
does CogVideoX (``COGVIDEOX_SCHEMES``): delta_a on the 512-d time
embedding, LoRA on to_q / to_k / to_v / to_out (and optionally the
feed-forward), full.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Set, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..config import AdapterConfig, DiTConfig
from ..models.dit import LongCatDiT
from ..ops.quant import shallow_module

TrainParams = Dict[str, torch.Tensor]


# ---------------------------------------------------------------------------
# Block scoping and groups
# ---------------------------------------------------------------------------


def parse_target_blocks(target_blocks: str, num_blocks: int) -> Optional[Set[int]]:
    """"all" -> None; "last_N" -> the trailing N; "0,5,10" -> that set."""
    t = target_blocks.strip().lower()
    if t == "all":
        return None
    if t.startswith("last_"):
        n = int(t.split("_", 1)[1])
        if n <= 0 or n > num_blocks:
            raise ValueError(f"last_{n} invalid for {num_blocks} blocks")
        return set(range(num_blocks - n, num_blocks))
    idxs = {int(x.strip()) for x in t.split(",")}
    for i in idxs:
        if not 0 <= i < num_blocks:
            raise ValueError(f"block index {i} out of range [0, {num_blocks})")
    return idxs


def block_group_map(num_blocks: int, num_groups: int) -> Tuple[int, ...]:
    """Blocks split evenly into ``num_groups`` consecutive groups."""
    per = math.ceil(num_blocks / num_groups)
    return tuple(min(i // per, num_groups - 1) for i in range(num_blocks))


def active_mask(num_blocks: int, targets: Optional[Set[int]], device=None) -> torch.Tensor:
    """fp32 [num_blocks]: 1 for a targeted block, 0 otherwise. Untargeted
    blocks are multiplied by 0, not cut from the graph, as in the
    reference."""
    return torch.tensor([1.0 if targets is None or i in targets else 0.0
                         for i in range(num_blocks)], dtype=torch.float32, device=device)


def _pad_dim(x: torch.Tensor, full: int) -> torch.Tensor:
    """Zero-pad the last axis to ``full`` (partial-dim deltas)."""
    return x if x.shape[-1] >= full else F.pad(x, (0, full - x.shape[-1]))


# ---------------------------------------------------------------------------
# Trained tensors in place of parameters
# ---------------------------------------------------------------------------


def with_tensors(root: nn.Module, tensors: Dict[str, torch.Tensor]) -> nn.Module:
    """A copy of ``root`` that holds ``tensors`` (keyed by parameter name,
    e.g. "blocks.3.attn.qkv.weight") in place of those parameters and
    shares every other parameter and buffer with ``root``. Only the
    modules on the way to a replaced tensor are copied, shallowly. An
    ``nn.Module`` refuses a plain tensor under a parameter's name, so the
    name leaves the copy's parameter table and the tensor becomes a plain
    attribute; the module code reads it the same way."""
    copies = {"": shallow_module(root)}

    def module(path: str) -> nn.Module:
        if path not in copies:
            parent, _, name = path.rpartition(".")
            owner = module(parent)
            copies[path] = owner._modules[name] = shallow_module(owner._modules[name])
        return copies[path]

    for key, t in tensors.items():
        path, _, name = key.rpartition(".")
        m = module(path)
        if name not in m._parameters:
            raise KeyError(f"{key} is not a parameter of {type(root).__name__}")
        del m._parameters[name]
        m.__dict__[name] = t
    return copies[""]


# norm affines per block (the reference's NORM_TARGET_PATHS)
NORM_TARGET_PATHS = {
    "cross_attn_norm": ("pre_crs_norm.weight", "pre_crs_norm.bias"),
    "qk_norm": ("attn.q_norm", "attn.k_norm", "cross_attn.q_norm", "cross_attn.k_norm"),
}
NORM_TARGET_PATHS["all_norm"] = (NORM_TARGET_PATHS["cross_attn_norm"]
                                 + NORM_TARGET_PATHS["qk_norm"])

# LoRA sites -> (in, out) dims and the block linear they patch
LORA_SITES = {
    "qkv": (lambda c: (c.hidden_size, 3 * c.hidden_size), "attn.qkv"),
    "attn_proj": (lambda c: (c.hidden_size, c.hidden_size), "attn.proj"),
    "xattn_q": (lambda c: (c.hidden_size, c.hidden_size), "cross_attn.q"),
    "xattn_kv": (lambda c: (c.hidden_size, 2 * c.hidden_size), "cross_attn.kv"),
    "xattn_proj": (lambda c: (c.hidden_size, c.hidden_size), "cross_attn.proj"),
    "ffn_w1": (lambda c: (c.hidden_size, c.ffn_dim), "ffn.w1"),
    "ffn_w2": (lambda c: (c.ffn_dim, c.hidden_size), "ffn.w2"),
    "ffn_w3": (lambda c: (c.hidden_size, c.ffn_dim), "ffn.w3"),
}


def lora_site_names(target_modules: Sequence[str], target_ffn: bool) -> List[str]:
    """The reference's --lora-target-modules / --lora-target-ffn flags as
    site names."""
    sites: List[str] = []
    if "qkv" in target_modules:
        sites += ["qkv", "xattn_q", "xattn_kv"]
    if "proj" in target_modules:
        sites += ["attn_proj", "xattn_proj"]
    if target_ffn:
        sites += ["ffn_w1", "ffn_w2", "ffn_w3"]
    return sites


# ---------------------------------------------------------------------------
# Schemes
# ---------------------------------------------------------------------------


class AdapterScheme:
    """One TTA method = ``init`` + a ``to_forward`` mapping."""

    method = "base"

    def __init__(self, dit_cfg: DiTConfig, acfg: AdapterConfig):
        self.cfg = dit_cfg
        self.acfg = acfg

    def init(self, device="cpu", *, dit: Optional[LongCatDiT] = None,
             generator: Optional[torch.Generator] = None) -> TrainParams:
        """The initial trainable tensors. ``dit`` is the base model (the
        weight-training methods start from its tensors); ``generator``
        draws LoRA's random init."""
        raise NotImplementedError

    def to_forward(self, train_params: TrainParams, dit: LongCatDiT
                   ) -> Tuple[LongCatDiT, Optional[Dict]]:
        raise NotImplementedError

    def num_params(self, train_params: TrainParams) -> int:
        return sum(int(x.numel()) for x in train_params.values())


def _zeros(*shape, device):
    return torch.zeros(shape, dtype=torch.float32, device=device)


class DeltaAScheme(AdapterScheme):
    """delta_a: one zero-initialised fp32 [adaln_tembed_dim] delta on the
    t-embedding of every block and of the final layer."""

    method = "delta_a"

    def init(self, device="cpu", *, dit=None, generator=None):
        return {"delta": _zeros(self.cfg.adaln_tembed_dim, device=device)}

    def to_forward(self, train_params, dit):
        return dit, {"delta_t": train_params["delta"]}


class DeltaBScheme(AdapterScheme):
    """delta_b: G group deltas [G, dim] (dim <= the target's width,
    zero-padded), on each block's t-embedding ("timestep") or added to
    each block's output plus one final delta ("hidden"); untargeted
    blocks get zero rows."""

    method = "delta_b"

    def __init__(self, dit_cfg, acfg):
        super().__init__(dit_cfg, acfg)
        self.groups = block_group_map(dit_cfg.depth, acfg.num_groups)
        self.targets = parse_target_blocks(acfg.target_blocks, dit_cfg.depth)
        self.full_dim = (dit_cfg.adaln_tembed_dim if acfg.delta_target == "timestep"
                         else dit_cfg.hidden_size)
        self.dim = acfg.delta_dim or self.full_dim

    def init(self, device="cpu", *, dit=None, generator=None):
        p = {"deltas": _zeros(self.acfg.num_groups, self.dim, device=device)}
        if self.acfg.delta_target == "hidden":
            p["delta_final"] = _zeros(self.dim, device=device)
        return p

    def to_forward(self, train_params, dit):
        deltas = train_params["deltas"]
        padded = _pad_dim(deltas, self.full_dim)  # [(V,) G, full]
        gmap = torch.tensor(self.groups, dtype=torch.long, device=deltas.device)
        per_block = padded[..., gmap, :] * active_mask(self.cfg.depth, self.targets,
                                                       deltas.device)[:, None]
        if self.acfg.delta_target == "timestep":
            return dit, {"delta_t_blocks": per_block}
        return dit, {"delta_h_blocks": per_block,
                     "delta_h_final": _pad_dim(train_params["delta_final"],
                                               self.full_dim)}


class DeltaCScheme(AdapterScheme):
    """delta_c: a per-channel residual [out_channels] on the velocity."""

    method = "delta_c"

    def init(self, device="cpu", *, dit=None, generator=None):
        return {"delta_out": _zeros(self.cfg.out_channels, device=device)}

    def to_forward(self, train_params, dit):
        return dit, {"delta_out": train_params["delta_out"]}


class FiLMScheme(AdapterScheme):
    """FiLM: per-group corrections [G, k*D] of the adaLN output's chunks
    [shift_msa, scale_msa, gate_msa, shift_mlp, scale_mlp, gate_mlp]
    that ``film_mode`` selects; the others stay zero."""

    method = "film"

    _MODE_CHUNKS = {
        "full": (0, 1, 2, 3, 4, 5),
        "shift_scale": (0, 1, 3, 4),
        "scale_only": (1, 4),
    }

    def __init__(self, dit_cfg, acfg):
        super().__init__(dit_cfg, acfg)
        self.groups = block_group_map(dit_cfg.depth, acfg.num_groups)
        self.chunks = self._MODE_CHUNKS[acfg.film_mode]
        self.dim = len(self.chunks) * dit_cfg.hidden_size

    def init(self, device="cpu", *, dit=None, generator=None):
        return {"corrections": _zeros(self.acfg.num_groups, self.dim, device=device)}

    def _expand(self, corr: torch.Tensor) -> torch.Tensor:
        """[(V,) G, k*D] -> [(V,) G, 6*D], zeros in the untouched chunks."""
        D = self.cfg.hidden_size
        pieces = [corr[..., self.chunks.index(c) * D:(self.chunks.index(c) + 1) * D]
                  if c in self.chunks else corr.new_zeros(corr.shape[:-1] + (D,))
                  for c in range(6)]
        return torch.cat(pieces, dim=-1)

    def to_forward(self, train_params, dit):
        full = self._expand(train_params["corrections"])
        gmap = torch.tensor(self.groups, dtype=torch.long, device=full.device)
        return dit, {"film_blocks": full[..., gmap, :]}


class LoRAScheme(AdapterScheme):
    """LoRA on the targeted block linears: a [depth, in, r] drawn
    U(+-1/sqrt(in)) (kaiming-uniform with a = sqrt(5)), b [depth, r, out]
    zero, scale alpha / rank; untargeted blocks multiply a by 0. With
    ``lora_builtin`` ``to_forward`` merges W + scale * a @ b into the
    weights (a weight copy and its gradient per step) instead of the side
    branch."""

    method = "lora"
    table = LORA_SITES  # site -> (its (in, out) from the config, module path)

    def __init__(self, dit_cfg, acfg):
        super().__init__(dit_cfg, acfg)
        self.sites = lora_site_names(acfg.lora_target_modules, acfg.lora_target_ffn)
        self.targets = parse_target_blocks(acfg.target_blocks, dit_cfg.depth)
        self.rank = acfg.lora_rank
        self.scale = acfg.lora_alpha / acfg.lora_rank
        self.builtin = acfg.lora_builtin

    def init(self, device="cpu", *, dit=None, generator=None):
        L, r = self.cfg.depth, self.rank
        p = {}
        for site in self.sites:
            din, dout = self.table[site][0](self.cfg)
            bound = 1.0 / math.sqrt(din)
            u = torch.rand((L, din, r), generator=generator, dtype=torch.float32,
                           device=device)
            p[f"{site}.a"] = u * (2 * bound) - bound
            p[f"{site}.b"] = _zeros(L, r, dout, device=device)
        return p

    def _masked(self, train_params):
        """{site: (a * mask, b)}."""
        out = {}
        for site in self.sites:
            a, b = train_params[f"{site}.a"], train_params[f"{site}.b"]
            mask = active_mask(self.cfg.depth, self.targets, a.device)[:, None, None]
            out[site] = (a * mask, b)
        return out

    def to_forward(self, train_params, dit):
        ab = self._masked(train_params)
        if not self.builtin:
            return dit, {"lora": {site: {"a": a, "b": b} for site, (a, b) in ab.items()},
                         "lora_scale": self.scale}
        merged = {}
        for site, (a, b) in ab.items():
            path = self.table[site][1]
            for i, blk in enumerate(dit.blocks):
                w = blk.get_submodule(path).weight  # [out, in]
                delta = (a[..., i, :, :] @ b[..., i, :, :]) * self.scale  # [(V,) in, out]
                merged[f"blocks.{i}.{path}.weight"] = w + delta.transpose(-1, -2).to(w.dtype)
        return with_tensors(dit, merged), None

    def num_params(self, train_params) -> int:
        """Only the targeted blocks count (as the reference counts)."""
        n_active = self.cfg.depth if self.targets is None else len(self.targets)
        total = 0
        for site in self.sites:
            din, dout = self.table[site][0](self.cfg)
            total += (din * self.rank + self.rank * dout) * n_active
        return total


class NormTuneScheme(AdapterScheme):
    """norm_tune: the norm affines of ``norm_target`` in every block,
    started from the base model's; with ``also_tune_delta`` a delta_a
    vector ("delta_t") trains alongside."""

    method = "norm_tune"

    def __init__(self, dit_cfg, acfg):
        super().__init__(dit_cfg, acfg)
        self.paths = NORM_TARGET_PATHS[acfg.norm_target]
        self.also_tune_delta = acfg.also_tune_delta

    def init(self, device="cpu", *, dit=None, generator=None):
        p = {f"blocks.{i}.{path}": dit.get_parameter(f"blocks.{i}.{path}").detach()
             for i in range(self.cfg.depth) for path in self.paths}
        if self.also_tune_delta:
            p["delta_t"] = _zeros(self.cfg.adaln_tembed_dim, device=device)
        return p

    def to_forward(self, train_params, dit):
        norms = {k: v for k, v in train_params.items() if k != "delta_t"}
        adapters = ({"delta_t": train_params["delta_t"]} if self.also_tune_delta
                    else None)
        return with_tensors(dit, norms), adapters


class FullScheme(AdapterScheme):
    """full: every DiT parameter, started from the base model's (the
    initial dict shares their storage; updates make new tensors)."""

    method = "full"

    def init(self, device="cpu", *, dit=None, generator=None):
        return {name: p.detach() for name, p in dit.named_parameters()}

    def to_forward(self, train_params, dit):
        return with_tensors(dit, train_params), None


SCHEMES = {
    "delta_a": DeltaAScheme,
    "delta_b": DeltaBScheme,
    "delta_c": DeltaCScheme,
    "film": FiLMScheme,
    "lora": LoRAScheme,
    "norm_tune": NormTuneScheme,
    "full": FullScheme,
}


# ---------------------------------------------------------------------------
# MMDiT (Open-Sora v2) backbone
# ---------------------------------------------------------------------------

_MMDIT_DOUBLE_SITES = {
    "img_qkv": lambda c: (c.hidden_size, 3 * c.hidden_size),
    "img_proj": lambda c: (c.hidden_size, c.hidden_size),
    "txt_qkv": lambda c: (c.hidden_size, 3 * c.hidden_size),
    "txt_proj": lambda c: (c.hidden_size, c.hidden_size),
    "img_mlp_in": lambda c: (c.hidden_size, c.mlp_dim),
    "img_mlp_out": lambda c: (c.mlp_dim, c.hidden_size),
    "txt_mlp_in": lambda c: (c.hidden_size, c.mlp_dim),
    "txt_mlp_out": lambda c: (c.mlp_dim, c.hidden_size),
}
_MMDIT_SINGLE_SITES = {
    "lin1": lambda c: (c.hidden_size, 3 * c.hidden_size + c.mlp_dim),
    "lin2": lambda c: (c.hidden_size + c.mlp_dim, c.hidden_size),
}


class MMDiTLoRAScheme(AdapterScheme):
    """LoRA over the MMDiT's two stacks: ``target_blocks`` "all" | "double"
    | "single"; ``lora_target_modules`` qkv / proj on the double blocks'
    img and txt attention, ``lora_target_ffn`` adds their mlps; the single
    blocks' linear1 / linear2 always (their attention and mlp are fused).
    a [depth, in, r] U(+-1/sqrt(in)), b zero, scale alpha / rank.
    ``lora_builtin`` does not apply here (as in the reference)."""

    method = "lora"

    def __init__(self, dit_cfg, acfg):
        super().__init__(dit_cfg, acfg)
        if acfg.target_blocks not in ("all", "double", "single"):
            raise ValueError("MMDiT lora target_blocks must be all|double|single")
        dsites: List[str] = []
        if "qkv" in acfg.lora_target_modules:
            dsites += ["img_qkv", "txt_qkv"]
        if "proj" in acfg.lora_target_modules:
            dsites += ["img_proj", "txt_proj"]
        if acfg.lora_target_ffn:
            dsites += ["img_mlp_in", "img_mlp_out", "txt_mlp_in", "txt_mlp_out"]
        self.groups = {
            "double": (dsites if acfg.target_blocks != "single" else [],
                       _MMDIT_DOUBLE_SITES, dit_cfg.depth_double),
            "single": (list(_MMDIT_SINGLE_SITES) if acfg.target_blocks != "double"
                       else [], _MMDIT_SINGLE_SITES, dit_cfg.depth_single)}
        self.rank = acfg.lora_rank
        self.scale = acfg.lora_alpha / acfg.lora_rank

    def init(self, device="cpu", *, dit=None, generator=None):
        p = {}
        for group, (sites, table, depth) in self.groups.items():
            for site in sites:
                din, dout = table[site](self.cfg)
                bound = 1.0 / math.sqrt(din)
                u = torch.rand((depth, din, self.rank), generator=generator,
                               dtype=torch.float32, device=device)
                p[f"{group}.{site}.a"] = u * (2 * bound) - bound
                p[f"{group}.{site}.b"] = _zeros(depth, self.rank, dout, device=device)
        return p

    def to_forward(self, train_params, dit):
        ad = {"lora_scale": self.scale}
        for group, (sites, _, _) in self.groups.items():
            if sites:
                ad[f"lora_{group}"] = {site: {"a": train_params[f"{group}.{site}.a"],
                                              "b": train_params[f"{group}.{site}.b"]}
                                       for site in sites}
        return dit, ad


MMDIT_SCHEMES = {
    "delta_a": DeltaAScheme,
    "lora": MMDiTLoRAScheme,
    "full": FullScheme,
}


# ---------------------------------------------------------------------------
# CogVideoX backbone
# ---------------------------------------------------------------------------

_COGVIDEOX_LORA_SITES = {
    "to_q": (lambda c: (c.hidden_size, c.hidden_size), "attn.to_q"),
    "to_k": (lambda c: (c.hidden_size, c.hidden_size), "attn.to_k"),
    "to_v": (lambda c: (c.hidden_size, c.hidden_size), "attn.to_v"),
    "to_out": (lambda c: (c.hidden_size, c.hidden_size), "attn.to_out"),
    "ff_in": (lambda c: (c.hidden_size, c.ffn_dim), "ff.w_in"),
    "ff_out": (lambda c: (c.ffn_dim, c.hidden_size), "ff.w_out"),
}


class CogVideoXLoRAScheme(LoRAScheme):
    """LoRA over the CogVideoX blocks, the LongCat scheme's draws and block
    scoping on CogVideoX's sites: ``lora_target_modules`` qkv -> to_q /
    to_k / to_v, proj -> to_out, ``lora_target_ffn`` adds ff_in / ff_out.
    Every block's tensors count as trainable, as the reference counts
    them; ``lora_builtin`` does not apply (as in the reference)."""

    table = _COGVIDEOX_LORA_SITES
    num_params = AdapterScheme.num_params

    def __init__(self, dit_cfg, acfg):
        super().__init__(dit_cfg, acfg)
        sites: List[str] = []
        if "qkv" in acfg.lora_target_modules:
            sites += ["to_q", "to_k", "to_v"]
        if "proj" in acfg.lora_target_modules:
            sites += ["to_out"]
        if acfg.lora_target_ffn:
            sites += ["ff_in", "ff_out"]
        self.sites = sites
        self.builtin = False


COGVIDEOX_SCHEMES = {
    "delta_a": DeltaAScheme,
    "lora": CogVideoXLoRAScheme,
    "full": FullScheme,
}

_BACKBONE_NAMES = {"mmdit": "MMDiT", "cogvideox": "CogVideoX"}


def build_scheme(dit_cfg, acfg: AdapterConfig) -> AdapterScheme:
    """The LongCat DiT takes all seven methods; the MMDiT and CogVideoX
    the three the reference ports to them (delta_a, lora, full): the
    backbone's record in ``archs.py``."""
    from ..archs import get_arch

    schemes = get_arch(dit_cfg.arch).schemes
    if acfg.method in schemes:
        return schemes[acfg.method](dit_cfg, acfg)
    if dit_cfg.arch in _BACKBONE_NAMES:
        raise ValueError(f"method {acfg.method} is not ported to the "
                         f"{_BACKBONE_NAMES[dit_cfg.arch]} backbone "
                         "(reference ports delta_a/lora/full — SURVEY.md §2.7)")
    raise ValueError(f"unknown TTA method {acfg.method!r} (one of {sorted(schemes)})")
