"""Weights for the port's modules: the bridge from the reference's
parameter trees (nested dicts of numpy arrays, e.g.
``jax.tree.map(np.asarray, bundle.dit_params)``) and a seeded random
init that draws on the device.

One traversal per model walks the module and, for every leaf, asks a
``get(path, index, shape, init)`` callback for a tensor in the
reference's layout:
  - linear kernels are [in, out] (``nn.Linear.weight`` is [out, in]);
  - conv kernels are [kt, kh, kw, Cin, Cout] (the port's are
    [Cout, Cin, kt, kh, kw]);
  - depth-stacked leaves (DiT blocks, UMT5 layers) are asked for per
    block with ``index`` set.
The numpy getter reads the tree; the random getter draws from the
distributions of ``init_dit`` / ``init_mmdit`` / ``init_cogvideox`` (with
``zero_init=False``, as ``ModelBundle.init_random`` uses), ``init_vae``,
``init_umt5`` and ``init_clip_text``. At full width the DiT alone is 27 GB in bf16, so the
draws happen on the device, one leaf at a time.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..config import (
    CLIPTextConfig,
    CogVideoXConfig,
    DiTConfig,
    MMDiTConfig,
    ModelConfig,
    TextEncoderConfig,
    VAEConfig,
)
from .clip_text import CLIPTextTower
from .cogvideox import CogVideoX
from .dit import LongCatDiT
from .mmdit import MMDiT
from .umt5 import UMT5Encoder
from .vae import WanVAE, decoder_channel_plan

# init spec: ("normal", std) | ("zeros",) | ("ones",)
Getter = Callable[[Tuple[Any, ...], Optional[int], Tuple[int, ...], tuple],
                  torch.Tensor]


def _to_torch(a: np.ndarray) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes bfloat16 from a jax array
        return torch.from_numpy(np.array(a).view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def numpy_getter(tree: Dict[str, Any]) -> Getter:
    def get(path, index, shape, init):
        node = tree
        for key in path:
            node = node[key]
        a = node if index is None else np.asarray(node)[index]
        if tuple(np.shape(a)) != tuple(shape):
            raise ValueError(f"{'/'.join(map(str, path))}[{index}]: shape "
                             f"{np.shape(a)} != expected {tuple(shape)}")
        return _to_torch(a)
    return get


def random_getter(generator: torch.Generator, device) -> Getter:
    """Draws in place of reading, in fp32 on ``device`` (the leaf is cast
    to its parameter's dtype when set, as the reference casts its fp32
    draws)."""
    def get(path, index, shape, init):
        if init[0] == "zeros":
            return torch.zeros(shape, device=device)
        if init[0] == "ones":
            return torch.ones(shape, device=device)
        t = torch.empty(shape, device=device)
        return t.normal_(0.0, init[1], generator=generator)
    return get


# ---------------------------------------------------------------------------
# Leaf setters
# ---------------------------------------------------------------------------


def _set(param: torch.Tensor, value: torch.Tensor) -> None:
    with torch.no_grad():
        param.copy_(value.to(device=param.device, dtype=param.dtype))


def _vec(param, get, path, index=None, init=("zeros",)):
    _set(param, get(path, index, tuple(param.shape), init))


def _kernel(weight, get, path, index=None, init=("normal", 0.02)):
    """A linear kernel: [in, out] in the reference, [out, in] here."""
    out_f, in_f = weight.shape
    _set(weight, get(path, index, (in_f, out_f), init).t())


def _dense(layer: nn.Linear, get, path, index=None, std=0.02,
           zero_kernel: bool = False):
    """A linear's kernel and bias. A tensor-parallel linear (``layer.tp``,
    ``parallel/sharding.py``) holds a slice: the whole tensor is drawn (or
    read) as for one rank, sliced and dropped, one tensor at a time."""
    init = ("zeros",) if zero_kernel else ("normal", std)
    tp = getattr(layer, "tp", None)
    if tp is None:
        _kernel(layer.weight, get, path + ("kernel",), index, init)
        if layer.bias is not None:
            _vec(layer.bias, get, path + ("bias",), index)
        return
    out_f, in_f = tp.full_shape
    _set(layer.weight, tp.slice_weight(get(path + ("kernel",), index, (in_f, out_f),
                                           init).t()))
    if layer.bias is not None:
        _set(layer.bias, tp.slice_bias(get(path + ("bias",), index, (out_f,), ("zeros",))))


def _conv(p, get, path, index=None):
    cout, cin, kt, kh, kw = p.weight.shape
    std = (kt * kh * kw * cin) ** -0.5
    w = get(path + ("kernel",), index, (kt, kh, kw, cin, cout), ("normal", std))
    _set(p.weight, w.permute(4, 3, 0, 1, 2))
    _vec(p.bias, get, path + ("bias",), index)


# ---------------------------------------------------------------------------
# Traversals
# ---------------------------------------------------------------------------


def _fill_dit(m: LongCatDiT, get: Getter) -> None:
    _dense(m.x_embed, get, ("x_embed",))
    for w, b in (("w1", "b1"), ("w2", "b2")):  # {w1, b1, w2, b2} in the reference
        _kernel(m.t_embed[w].weight, get, ("t_embed", w))
        _vec(m.t_embed[w].bias, get, ("t_embed", b))
    _dense(m.y_embed["in"], get, ("y_embed", "in"))
    _dense(m.y_embed["out"], get, ("y_embed", "out"))
    for i, blk in enumerate(m.blocks):
        b = ("blocks",)
        _dense(blk.adaln, get, b + ("adaln",), i)
        _dense(blk.attn.qkv, get, b + ("attn", "qkv"), i)
        _dense(blk.attn.proj, get, b + ("attn", "proj"), i)
        _vec(blk.attn.q_norm, get, b + ("attn", "q_norm"), i, ("ones",))
        _vec(blk.attn.k_norm, get, b + ("attn", "k_norm"), i, ("ones",))
        ca = blk.cross_attn
        _dense(ca.q, get, b + ("cross_attn", "q"), i)
        _dense(ca.kv, get, b + ("cross_attn", "kv"), i)
        _dense(ca.proj, get, b + ("cross_attn", "proj"), i)
        _vec(ca.q_norm, get, b + ("cross_attn", "q_norm"), i, ("ones",))
        _vec(ca.k_norm, get, b + ("cross_attn", "k_norm"), i, ("ones",))
        _vec(blk.pre_crs_norm.weight, get, b + ("pre_crs_norm", "weight"), i,
             ("ones",))
        _vec(blk.pre_crs_norm.bias, get, b + ("pre_crs_norm", "bias"), i)
        for name in ("w1", "w3", "w2"):
            _dense(getattr(blk.ffn, name), get, b + ("ffn", name), i)
    _dense(m.final["adaln"], get, ("final", "adaln"), zero_kernel=True)
    _dense(m.final["proj"], get, ("final", "proj"))


def _fill_mmdit(m: MMDiT, get: Getter) -> None:
    """The reference's ``init_mmdit`` tree: embedder MLPs {w1, b1, w2, b2}
    in fp32, per-block stacks under "double" / "single"."""
    cfg = m.cfg
    _dense(m.img_in, get, ("img_in",))
    _dense(m.txt_in, get, ("txt_in",))
    embedders = ["time_in", "vector_in"] + (["guidance_in"] if cfg.guidance_embed else [])
    for name in embedders:
        for w, b in (("w1", "b1"), ("w2", "b2")):
            _kernel(getattr(m, name)[w].weight, get, (name, w))
            _vec(getattr(m, name)[w].bias, get, (name, b))
    if cfg.cond_embed:
        _dense(m.cond_in, get, ("cond_in",))
    d = ("double",)
    for i, blk in enumerate(m.double_blocks):
        for stream in ("img", "txt"):
            _dense(getattr(blk, f"{stream}_mod"), get, d + (f"{stream}_mod",), i)
            a = getattr(blk, f"{stream}_attn")
            ap = d + (f"{stream}_attn",)
            _dense(a.qkv, get, ap + ("qkv",), i)
            _vec(a.q_norm, get, ap + ("q_norm",), i, ("ones",))
            _vec(a.k_norm, get, ap + ("k_norm",), i, ("ones",))
            _dense(a.proj, get, ap + ("proj",), i)
            mlp = getattr(blk, f"{stream}_mlp")
            _dense(mlp.w_in, get, d + (f"{stream}_mlp", "w_in"), i)
            _dense(mlp.w_out, get, d + (f"{stream}_mlp", "w_out"), i)
    s = ("single",)
    for i, blk in enumerate(m.single_blocks):
        _dense(blk.mod, get, s + ("mod",), i)
        _dense(blk.linear1, get, s + ("linear1",), i)
        _vec(blk.q_norm, get, s + ("q_norm",), i, ("ones",))
        _vec(blk.k_norm, get, s + ("k_norm",), i, ("ones",))
        _dense(blk.linear2, get, s + ("linear2",), i)
    _dense(m.final["adaln"], get, ("final", "adaln"))
    _dense(m.final["proj"], get, ("final", "proj"))


def _fill_cogvideox(m: CogVideoX, get: Getter) -> None:
    """The reference's ``init_cogvideox`` / converter tree: the time
    embedding {w1, b1, w2, b2} in fp32, per-block stacks under "blocks",
    ``pos_embed`` [len, hidden] when the config has a learned table."""
    if m.cfg.learned_pos_embed_len > 0:
        _vec(m.pos_embed, get, ("pos_embed",), None, ("normal", 0.02))
    _dense(m.patch_embed, get, ("patch_embed",))
    _dense(m.text_proj, get, ("text_proj",))
    for w, b in (("w1", "b1"), ("w2", "b2")):
        _kernel(m.time_embed[w].weight, get, ("time_embed", w))
        _vec(m.time_embed[w].bias, get, ("time_embed", b))
    bp = ("blocks",)
    for i, blk in enumerate(m.blocks):
        for n in ("norm1", "norm2"):
            _dense(getattr(blk, n).lin, get, bp + (n, "lin"), i)
            _fill_norm_at(getattr(blk, n).ln, get, bp + (n, "ln"), i)
        for n in ("to_q", "to_k", "to_v", "to_out"):
            _dense(getattr(blk.attn, n), get, bp + ("attn", n), i)
        for n in ("norm_q", "norm_k"):
            _fill_norm_at(getattr(blk.attn, n), get, bp + ("attn", n), i)
        _dense(blk.ff.w_in, get, bp + ("ff", "w_in"), i)
        _dense(blk.ff.w_out, get, bp + ("ff", "w_out"), i)
    _fill_norm(m.norm_final, get, ("norm_final",))
    _dense(m.norm_out["lin"], get, ("norm_out", "lin"))
    _fill_norm(m.norm_out["ln"], get, ("norm_out", "ln"))
    _dense(m.proj_out, get, ("proj_out",))


def _fill_clip_text(m: CLIPTextTower, get: Getter) -> None:
    """The reference's ``init_clip_text`` tree (layers stacked on a depth
    axis)."""
    _vec(m.token_embedding, get, ("token_embedding",), None, ("normal", 0.02))
    _vec(m.position_embedding, get, ("position_embedding",), None, ("normal", 0.01))
    for i, layer in enumerate(m.encoder.layers):
        lp = ("layers",)
        for ln in ("ln1", "ln2"):
            _fill_norm_at(getattr(layer, ln), get, lp + (ln,), i)
        for name in ("q", "k", "v", "out", "fc1", "fc2"):
            _dense(getattr(layer, name), get, lp + (name,), i)
    _fill_norm(m.final_ln, get, ("final_ln",))


def _fill_norm_at(p, get, path, index):
    _vec(p.weight, get, path + ("weight",), index, ("ones",))
    _vec(p.bias, get, path + ("bias",), index)


def _fill_umt5(m: UMT5Encoder, get: Getter) -> None:
    cfg = m.cfg
    d, dkv, dff = cfg.d_model, cfg.d_kv, cfg.d_ff
    inner = cfg.num_heads * dkv
    _vec(m.embed, get, ("embed",), None, ("normal", 1.0))
    stds = {"q": (d * dkv) ** -0.5, "k": d ** -0.5, "v": d ** -0.5,
            "o": inner ** -0.5, "wi0": d ** -0.5, "wi1": d ** -0.5,
            "wo": dff ** -0.5}
    for i, blk in enumerate(m.blocks):
        b = ("blocks",)
        _vec(blk.ln1, get, b + ("ln1",), i, ("ones",))
        _vec(blk.ln2, get, b + ("ln2",), i, ("ones",))
        _vec(blk.rel_bias, get, b + ("rel_bias",), i)
        for name, std in stds.items():
            _kernel(getattr(blk, name).weight, get, b + (name,), i, ("normal", std))
    _vec(m.final_ln, get, ("final_ln",), None, ("ones",))


def _fill_norm(p, get, path):
    _fill_norm_at(p, get, path, None)


def _fill_resblock(p, get, path):
    _fill_norm(p.norm1, get, path + ("norm1",))
    _conv(p.conv1, get, path + ("conv1",))
    _fill_norm(p.norm2, get, path + ("norm2",))
    _conv(p.conv2, get, path + ("conv2",))
    if p.shortcut is not None:
        _conv(p.shortcut, get, path + ("shortcut",))


def _fill_mid(p, get, path):
    _fill_resblock(p.res1, get, path + ("res1",))
    a = p.attn
    _fill_norm(a.norm, get, path + ("attn", "norm"))
    c = a.q.weight.shape[0]
    for name in ("q", "k", "v", "proj"):
        _dense(getattr(a, name), get, path + ("attn", name), std=c ** -0.5)
    _fill_resblock(p.res2, get, path + ("res2",))


def _fill_vae(m: WanVAE, get: Getter) -> None:
    cfg = m.cfg
    e, d = m.enc, m.dec
    _conv(e.conv_in, get, ("enc", "conv_in"))
    for i, sc in enumerate(e.scales):
        p = ("enc", "scales", i)
        for j, rb in enumerate(sc.res):
            _fill_resblock(rb, get, p + ("res", j))
        if i < len(cfg.dim_mults) - 1:
            _conv(sc.sdown, get, p + ("sdown",))
            if cfg.temporal_downsample[i]:
                _conv(sc.tdown, get, p + ("tdown",))
    _fill_mid(e.mid, get, ("enc", "mid"))
    _fill_norm(e.norm_out, get, ("enc", "norm_out"))
    _conv(e.conv_out, get, ("enc", "conv_out"))
    _conv(e.quant, get, ("enc", "quant"))

    _conv(d.post_quant, get, ("dec", "post_quant"))
    _conv(d.conv_in, get, ("dec", "conv_in"))
    _fill_mid(d.mid, get, ("dec", "mid"))
    for i, (sc, (_, _, has_rs, has_t)) in enumerate(
            zip(d.scales, decoder_channel_plan(cfg))):
        p = ("dec", "scales", i)
        for j, rb in enumerate(sc.res):
            _fill_resblock(rb, get, p + ("res", j))
        if has_rs:
            if has_t:
                _conv(sc.tup, get, p + ("tup",))
            _conv(sc.sup, get, p + ("sup",))
    _fill_norm(d.norm_out, get, ("dec", "norm_out"))
    _conv(d.conv_out, get, ("dec", "conv_out"))


# ---------------------------------------------------------------------------
# Public API
# ---------------------------------------------------------------------------


def _empty(cls, cfg, device, mesh=None, arch: str = "longcat") -> nn.Module:
    """Build a module without running any init (parameters unset). With a
    ``mesh`` that has a tensor axis the linears are sliced on the meta
    device first, so only this rank's shares are allocated."""
    with torch.device("meta"):
        m = cls(cfg)
    if mesh is not None:
        from ..parallel.sharding import parallelize

        parallelize(m, mesh, arch)
    return m.to_empty(device=device).eval().requires_grad_(False)


def load_dit_from_numpy(tree, cfg: DiTConfig, device="cuda") -> LongCatDiT:
    m = _empty(LongCatDiT, cfg, device)
    _fill_dit(m, numpy_getter(tree))
    return m


def load_mmdit_from_numpy(tree, cfg: MMDiTConfig, device="cuda") -> MMDiT:
    """The MMDiT of the reference's ``init_mmdit`` / converter tree."""
    m = _empty(MMDiT, cfg, device)
    _fill_mmdit(m, numpy_getter(tree))
    return m


def load_cogvideox_from_numpy(tree, cfg: CogVideoXConfig, device="cuda") -> CogVideoX:
    """The CogVideoX of the reference's ``init_cogvideox`` / converter tree."""
    m = _empty(CogVideoX, cfg, device)
    _fill_cogvideox(m, numpy_getter(tree))
    return m


def load_clip_text_from_numpy(tree, cfg: CLIPTextConfig, device="cuda") -> CLIPTextTower:
    """The CLIP text tower of the reference's ``init_clip_text`` tree."""
    m = _empty(CLIPTextTower, cfg, device)
    _fill_clip_text(m, numpy_getter(tree))
    return m


def load_vae_from_numpy(tree, cfg: VAEConfig, device="cuda") -> WanVAE:
    m = _empty(WanVAE, cfg, device)
    _fill_vae(m, numpy_getter(tree))
    return m


def load_umt5_from_numpy(tree, cfg: TextEncoderConfig, device="cuda") -> UMT5Encoder:
    m = _empty(UMT5Encoder, cfg, device)
    _fill_umt5(m, numpy_getter(tree))
    return m


def init_random(cfg: ModelConfig, device, generator: torch.Generator, mesh=None):
    """Random (dit, vae, text) modules drawn on ``device`` from
    ``generator`` (which must live on that device), with the reference
    inits' distributions; the DiT is ``cfg.arch``'s (``archs.py``). With a
    ``mesh`` the DiT is this rank's (``parallel.sharding.parallelize``),
    its draws those of one rank."""
    from ..archs import get_arch

    arch = get_arch(cfg.arch)
    out = []
    for cls, sub, fill, m_mesh in ((arch.dit_cls, cfg.dit, arch.fill, mesh),
                                   (WanVAE, cfg.vae, _fill_vae, None),
                                   (UMT5Encoder, cfg.text, _fill_umt5, None)):
        m = _empty(cls, sub, device, m_mesh, cfg.arch)
        fill(m, random_getter(generator, device))
        out.append(m)
    return tuple(out)


def init_random_dit(cfg: DiTConfig, device, generator: torch.Generator) -> LongCatDiT:
    """A random LongCat DiT drawn on ``device`` from ``generator``: the DiT
    that ``init_random`` draws first from the same generator state, without
    the VAE and the text encoder."""
    m = _empty(LongCatDiT, cfg, device)
    _fill_dit(m, random_getter(generator, device))
    return m


def init_random_clip_text(cfg: CLIPTextConfig, device,
                          generator: torch.Generator) -> CLIPTextTower:
    """A random CLIP text tower (``init_clip_text``'s distributions)."""
    m = _empty(CLIPTextTower, cfg, device)
    _fill_clip_text(m, random_getter(generator, device))
    return m


def train_params_from_numpy(scheme, tree: Dict[str, Any],
                            device="cuda") -> Dict[str, torch.Tensor]:
    """A reference scheme's trainable tree (numpy leaves) as the port
    scheme's flat dict (``tta/adapters.py``):
      - delta_a / delta_b / delta_c / film: the same keys and arrays;
      - lora {site: {'a': [depth, in, r], 'b': [depth, r, out]}} ->
        "<site>.a" / "<site>.b" in the same layout (builtin mode
        transposes the merged update into ``nn.Linear``'s [out, in] at
        ``to_forward``; the CogVideoX sites likewise); the MMDiT's
        {"double"|"single": {site: ...}} -> "<group>.<site>.a" / ".b";
      - norm_tune {"blocks/<path>": [depth, ...]} (under "norms" with a
        "delta_t" when also_tune_delta) -> "blocks.<i>.<path>" per block;
      - full: the whole parameter tree, through the backbone's
        ``from_numpy`` (``archs.py``).
    """
    from ..archs import get_arch

    method = scheme.method
    if method == "full":
        dit = get_arch(scheme.cfg.arch).from_numpy(tree, scheme.cfg, device)
        return {name: p.detach() for name, p in dit.named_parameters()}
    out: Dict[str, torch.Tensor] = {}
    if method == "lora" and scheme.cfg.arch == "mmdit":
        for group, sites in tree.items():
            for site, ab in sites.items():
                for part in ("a", "b"):
                    out[f"{group}.{site}.{part}"] = _to_torch(ab[part]).to(device)
    elif method == "lora":
        for site, ab in tree.items():
            for part in ("a", "b"):
                out[f"{site}.{part}"] = _to_torch(ab[part]).to(device)
    elif method == "norm_tune":
        norms = tree["norms"] if "norms" in tree else tree
        for path, stacked in norms.items():
            rest = ".".join(path.split("/")[1:])  # "blocks/attn/q_norm" -> "attn.q_norm"
            for i in range(np.shape(stacked)[0]):
                out[f"blocks.{i}.{rest}"] = _to_torch(np.asarray(stacked)[i]).to(device)
        if "delta_t" in tree:
            out["delta_t"] = _to_torch(tree["delta_t"]).to(device)
    else:
        out = {k: _to_torch(v).to(device) for k, v in tree.items()}
    return out
