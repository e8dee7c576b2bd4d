"""LongCat checkpoints in the upstream torch layout -> the port's modules
(counterpart of ``longcat_video_tta_tpu/models/convert.py``'s
``convert_torch_dit_state`` :175, ``convert_torch_umt5_state`` :347 and
``convert_torch_vae_state`` :462, with the same key mapping, transposes and
``rope_interleaved`` permutation).

Where the reference converts a whole state dict into a numpy tree, this
module converts one tensor at a time: each converter builds a tree of the
reference's shape whose leaves are functions of the block index; the
traversals of ``models/weights.py`` call them leaf by leaf, and each leaf
reads its shard tensor, moves it to the device in the shard's dtype and
transposes or flattens it there; ``weights._set`` then casts it to the
parameter's dtype. So a 13.6B checkpoint never stands whole on the host,
in fp32 or otherwise. Every converter refuses a layout it does not
understand: a missing key raises ``KeyError``, a key left unread raises
``ValueError`` (the reference's ``_TrackedStateDict`` rule, :139-165, here
for the DiT and UMT5 too).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import torch

from ..config import DiTConfig, TextEncoderConfig, VAEConfig
from ..utils.safetensors import ShardIndex
from .dit import LongCatDiT
from .umt5 import UMT5Encoder
from .vae import WanVAE, decoder_channel_plan
from .weights import Getter, _empty, _fill_dit, _fill_umt5, _fill_vae

Leaf = Callable[[Optional[int]], torch.Tensor]


def tree_getter(tree: Dict[str, Any]) -> Getter:
    """A ``models/weights.py`` getter over a tree whose leaves are
    ``leaf(index) -> tensor`` in the reference's layout."""
    def get(path, index, shape, init):
        node = tree
        for key in path:
            node = node[key]
        t = node(index)
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{'/'.join(map(str, path))}[{index}]: shape "
                             f"{tuple(t.shape)} != expected {tuple(shape)}")
        return t
    return get


class _Source:
    """Leaf makers over one shard folder: every leaf reads its tensor,
    moves it to ``device`` in its stored dtype, then applies ``fn``."""

    def __init__(self, sd: ShardIndex, device):
        self.sd = sd
        self.device = device

    def load(self, key: str) -> torch.Tensor:
        return self.sd[key].to(self.device)

    def one(self, key: str, fn=lambda w: w) -> Leaf:
        return lambda index: fn(self.load(key))

    def stack(self, fmt: str, fn=lambda w: w) -> Leaf:
        """A depth-stacked leaf: block ``index`` reads ``fmt.format(index)``."""
        return lambda index: fn(self.load(fmt.format(index)))


def _t(w: torch.Tensor) -> torch.Tensor:
    return w.t()


def rope_perm(dh: int) -> torch.Tensor:
    """The channel permutation from interleaved-pair RoPE to the half-split
    rotation (the reference's ``_rope_perm``): new[j] = old[2j] for
    j < dh/2, old[2(j - dh/2) + 1] after."""
    half = dh // 2
    return torch.cat([torch.arange(half) * 2, torch.arange(half) * 2 + 1])


def permute_qkv_rows(w: torch.Tensor, num_heads: int, dh: int) -> torch.Tensor:
    """The per-head rows of the q and k chunks of a fused qkv weight
    [3 H dh, in] (or bias [3 H dh]) permuted by ``rope_perm``; v untouched
    (the reference's ``_permute_qkv_rows``)."""
    perm = rope_perm(dh).to(w.device)
    rows = torch.arange(w.shape[0], device=w.device)
    qk = (rows[:2 * num_heads * dh].view(2 * num_heads, dh)[:, perm]).reshape(-1)
    return w[torch.cat([qk, rows[2 * num_heads * dh:]])]


def dit_tree(src: _Source, cfg: DiTConfig, rope_interleaved: bool = False) -> Dict:
    """The reference's DiT tree (``convert_torch_dit_state``) with leaves
    over a LongCat DiT state dict: torch Linear weights [out, in] are
    transposed; a Conv3d patch embedding [D, C, pt, ph, pw] is flattened in
    the patchify feature order (pt, ph, pw, C); with ``rope_interleaved``
    the q/k rows of each fused qkv and the q/k RMSNorm scales are permuted
    so the half-split RoPE equals the interleaved one."""
    nH, dh = cfg.num_heads, cfg.head_dim

    def x_kernel(w):
        if w.ndim == 5:  # Conv3d [D, C, pt, ph, pw] -> [(pt ph pw C), D]
            return w.permute(2, 3, 4, 1, 0).reshape(-1, w.shape[0])
        return w.t()

    def qkv(w):
        return permute_qkv_rows(w, nH, dh) if rope_interleaved else w

    def qk_norm(w):
        return w[rope_perm(dh).to(w.device)] if rope_interleaved else w

    lin = lambda fmt: {"kernel": src.stack(fmt + ".weight", _t),
                       "bias": src.stack(fmt + ".bias")}
    top = lambda name: {"kernel": src.one(name + ".weight", _t),
                        "bias": src.one(name + ".bias")}
    b = "blocks.{}."
    return {
        "x_embed": {"kernel": src.one("x_embedder.proj.weight", x_kernel),
                    "bias": src.one("x_embedder.proj.bias")},
        "t_embed": {"w1": src.one("t_embedder.mlp.0.weight", _t),
                    "b1": src.one("t_embedder.mlp.0.bias"),
                    "w2": src.one("t_embedder.mlp.2.weight", _t),
                    "b2": src.one("t_embedder.mlp.2.bias")},
        "y_embed": {"in": top("y_embedder.y_proj.0"),
                    "out": top("y_embedder.y_proj.2")},
        "blocks": {
            "adaln": lin(b + "adaLN_modulation.1"),
            "attn": {
                "qkv": {"kernel": src.stack(b + "attn.qkv.weight", lambda w: qkv(w).t()),
                        "bias": src.stack(b + "attn.qkv.bias", qkv)},
                "proj": lin(b + "attn.proj"),
                "q_norm": src.stack(b + "attn.q_norm.weight", qk_norm),
                "k_norm": src.stack(b + "attn.k_norm.weight", qk_norm),
            },
            "cross_attn": {
                "q": lin(b + "cross_attn.q_linear"),
                "kv": lin(b + "cross_attn.kv_linear"),
                "proj": lin(b + "cross_attn.proj"),
                "q_norm": src.stack(b + "cross_attn.q_norm.weight"),
                "k_norm": src.stack(b + "cross_attn.k_norm.weight"),
            },
            "pre_crs_norm": {"weight": src.stack(b + "pre_crs_attn_norm.weight"),
                             "bias": src.stack(b + "pre_crs_attn_norm.bias")},
            "ffn": {name: {"kernel": src.stack(b + f"ffn.{name}.weight", _t)}
                    for name in ("w1", "w3", "w2")},
        },
        "final": {"adaln": top("final_layer.adaLN_modulation.1"),
                  "proj": top("final_layer.linear")},
    }


def umt5_tree(src: _Source, cfg: TextEncoderConfig) -> Dict:
    """The reference's UMT5 tree (``convert_torch_umt5_state``) over a HF
    ``UMT5EncoderModel`` state dict: one relative-attention-bias table per
    layer, Linear weights transposed. A tied ``encoder.embed_tokens.weight``
    is accepted only when it equals ``shared.weight``."""
    if "encoder.embed_tokens.weight" in src.sd:
        if not torch.equal(src.load("encoder.embed_tokens.weight"),
                           src.load("shared.weight")):
            raise ValueError("encoder.embed_tokens.weight differs from shared.weight: "
                             "an untied UMT5 embedding is not this layout")
    att = "encoder.block.{}.layer.0.SelfAttention."
    ff = "encoder.block.{}.layer.1.DenseReluDense."
    blocks = {name: src.stack(att + f"{name}.weight", _t) for name in "qkvo"}
    blocks.update({
        "ln1": src.stack("encoder.block.{}.layer.0.layer_norm.weight"),
        "ln2": src.stack("encoder.block.{}.layer.1.layer_norm.weight"),
        "rel_bias": src.stack(att + "relative_attention_bias.weight"),
        "wi0": src.stack(ff + "wi_0.weight", _t),
        "wi1": src.stack(ff + "wi_1.weight", _t),
        "wo": src.stack(ff + "wo.weight", _t),
    })
    return {"embed": src.one("shared.weight"), "blocks": blocks,
            "final_ln": src.one("encoder.final_layer_norm.weight")}


def vae_tree(src: _Source, cfg: VAEConfig) -> Dict:
    """The reference's VAE tree (``convert_torch_vae_state``) over a
    Wan2.1-named state dict: Conv3d [Cout, Cin, kt, kh, kw] -> [kt, kh,
    kw, Cin, Cout]; the resample Conv2d as a kt = 1 Conv3d; RMS_norm gamma
    -> weight with a zero bias when the checkpoint has none; the fused 1x1
    ``to_qkv`` split into q, k, v matrices."""
    def c3d(name):
        return {"kernel": src.one(name + ".weight", lambda w: w.permute(2, 3, 4, 1, 0)),
                "bias": src.one(name + ".bias")}

    def c2d(name):
        return {"kernel": src.one(name + ".weight", lambda w: w.permute(2, 3, 1, 0)[None]),
                "bias": src.one(name + ".bias")}

    def norm(name):
        flat = lambda w: w.reshape(-1)
        gamma = src.one(name + ".gamma", flat)
        if name + ".bias" in src.sd:
            return {"weight": gamma, "bias": src.one(name + ".bias", flat)}
        return {"weight": gamma, "bias": lambda index: torch.zeros_like(gamma(None))}

    def res(prefix, shortcut):
        p = {"norm1": norm(f"{prefix}.residual.0"), "conv1": c3d(f"{prefix}.residual.2"),
             "norm2": norm(f"{prefix}.residual.3"), "conv2": c3d(f"{prefix}.residual.6")}
        if shortcut:
            p["shortcut"] = c3d(f"{prefix}.shortcut")
        return p

    def attn(prefix):
        def part(i):
            def kernel(w):
                c = w.shape[0] // 3
                return w.reshape(3, c, -1)[i].t()
            def bias(b):
                c = b.shape[0] // 3
                return b[i * c:(i + 1) * c]
            return {"kernel": src.one(f"{prefix}.to_qkv.weight", kernel),
                    "bias": src.one(f"{prefix}.to_qkv.bias", bias)}

        proj = lambda w: w.reshape(w.shape[0], w.shape[0]).t()
        return {"norm": norm(f"{prefix}.norm"), "q": part(0), "k": part(1), "v": part(2),
                "proj": {"kernel": src.one(f"{prefix}.proj.weight", proj),
                         "bias": src.one(f"{prefix}.proj.bias")}}

    def mid(prefix):
        return {"res1": res(f"{prefix}.0", False), "attn": attn(f"{prefix}.1"),
                "res2": res(f"{prefix}.2", False)}

    dims = [cfg.base_dim * m for m in cfg.dim_mults]
    enc_scales, k = [], 0
    for i, cout in enumerate(dims):
        cin = dims[i - 1] if i > 0 else dims[0]
        sp = {"res": []}
        for j in range(cfg.num_res_blocks):
            sp["res"].append(res(f"encoder.downsamples.{k}", (cin if j == 0 else cout) != cout))
            k += 1
        if i < len(dims) - 1:
            sp["sdown"] = c2d(f"encoder.downsamples.{k}.resample.1")
            if cfg.temporal_downsample[i]:
                sp["tdown"] = c3d(f"encoder.downsamples.{k}.time_conv")
            k += 1
        enc_scales.append(sp)
    dec_scales, k = [], 0
    for cin, cout, has_rs, has_t in decoder_channel_plan(cfg):
        sp = {"res": []}
        for j in range(cfg.num_res_blocks + 1):
            sp["res"].append(res(f"decoder.upsamples.{k}", (cin if j == 0 else cout) != cout))
            k += 1
        if has_rs:
            if has_t:
                sp["tup"] = c3d(f"decoder.upsamples.{k}.time_conv")
            sp["sup"] = c2d(f"decoder.upsamples.{k}.resample.1")
            k += 1
        dec_scales.append(sp)
    return {
        "enc": {"conv_in": c3d("encoder.conv1"), "scales": enc_scales,
                "mid": mid("encoder.middle"), "norm_out": norm("encoder.head.0"),
                "conv_out": c3d("encoder.head.2"), "quant": c3d("conv1")},
        "dec": {"post_quant": c3d("conv2"), "conv_in": c3d("decoder.conv1"),
                "mid": mid("decoder.middle"), "scales": dec_scales,
                "norm_out": norm("decoder.head.0"), "conv_out": c3d("decoder.head.2")},
    }


def _load(folder: str, cls, cfg, fill, tree_fn, what: str, device, **kw):
    sd = ShardIndex(folder)
    m = _empty(cls, cfg, device)
    fill(m, tree_getter(tree_fn(_Source(sd, device), cfg, **kw)))
    sd.assert_fully_consumed(what)
    return m


def load_dit_checkpoint(folder: str, cfg: DiTConfig, device="cuda",
                        rope_interleaved: bool = False) -> LongCatDiT:
    """The LongCat DiT of a checkpoint's ``dit/`` shard folder."""
    return _load(folder, LongCatDiT, cfg, _fill_dit, dit_tree, "LongCat DiT", device,
                 rope_interleaved=rope_interleaved)


def load_umt5_checkpoint(folder: str, cfg: TextEncoderConfig,
                         device="cuda") -> UMT5Encoder:
    """UMT5 of a checkpoint's ``text_encoder/`` shard folder."""
    return _load(folder, UMT5Encoder, cfg, _fill_umt5, umt5_tree, "UMT5EncoderModel",
                 device)


def load_vae_checkpoint(folder: str, cfg: VAEConfig, device="cuda") -> WanVAE:
    """The WAN VAE of a checkpoint's ``vae/`` shard folder."""
    return _load(folder, WanVAE, cfg, _fill_vae, vae_tree, "AutoencoderKLWan", device)


# ---------------------------------------------------------------------------
# The upstream layouts: every key and shape a converter reads
# ---------------------------------------------------------------------------


def dit_state_shapes(cfg: DiTConfig, patch_conv: bool = True) -> Dict[str, tuple]:
    """Key -> shape of a LongCat DiT state dict (the patch embedding as a
    Conv3d, or with ``patch_conv=False`` as a Linear)."""
    D, Ct, F, dh = cfg.hidden_size, cfg.adaln_tembed_dim, cfg.ffn_dim, cfg.head_dim
    pt, ph, pw = cfg.patch_size
    C, Cout = cfg.in_channels, cfg.out_channels
    out = {"x_embedder.proj.weight": (D, C, pt, ph, pw) if patch_conv
           else (D, pt * ph * pw * C),
           "x_embedder.proj.bias": (D,),
           "t_embedder.mlp.0.weight": (Ct, cfg.t_embed_freq_dim),
           "t_embedder.mlp.0.bias": (Ct,),
           "t_embedder.mlp.2.weight": (Ct, Ct), "t_embedder.mlp.2.bias": (Ct,),
           "y_embedder.y_proj.0.weight": (D, cfg.text_dim), "y_embedder.y_proj.0.bias": (D,),
           "y_embedder.y_proj.2.weight": (D, D), "y_embedder.y_proj.2.bias": (D,)}
    for i in range(cfg.depth):
        b = f"blocks.{i}."
        for name, (o, n) in (("adaLN_modulation.1", (6 * D, Ct)), ("attn.qkv", (3 * D, D)),
                             ("attn.proj", (D, D)), ("cross_attn.q_linear", (D, D)),
                             ("cross_attn.kv_linear", (2 * D, D)),
                             ("cross_attn.proj", (D, D))):
            out[b + name + ".weight"], out[b + name + ".bias"] = (o, n), (o,)
        for name in ("attn.q_norm", "attn.k_norm", "cross_attn.q_norm", "cross_attn.k_norm"):
            out[b + name + ".weight"] = (dh,)
        out[b + "pre_crs_attn_norm.weight"] = out[b + "pre_crs_attn_norm.bias"] = (D,)
        out[b + "ffn.w1.weight"] = out[b + "ffn.w3.weight"] = (F, D)
        out[b + "ffn.w2.weight"] = (D, F)
    out.update({"final_layer.adaLN_modulation.1.weight": (2 * D, Ct),
                "final_layer.adaLN_modulation.1.bias": (2 * D,),
                "final_layer.linear.weight": (pt * ph * pw * Cout, D),
                "final_layer.linear.bias": (pt * ph * pw * Cout,)})
    return out


def umt5_state_shapes(cfg: TextEncoderConfig) -> Dict[str, tuple]:
    """Key -> shape of a HF ``UMT5EncoderModel`` state dict."""
    d, inner, dff = cfg.d_model, cfg.num_heads * cfg.d_kv, cfg.d_ff
    out = {"shared.weight": (cfg.vocab_size, d), "encoder.final_layer_norm.weight": (d,)}
    for i in range(cfg.num_layers):
        a = f"encoder.block.{i}.layer.0."
        f = f"encoder.block.{i}.layer.1."
        out.update({a + "SelfAttention.q.weight": (inner, d),
                    a + "SelfAttention.k.weight": (inner, d),
                    a + "SelfAttention.v.weight": (inner, d),
                    a + "SelfAttention.o.weight": (d, inner),
                    a + "SelfAttention.relative_attention_bias.weight":
                        (cfg.relative_attention_num_buckets, cfg.num_heads),
                    a + "layer_norm.weight": (d,),
                    f + "DenseReluDense.wi_0.weight": (dff, d),
                    f + "DenseReluDense.wi_1.weight": (dff, d),
                    f + "DenseReluDense.wo.weight": (d, dff),
                    f + "layer_norm.weight": (d,)})
    return out


def vae_state_shapes(cfg: VAEConfig) -> Dict[str, tuple]:
    """Key -> shape of a Wan2.1-named VAE state dict (norms bias-free)."""
    out: Dict[str, tuple] = {}

    def conv3(name, cin, cout, kt, kh, kw):
        out[name + ".weight"], out[name + ".bias"] = (cout, cin, kt, kh, kw), (cout,)

    def conv2(name, cin, cout, k=3):
        out[name + ".weight"], out[name + ".bias"] = (cout, cin, k, k), (cout,)

    def norm(name, c):
        out[name + ".gamma"] = (c, 1, 1, 1)

    def res(prefix, cin, cout):
        norm(prefix + ".residual.0", cin)
        conv3(prefix + ".residual.2", cin, cout, 3, 3, 3)
        norm(prefix + ".residual.3", cout)
        conv3(prefix + ".residual.6", cout, cout, 3, 3, 3)
        if cin != cout:
            conv3(prefix + ".shortcut", cin, cout, 1, 1, 1)

    def mid(prefix, c):
        res(prefix + ".0", c, c)
        norm(prefix + ".1.norm", c)
        conv2(prefix + ".1.to_qkv", c, 3 * c, 1)
        conv2(prefix + ".1.proj", c, c, 1)
        res(prefix + ".2", c, c)

    dims = [cfg.base_dim * m for m in cfg.dim_mults]
    conv3("encoder.conv1", 3, dims[0], 3, 3, 3)
    k = 0
    for i, cout in enumerate(dims):
        cin = dims[i - 1] if i > 0 else dims[0]
        for j in range(cfg.num_res_blocks):
            res(f"encoder.downsamples.{k}", cin if j == 0 else cout, cout)
            k += 1
        if i < len(dims) - 1:
            conv2(f"encoder.downsamples.{k}.resample.1", cout, cout)
            if cfg.temporal_downsample[i]:
                conv3(f"encoder.downsamples.{k}.time_conv", cout, cout, 3, 1, 1)
            k += 1
    mid("encoder.middle", dims[-1])
    norm("encoder.head.0", dims[-1])
    conv3("encoder.head.2", dims[-1], 2 * cfg.z_dim, 3, 3, 3)
    conv3("conv1", 2 * cfg.z_dim, 2 * cfg.z_dim, 1, 1, 1)
    conv3("conv2", cfg.z_dim, cfg.z_dim, 1, 1, 1)
    conv3("decoder.conv1", cfg.z_dim, dims[-1], 3, 3, 3)
    mid("decoder.middle", dims[-1])
    k = 0
    for cin, cout, has_rs, has_t in decoder_channel_plan(cfg):
        for j in range(cfg.num_res_blocks + 1):
            res(f"decoder.upsamples.{k}", cin if j == 0 else cout, cout)
            k += 1
        if has_rs:  # the Wan decoder's spatial resample conv halves channels
            conv2(f"decoder.upsamples.{k}.resample.1", cout, cout // 2)
            if has_t:
                conv3(f"decoder.upsamples.{k}.time_conv", cout, 2 * cout, 3, 1, 1)
            k += 1
    norm("decoder.head.0", dims[0])
    conv3("decoder.head.2", dims[0], 3, 3, 3, 3)
    return out


STATE_SHAPES = {"dit": lambda cfg: dit_state_shapes(cfg.dit),
                "vae": lambda cfg: vae_state_shapes(cfg.vae),
                "text_encoder": lambda cfg: umt5_state_shapes(cfg.text)}
