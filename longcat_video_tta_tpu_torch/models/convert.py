"""Checkpoints in the upstream torch layout -> the port's modules
(counterpart of ``longcat_video_tta_tpu/models/convert.py``'s
``convert_torch_dit_state`` :175, ``convert_torch_umt5_state`` :347,
``convert_torch_vae_state`` :462, ``convert_torch_mmdit_state`` :624 and
``convert_torch_cogvideox_state`` :1031, with the same key mapping,
transposes and RoPE row permutations).

Where the reference converts a whole state dict into a numpy tree, this
module converts one tensor at a time: each converter builds a tree of the
reference's shape whose leaves are functions of the block index; the
traversals of ``models/weights.py`` call them leaf by leaf, and each leaf
reads its shard tensor, moves it to the device in the shard's dtype and
transposes or flattens it there; ``weights._set`` then casts it to the
parameter's dtype. So a 13.6B checkpoint never stands whole on the host,
in fp32 or otherwise. Every converter refuses a layout it does not
understand: a missing key raises ``KeyError``, a key left unread raises
``ValueError`` (the reference's ``_TrackedStateDict`` rule, :139-165, which
its CogVideoX converter applies, here for the DiT, the MMDiT and UMT5
too; the reference's MMDiT converter does not track its reads).

The CLIP part (the reference's :761-1023) maps Hugging Face ``CLIPModel``,
``CLIPTextModel`` and ``XCLIPModel`` state dicts onto the port's towers
(``models/clip.py``, ``models/xclip.py``) through ``load_mapped``, which
the evaluation towers' converters (``eval/``) share.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import torch

from ..config import (
    CLIPTextConfig,
    CogVideoXConfig,
    DiTConfig,
    MMDiTConfig,
    TextEncoderConfig,
    VAEConfig,
)
from ..utils.safetensors import ShardIndex
from .cogvideox import CogVideoX
from .dit import LongCatDiT
from .mmdit import MMDiT
from .umt5 import UMT5Encoder
from .vae import WanVAE, decoder_channel_plan
from .weights import (
    Getter,
    _empty,
    _fill_cogvideox,
    _fill_dit,
    _fill_mmdit,
    _fill_umt5,
    _fill_vae,
)

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


def mmdit_tree(src: _Source, cfg: MMDiTConfig) -> Dict:
    """The reference's MMDiT tree (``convert_torch_mmdit_state``) over an
    Open-Sora v2 / Flux state dict: Linear weights transposed; the q/k rows
    of every fused qkv (double blocks) and of ``linear1``'s qkv part
    (single blocks; its mlp rows untouched), with their biases and the
    q/k RMSNorm scales, permuted from the interleaved RoPE pairs to the
    half-split rotation (``permute_qkv_rows``); the cond embedding under
    ``cond_in`` or ``cond_embed``."""
    nH, dh = cfg.num_heads, cfg.head_dim
    perm = lambda w: w[rope_perm(dh).to(w.device)]
    qkv_w = lambda w: permute_qkv_rows(w, nH, dh).t()
    qkv_b = lambda b: permute_qkv_rows(b, nH, dh)
    lin = lambda fmt: {"kernel": src.stack(fmt + ".weight", _t),
                       "bias": src.stack(fmt + ".bias")}
    top = lambda name: {"kernel": src.one(name + ".weight", _t),
                        "bias": src.one(name + ".bias")}

    def emb(prefix):
        return {"w1": src.one(prefix + ".in_layer.weight", _t),
                "b1": src.one(prefix + ".in_layer.bias"),
                "w2": src.one(prefix + ".out_layer.weight", _t),
                "b2": src.one(prefix + ".out_layer.bias")}

    def attn(stream):
        b = "double_blocks.{}." + stream + "_attn"
        return {"qkv": {"kernel": src.stack(b + ".qkv.weight", qkv_w),
                        "bias": src.stack(b + ".qkv.bias", qkv_b)},
                "q_norm": src.stack(b + ".norm.query_norm.scale", perm),
                "k_norm": src.stack(b + ".norm.key_norm.scale", perm),
                "proj": lin(b + ".proj")}

    def mlp(stream):
        b = "double_blocks.{}." + stream + "_mlp"
        return {"w_in": lin(b + ".0"), "w_out": lin(b + ".2")}

    s = "single_blocks.{}."
    tree = {
        "img_in": top("img_in"), "txt_in": top("txt_in"),
        "time_in": emb("time_in"), "vector_in": emb("vector_in"),
        "double": {"img_mod": lin("double_blocks.{}.img_mod.lin"),
                   "txt_mod": lin("double_blocks.{}.txt_mod.lin"),
                   "img_attn": attn("img"), "txt_attn": attn("txt"),
                   "img_mlp": mlp("img"), "txt_mlp": mlp("txt")},
        "single": {"mod": lin(s + "modulation.lin"),
                   "linear1": {"kernel": src.stack(s + "linear1.weight", qkv_w),
                               "bias": src.stack(s + "linear1.bias", qkv_b)},
                   "q_norm": src.stack(s + "norm.query_norm.scale", perm),
                   "k_norm": src.stack(s + "norm.key_norm.scale", perm),
                   "linear2": lin(s + "linear2")},
        "final": {"adaln": top("final_layer.adaLN_modulation.1"),
                  "proj": top("final_layer.linear")},
    }
    if cfg.cond_embed:
        tree["cond_in"] = top("cond_in" if "cond_in.weight" in src.sd else "cond_embed")
    if cfg.guidance_embed:
        tree["guidance_in"] = emb("guidance_in")
    return tree


def cogvideox_tree(src: _Source, cfg: CogVideoXConfig) -> Dict:
    """The reference's CogVideoX tree (``convert_torch_cogvideox_state``)
    over a diffusers ``CogVideoXTransformer3DModel`` state dict: Linear
    weights transposed; the Conv2d patch kernel [D, C, p, p] as the dense
    [(c, ph, pw), D] of ``pack_latents``' channel order; the rows of each
    head of to_q / to_k, their biases and the q/k LayerNorm affines
    permuted from interleaved RoPE pairs to the half-split rotation
    (``rope_perm``); ``patch_embed.pos_embedding`` [1, len, D] as
    ``pos_embed`` [len, D] when the config has a learned table."""
    nH, dh = cfg.num_heads, cfg.head_dim
    perm = lambda w: w[rope_perm(dh).to(w.device)]

    def head_rows(w):  # [H dh, ...]: each head's rows by rope_perm
        rows = torch.arange(w.shape[0], device=w.device).view(nH, dh)
        return w[rows[:, rope_perm(dh).to(w.device)].reshape(-1)]

    lin = lambda fmt: {"kernel": src.stack(fmt + ".weight", _t),
                       "bias": src.stack(fmt + ".bias")}
    top = lambda name: {"kernel": src.one(name + ".weight", _t),
                        "bias": src.one(name + ".bias")}
    norm = lambda fmt, fn=lambda w: w: {"weight": src.stack(fmt + ".weight", fn),
                                        "bias": src.stack(fmt + ".bias", fn)}
    b = "transformer_blocks.{}."
    a = b + "attn1."

    def qk(name):
        return {"kernel": src.stack(a + name + ".weight", lambda w: head_rows(w).t()),
                "bias": src.stack(a + name + ".bias", head_rows)}

    def norm_zero(n):
        return {"lin": lin(b + n + ".linear"), "ln": norm(b + n + ".norm")}

    def patch_kernel(w):  # Conv2d [D, C, p, p] -> [(c, ph, pw), D]
        return w.permute(1, 2, 3, 0).reshape(-1, w.shape[0])

    tree = {
        "patch_embed": {"kernel": src.one("patch_embed.proj.weight", patch_kernel),
                        "bias": src.one("patch_embed.proj.bias")},
        "text_proj": top("patch_embed.text_proj"),
        "time_embed": {"w1": src.one("time_embedding.linear_1.weight", _t),
                       "b1": src.one("time_embedding.linear_1.bias"),
                       "w2": src.one("time_embedding.linear_2.weight", _t),
                       "b2": src.one("time_embedding.linear_2.bias")},
        "blocks": {
            "norm1": norm_zero("norm1"),
            "attn": {"to_q": qk("to_q"), "to_k": qk("to_k"), "to_v": lin(a + "to_v"),
                     "to_out": lin(a + "to_out.0"),
                     "norm_q": norm(a + "norm_q", perm), "norm_k": norm(a + "norm_k", perm)},
            "norm2": norm_zero("norm2"),
            "ff": {"w_in": lin(b + "ff.net.0.proj"), "w_out": lin(b + "ff.net.2")},
        },
        "norm_final": {"weight": src.one("norm_final.weight"),
                       "bias": src.one("norm_final.bias")},
        "norm_out": {"lin": top("norm_out.linear"),
                     "ln": {"weight": src.one("norm_out.norm.weight"),
                            "bias": src.one("norm_out.norm.bias")}},
        "proj_out": top("proj_out"),
    }
    if cfg.learned_pos_embed_len > 0:
        if "patch_embed.pos_embedding" not in src.sd:
            raise ValueError("cfg.learned_pos_embed_len > 0 but the checkpoint has no "
                             "patch_embed.pos_embedding key")
        tree["pos_embed"] = src.one("patch_embed.pos_embedding",
                                    lambda w: w.reshape(-1, w.shape[-1]))
    return tree


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


def _load(folder: str, cls, cfg, fill, tree_fn, what: str, device, mesh=None,
          arch: str = "longcat", **kw):
    """``cls`` filled from ``folder``'s shards, tensor by tensor. With a
    ``mesh`` that has a tensor axis the module's linears are this rank's
    slices (``models/weights.py::_empty``): each full tensor is read,
    sliced and dropped before the next is read."""
    sd = ShardIndex(folder)
    m = _empty(cls, cfg, device, mesh, arch)
    fill(m, tree_getter(tree_fn(_Source(sd, device), cfg, **kw)))
    sd.assert_fully_consumed(what)
    return m


def load_dit_checkpoint(folder: str, cfg: DiTConfig, device="cuda",
                        rope_interleaved: bool = False, mesh=None) -> LongCatDiT:
    """The LongCat DiT of a checkpoint's ``dit/`` shard folder (with a
    ``mesh``, this rank's)."""
    return _load(folder, LongCatDiT, cfg, _fill_dit, dit_tree, "LongCat DiT", device,
                 mesh, "longcat", rope_interleaved=rope_interleaved)


def load_mmdit_checkpoint(folder: str, cfg: MMDiTConfig, device="cuda",
                          mesh=None) -> MMDiT:
    """The Open-Sora v2 MMDiT of a checkpoint's ``dit/`` shard folder (with
    a ``mesh``, this rank's)."""
    return _load(folder, MMDiT, cfg, _fill_mmdit, mmdit_tree, "Open-Sora MMDiT", device,
                 mesh, "mmdit")


def load_cogvideox_checkpoint(folder: str, cfg: CogVideoXConfig,
                              device="cuda", mesh=None) -> CogVideoX:
    """The CogVideoX of a checkpoint's ``dit/`` shard folder (a diffusers
    ``CogVideoXTransformer3DModel`` state dict; with a ``mesh``, this
    rank's). A ``pos_embedding`` in the folder is applied, as the
    reference's converter applies it: the module gets a learned table of
    its length when the config has none."""
    import dataclasses

    sd = ShardIndex(folder)
    key = "patch_embed.pos_embedding"
    if cfg.learned_pos_embed_len == 0 and key in sd:
        cfg = dataclasses.replace(cfg, learned_pos_embed_len=sd[key].shape[-2])
    return _load(folder, CogVideoX, cfg, _fill_cogvideox, cogvideox_tree, "CogVideoX",
                 device, mesh, "cogvideox")


def load_clip_text_checkpoint(folder: str, cfg: CLIPTextConfig, device="cuda"):
    """The CLIP text tower of a checkpoint's ``clip/`` shard folder (a HF
    ``CLIPTextModel`` state dict), through ``convert_torch_clip_text_state``:
    a key left unread raises."""
    sd = ShardIndex(folder)
    return convert_torch_clip_text_state({k: sd[k] for k in sd.keys()}, cfg, device)


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


def mmdit_state_shapes(cfg: MMDiTConfig) -> Dict[str, tuple]:
    """Key -> shape of an Open-Sora v2 / Flux MMDiT state dict (with
    ``cond_in``)."""
    D, mlp, dh = cfg.hidden_size, cfg.mlp_dim, cfg.head_dim
    out: Dict[str, tuple] = {}

    def lin(name, din, dout):
        out[name + ".weight"], out[name + ".bias"] = (dout, din), (dout,)

    lin("img_in", cfg.packed_channels, D)
    lin("txt_in", cfg.context_in_dim, D)
    if cfg.cond_embed:
        lin("cond_in", cfg.cond_channels, D)
    embedders = [("time_in", cfg.t_embed_freq_dim), ("vector_in", cfg.vec_in_dim)]
    if cfg.guidance_embed:
        embedders.append(("guidance_in", cfg.t_embed_freq_dim))
    for name, din in embedders:
        lin(name + ".in_layer", din, D)
        lin(name + ".out_layer", D, D)
    for i in range(cfg.depth_double):
        b = f"double_blocks.{i}."
        for st in ("img", "txt"):
            lin(b + st + "_mod.lin", D, 6 * D)
            lin(b + st + "_attn.qkv", D, 3 * D)
            out[b + st + "_attn.norm.query_norm.scale"] = (dh,)
            out[b + st + "_attn.norm.key_norm.scale"] = (dh,)
            lin(b + st + "_attn.proj", D, D)
            lin(b + st + "_mlp.0", D, mlp)
            lin(b + st + "_mlp.2", mlp, D)
    for i in range(cfg.depth_single):
        b = f"single_blocks.{i}."
        lin(b + "linear1", D, 3 * D + mlp)
        lin(b + "linear2", D + mlp, D)
        out[b + "norm.query_norm.scale"] = out[b + "norm.key_norm.scale"] = (dh,)
        lin(b + "modulation.lin", D, 3 * D)
    lin("final_layer.adaLN_modulation.1", D, 2 * D)
    lin("final_layer.linear", D, cfg.packed_channels)
    return out


def clip_text_state_shapes(cfg: CLIPTextConfig) -> Dict[str, tuple]:
    """Key -> shape of a HF ``CLIPTextModel`` state dict."""
    W, pre = cfg.width, "text_model."
    out = {pre + "embeddings.token_embedding.weight": (cfg.vocab_size, W),
           pre + "embeddings.position_embedding.weight": (cfg.max_length, W),
           pre + "final_layer_norm.weight": (W,), pre + "final_layer_norm.bias": (W,)}
    for i in range(cfg.num_layers):
        b = f"{pre}encoder.layers.{i}."
        for n in ("layer_norm1", "layer_norm2"):
            out[b + n + ".weight"] = out[b + n + ".bias"] = (W,)
        for n, (o, i_) in (("self_attn.q_proj", (W, W)), ("self_attn.k_proj", (W, W)),
                           ("self_attn.v_proj", (W, W)), ("self_attn.out_proj", (W, W)),
                           ("mlp.fc1", (4 * W, W)), ("mlp.fc2", (W, 4 * W))):
            out[b + n + ".weight"], out[b + n + ".bias"] = (o, i_), (o,)
    return out


STATE_SHAPES = {"dit": lambda cfg: dit_state_shapes(cfg.dit),
                "vae": lambda cfg: vae_state_shapes(cfg.vae),
                "text_encoder": lambda cfg: umt5_state_shapes(cfg.text)}
# the MMDiT's folders <dir>/{dit,vae,text_encoder,clip}: dit/ and clip/ in
# Open-Sora v2's layout; text_encoder/ in the UMT5 per-block layout
# (``umt5_tree`` reads a relative_attention_bias in every block), which
# T5 v1.1 checkpoints, with one in block 0 only, do not have
MMDIT_STATE_SHAPES = {"dit": lambda cfg: mmdit_state_shapes(cfg.dit),
                      "vae": lambda cfg: vae_state_shapes(cfg.vae),
                      "text_encoder": lambda cfg: umt5_state_shapes(cfg.text),
                      "clip": lambda cfg: clip_text_state_shapes(cfg.clip)}


# ---------------------------------------------------------------------------
# CLIP / X-CLIP (Hugging Face CLIPModel / XCLIPModel state dicts)
# ---------------------------------------------------------------------------


class TrackedStateDict(dict):
    """An in-memory state dict that records the keys read, so a converter
    can refuse a layout it did not read in full (the reference's
    ``_TrackedStateDict``, ``models/convert.py:139``)."""

    def __init__(self, sd):
        super().__init__(sd)
        self.accessed = set()

    def __getitem__(self, k):
        self.accessed.add(k)
        return super().__getitem__(k)

    def ignore(self, pred: Callable[[str], bool]) -> None:
        """Count the keys ``pred`` accepts as read (buffers a converter
        does not need)."""
        self.accessed.update(k for k in self if pred(k))

    def assert_fully_consumed(self, what: str) -> None:
        leftover = sorted(set(self) - self.accessed)
        if leftover:
            shown = ", ".join(leftover[:8])
            more = f" (+{len(leftover) - 8} more)" if len(leftover) > 8 else ""
            raise ValueError(
                f"{what} conversion left {len(leftover)} state-dict key(s) "
                f"unconsumed: {shown}{more}; the converter does not understand "
                "this checkpoint layout and refuses a partial conversion")


def as_f32(value, device) -> torch.Tensor:
    """A state-dict value (tensor or numpy array) as an fp32 tensor on
    ``device``."""
    import numpy as np

    t = value if isinstance(value, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(value))
    return t.to(device=device, dtype=torch.float32)


def load_mapped(module_fn: Callable[[], torch.nn.Module], sd: TrackedStateDict,
                pairs, what: str, device) -> torch.nn.Module:
    """Build ``module_fn()`` without memory, fill it from ``sd`` through
    ``pairs`` of (module key, checkpoint key or constant tensor[,
    transform]) and return it in eval mode on ``device``. A checkpoint
    key that is missing raises ``KeyError``, one left unread
    ``ValueError``, a module key no pair fills or a shape that differs
    ``RuntimeError``."""
    mapped = {}
    for ours, theirs, *fn in pairs:
        t = as_f32(sd[theirs] if isinstance(theirs, str) else theirs, device)
        mapped[ours] = fn[0](t) if fn else t
    sd.assert_fully_consumed(what)
    with torch.device("meta"):
        module = module_fn()
    module.load_state_dict(mapped, strict=True, assign=True)
    return module.eval().requires_grad_(False)


# port layer name -> Hugging Face CLIPEncoderLayer name
_CLIP_LAYER = (("ln1", "layer_norm1"), ("q", "self_attn.q_proj"), ("k", "self_attn.k_proj"),
               ("v", "self_attn.v_proj"), ("out", "self_attn.out_proj"),
               ("ln2", "layer_norm2"), ("fc1", "mlp.fc1"), ("fc2", "mlp.fc2"))
# X-CLIP vision layers add the message attention
_XCLIP_VISION_LAYER = (("msg_fc", "message_fc"), ("msg_ln", "message_ln"),
                       ("msg_q", "message_attn.q_proj"), ("msg_k", "message_attn.k_proj"),
                       ("msg_v", "message_attn.v_proj"),
                       ("msg_out", "message_attn.out_proj")) + _CLIP_LAYER
# X-CLIP prompt-generator decoder layers (q, k, v carry no bias)
_PROMPT_LAYER = (("norm1", "norm1"), ("proj", "cross_attn.proj"), ("norm3", "norm3"),
                 ("fc1", "mlp.0"), ("fc2", "mlp.3"))


def _pairs(ours: str, theirs: str, names=("weight", "bias")):
    return [(f"{ours}.{n}", f"{theirs}.{n}") for n in names]


def _layer_pairs(ours: str, theirs: str, depth: int, table):
    out = []
    for i in range(depth):
        for a, b in table:
            out += _pairs(f"{ours}.{i}.{a}", f"{theirs}.{i}.{b}")
    return out


def _text_pairs(ours: str, theirs: str, cfg):
    return ([(ours + "token_embedding", theirs + "embeddings.token_embedding.weight"),
             (ours + "position_embedding", theirs + "embeddings.position_embedding.weight")]
            + _layer_pairs(ours + "encoder.layers", theirs + "encoder.layers",
                           cfg.num_layers, _CLIP_LAYER)
            + _pairs(ours + "final_ln", theirs + "final_layer_norm"))


def _vision_pairs(ours: str, theirs: str, cfg, pre_ln: str, table):
    return ([(ours + "class_embedding", theirs + "embeddings.class_embedding"),
             (ours + "patch_embedding.weight", theirs + "embeddings.patch_embedding.weight"),
             (ours + "position_embedding",
              theirs + "embeddings.position_embedding.weight")]
            + _pairs(ours + "pre_ln", theirs + pre_ln)
            + _layer_pairs(ours + "encoder.layers", theirs + "encoder.layers",
                           cfg.num_layers, table)
            + _pairs(ours + "post_ln", theirs + "post_layernorm"))


def _is_position_ids(key: str) -> bool:
    return key.endswith("position_ids")  # buffers of older transformers versions


def convert_torch_clip_text_state(sd, cfg, device="cpu"):
    """A Hugging Face ``CLIPTextModel`` state dict (``text_model.*``, or
    the same names without the prefix) -> ``CLIPTextTower``. Every key is
    read or the conversion refuses (a layer-count mismatch too)."""
    from .clip_text import CLIPTextTower

    pre = "text_model." if any(k.startswith("text_model.") for k in sd) else ""
    sd = TrackedStateDict(sd)
    sd.ignore(_is_position_ids)
    return load_mapped(lambda: CLIPTextTower(cfg), sd, _text_pairs("", pre, cfg),
                       "CLIPTextModel", device)


def convert_torch_clip_model_state(sd, vcfg, tcfg, device="cpu"):
    """A Hugging Face ``CLIPModel`` state dict (``vision_model.*``,
    ``text_model.*``, both projections, ``logit_scale``) -> ``CLIPModel``."""
    from .clip import CLIPModel

    sd = TrackedStateDict(sd)
    sd.ignore(_is_position_ids)
    pairs = (_vision_pairs("vision.", "vision_model.", vcfg, "pre_layrnorm", _CLIP_LAYER)
             + _text_pairs("text.", "text_model.", tcfg)
             + [("visual_projection.weight", "visual_projection.weight"),
                ("text_projection.weight", "text_projection.weight"),
                ("logit_scale", "logit_scale")])
    return load_mapped(lambda: CLIPModel(vcfg, tcfg), sd, pairs, "CLIPModel", device)


def convert_torch_xclip_state(sd, cfg, device="cpu"):
    """A Hugging Face ``XCLIPModel`` state dict -> ``XCLIPModel``: the
    CLIP text tower, the message-attention ViT, the MIT, the prompt
    generator and the projections."""
    from .xclip import XCLIPModel

    sd = TrackedStateDict(sd)
    sd.ignore(_is_position_ids)
    pl = "prompts_generator.decoder"
    prompt_qkv = [(f"prompts.layers.{i}.{n}.weight", f"{pl}.{i}.cross_attn.{n}_proj.weight")
                  for i in range(cfg.prompt_layers) for n in "qkv"]
    pairs = (_vision_pairs("vision.", "vision_model.", cfg.vision, "pre_layernorm",
                           _XCLIP_VISION_LAYER)
             + _text_pairs("text.", "text_model.", cfg.text)
             + [("mit.position_embedding", "mit.position_embedding",
                 lambda t: t.reshape(cfg.num_frames, -1))]
             + _layer_pairs("mit.encoder.layers", "mit.encoder.layers", cfg.mit_layers,
                            _CLIP_LAYER)
             + _pairs("prompts.ln", "prompts_generator.layernorm")
             + [("prompts.alpha", "prompts_generator.alpha")]
             + _layer_pairs("prompts.layers", pl, cfg.prompt_layers, _PROMPT_LAYER)
             + prompt_qkv
             + [("visual_projection.weight", "visual_projection.weight"),
                ("text_projection.weight", "text_projection.weight"),
                ("prompts_visual_projection", "prompts_visual_projection"),
                ("logit_scale", "logit_scale")]
             + _pairs("prompts_visual_ln", "prompts_visual_layernorm"))
    return load_mapped(lambda: XCLIPModel(cfg), sd, pairs, "XCLIPModel", device)


def read_hf_clip_dir(model_path: str):
    """A local Hugging Face CLIP / X-CLIP snapshot folder -> (state dict of
    CPU tensors, parsed ``config.json``): ``model.safetensors`` through the
    port's reader, else ``pytorch_model.bin`` through
    ``torch.load(weights_only=True)``."""
    import json
    import os

    from ..utils.safetensors import load_file

    with open(os.path.join(model_path, "config.json")) as f:
        hf = json.load(f)
    st_path = os.path.join(model_path, "model.safetensors")
    if os.path.exists(st_path):
        return load_file(st_path), hf
    return torch.load(os.path.join(model_path, "pytorch_model.bin"), map_location="cpu",
                      weights_only=True), hf
