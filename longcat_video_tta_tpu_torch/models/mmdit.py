"""Open-Sora v2.0 MMDiT backbone in PyTorch (counterpart of
``longcat_video_tta_tpu/models/mmdit.py``): the Flux-style stack of
``depth_double`` dual-stream blocks (separate img/txt weights, joint
attention over [txt | img]) and ``depth_single`` fused blocks over the
concatenated sequence, as ``nn.ModuleList``s where the reference scans
stacked weights.

Forward contract: latents [B, C, T, H, W] are packed to tokens (t, h, w
order; channels c, ph, pw), the vec is time_in(t-embedding(sigma*1000))
+ vector_in(CLIP pooled y_vec) in fp32 (the delta_a site), ``cond``
[B, 1+C, T, H, W] carries the [masks | masked_ref] v2v conditioning
through ``cond_in``. Every joint attention goes through
``ops/attention.py``: the forward kernel on the card, and under autograd
``FlashAttentionFunction`` (the dQ and dK/dV kernels), with no prefix
mask and no key mask (padded text tokens are attended to, as in the
reference).

RoPE rotates half-split pairs; text tokens get the identity (their ids
are zeros). Upstream checkpoints rotate interleaved pairs, and the
converter permutes the q/k rows (``models/convert.py``).

Adapter dict keys: ``delta_t`` [D] added to the fp32 vec; ``lora_double``
/ ``lora_single`` {site: {'a': [depth, in, r], 'b': [depth, r, out]}}
with ``lora_scale`` (sites img_qkv, img_proj, txt_qkv, txt_proj,
img/txt_mlp_in/out; lin1, lin2). Each may carry a leading lane axis
(``--video-parallel``; ``models/dit.py``).

Parameter names follow the reference's tree under ``double_blocks`` /
``single_blocks`` (``double_blocks[i].img_attn.qkv``,
``single_blocks[i].linear1`` ...); linear weights are [out, in].
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..config import MMDiTConfig, resolve_dtype
from ..ops.attention import attention
from ..ops.layers import (
    lane_rows,
    layer_norm,
    linear,
    mlp_embedder,
    shared_in_group,
    modulate,
    remat_wrap,
    rms_norm,
    rope_3d_angles,
    timestep_embedding,
)
from ..parallel.sharding import tp_size
from ..utils.spans import span
from .dit import block_slice

PORTED_ADAPTERS = ("delta_t", "lora_double", "lora_single", "lora_scale")
PABCache = Tuple[torch.Tensor, torch.Tensor]  # [n_double|n_single, B, L+S, D]


def pack_latents(latents: torch.Tensor, p: int) -> torch.Tensor:
    """[B, C, T, H, W] -> [B, T*Hp*Wp, C*p*p]."""
    B, C, T, H, W = latents.shape
    x = latents.reshape(B, C, T, H // p, p, W // p, p)
    x = x.permute(0, 2, 3, 5, 1, 4, 6)
    return x.reshape(B, T * (H // p) * (W // p), C * p * p)


def unpack_tokens(tokens: torch.Tensor, T: int, H: int, W: int, p: int) -> torch.Tensor:
    """[B, N, C*p*p] -> [B, C, T, H, W]."""
    B, _, Cpp = tokens.shape
    C = Cpp // (p * p)
    x = tokens.reshape(B, T, H // p, W // p, C, p, p)
    x = x.permute(0, 4, 1, 2, 5, 3, 6)
    return x.reshape(B, C, T, H, W)


def rope_joint(cfg: MMDiTConfig, L_txt: int, nt: int, nh: int, nw: int, device=None):
    """cos/sin [L_txt + N_img, head_dim//2] fp32: the identity for the
    text tokens, factored (t, h, w) angles for the video tokens."""
    cos_i, sin_i = rope_3d_angles(nt, nh, nw, cfg.axes_dims, cfg.rope_theta,
                                  device=device)
    half = cfg.head_dim // 2
    cos = torch.cat([torch.ones((L_txt, half), device=device),
                     cos_i.reshape(nt * nh * nw, half)])
    sin = torch.cat([torch.zeros((L_txt, half), device=device),
                     sin_i.reshape(nt * nh * nw, half)])
    return cos, sin


def apply_rope_flat(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor):
    """Half-split rotation. x: [B, S, H, dh]; cos/sin: [S, dh//2]."""
    with span("op.rope"):
        half = x.shape[-1] // 2
        xa, xb = x[..., :half], x[..., half:]
        c = cos[None, :, None, :].to(x.dtype)
        s = sin[None, :, None, :].to(x.dtype)
        return torch.cat([xa * c - xb * s, xb * c + xa * s], dim=-1)


def _embedder(din: int, D: int) -> nn.ModuleDict:
    """The fp32 2-layer SiLU MLP of time_in / vector_in / guidance_in."""
    return nn.ModuleDict({"w1": nn.Linear(din, D, dtype=torch.float32),
                          "w2": nn.Linear(D, D, dtype=torch.float32)})


class _Attn(nn.Module):
    """One stream's attention weights: fused qkv, per-head RMS q/k scales,
    the output projection."""

    def __init__(self, D: int, dh: int, dtype):
        super().__init__()
        self.qkv = nn.Linear(D, 3 * D, dtype=dtype)
        self.q_norm = nn.Parameter(torch.empty(dh, dtype=dtype))
        self.k_norm = nn.Parameter(torch.empty(dh, dtype=dtype))
        self.proj = nn.Linear(D, D, dtype=dtype)


class _MLP(nn.Module):
    def __init__(self, D: int, mlp: int, dtype):
        super().__init__()
        self.w_in = nn.Linear(D, mlp, dtype=dtype)
        self.w_out = nn.Linear(mlp, D, dtype=dtype)

    def forward(self, x, lora_in=None, lora_out=None, scale=None):
        h = F.gelu(linear(self.w_in, x, lora_in, scale), approximate="tanh")
        return linear(self.w_out, h, lora_out, scale)


def _qkv_heads(attn: _Attn, x, nH: int, dh: int, lora=None, scale=None):
    """q, k, v [B, S, H, dh] of one stream, q and k RMS-normed."""
    B, S, _ = x.shape
    qkv = linear(attn.qkv, x, lora, scale).reshape(B, S, 3, nH, dh)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    return (rms_norm(q, shared_in_group(attn.q_norm, attn.qkv)),
            rms_norm(k, shared_in_group(attn.k_norm, attn.qkv)), v)


class DoubleBlock(nn.Module):
    def __init__(self, cfg: MMDiTConfig, dtype):
        super().__init__()
        D, dh, mlp = cfg.hidden_size, cfg.head_dim, cfg.mlp_dim
        self.cfg = cfg
        self.img_mod = nn.Linear(D, 6 * D, dtype=dtype)
        self.txt_mod = nn.Linear(D, 6 * D, dtype=dtype)
        self.img_attn = _Attn(D, dh, dtype)
        self.txt_attn = _Attn(D, dh, dtype)
        self.img_mlp = _MLP(D, mlp, dtype)
        self.txt_mlp = _MLP(D, mlp, dtype)

    def forward(self, img, txt, vec, cos, sin, lora=None, lscale=None,
                pab_cached: Optional[torch.Tensor] = None):
        """-> (img, txt, joint attention output [B, L+S, D]). With
        ``pab_cached`` that output is taken from the cache and the
        attention is skipped (the q/k/v projections too)."""
        cfg = self.cfg
        B, L = txt.shape[:2]
        S = img.shape[1]
        nH, dh = cfg.num_heads // tp_size(self.img_attn.qkv), cfg.head_dim
        lora = lora or {}
        svec = F.silu(vec).to(img.dtype)
        i_sh1, i_sc1, i_g1, i_sh2, i_sc2, i_g2 = \
            linear(self.img_mod, svec)[:, None, :].chunk(6, dim=-1)
        t_sh1, t_sc1, t_g1, t_sh2, t_sc2, t_g2 = \
            linear(self.txt_mod, svec)[:, None, :].chunk(6, dim=-1)
        img_n = modulate(layer_norm(img), i_sh1, i_sc1)
        txt_n = modulate(layer_norm(txt), t_sh1, t_sc1)
        if pab_cached is not None:
            o = pab_cached.to(img.dtype)
        else:
            iq, ik, iv = _qkv_heads(self.img_attn, img_n, nH, dh, lora.get("img_qkv"),
                                    lscale)
            tq, tk, tv = _qkv_heads(self.txt_attn, txt_n, nH, dh, lora.get("txt_qkv"),
                                    lscale)
            q = apply_rope_flat(torch.cat([tq, iq], dim=1), cos, sin)
            k = apply_rope_flat(torch.cat([tk, ik], dim=1), cos, sin)
            v = torch.cat([tv, iv], dim=1)
            o = attention(q, k, v).reshape(B, L + S, -1).to(img.dtype)
        t_o, i_o = o[:, :L], o[:, L:]
        img = img + i_g1 * linear(self.img_attn.proj, i_o, lora.get("img_proj"), lscale)
        txt = txt + t_g1 * linear(self.txt_attn.proj, t_o, lora.get("txt_proj"), lscale)
        h = modulate(layer_norm(img), i_sh2, i_sc2)
        img = img + i_g2 * self.img_mlp(h, lora.get("img_mlp_in"),
                                        lora.get("img_mlp_out"), lscale)
        h = modulate(layer_norm(txt), t_sh2, t_sc2)
        txt = txt + t_g2 * self.txt_mlp(h, lora.get("txt_mlp_in"),
                                        lora.get("txt_mlp_out"), lscale)
        return img, txt, o


class SingleBlock(nn.Module):
    def __init__(self, cfg: MMDiTConfig, dtype):
        super().__init__()
        D, dh, mlp = cfg.hidden_size, cfg.head_dim, cfg.mlp_dim
        self.cfg = cfg
        self.mod = nn.Linear(D, 3 * D, dtype=dtype)
        self.linear1 = nn.Linear(D, 3 * D + mlp, dtype=dtype)
        self.q_norm = nn.Parameter(torch.empty(dh, dtype=dtype))
        self.k_norm = nn.Parameter(torch.empty(dh, dtype=dtype))
        self.linear2 = nn.Linear(D + mlp, D, dtype=dtype)

    def forward(self, x, vec, cos, sin, lora=None, lscale=None,
                pab_cached: Optional[torch.Tensor] = None):
        """-> (x, attention output [B, S, D]). ``linear1`` runs on PAB
        reuse steps too (the mlp half shares it); only rope, the norms and
        the attention are skipped. q, k and v are strided views of
        ``linear1``'s output (token stride 3D + mlp), which the kernels
        take as they are."""
        cfg = self.cfg
        B, S, _ = x.shape
        nH, dh = cfg.num_heads // tp_size(self.linear1), cfg.head_dim
        D = nH * dh  # this rank's attention features (all of them on one rank)
        lora = lora or {}
        shift, scale, gate = linear(self.mod, F.silu(vec).to(x.dtype))[:, None, :].chunk(
            3, dim=-1)
        xn = modulate(layer_norm(x), shift, scale)
        h = linear(self.linear1, xn, lora.get("lin1"), lscale)
        qkv, mlp_h = h[..., :3 * D], h[..., 3 * D:]
        if pab_cached is not None:
            o = pab_cached.to(x.dtype)
        else:
            qkv = qkv.reshape(B, S, 3, nH, dh)
            q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
            q = apply_rope_flat(rms_norm(q, shared_in_group(self.q_norm, self.linear1)),
                                cos, sin)
            k = apply_rope_flat(rms_norm(k, shared_in_group(self.k_norm, self.linear1)),
                                cos, sin)
            o = attention(q, k, v).reshape(B, S, D).to(x.dtype)
        out = linear(self.linear2,
                     torch.cat([o, F.gelu(mlp_h, approximate="tanh")], dim=-1),
                     lora.get("lin2"), lscale)
        return x + gate * out, o


class MMDiT(nn.Module):
    """The full MMDiT. Velocity outputs are fp32 [B, C, T, H, W]."""

    def __init__(self, cfg: MMDiTConfig):
        super().__init__()
        self.cfg = cfg
        pdtype = resolve_dtype(cfg.param_dtype)
        D = cfg.hidden_size
        self.img_in = nn.Linear(cfg.packed_channels, D, dtype=pdtype)
        self.txt_in = nn.Linear(cfg.context_in_dim, D, dtype=pdtype)
        self.time_in = _embedder(cfg.t_embed_freq_dim, D)
        self.vector_in = _embedder(cfg.vec_in_dim, D)
        if cfg.guidance_embed:
            self.guidance_in = _embedder(cfg.t_embed_freq_dim, D)
        if cfg.cond_embed:
            self.cond_in = nn.Linear(cfg.cond_channels, D, dtype=pdtype)
        self.double_blocks = nn.ModuleList([DoubleBlock(cfg, pdtype)
                                     for _ in range(cfg.depth_double)])
        self.single_blocks = nn.ModuleList([SingleBlock(cfg, pdtype)
                                     for _ in range(cfg.depth_single)])
        self.final = nn.ModuleDict({
            "adaln": nn.Linear(D, 2 * D, dtype=pdtype),
            "proj": nn.Linear(D, cfg.packed_channels, dtype=pdtype),
        })

    @staticmethod
    def _block_lora(group: Optional[Dict], i: int) -> Optional[Dict]:
        if not group:
            return None
        return {site: {"a": block_slice(ab["a"], 3, i), "b": block_slice(ab["b"], 3, i)}
                for site, ab in group.items()}

    def forward(self, latents, sigma, txt, y_vec, cond=None, guidance=None, *,
                adapters: Optional[Dict] = None, pab_reuse: bool = False,
                pab_cache: Optional[PABCache] = None,
                cache_cond_first: bool = False) -> torch.Tensor:
        """Velocity [B, C, T, H, W] fp32 from latents [B, C, T, H, W],
        sigma [B] (flow-match time in [0, 1]), txt [B, L, context_in_dim],
        y_vec [B, vec_in_dim], optional ``cond`` [B, 1+C, T, H, W].

        ``pab_cache`` (double, single) [n_blocks, B_cache, L+S, D]
        (``pab_init_cache_mmdit``): with ``pab_reuse`` each block takes its
        attention output from its slot and skips the attention; otherwise
        it writes the output there in place. ``cache_cond_first``: the
        CFG-reuse conditional-only forward, where the inputs carry B rows
        and each block uses the first B rows of its slot (a view, no
        copy). In training (grad enabled) each block is checkpointed when
        ``cfg.remat``."""
        cfg = self.cfg
        adapters = adapters or {}
        unported = sorted(set(adapters) - set(PORTED_ADAPTERS))
        if unported:
            raise NotImplementedError(f"MMDiT adapters {unported} are not ported (it "
                                      f"takes {', '.join(PORTED_ADAPTERS)})")
        cdtype = resolve_dtype(cfg.compute_dtype)
        B, C, T, H, W = latents.shape
        p = cfg.patch_size
        L = txt.shape[1]

        img = linear(self.img_in, pack_latents(latents.to(cdtype), p))
        if cond is not None:
            img = img + linear(self.cond_in, pack_latents(cond.to(cdtype), p))
        txt_h = linear(self.txt_in, txt.to(cdtype))

        t_feat = timestep_embedding(sigma.float() * 1000.0, cfg.t_embed_freq_dim)
        vec = mlp_embedder(self.time_in["w1"], self.time_in["w2"], t_feat)
        vec = vec + mlp_embedder(self.vector_in["w1"], self.vector_in["w2"],
                                 y_vec.float())
        if cfg.guidance_embed and guidance is not None:
            vec = vec + mlp_embedder(
                self.guidance_in["w1"], self.guidance_in["w2"],
                timestep_embedding(guidance.float() * 1000.0, cfg.t_embed_freq_dim))
        if adapters.get("delta_t") is not None:
            vec = vec + lane_rows(adapters["delta_t"].float(), 1, B)

        cos, sin = rope_joint(cfg, L, T, H // p, W // p, device=latents.device)
        lscale = adapters.get("lora_scale", 1.0)
        lora_d, lora_s = adapters.get("lora_double"), adapters.get("lora_single")
        nb = latents.shape[0]

        # under a tensor axis a block's attention output holds this rank's
        # features: its slot is that many leading features of the cache
        n_feat = cfg.hidden_size // tp_size(self.single_blocks[0].linear1) \
            if len(self.single_blocks) else cfg.hidden_size

        def slot(cache, i):
            if cache is None:
                return None
            return (cache[i][:nb] if cache_cond_first else cache[i])[..., :n_feat]

        dbl_cache, sgl_cache = pab_cache if pab_cache is not None else (None, None)
        reuse = pab_cache is not None and pab_reuse

        def dbl(blk, img, txt_h, vec, lora):
            with span("dit.block"):
                return blk(img, txt_h, vec, cos, sin, lora, lscale)[:2]

        def sgl(blk, x, vec, lora):
            with span("dit.block"):
                return blk(x, vec, cos, sin, lora, lscale)[0]

        train = cfg.remat and torch.is_grad_enabled() and pab_cache is None
        dbl_body = remat_wrap(dbl, train, cfg.remat_policy)
        sgl_body = remat_wrap(sgl, train, cfg.remat_policy)
        for i, blk in enumerate(self.double_blocks):
            lora = self._block_lora(lora_d, i)
            if pab_cache is None:
                img, txt_h = dbl_body(blk, img, txt_h, vec, lora)
                continue
            s = slot(dbl_cache, i)
            with span("dit.block"):
                img, txt_h, o = blk(img, txt_h, vec, cos, sin, lora, lscale,
                                    pab_cached=s if reuse else None)
            if not reuse:
                s.copy_(o)
        x = torch.cat([txt_h, img], dim=1)
        for i, blk in enumerate(self.single_blocks):
            lora = self._block_lora(lora_s, i)
            if pab_cache is None:
                x = sgl_body(blk, x, vec, lora)
                continue
            s = slot(sgl_cache, i)
            with span("dit.block"):
                x, o = blk(x, vec, cos, sin, lora, lscale, pab_cached=s if reuse else None)
            if not reuse:
                s.copy_(o)
        img = x[:, L:]

        shift, scale = linear(self.final["adaln"],
                              F.silu(vec).to(cdtype))[:, None, :].chunk(2, dim=-1)
        img = modulate(layer_norm(img), shift, scale)
        img = linear(self.final["proj"], img)
        return unpack_tokens(img, T, H, W, p).float()


def pab_init_cache_mmdit(cfg: MMDiTConfig, batch: int, t_lat: int, lat_h: int,
                         lat_w: int, text_len: int, device=None) -> PABCache:
    """Zero PAB caches (double, single) of the joint attention outputs,
    each [n_blocks, B, L+S, hidden] in the compute dtype (the sampler
    computes step 0, so the zeros are never read)."""
    p = cfg.patch_size
    s_joint = text_len + t_lat * (lat_h // p) * (lat_w // p)
    dt = resolve_dtype(cfg.compute_dtype)
    shape = (batch, s_joint, cfg.hidden_size)
    return (torch.zeros((cfg.depth_double, *shape), dtype=dt, device=device),
            torch.zeros((cfg.depth_single, *shape), dtype=dt, device=device))


def count_params(module: nn.Module) -> int:
    return sum(int(p.numel()) for p in module.parameters())
