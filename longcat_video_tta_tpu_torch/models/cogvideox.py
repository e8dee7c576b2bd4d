"""CogVideoX-5B(-I2V) backbone in PyTorch (counterpart of
``longcat_video_tta_tpu/models/cogvideox.py``, the diffusers
``CogVideoXTransformer3DModel`` layout): a per-frame 2 x 2 patch embed
(a dense layer over packed patches) and a text projection, the joint
[text | video] sequence through ``depth`` blocks of {CogVideoXLayerNormZero
(silu(temb) -> Linear -> 6 chunks modulating both streams), separate
to_q / to_k / to_v, q/k LayerNorm over head_dim, 3D RoPE on the video
tokens only, the joint attention, the gated residuals; LayerNormZero'd
tanh-GELU feed-forward over the joint sequence}, then ``norm_final``,
``norm_out`` (shift-first chunks) and ``proj_out``. The reference scans
stacked weights; the port holds an ``nn.ModuleList``.

Forward contract: latents [B, 16, T, H, W] (noisy), timestep [B] in
sigma * 1000 units, text [B, L, text_dim]; for I2V (in_channels 32) the
image latents [B, 16, T, H, W] (the first conditioning latent, zeros
after it) are concatenated on the channels. The time embedding is fp32:
the sinusoid of width hidden, then the 2-layer SiLU MLP into
``time_embed_dim`` (the delta_a site). Every joint attention goes
through ``ops/attention.py``: the forward kernel on the card, and under
autograd ``FlashAttentionFunction`` (the dQ and dK/dV kernels), with no
mask (head_dim 64 at 5B width).

Adapter dict keys: ``delta_t`` [time_embed_dim] added to the fp32 time
embedding; ``lora`` {site: {'a': [depth, in, r], 'b': [depth, r, out]}}
with ``lora_scale`` (sites to_q, to_k, to_v, to_out, ff_in, ff_out). The
reference's ``delta_out`` hook is reached by none of its CogVideoX
schemes and is not ported. Each may carry a leading lane axis
(``--video-parallel``; ``models/dit.py``).

RoPE rotates half-split pairs; upstream checkpoints rotate interleaved
pairs, and the converter permutes the to_q / to_k rows and the q/k norm
affines (``models/convert.py``). Linear weights are [out, in].
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..config import CogVideoXConfig, resolve_dtype
from ..ops.attention import attention
from ..ops.layers import (
    apply_rope,
    lane_rows,
    layer_norm,
    linear,
    shared_in_group,
    mlp_embedder,
    modulate,
    remat_wrap,
    rope_3d_angles,
    timestep_embedding,
)
from ..parallel.sharding import tp_size
from ..utils.spans import span
from .dit import _Norm, block_slice
from .mmdit import _embedder, pack_latents, unpack_tokens

PORTED_ADAPTERS = ("delta_t", "lora", "lora_scale")


class _LNZero(nn.Module):
    """CogVideoXLayerNormZero: ``lin`` maps silu(temb) to (shift, scale,
    gate) x (video, text); ``ln`` is the affine LayerNorm both streams
    share."""

    def __init__(self, cfg: CogVideoXConfig, dtype):
        super().__init__()
        self.lin = nn.Linear(cfg.time_embed_dim, 6 * cfg.hidden_size, dtype=dtype)
        self.ln = _Norm(cfg.hidden_size, dtype)

    def forward(self, temb, vid, txt):
        """-> (modulated video, modulated text, video gate, text gate). The
        LayerNorm takes the default eps 1e-6, as the reference's ``_ln_zero``
        does (the q/k norms and ``norm_final`` take ``cfg.norm_eps``)."""
        mod = linear(self.lin, F.silu(temb).to(vid.dtype))[:, None, :]
        sh, sc, g, e_sh, e_sc, e_g = mod.chunk(6, dim=-1)
        h = layer_norm(vid, self.ln.weight, self.ln.bias)
        e = layer_norm(txt, self.ln.weight, self.ln.bias)
        return modulate(h, sh, sc), modulate(e, e_sh, e_sc), g, e_g


class _Attn(nn.Module):
    def __init__(self, cfg: CogVideoXConfig, dtype):
        super().__init__()
        D = cfg.hidden_size
        for name in ("to_q", "to_k", "to_v", "to_out"):
            setattr(self, name, nn.Linear(D, D, dtype=dtype))
        self.norm_q = _Norm(cfg.head_dim, dtype)
        self.norm_k = _Norm(cfg.head_dim, dtype)


class _FF(nn.Module):
    def __init__(self, cfg: CogVideoXConfig, dtype):
        super().__init__()
        self.w_in = nn.Linear(cfg.hidden_size, cfg.ffn_dim, dtype=dtype)
        self.w_out = nn.Linear(cfg.ffn_dim, cfg.hidden_size, dtype=dtype)


class CogVideoXBlock(nn.Module):
    def __init__(self, cfg: CogVideoXConfig, dtype):
        super().__init__()
        self.cfg = cfg
        self.norm1 = _LNZero(cfg, dtype)
        self.attn = _Attn(cfg, dtype)
        self.norm2 = _LNZero(cfg, dtype)
        self.ff = _FF(cfg, dtype)

    def forward(self, vid, txt, temb, cos, sin, lora=None, lscale=None,
                pab_cached: Optional[torch.Tensor] = None):
        """-> (vid, txt, the attention module's output [B, L+S, D] after
        to_out). With ``pab_cached`` that output is taken from the cache
        and the whole module (projections, norms, RoPE, attention, to_out)
        is skipped. The projections run once over the joint [text | video]
        rows (the reference projects the two streams apart with the same
        weights: the same product, row by row)."""
        cfg = self.cfg
        B, L = txt.shape[:2]
        S = vid.shape[1]
        nH, dh = cfg.num_heads // tp_size(self.attn.to_q), cfg.head_dim
        lora = lora or {}
        vid_n, txt_n, g, eg = self.norm1(temb, vid, txt)
        if pab_cached is not None:
            o = pab_cached.to(vid.dtype)
        else:
            a = self.attn
            joint = torch.cat([txt_n, vid_n], dim=1)
            q, k, v = (linear(getattr(a, name), joint, lora.get(name), lscale).reshape(
                B, L + S, nH, dh) for name in ("to_q", "to_k", "to_v"))
            sh = lambda t: shared_in_group(t, a.to_q)  # per-head norms on head shards
            q = layer_norm(q, sh(a.norm_q.weight), sh(a.norm_q.bias), eps=cfg.norm_eps)
            k = layer_norm(k, sh(a.norm_k.weight), sh(a.norm_k.bias), eps=cfg.norm_eps)
            T = cos.shape[0]

            def rope_vid(t):  # RoPE on the video tokens only
                tv = apply_rope(t[:, L:].reshape(B, T, S // T, nH, dh), cos, sin)
                return torch.cat([t[:, :L], tv.reshape(B, S, nH, dh)], dim=1)

            o = attention(rope_vid(q), rope_vid(k), v).reshape(B, L + S, -1)
            o = linear(a.to_out, o, lora.get("to_out"), lscale).to(vid.dtype)
        txt = txt + eg * o[:, :L]
        vid = vid + g * o[:, L:]
        vid_n, txt_n, g, eg = self.norm2(temb, vid, txt)
        h = F.gelu(linear(self.ff.w_in, torch.cat([txt_n, vid_n], dim=1), lora.get("ff_in"),
                          lscale), approximate="tanh")
        h = linear(self.ff.w_out, h, lora.get("ff_out"), lscale)
        return vid + g * h[:, L:], txt + eg * h[:, :L], o


class CogVideoX(nn.Module):
    """The full CogVideoX transformer. Outputs are fp32 [B, C_out, T, H, W]."""

    def __init__(self, cfg: CogVideoXConfig):
        super().__init__()
        self.cfg = cfg
        pdtype = resolve_dtype(cfg.param_dtype)
        D, p = cfg.hidden_size, cfg.patch_size
        if cfg.learned_pos_embed_len > 0:
            self.pos_embed = nn.Parameter(torch.empty(cfg.learned_pos_embed_len, D,
                                                      dtype=pdtype))
        self.patch_embed = nn.Linear(cfg.in_channels * p * p, D, dtype=pdtype)
        self.text_proj = nn.Linear(cfg.text_dim, D, dtype=pdtype)
        self.time_embed = _embedder(D, cfg.time_embed_dim)
        self.blocks = nn.ModuleList([CogVideoXBlock(cfg, pdtype) for _ in range(cfg.depth)])
        self.norm_final = _Norm(D, pdtype)
        self.norm_out = nn.ModuleDict({"lin": nn.Linear(cfg.time_embed_dim, 2 * D,
                                                        dtype=pdtype),
                                       "ln": _Norm(D, pdtype)})
        self.proj_out = nn.Linear(D, cfg.out_channels * p * p, dtype=pdtype)

    @staticmethod
    def _block_lora(stack: Optional[Dict], i: int) -> Optional[Dict]:
        if not stack:
            return None
        return {site: {"a": block_slice(ab["a"], 3, i), "b": block_slice(ab["b"], 3, i)}
                for site, ab in stack.items()}

    def forward(self, latents, timestep, text_emb, image_latents=None, *,
                adapters: Optional[Dict] = None, pab_reuse: bool = False,
                pab_cache: Optional[torch.Tensor] = None,
                cache_cond_half: bool = False) -> torch.Tensor:
        """Prediction [B, C_out, T, H, W] fp32 from latents [B, 16, T, H, W],
        timestep [B] (sigma * 1000), text_emb [B, L, text_dim] and, for I2V,
        ``image_latents`` [B, 16, T, H, W] (zeros when not given).

        ``pab_cache`` [depth, B_cache, L+S, D] (``pab_init_cache_cogvideox``):
        with ``pab_reuse`` each block takes its attention module's output
        from its slot; otherwise it writes the output there in place.
        ``cache_cond_half``: the CFG-reuse conditional-only forward, where
        the inputs carry B rows and each block uses the last B rows of its
        slot (the conditional half of the [uncond, cond] batch; a view, no
        copy). In training (grad enabled) each block is checkpointed when
        ``cfg.remat``."""
        cfg = self.cfg
        adapters = adapters or {}
        unported = sorted(set(adapters) - set(PORTED_ADAPTERS))
        if unported:
            raise NotImplementedError(f"CogVideoX adapters {unported} are not ported (it "
                                      f"takes {', '.join(PORTED_ADAPTERS)})")
        cdtype = resolve_dtype(cfg.compute_dtype)
        B, _, T, H, W = latents.shape
        p = cfg.patch_size
        L = text_emb.shape[1]

        x = latents
        if cfg.in_channels != cfg.latent_channels:
            if image_latents is None:
                image_latents = torch.zeros_like(latents)
            x = torch.cat([x, image_latents.to(x.dtype)], dim=1)
        vid = linear(self.patch_embed, pack_latents(x.to(cdtype), p))
        txt = linear(self.text_proj, text_emb.to(cdtype))
        if cfg.learned_pos_embed_len > 0:
            S = L + vid.shape[1]
            pos = lane_rows(self.pos_embed, 2, B)  # full's lane tables apply per row
            if S > pos.shape[1]:
                raise ValueError(
                    f"sequence {S} exceeds learned pos-embed table "
                    f"{pos.shape[1]} (text {L} + video {vid.shape[1]})")
            txt = txt + pos[:, :L].to(cdtype)
            vid = vid + pos[:, L:S].to(cdtype)

        t_feat = timestep_embedding(timestep.float(), cfg.hidden_size)
        temb = mlp_embedder(self.time_embed["w1"], self.time_embed["w2"], t_feat)
        if adapters.get("delta_t") is not None:
            temb = temb + lane_rows(adapters["delta_t"].float(), 1, B)

        cos, sin = rope_3d_angles(T, H // p, W // p, cfg.rope_dims, cfg.rope_theta,
                                  device=latents.device)
        lscale = adapters.get("lora_scale", 1.0)
        lora_stack = adapters.get("lora")
        nb = latents.shape[0]

        def body(blk, vid, txt, temb, lora):
            with span("dit.block"):
                return blk(vid, txt, temb, cos, sin, lora, lscale)[:2]

        train = cfg.remat and torch.is_grad_enabled() and pab_cache is None
        body = remat_wrap(body, train, cfg.remat_policy)
        for i, blk in enumerate(self.blocks):
            lora = self._block_lora(lora_stack, i)
            if pab_cache is None:
                vid, txt = body(blk, vid, txt, temb, lora)
                continue
            s = pab_cache[i][pab_cache.shape[1] - nb:] if cache_cond_half else pab_cache[i]
            with span("dit.block"):
                vid, txt, o = blk(vid, txt, temb, cos, sin, lora, lscale,
                                  pab_cached=s if pab_reuse else None)
            if not pab_reuse:
                s.copy_(o)

        # norm_final is row-wise: the reference's LayerNorm over the joint
        # sequence, then its video rows, is this LayerNorm of the video rows
        vid = layer_norm(vid, self.norm_final.weight, self.norm_final.bias, eps=cfg.norm_eps)
        shift, scale = linear(self.norm_out["lin"],
                              F.silu(temb).to(cdtype))[:, None, :].chunk(2, dim=-1)
        vid = modulate(layer_norm(vid, self.norm_out["ln"].weight, self.norm_out["ln"].bias,
                                  eps=cfg.norm_eps), shift, scale)
        out = linear(self.proj_out, vid)
        return unpack_tokens(out, T, H, W, p).float()


def pab_init_cache_cogvideox(cfg: CogVideoXConfig, batch: int, t_lat: int, lat_h: int,
                             lat_w: int, text_len: int, device=None) -> torch.Tensor:
    """A zero PAB cache of the joint attention modules' outputs,
    [depth, B, L + S_vid, hidden] in the compute dtype (the sampler computes
    step 0, so the zeros are never read)."""
    p = cfg.patch_size
    s_vid = t_lat * (lat_h // p) * (lat_w // p)
    return torch.zeros((cfg.depth, batch, text_len + s_vid, cfg.hidden_size),
                       dtype=resolve_dtype(cfg.compute_dtype), device=device)


def count_params(module: nn.Module) -> int:
    return sum(int(p.numel()) for p in module.parameters())
