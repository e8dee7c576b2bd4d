"""LongCat-style video diffusion transformer in PyTorch.

Counterpart of ``longcat_video_tta_tpu/models/dit.py``: x/t/y embedders,
``depth`` blocks of {adaLN-modulated self-attention with fused qkv,
per-head RMS qk-norm and 3D RoPE; affine pre-norm cross-attention over
the text tokens; SwiGLU ffn w1/w2/w3}, per-latent-frame timesteps,
``num_cond_latents`` conditioning semantics, final adaLN layer and
unpatchify. Where the reference stacks blocks on a depth axis and scans,
the port holds an ``nn.ModuleList``.

Three entry points (PAB arguments are not ported yet):
  - ``forward``                (reference ``dit_forward``)
  - ``precompute_cond_cache``  (``dit_precompute_cond_cache``)
  - ``forward_with_cache``     (``dit_forward_with_cache``)
Each takes the reference's ``adapters`` dict; only ``delta_t`` (the
delta_a adapter, added to the fp32 t-embedding) is ported. In training
(grad enabled) ``forward`` checkpoints every block when ``cfg.remat``.

Parameter names follow the reference's parameter tree (``x_embed``,
``blocks[i].attn.qkv`` ...) so ``models/weights.py`` maps one onto the
other. Linear weights are stored [out, in] (``nn.Linear``).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..config import DiTConfig, resolve_dtype
from ..ops.attention import attention
from ..ops.layers import (
    apply_rope,
    layer_norm,
    linear,
    mlp_embedder,
    modulate,
    remat_wrap,
    rms_norm,
    rope_3d_angles,
    timestep_embedding,
)

KVCache = Tuple[torch.Tensor, torch.Tensor]  # (k, v) each [depth, B, S, H, D]
AdapterDict = Optional[Dict[str, torch.Tensor]]
PORTED_ADAPTERS = ("delta_t",)


def patchify(x: torch.Tensor, patch: Tuple[int, int, int]) -> torch.Tensor:
    """[B, C, T, H, W] -> [B, N_t, N_h*N_w, pt*ph*pw*C]."""
    B, C, T, H, W = x.shape
    pt, ph, pw = patch
    nt, nh, nw = T // pt, H // ph, W // pw
    x = x.permute(0, 2, 3, 4, 1)
    x = x.reshape(B, nt, pt, nh, ph, nw, pw, C)
    x = x.permute(0, 1, 3, 5, 2, 4, 6, 7)
    return x.reshape(B, nt, nh * nw, pt * ph * pw * C)


def unpatchify(x: torch.Tensor, patch: Tuple[int, int, int],
               nt: int, nh: int, nw: int, out_channels: int) -> torch.Tensor:
    """[B, N_t, N_h*N_w, pt*ph*pw*C] -> [B, C, T, H, W]."""
    B = x.shape[0]
    pt, ph, pw = patch
    x = x.reshape(B, nt, nh, nw, pt, ph, pw, out_channels)
    x = x.permute(0, 7, 1, 4, 2, 5, 3, 6)
    return x.reshape(B, out_channels, nt * pt, nh * ph, nw * pw)


class _Norm(nn.Module):
    """Holds an affine norm's weight and bias (applied by the caller)."""

    def __init__(self, dim: int, dtype):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(dim, dtype=dtype))
        self.bias = nn.Parameter(torch.empty(dim, dtype=dtype))


class SelfAttention(nn.Module):
    def __init__(self, cfg: DiTConfig, dtype):
        super().__init__()
        D, dh = cfg.hidden_size, cfg.head_dim
        self.cfg = cfg
        self.qkv = nn.Linear(D, 3 * D, dtype=dtype)
        self.proj = nn.Linear(D, D, dtype=dtype)
        self.q_norm = nn.Parameter(torch.empty(dh, dtype=dtype))
        self.k_norm = nn.Parameter(torch.empty(dh, dtype=dtype))

    def forward(self, x, rope_cos, rope_sin, num_cond_tokens: int,
                kv_cache: Optional[KVCache] = None):
        """x: [B, nt, nhw, D]. ``kv_cache``: optional (k, v)
        [B, S_c, nH, dh] prepended to the keys (decode path). Returns
        (out, (k, v) of this call's tokens)."""
        cfg = self.cfg
        B, nt, nhw, D = x.shape
        nH, dh = cfg.num_heads, cfg.head_dim
        qkv = linear(self.qkv, x).reshape(B, nt, nhw, 3, nH, dh)
        q, k, v = qkv[..., 0, :, :], qkv[..., 1, :, :], qkv[..., 2, :, :]
        if cfg.qk_norm:
            q = rms_norm(q, self.q_norm)
            k = rms_norm(k, self.k_norm)
        q = apply_rope(q, rope_cos, rope_sin)
        k = apply_rope(k, rope_cos, rope_sin)
        S = nt * nhw
        q = q.reshape(B, S, nH, dh)
        k = k.reshape(B, S, nH, dh)
        v = v.reshape(B, S, nH, dh)
        kv_out = (k, v)
        if kv_cache is not None:
            k = torch.cat([kv_cache[0].to(k.dtype), k], dim=1)
            v = torch.cat([kv_cache[1].to(v.dtype), v], dim=1)
        o = attention(q, k, v, num_cond_tokens=num_cond_tokens)
        return linear(self.proj, o.reshape(B, nt, nhw, D)), kv_out


class CrossAttention(nn.Module):
    def __init__(self, cfg: DiTConfig, dtype):
        super().__init__()
        D, dh = cfg.hidden_size, cfg.head_dim
        self.cfg = cfg
        self.q = nn.Linear(D, D, dtype=dtype)
        self.kv = nn.Linear(D, 2 * D, dtype=dtype)
        self.proj = nn.Linear(D, D, dtype=dtype)
        self.q_norm = nn.Parameter(torch.empty(dh, dtype=dtype))
        self.k_norm = nn.Parameter(torch.empty(dh, dtype=dtype))

    def forward(self, x, y):
        """x: [B, nt, nhw, D]; y: [B, L, D]. No key mask: padded text
        tokens are zeroed upstream but still attended to, as in the
        reference."""
        cfg = self.cfg
        B, nt, nhw, D = x.shape
        nH, dh = cfg.num_heads, cfg.head_dim
        L = y.shape[1]
        q = linear(self.q, x).reshape(B, nt * nhw, nH, dh)
        kv = linear(self.kv, y).reshape(B, L, 2, nH, dh)
        k, v = kv[:, :, 0], kv[:, :, 1]
        if cfg.cross_qk_norm:
            q = rms_norm(q, self.q_norm)
            k = rms_norm(k, self.k_norm)
        o = attention(q, k, v)
        return linear(self.proj, o.reshape(B, nt, nhw, D))


class FFN(nn.Module):
    def __init__(self, cfg: DiTConfig, dtype):
        super().__init__()
        D, F_ = cfg.hidden_size, cfg.ffn_dim
        self.w1 = nn.Linear(D, F_, bias=False, dtype=dtype)
        self.w3 = nn.Linear(D, F_, bias=False, dtype=dtype)
        self.w2 = nn.Linear(F_, D, bias=False, dtype=dtype)

    def forward(self, x):
        return linear(self.w2, F.silu(linear(self.w1, x)) * linear(self.w3, x))


class DiTBlock(nn.Module):
    def __init__(self, cfg: DiTConfig, dtype):
        super().__init__()
        D, Ct = cfg.hidden_size, cfg.adaln_tembed_dim
        self.adaln = nn.Linear(Ct, 6 * D, dtype=dtype)
        self.attn = SelfAttention(cfg, dtype)
        self.cross_attn = CrossAttention(cfg, dtype)
        self.pre_crs_norm = _Norm(D, dtype)
        self.ffn = FFN(cfg, dtype)

    def forward(self, x, t_emb, y, rope_cos, rope_sin, num_cond_tokens: int,
                kv_cache: Optional[KVCache] = None):
        """One block. Returns (x_out, (k, v) of this call's tokens)."""
        mod = linear(self.adaln, F.silu(t_emb).to(x.dtype))  # [B, nt, 6D]
        shift_msa, scale_msa, gate_msa, shift_mlp, scale_mlp, gate_mlp = \
            mod.chunk(6, dim=-1)
        e = lambda m: m[:, :, None, :]  # per-latent-frame, broadcast over hw

        h = modulate(layer_norm(x), e(shift_msa), e(scale_msa))
        attn_out, kv = self.attn(h, rope_cos, rope_sin, num_cond_tokens,
                                 kv_cache=kv_cache)
        x = x + e(gate_msa) * attn_out

        h = layer_norm(x, self.pre_crs_norm.weight, self.pre_crs_norm.bias)
        x = x + self.cross_attn(h, y)

        h = modulate(layer_norm(x), e(shift_mlp), e(scale_mlp))
        x = x + e(gate_mlp) * self.ffn(h)
        return x, kv


class LongCatDiT(nn.Module):
    """The full DiT. Velocity outputs are fp32 [B, C_out, T, H, W]."""

    def __init__(self, cfg: DiTConfig):
        super().__init__()
        self.cfg = cfg
        pdtype = resolve_dtype(cfg.param_dtype)
        D, Ct = cfg.hidden_size, cfg.adaln_tembed_dim
        pt, ph, pw = cfg.patch_size
        pdim = pt * ph * pw * cfg.in_channels
        out_dim = pt * ph * pw * cfg.out_channels
        self.x_embed = nn.Linear(pdim, D, dtype=pdtype)
        # t_embedder stays fp32 end to end
        self.t_embed = nn.ModuleDict({
            "w1": nn.Linear(cfg.t_embed_freq_dim, Ct, dtype=torch.float32),
            "w2": nn.Linear(Ct, Ct, dtype=torch.float32),
        })
        self.y_embed = nn.ModuleDict({
            "in": nn.Linear(cfg.text_dim, D, dtype=pdtype),
            "out": nn.Linear(D, D, dtype=pdtype),
        })
        self.blocks = nn.ModuleList([DiTBlock(cfg, pdtype)
                                     for _ in range(cfg.depth)])
        self.final = nn.ModuleDict({
            "adaln": nn.Linear(Ct, 2 * D, dtype=pdtype),
            "proj": nn.Linear(D, out_dim, dtype=pdtype),
        })

    # ------------------------------------------------------------------
    def _embed_inputs(self, latents, timesteps, text_emb, text_mask,
                      adapters: AdapterDict = None):
        """Returns (x [B,nt,nhw,D], t_emb fp32 [B,nt,Ct], y [B,L,D], dims)."""
        cfg = self.cfg
        unported = sorted(set(adapters or {}) - set(PORTED_ADAPTERS))
        if unported:
            raise NotImplementedError(
                f"DiT adapters {unported} are not yet ported (only delta_t; the "
                "other TTA methods come in a later slice)")
        cdtype = resolve_dtype(cfg.compute_dtype)
        B, C, T, H, W = latents.shape
        pt, ph, pw = cfg.patch_size
        if T % pt or H % ph or W % pw:
            raise ValueError(f"latent dims {(T, H, W)} not divisible by patch "
                             f"{cfg.patch_size}")
        nt, nh, nw = T // pt, H // ph, W // pw

        x = linear(self.x_embed, patchify(latents.to(cdtype), cfg.patch_size))
        if timesteps.ndim == 1:
            timesteps = timesteps[:, None].expand(B, nt)
        feats = timestep_embedding(timesteps, cfg.t_embed_freq_dim)
        t_emb = mlp_embedder(self.t_embed["w1"], self.t_embed["w2"], feats)
        if adapters and "delta_t" in adapters:
            t_emb = t_emb + adapters["delta_t"].float()[None, None, :]

        if text_emb.ndim == 4:  # the reference's [B, 1, L, C] layout
            text_emb = text_emb[:, 0]
        y = linear(self.y_embed["in"], text_emb.to(cdtype))
        y = F.gelu(y, approximate="tanh")
        y = linear(self.y_embed["out"], y)
        if cfg.text_tokens_zero_pad and text_mask is not None:
            y = y * text_mask.to(y.dtype)[:, :, None]
        return x, t_emb, y, (nt, nh, nw)

    def _final_layer(self, x, t_emb, nt, nh, nw):
        cfg = self.cfg
        mod = linear(self.final["adaln"], F.silu(t_emb).to(x.dtype))
        shift, scale = mod.chunk(2, dim=-1)
        h = modulate(layer_norm(x), shift[:, :, None, :], scale[:, :, None, :])
        h = linear(self.final["proj"], h)
        return unpatchify(h, cfg.patch_size, nt, nh, nw, cfg.out_channels).float()

    def _rope(self, nt, nh, nw, device, t_offset=0):
        cfg = self.cfg
        return rope_3d_angles(nt, nh, nw, cfg.rope_dims, cfg.rope_theta,
                              t_offset=t_offset, device=device)

    # ------------------------------------------------------------------
    def forward(self, latents, timesteps, text_emb, text_mask=None, *,
                num_cond_latents: int = 0,
                adapters: AdapterDict = None) -> torch.Tensor:
        """Full forward (training / no-cache sampling): latents
        [B, C, T, H, W], timesteps [B] or [B, N_t] (sigma * 1000).
        The first ``num_cond_latents`` latent frames get the prefix
        attention treatment."""
        cfg = self.cfg
        x, t_emb, y, (nt, nh, nw) = self._embed_inputs(
            latents, timesteps, text_emb, text_mask, adapters)
        cos, sin = self._rope(nt, nh, nw, latents.device)
        num_cond_tokens = (num_cond_latents // cfg.patch_size[0]) * nh * nw

        def block(blk, x, t_emb):
            return blk(x, t_emb, y, cos, sin, num_cond_tokens)[0]

        body = remat_wrap(block, cfg.remat and torch.is_grad_enabled(),
                          cfg.remat_policy)
        for blk in self.blocks:
            x = body(blk, x, t_emb)
        return self._final_layer(x, t_emb, nt, nh, nw)

    def precompute_cond_cache(self, cond_latents, text_emb, text_mask=None, *,
                              adapters: AdapterDict = None) -> KVCache:
        """Run the conditioning tokens (timestep 0) through every block
        once, collecting per-block K/V: (k, v) each
        [depth, B, S_cond, heads, head_dim]."""
        B = cond_latents.shape[0]
        t0 = torch.zeros((B,), dtype=torch.float32, device=cond_latents.device)
        x, t_emb, y, (nt, nh, nw) = self._embed_inputs(
            cond_latents, t0, text_emb, text_mask, adapters)
        cos, sin = self._rope(nt, nh, nw, cond_latents.device)
        num_cond_tokens = nt * nh * nw  # every token is conditioning here
        k_all = v_all = None
        for i, blk in enumerate(self.blocks):
            x, (k, v) = blk(x, t_emb, y, cos, sin, num_cond_tokens)
            if k_all is None:
                k_all = k.new_empty((len(self.blocks),) + tuple(k.shape))
                v_all = v.new_empty((len(self.blocks),) + tuple(v.shape))
            k_all[i] = k
            v_all[i] = v
        return k_all, v_all

    def forward_with_cache(self, noise_latents, timesteps, text_emb, text_mask,
                           kv_cache: KVCache, *, num_cond_latents: int,
                           adapters: AdapterDict = None):
        """Decode-phase forward: noise tokens only, self-attention against
        [cached cond K/V ++ fresh noise K/V]. Returns the velocity of the
        noise region, fp32 [B, C_out, T_noise, H, W]."""
        x, t_emb, y, (nt, nh, nw) = self._embed_inputs(
            noise_latents, timesteps, text_emb, text_mask, adapters)
        nt_cond = num_cond_latents // self.cfg.patch_size[0]
        # noise-frame tokens sit after the conditioning frames in RoPE space
        cos, sin = self._rope(nt, nh, nw, noise_latents.device, t_offset=nt_cond)
        k_all, v_all = kv_cache
        for i, blk in enumerate(self.blocks):
            x, _ = blk(x, t_emb, y, cos, sin, 0, kv_cache=(k_all[i], v_all[i]))
        return self._final_layer(x, t_emb, nt, nh, nw)
