"""LongCat-style video diffusion transformer in PyTorch.

Counterpart of ``longcat_video_tta_tpu/models/dit.py``: x/t/y embedders,
``depth`` blocks of {adaLN-modulated self-attention with fused qkv,
per-head RMS qk-norm and 3D RoPE; affine pre-norm cross-attention over
the text tokens; SwiGLU ffn w1/w2/w3}, per-latent-frame timesteps,
``num_cond_latents`` conditioning semantics, final adaLN layer and
unpatchify. Where the reference stacks blocks on a depth axis and scans,
the port holds an ``nn.ModuleList``.

Three entry points, with the reference's decode levers (block-sparse
attention, PAB, the CFG-reuse conditional half, bucketed valid counts):
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

from ..config import BSAConfig, DiTConfig, resolve_dtype
from ..ops.attention import attention
from ..ops.bsa import bsa_attention, decode_top_k
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
                kv_cache: Optional[KVCache] = None, kv_valid: Optional[int] = None,
                bsa_cfg: Optional[BSAConfig] = None):
        """x: [B, nt, nhw, D]. ``kv_cache``: optional (k, v)
        [B, S_c, nH, dh] prepended to the keys (decode path). Keys at
        index >= ``kv_valid`` are masked. With ``bsa_cfg`` the decode path
        runs block-sparse attention (``ops/bsa.py``): the cached
        conditioning blocks stay exact. Returns (out, (k, v) of this
        call's tokens)."""
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
        if bsa_cfg is not None and kv_cache is not None:
            top_k = decode_top_k(-(-k.shape[1] // bsa_cfg.block_k),
                                 bsa_cfg.keep_ratio, bsa_cfg.min_blocks)
            o = bsa_attention(q, k, v, top_k=top_k, block_q=bsa_cfg.block_q,
                              block_k=bsa_cfg.block_k,
                              num_cond_tokens=kv_cache[0].shape[1],
                              kv_valid=kv_valid, qk_int8=bsa_cfg.qk_int8)
        else:
            o = attention(q, k, v, num_cond_tokens=num_cond_tokens,
                          kv_valid_len=kv_valid)
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
                kv_cache: Optional[KVCache] = None, kv_valid: Optional[int] = None,
                bsa_cfg: Optional[BSAConfig] = None,
                pab_cached: Optional[torch.Tensor] = None):
        """One block. Returns (x_out, (k, v) of this call's tokens or None,
        the self-attention output).

        ``pab_cached`` (Pyramid Attention Broadcast, arXiv:2408.12588):
        when given, it is taken as the self-attention output and the
        attention is skipped; the caller's cache holds the output of the
        block's last computed step. Cross-attention is never broadcast."""
        mod = linear(self.adaln, F.silu(t_emb).to(x.dtype))  # [B, nt, 6D]
        shift_msa, scale_msa, gate_msa, shift_mlp, scale_mlp, gate_mlp = \
            mod.chunk(6, dim=-1)
        e = lambda m: m[:, :, None, :]  # per-latent-frame, broadcast over hw

        h = modulate(layer_norm(x), e(shift_msa), e(scale_msa))
        if pab_cached is not None:
            attn_out, kv = pab_cached.to(x.dtype), None
        else:
            attn_out, kv = self.attn(h, rope_cos, rope_sin, num_cond_tokens,
                                     kv_cache=kv_cache, kv_valid=kv_valid,
                                     bsa_cfg=bsa_cfg)
        x = x + e(gate_msa) * attn_out

        h = layer_norm(x, self.pre_crs_norm.weight, self.pre_crs_norm.bias)
        x = x + self.cross_attn(h, y)

        h = modulate(layer_norm(x), e(shift_mlp), e(scale_mlp))
        x = x + e(gate_mlp) * self.ffn(h)
        return x, kv, attn_out


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
    def _decode_blocks(self, x, t_emb, y, cos, sin, num_cond_tokens, *,
                       kv_cache, kv_valid, bsa_cfg, pab_reuse, pab_cache,
                       cache_cond_half):
        """The block loop of the sampling forwards (no autograd).

        ``pab_cache`` ([depth, B_cache, nt, nhw, D]) is read when
        ``pab_reuse`` and updated in place otherwise. With
        ``cache_cond_half`` the inputs carry the conditional half of the
        CFG batch only, and each block reads the last ``B`` rows of its
        KV-cache and PAB-cache entries: ``a[-B:]`` is a view, so no
        half-batch copy of either cache is made."""
        nb = x.shape[0]
        half = (lambda a: a[a.shape[0] - nb:]) if cache_cond_half else (lambda a: a)
        for i, blk in enumerate(self.blocks):
            kv = None if kv_cache is None else (half(kv_cache[0][i]),
                                                half(kv_cache[1][i]))
            slot = None if pab_cache is None else half(pab_cache[i])
            x, _, attn_out = blk(x, t_emb, y, cos, sin, num_cond_tokens,
                                 kv_cache=kv, kv_valid=kv_valid, bsa_cfg=bsa_cfg,
                                 pab_cached=slot if pab_reuse else None)
            if slot is not None and not pab_reuse:
                slot.copy_(attn_out)
        return x

    def forward(self, latents, timesteps, text_emb, text_mask=None, *,
                num_cond_latents: int = 0, adapters: AdapterDict = None,
                num_valid_latents: Optional[int] = None, pab_reuse: bool = False,
                pab_cache: Optional[torch.Tensor] = None,
                cache_cond_half: bool = False) -> torch.Tensor:
        """Full forward (training / no-cache sampling): latents
        [B, C, T, H, W], timesteps [B] or [B, N_t] (sigma * 1000).
        The first ``num_cond_latents`` latent frames get the prefix
        attention treatment. Latent frames at index >= ``num_valid_latents``
        are padding, masked out of every key set. ``pab_reuse`` /
        ``pab_cache`` / ``cache_cond_half``: PAB on this path (t2v
        sampling), as in ``forward_with_cache``."""
        cfg = self.cfg
        x, t_emb, y, (nt, nh, nw) = self._embed_inputs(
            latents, timesteps, text_emb, text_mask, adapters)
        cos, sin = self._rope(nt, nh, nw, latents.device)
        num_cond_tokens = (num_cond_latents // cfg.patch_size[0]) * nh * nw
        kv_valid = None
        if num_valid_latents is not None:
            kv_valid = (int(num_valid_latents) // cfg.patch_size[0]) * nh * nw
        if pab_cache is not None:
            x = self._decode_blocks(x, t_emb, y, cos, sin, num_cond_tokens,
                                    kv_cache=None, kv_valid=kv_valid, bsa_cfg=None,
                                    pab_reuse=pab_reuse, pab_cache=pab_cache,
                                    cache_cond_half=cache_cond_half)
            return self._final_layer(x, t_emb, nt, nh, nw)

        def block(blk, x, t_emb):
            return blk(x, t_emb, y, cos, sin, num_cond_tokens, kv_valid=kv_valid)[0]

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
            x, (k, v), _ = blk(x, t_emb, y, cos, sin, num_cond_tokens)
            if k_all is None:
                k_all = k.new_empty((len(self.blocks),) + tuple(k.shape))
                v_all = v.new_empty((len(self.blocks),) + tuple(v.shape))
            k_all[i] = k
            v_all[i] = v
        return k_all, v_all

    def forward_with_cache(self, noise_latents, timesteps, text_emb, text_mask,
                           kv_cache: KVCache, *, num_cond_latents: int,
                           adapters: AdapterDict = None,
                           bsa_cfg: Optional[BSAConfig] = None,
                           num_valid_latents: Optional[int] = None,
                           pab_reuse: bool = False,
                           pab_cache: Optional[torch.Tensor] = None,
                           cache_cond_half: bool = False):
        """Decode-phase forward: noise tokens only, self-attention against
        [cached cond K/V ++ fresh noise K/V]. Returns the velocity of the
        noise region, fp32 [B, C_out, T_noise, H, W].

        ``bsa_cfg``: block-sparse self-attention over the cached + fresh
        key blocks. ``num_valid_latents``: noise latent frames at index >=
        it are padding (gen-horizon bucketing), masked out of every key
        set; their outputs are discarded by the caller.
        ``pab_cache`` ([depth, B_cache, nt, nhw, D], from
        ``pab_init_cache``): with ``pab_reuse`` every block takes its
        self-attention output from the cache and skips the attention;
        otherwise the blocks compute it and write it into the cache in
        place. ``cache_cond_half``: the CFG-reuse conditional-only forward;
        ``kv_cache`` and ``pab_cache`` carry the full CFG batch and each
        block uses their second (conditional) half."""
        x, t_emb, y, (nt, nh, nw) = self._embed_inputs(
            noise_latents, timesteps, text_emb, text_mask, adapters)
        nt_cond = num_cond_latents // self.cfg.patch_size[0]
        # noise-frame tokens sit after the conditioning frames in RoPE space
        cos, sin = self._rope(nt, nh, nw, noise_latents.device, t_offset=nt_cond)
        kv_valid = None
        if num_valid_latents is not None:
            kv_valid = kv_cache[0].shape[2] + \
                (int(num_valid_latents) // self.cfg.patch_size[0]) * nh * nw
        x = self._decode_blocks(x, t_emb, y, cos, sin, 0, kv_cache=kv_cache,
                                kv_valid=kv_valid, bsa_cfg=bsa_cfg,
                                pab_reuse=pab_reuse, pab_cache=pab_cache,
                                cache_cond_half=cache_cond_half)
        return self._final_layer(x, t_emb, nt, nh, nw)


def pab_init_cache(cfg: DiTConfig, batch: int, t_noise: int, lat_h: int, lat_w: int,
                   device=None) -> torch.Tensor:
    """Zero PAB self-attention cache [depth, B, nt, nh*nw, D] in the
    compute dtype (the sampler computes step 0, so the zeros are never
    read)."""
    pt, ph, pw = cfg.patch_size
    nt, nh, nw = t_noise // pt, lat_h // ph, lat_w // pw
    return torch.zeros((cfg.depth, batch, nt, nh * nw, cfg.hidden_size),
                       dtype=resolve_dtype(cfg.compute_dtype), device=device)
