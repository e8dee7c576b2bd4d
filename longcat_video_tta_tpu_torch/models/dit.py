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
Each takes the reference's ``adapters`` dict, the one way every TTA
method reaches the model (all keys optional):
    delta_t        [C_t]          delta_a: added to the fp32 t-embedding
    delta_t_blocks [depth, C_t]   delta_b timestep: per block, on its
                                  t-embedding before its adaLN
    film_blocks    [depth, 6D]    FiLM: added to each block's adaLN output
    lora           {site: {'a': [depth, in, r], 'b': [depth, r, out]}}
                   with ``lora_scale``: the side branch of the block
                   linears (sites qkv, attn_proj, xattn_q, xattn_kv,
                   xattn_proj, ffn_w1, ffn_w2, ffn_w3)
    delta_h_blocks [depth, D]     delta_b hidden: added to each block's output
    delta_h_final  [D]            delta_b hidden: before the final layer
    delta_out      [C_out]        delta_c: added to the velocity after
                                  unpatchify, in the compute dtype
Every key may also carry a leading lane axis V (``--video-parallel``: V
videos' adapters in one batch, row r of the batch in lane r % V;
``ops/layers.py::lane_rows``), and so may the weights a weight-training
method swaps in. In training (grad enabled) ``forward`` checkpoints every
block when ``cfg.remat``.

Parameter names follow the reference's parameter tree (``x_embed``,
``blocks[i].attn.qkv`` ...) so ``models/weights.py`` maps one onto the
other. Linear weights are stored [out, in] (``nn.Linear``).

Under a mesh (``self.mesh``, ``parallel/``): with a context axis the
flattened video tokens (S = nt * nh * nw) shard contiguously over its
ranks from the patch embedding to the final layer (a shard is held as
[B, S / P, 1, D], the RoPE tables and the per-frame modulation taken at
its global token range), self-attention runs the ring
(``parallel/context_attention.py``), cross-attention takes the shard's
queries against the whole text, and the tokens are gathered once, at
unpatchify: every rank returns the whole output. With a tensor axis the
block linears are Megatron-sharded (``parallel/sharding.py``) and the
attentions run at heads / T. BSA does not compose with a context axis,
as in the reference.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..config import BSAConfig, DiTConfig, resolve_dtype
from ..ops.attention import attention
from ..ops.bsa import bsa_attention, decode_top_k
from ..ops.qk_norm import qk_norm_rope
from ..parallel.collectives import gather_from_group, group_rank, group_size
from ..parallel.context_attention import ring_self_attention
from ..parallel.sharding import tp_size
from ..utils.spans import span
from ..ops.layers import (
    apply_rope,
    shared_in_group,
    lane_rows,
    layer_norm,
    linear,
    mlp_embedder,
    modulate,
    remat_wrap,
    rope_3d_angles,
    timestep_embedding,
)

KVCache = Tuple[torch.Tensor, torch.Tensor]  # (k, v) each [depth, B, S, H, D]
AdapterDict = Optional[Dict[str, torch.Tensor]]
PORTED_ADAPTERS = ("delta_t", "delta_t_blocks", "film_blocks", "lora", "lora_scale",
                   "delta_h_blocks", "delta_h_final", "delta_out")
_PER_BLOCK_KEYS = ("delta_t_blocks", "film_blocks", "delta_h_blocks")


def block_slice(t: torch.Tensor, ndim: int, i: int) -> torch.Tensor:
    """Block ``i`` of a per-block stack of rank ``ndim`` ([depth, ...]),
    or of its lane form ([V, depth, ...] -> [V, ...])."""
    return t[i] if t.ndim == ndim else t[:, i]


class TokenShard(NamedTuple):
    """This rank's contiguous share of the flattened tokens under a context
    group: global tokens [start, start + length), ``nhw`` tokens per latent
    frame."""

    group: object
    start: int
    length: int
    nhw: int


def _per_token(tokens: Optional[TokenShard]):
    """m [B, nt, X] -> its broadcast over the block's token layout:
    [B, nt, 1, X], or per token of the shard [B, S / P, 1, X]: the shard's
    frames broadcast over their tokens and sliced, so that the backward
    sums each frame's tokens in one reduction (an index gather's backward
    would add them one by one in the 16-bit dtype)."""
    if tokens is None:
        return lambda m: m[:, :, None, :]
    f0 = tokens.start // tokens.nhw
    f1 = (tokens.start + tokens.length - 1) // tokens.nhw + 1
    off = tokens.start - f0 * tokens.nhw

    def expand(m):
        B, X = m.shape[0], m.shape[-1]
        per = m[:, f0:f1, None, :].expand(B, f1 - f0, tokens.nhw, X)
        return per.reshape(B, (f1 - f0) * tokens.nhw, X)[:, off:off + tokens.length, None]
    return expand


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
                bsa_cfg: Optional[BSAConfig] = None, lora=None, lora_scale=None,
                cp=None):
        """x: [B, nt, nhw, D]. ``kv_cache``: optional (k, v)
        [B, S_c, nH, dh] prepended to the keys (decode path). Keys at
        index >= ``kv_valid`` are masked. With ``bsa_cfg`` the decode path
        runs block-sparse attention (``ops/bsa.py``): the cached
        conditioning blocks stay exact. ``cp``: the context group; x is
        this rank's token shard, the cache its shard of the cache, and
        the attention runs the ring. Returns (out, (k, v) of this call's
        tokens)."""
        cfg = self.cfg
        lora = lora or {}
        B, nt, nhw, D = x.shape
        nH, dh = cfg.num_heads // tp_size(self.qkv), cfg.head_dim
        qkv = linear(self.qkv, x, lora.get("qkv"), lora_scale).reshape(
            B, nt, nhw, 3, nH, dh)
        q, k, v = qkv[..., 0, :, :], qkv[..., 1, :, :], qkv[..., 2, :, :]
        if cfg.qk_norm:
            q, k = qk_norm_rope(q, k, shared_in_group(self.q_norm, self.qkv),
                                shared_in_group(self.k_norm, self.qkv), rope_cos, rope_sin)
        else:
            q = apply_rope(q, rope_cos, rope_sin)
            k = apply_rope(k, rope_cos, rope_sin)
        S = nt * nhw
        q = q.reshape(B, S, nH, dh)
        k = k.reshape(B, S, nH, dh)
        v = v.reshape(B, S, nH, dh)
        kv_out = (k, v)
        if cp is not None:
            if bsa_cfg is not None:
                raise ValueError("bsa_cfg does not compose with context parallelism: "
                                 "block selection is local to one rank")
            o = ring_self_attention(q, k, v, cp, num_cond_tokens=num_cond_tokens,
                                    kv_valid=kv_valid, cache=kv_cache)
            return linear(self.proj, o.reshape(B, nt, nhw, nH * dh), lora.get("attn_proj"),
                          lora_scale), kv_out
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
        return linear(self.proj, o.reshape(B, nt, nhw, nH * dh), lora.get("attn_proj"),
                      lora_scale), kv_out


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

    def forward(self, x, y, lora=None, lora_scale=None):
        """x: [B, nt, nhw, D]; y: [B, L, D]. No key mask: padded text
        tokens are zeroed upstream but still attended to, as in the
        reference."""
        cfg = self.cfg
        lora = lora or {}
        B, nt, nhw, D = x.shape
        nH, dh = cfg.num_heads // tp_size(self.q), cfg.head_dim
        L = y.shape[1]
        q = linear(self.q, x, lora.get("xattn_q"), lora_scale).reshape(
            B, nt * nhw, nH, dh)
        kv = linear(self.kv, y, lora.get("xattn_kv"), lora_scale).reshape(
            B, L, 2, nH, dh)
        k, v = kv[:, :, 0], kv[:, :, 1]
        if cfg.cross_qk_norm:
            q, k = qk_norm_rope(q, k, shared_in_group(self.q_norm, self.q),
                                shared_in_group(self.k_norm, self.q))
        o = attention(q, k, v)
        return linear(self.proj, o.reshape(B, nt, nhw, nH * dh), lora.get("xattn_proj"),
                      lora_scale)


class FFN(nn.Module):
    def __init__(self, cfg: DiTConfig, dtype):
        super().__init__()
        D, F_ = cfg.hidden_size, cfg.ffn_dim
        self.w1 = nn.Linear(D, F_, bias=False, dtype=dtype)
        self.w3 = nn.Linear(D, F_, bias=False, dtype=dtype)
        self.w2 = nn.Linear(F_, D, bias=False, dtype=dtype)

    def forward(self, x, lora=None, lora_scale=None):
        lora = lora or {}
        h = (F.silu(linear(self.w1, x, lora.get("ffn_w1"), lora_scale))
             * linear(self.w3, x, lora.get("ffn_w3"), lora_scale))
        return linear(self.w2, h, lora.get("ffn_w2"), lora_scale)


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
                pab_cached: Optional[torch.Tensor] = None,
                ad: Optional[Dict] = None, tokens: Optional["TokenShard"] = None):
        """One block. Returns (x_out, (k, v) of this call's tokens or None,
        the self-attention output). ``ad``: this block's slice of the
        adapter dict (``_block_adapters``), applied in the reference's
        order: delta_t_blocks on the t-embedding, film_blocks on the adaLN
        output, LoRA in every block linear, delta_h_blocks on the output.

        ``pab_cached`` (Pyramid Attention Broadcast, arXiv:2408.12588):
        when given, it is taken as the self-attention output and the
        attention is skipped; the caller's cache holds the output of the
        block's last computed step. Cross-attention is never broadcast.

        ``tokens``: this rank's token shard under a context group (x is
        [B, S / P, 1, D]; the per-frame modulation is taken per token)."""
        ad = ad or {}
        B = x.shape[0]
        if ad.get("delta_t_blocks") is not None:
            t_emb = t_emb + lane_rows(ad["delta_t_blocks"].float(), 1, B)[:, None, :]
        mod = linear(self.adaln, F.silu(t_emb).to(x.dtype))  # [B, nt, 6D]
        if ad.get("film_blocks") is not None:
            mod = mod + lane_rows(ad["film_blocks"].to(mod.dtype), 1, B)[:, None, :]
        lora, lora_scale = ad.get("lora") or {}, ad.get("lora_scale", 1.0)
        shift_msa, scale_msa, gate_msa, shift_mlp, scale_mlp, gate_mlp = \
            mod.chunk(6, dim=-1)
        e = _per_token(tokens)  # per-latent-frame, broadcast over hw
        cp = None if tokens is None else tokens.group

        h = modulate(layer_norm(x), e(shift_msa), e(scale_msa))
        if pab_cached is not None:
            attn_out, kv = pab_cached.to(x.dtype), None
        else:
            attn_out, kv = self.attn(h, rope_cos, rope_sin, num_cond_tokens,
                                     kv_cache=kv_cache, kv_valid=kv_valid,
                                     bsa_cfg=bsa_cfg, lora=lora, lora_scale=lora_scale,
                                     cp=cp)
        x = x + e(gate_msa) * attn_out

        h = layer_norm(x, self.pre_crs_norm.weight, self.pre_crs_norm.bias)
        x = x + self.cross_attn(h, y, lora, lora_scale)

        h = modulate(layer_norm(x), e(shift_mlp), e(scale_mlp))
        x = x + e(gate_mlp) * self.ffn(h, lora, lora_scale)
        if ad.get("delta_h_blocks") is not None:
            x = x + lane_rows(ad["delta_h_blocks"].to(x.dtype), 1, B)[:, None, None, :]
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
        self.mesh = None  # parallel.Mesh: context / tensor axes (module docstring)

    def _shard(self, nt: int, nhw: int) -> Optional[TokenShard]:
        """This rank's token shard under the mesh's context axis, or None."""
        mesh = self.mesh
        group = None if mesh is None else mesh.group("context")
        if group is None:
            return None
        S, n = nt * nhw, group_size(group)
        if S % n:
            raise ValueError(f"{S} video tokens do not shard over {n} context ranks "
                             f"(the spatial token count must divide by {n})")
        m = S // n
        return TokenShard(group, group_rank(group) * m, m, nhw)

    @staticmethod
    def _local(x: torch.Tensor, tokens: Optional[TokenShard]) -> torch.Tensor:
        """[B, nt, nhw, ...] -> this rank's tokens [B, S / P, 1, ...] (a view
        when ``x`` is contiguous)."""
        if tokens is None:
            return x
        B, nt, nhw = x.shape[:3]
        flat = x.reshape((B, nt * nhw) + tuple(x.shape[3:]))
        return flat[:, tokens.start:tokens.start + tokens.length, None]

    def _local_rope(self, cos, sin, tokens: Optional[TokenShard]):
        if tokens is None:
            return cos, sin
        return (self._local(cos[None], tokens)[0], self._local(sin[None], tokens)[0])

    # ------------------------------------------------------------------
    def _embed_inputs(self, latents, timesteps, text_emb, text_mask,
                      adapters: AdapterDict = None):
        """Returns (x [B,nt,nhw,D], t_emb fp32 [B,nt,Ct], y [B,L,D], dims,
        token shard). Under a context group x is this rank's shard
        [B, S / P, 1, D] (``_shard``)."""
        cfg = self.cfg
        unported = sorted(set(adapters or {}) - set(PORTED_ADAPTERS))
        if unported:
            raise NotImplementedError(
                f"DiT adapters {unported} are not yet ported to the LongCat DiT "
                f"(it takes {', '.join(PORTED_ADAPTERS)})")
        cdtype = resolve_dtype(cfg.compute_dtype)
        B, C, T, H, W = latents.shape
        pt, ph, pw = cfg.patch_size
        if T % pt or H % ph or W % pw:
            raise ValueError(f"latent dims {(T, H, W)} not divisible by patch "
                             f"{cfg.patch_size}")
        nt, nh, nw = T // pt, H // ph, W // pw

        tokens = self._shard(nt, nh * nw)
        x = linear(self.x_embed, self._local(patchify(latents.to(cdtype), cfg.patch_size),
                                             tokens))
        if timesteps.ndim == 1:
            timesteps = timesteps[:, None].expand(B, nt)
        feats = timestep_embedding(timesteps, cfg.t_embed_freq_dim)
        t_emb = mlp_embedder(self.t_embed["w1"], self.t_embed["w2"], feats)
        if adapters and "delta_t" in adapters:
            t_emb = t_emb + lane_rows(adapters["delta_t"].float(), 1, B)[:, None, :]

        if text_emb.ndim == 4:  # the reference's [B, 1, L, C] layout
            text_emb = text_emb[:, 0]
        y = linear(self.y_embed["in"], text_emb.to(cdtype))
        y = F.gelu(y, approximate="tanh")
        y = linear(self.y_embed["out"], y)
        if cfg.text_tokens_zero_pad and text_mask is not None:
            y = y * text_mask.to(y.dtype)[:, :, None]
        return x, t_emb, y, (nt, nh, nw), tokens

    def _final_layer(self, x, t_emb, nt, nh, nw, adapters: AdapterDict = None,
                     tokens: Optional[TokenShard] = None):
        """delta_h_final before the final adaLN layer, delta_out after
        unpatchify in the compute dtype, then the cast to fp32. Under a
        context group the shards are gathered before unpatchify."""
        cfg = self.cfg
        adapters = adapters or {}
        B = x.shape[0]
        if "delta_h_final" in adapters:
            x = x + lane_rows(adapters["delta_h_final"].to(x.dtype), 1, B)[:, None, None, :]
        mod = linear(self.final["adaln"], F.silu(t_emb).to(x.dtype))
        shift, scale = mod.chunk(2, dim=-1)
        e = _per_token(tokens)
        h = modulate(layer_norm(x), e(shift), e(scale))
        h = linear(self.final["proj"], h)
        if tokens is not None:
            h = gather_from_group(h.reshape(B, tokens.length, -1), tokens.group, 1)
        out = unpatchify(h, cfg.patch_size, nt, nh, nw, cfg.out_channels)
        if "delta_out" in adapters:
            out = out + lane_rows(adapters["delta_out"].to(out.dtype), 1, B)[
                :, :, None, None, None]
        return out.float()

    def _block_adapters(self, adapters: AdapterDict):
        """Per-block slices of the adapter dict (the reference's scan
        inputs): one dict per block, or None per block without adapters.
        A lane axis stays in front ([V, depth, ...] -> [V, ...])."""
        if not adapters:
            return [None] * len(self.blocks)
        out = []
        for i in range(len(self.blocks)):
            ad = {k: block_slice(adapters[k], 2, i)
                  for k in _PER_BLOCK_KEYS if k in adapters}
            if "lora" in adapters:
                ad["lora"] = {site: {"a": block_slice(ab["a"], 3, i),
                                     "b": block_slice(ab["b"], 3, i)}
                              for site, ab in adapters["lora"].items()}
                ad["lora_scale"] = adapters.get("lora_scale", 1.0)
            out.append(ad)
        return out

    def _rope(self, nt, nh, nw, device, t_offset=0):
        cfg = self.cfg
        return rope_3d_angles(nt, nh, nw, cfg.rope_dims, cfg.rope_theta,
                              t_offset=t_offset, device=device)

    # ------------------------------------------------------------------
    def _decode_blocks(self, x, t_emb, y, cos, sin, num_cond_tokens, *,
                       kv_cache, kv_valid, bsa_cfg, pab_reuse, pab_cache,
                       cache_cond_half, block_ads, tokens=None):
        """The block loop of the sampling forwards (no autograd).

        ``pab_cache`` ([depth, B_cache, nt, nhw, D]) is read when
        ``pab_reuse`` and updated in place otherwise. With
        ``cache_cond_half`` the inputs carry the conditional half of the
        CFG batch only, and each block reads the last ``B`` rows of its
        KV-cache and PAB-cache entries: ``a[-B:]`` is a view, so no
        half-batch copy of either cache is made. Under a context group each
        rank reads and writes its tokens' view of the PAB cache."""
        nb = x.shape[0]
        half = (lambda a: a[a.shape[0] - nb:]) if cache_cond_half else (lambda a: a)
        for i, blk in enumerate(self.blocks):
            kv = None if kv_cache is None else (half(kv_cache[0][i]),
                                                half(kv_cache[1][i]))
            slot = None if pab_cache is None else self._local(half(pab_cache[i]), tokens)
            with span("dit.block"):
                x, _, attn_out = blk(x, t_emb, y, cos, sin, num_cond_tokens,
                                     kv_cache=kv, kv_valid=kv_valid, bsa_cfg=bsa_cfg,
                                     pab_cached=slot if pab_reuse else None,
                                     ad=block_ads[i], tokens=tokens)
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
        x, t_emb, y, (nt, nh, nw), tokens = self._embed_inputs(
            latents, timesteps, text_emb, text_mask, adapters)
        cos, sin = self._local_rope(*self._rope(nt, nh, nw, latents.device), tokens)
        num_cond_tokens = (num_cond_latents // cfg.patch_size[0]) * nh * nw
        kv_valid = None
        if num_valid_latents is not None:
            kv_valid = (int(num_valid_latents) // cfg.patch_size[0]) * nh * nw
        block_ads = self._block_adapters(adapters)
        if pab_cache is not None:
            x = self._decode_blocks(x, t_emb, y, cos, sin, num_cond_tokens,
                                    kv_cache=None, kv_valid=kv_valid, bsa_cfg=None,
                                    pab_reuse=pab_reuse, pab_cache=pab_cache,
                                    cache_cond_half=cache_cond_half,
                                    block_ads=block_ads, tokens=tokens)
            return self._final_layer(x, t_emb, nt, nh, nw, adapters, tokens)

        def block(blk, x, t_emb, ad):
            with span("dit.block"):
                return blk(x, t_emb, y, cos, sin, num_cond_tokens, kv_valid=kv_valid,
                           ad=ad, tokens=tokens)[0]

        body = remat_wrap(block, cfg.remat and torch.is_grad_enabled(),
                          cfg.remat_policy)
        for blk, ad in zip(self.blocks, block_ads):
            x = body(blk, x, t_emb, ad)
        return self._final_layer(x, t_emb, nt, nh, nw, adapters, tokens)

    def precompute_cond_cache(self, cond_latents, text_emb, text_mask=None, *,
                              adapters: AdapterDict = None) -> KVCache:
        """Run the conditioning tokens (timestep 0) through every block
        once, collecting per-block K/V: (k, v) each
        [depth, B, S_cond, heads, head_dim]."""
        B = cond_latents.shape[0]
        t0 = torch.zeros((B,), dtype=torch.float32, device=cond_latents.device)
        x, t_emb, y, (nt, nh, nw), tokens = self._embed_inputs(
            cond_latents, t0, text_emb, text_mask, adapters)
        cos, sin = self._local_rope(*self._rope(nt, nh, nw, cond_latents.device), tokens)
        num_cond_tokens = nt * nh * nw  # every token is conditioning here
        k_all = v_all = None
        for i, (blk, ad) in enumerate(zip(self.blocks, self._block_adapters(adapters))):
            with span("dit.block"):
                x, (k, v), _ = blk(x, t_emb, y, cos, sin, num_cond_tokens, ad=ad,
                                   tokens=tokens)
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
        x, t_emb, y, (nt, nh, nw), tokens = self._embed_inputs(
            noise_latents, timesteps, text_emb, text_mask, adapters)
        nt_cond = num_cond_latents // self.cfg.patch_size[0]
        # noise-frame tokens sit after the conditioning frames in RoPE space
        cos, sin = self._local_rope(
            *self._rope(nt, nh, nw, noise_latents.device, t_offset=nt_cond), tokens)
        kv_valid = None
        if num_valid_latents is not None:
            # a global key index: each rank's cache is its shard of the cache
            n_cache = kv_cache[0].shape[2] * (1 if tokens is None
                                              else group_size(tokens.group))
            kv_valid = n_cache + (int(num_valid_latents) // self.cfg.patch_size[0]) * nh * nw
        x = self._decode_blocks(x, t_emb, y, cos, sin, 0, kv_cache=kv_cache,
                                kv_valid=kv_valid, bsa_cfg=bsa_cfg,
                                pab_reuse=pab_reuse, pab_cache=pab_cache,
                                cache_cond_half=cache_cond_half,
                                block_ads=self._block_adapters(adapters), tokens=tokens)
        return self._final_layer(x, t_emb, nt, nh, nw, adapters, tokens)


def pab_init_cache(cfg: DiTConfig, batch: int, t_noise: int, lat_h: int, lat_w: int,
                   device=None) -> torch.Tensor:
    """Zero PAB self-attention cache [depth, B, nt, nh*nw, D] in the
    compute dtype (the sampler computes step 0, so the zeros are never
    read)."""
    pt, ph, pw = cfg.patch_size
    nt, nh, nw = t_noise // pt, lat_h // ph, lat_w // pw
    return torch.zeros((cfg.depth, batch, nt, nh * nw, cfg.hidden_size),
                       dtype=resolve_dtype(cfg.compute_dtype), device=device)
