"""Causal 3D VAE (WAN-style) in PyTorch (counterpart of
``longcat_video_tta_tpu/models/vae.py``).

Temporal x4 / spatial x8 compression, ``z_dim``-channel latents with
per-channel ``latents_mean``/``latents_std`` normalization, causal
temporal convolutions (the first frame encodes independently, so
``T_lat = 1 + (T-1)/4``). The layout is NCTHW throughout and every 3D
convolution is one ``F.conv3d`` (the reference splits them into k_t 2D
convolutions only to work around the TPU compiler).

The module tree mirrors the reference's parameter tree
(``enc.scales[i].res[j].conv1`` ...); conv weights are stored
[Cout, Cin, kt, kh, kw]. The encode/decode traversals are functions over
that tree, as in the reference, so the streamed feature-cache variants
read side by side with it.
"""

from __future__ import annotations

from typing import List, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..config import VAEConfig, resolve_dtype


# ---------------------------------------------------------------------------
# Parameter containers
# ---------------------------------------------------------------------------


class Conv(nn.Module):
    """A 3D conv's weight [Cout, Cin, kt, kh, kw] and bias [Cout]."""

    def __init__(self, cin, cout, kernel, dtype):
        super().__init__()
        self.weight = nn.Parameter(torch.empty((cout, cin) + tuple(kernel), dtype=dtype))
        self.bias = nn.Parameter(torch.empty(cout, dtype=dtype))


class RMSNorm(nn.Module):
    """Wan channelwise RMS norm gamma/beta (kept in fp32)."""

    def __init__(self, c):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(c, dtype=torch.float32))
        self.bias = nn.Parameter(torch.empty(c, dtype=torch.float32))


class ResBlock(nn.Module):
    def __init__(self, cin, cout, dtype):
        super().__init__()
        self.norm1 = RMSNorm(cin)
        self.conv1 = Conv(cin, cout, (3, 3, 3), dtype)
        self.norm2 = RMSNorm(cout)
        self.conv2 = Conv(cout, cout, (3, 3, 3), dtype)
        self.shortcut = Conv(cin, cout, (1, 1, 1), dtype) if cin != cout else None


class Attn(nn.Module):
    def __init__(self, c, dtype):
        super().__init__()
        self.norm = RMSNorm(c)
        self.q = nn.Linear(c, c, dtype=dtype)
        self.k = nn.Linear(c, c, dtype=dtype)
        self.v = nn.Linear(c, c, dtype=dtype)
        self.proj = nn.Linear(c, c, dtype=dtype)


class Mid(nn.Module):
    def __init__(self, c, dtype):
        super().__init__()
        self.res1 = ResBlock(c, c, dtype)
        self.attn = Attn(c, dtype)
        self.res2 = ResBlock(c, c, dtype)


def decoder_channel_plan(cfg: VAEConfig):
    """Wan2.1 decoder plan: dims_dec = [dims[-1]] + dims[::-1]; every
    Resample's spatial conv halves channels. Returns
    [(cin, cout, has_resample, has_temporal)] per decoder scale."""
    dims = [cfg.base_dim * m for m in cfg.dim_mults]
    dims_dec = [dims[-1]] + dims[::-1]
    ups = tuple(cfg.temporal_downsample)[::-1]
    n = len(dims)
    plan = []
    for idx in range(n):
        cin = dims_dec[idx] if idx == 0 else dims_dec[idx] // 2
        cout = dims_dec[idx + 1]
        has_rs = idx < n - 1
        plan.append((cin, cout, has_rs, has_rs and ups[idx]))
    return plan


class WanVAE(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        self.cfg = cfg
        dt = resolve_dtype(cfg.param_dtype)
        dims = [cfg.base_dim * m for m in cfg.dim_mults]
        mid_c = dims[-1]

        enc_scales = nn.ModuleList()
        for i in range(len(dims)):
            cin = dims[i - 1] if i > 0 else dims[0]
            cout = dims[i]
            sc = nn.Module()
            sc.res = nn.ModuleList([ResBlock(cin if j == 0 else cout, cout, dt)
                                    for j in range(cfg.num_res_blocks)])
            if i < len(dims) - 1:
                sc.sdown = Conv(cout, cout, (1, 3, 3), dt)
                if cfg.temporal_downsample[i]:
                    sc.tdown = Conv(cout, cout, (3, 1, 1), dt)
            enc_scales.append(sc)
        enc = nn.Module()
        enc.conv_in = Conv(3, dims[0], (3, 3, 3), dt)
        enc.scales = enc_scales
        enc.mid = Mid(mid_c, dt)
        enc.norm_out = RMSNorm(mid_c)
        enc.conv_out = Conv(mid_c, 2 * cfg.z_dim, (3, 3, 3), dt)
        enc.quant = Conv(2 * cfg.z_dim, 2 * cfg.z_dim, (1, 1, 1), dt)
        self.enc = enc

        dec_scales = nn.ModuleList()
        for cin, cout, has_rs, has_t in decoder_channel_plan(cfg):
            sc = nn.Module()
            sc.res = nn.ModuleList([ResBlock(cin if j == 0 else cout, cout, dt)
                                    for j in range(cfg.num_res_blocks + 1)])
            if has_rs:
                if has_t:
                    sc.tup = Conv(cout, 2 * cout, (3, 1, 1), dt)
                sc.sup = Conv(cout, cout // 2, (1, 3, 3), dt)
            dec_scales.append(sc)
        dec = nn.Module()
        dec.post_quant = Conv(cfg.z_dim, cfg.z_dim, (1, 1, 1), dt)
        dec.conv_in = Conv(cfg.z_dim, mid_c, (3, 3, 3), dt)
        dec.mid = Mid(mid_c, dt)
        dec.scales = dec_scales
        dec.norm_out = RMSNorm(dims[0])
        dec.conv_out = Conv(dims[0], 3, (3, 3, 3), dt)
        self.dec = dec


# ---------------------------------------------------------------------------
# Primitive ops (NCTHW)
# ---------------------------------------------------------------------------


def _conv(p: Conv, x, tpad, stride=(1, 1, 1), spad=None):
    """conv3d with explicit (left, right) temporal padding and spatial
    padding ((top, bottom), (left, right)); default spatial is SAME."""
    kt, kh, kw = p.weight.shape[2:]
    if spad is None:
        spad = (((kh - 1) // 2, kh // 2), ((kw - 1) // 2, kw // 2))
    (pt, pb), (pl, pr) = spad
    if any((tpad[0], tpad[1], pt, pb, pl, pr)):
        x = F.pad(x, (pl, pr, pt, pb, tpad[0], tpad[1]))
    return F.conv3d(x, p.weight.to(x.dtype), p.bias.to(x.dtype), stride=stride)


def causal_conv3d(p: Conv, x, stride=(1, 1, 1)):
    """Causal temporal padding (kt-1 zeros on the left), SAME spatial."""
    return _conv(p, x, (p.weight.shape[2] - 1, 0), stride)


def wan_rms_norm(p: RMSNorm, x, eps: float = 1e-12):
    """Channelwise L2 normalization per (t, h, w) position, scaled by
    sqrt(C) and a per-channel gamma (+ beta), in fp32."""
    xf = x.float()
    n = torch.sqrt(torch.sum(xf * xf, dim=1, keepdim=True))
    xf = xf / torch.clamp(n, min=eps) * (x.shape[1] ** 0.5)
    xf = xf * p.weight.view(1, -1, 1, 1, 1) + p.bias.view(1, -1, 1, 1, 1)
    return xf.to(x.dtype)


def _resblock(p: ResBlock, x):
    h = causal_conv3d(p.conv1, F.silu(wan_rms_norm(p.norm1, x)))
    h = causal_conv3d(p.conv2, F.silu(wan_rms_norm(p.norm2, h)))
    if p.shortcut is not None:
        x = causal_conv3d(p.shortcut, x)
    return x + h


def _spatial_attn(p: Attn, x):
    """Per-frame spatial self-attention (mid-block), plain fp32 softmax."""
    B, C, T, H, W = x.shape
    h = wan_rms_norm(p.norm, x).permute(0, 2, 3, 4, 1).reshape(B * T, H * W, C)
    lin = lambda m, t: F.linear(t, m.weight.to(t.dtype), m.bias.to(t.dtype))
    q, k, v = lin(p.q, h), lin(p.k, h), lin(p.v, h)
    logits = torch.einsum("bqc,bkc->bqk", q.float(), k.float()) * (C ** -0.5)
    attn = torch.softmax(logits, dim=-1)
    o = torch.einsum("bqk,bkc->bqc", attn, v.float()).to(x.dtype)
    o = lin(p.proj, o)
    return x + o.reshape(B, T, H, W, C).permute(0, 4, 1, 2, 3)


def _temporal_downsample(p: Conv, x):
    """Wan downsample3d: cat([x[:1], conv_nopad_stride2(x)]) in time."""
    if x.shape[2] < p.weight.shape[2]:
        return x[:, :, :1]
    y = _conv(p, x, (0, 0), stride=(2, 1, 1))
    return torch.cat([x[:, :, :1], y], dim=2)


def _interleave2(y):
    """[B, 2C, T, H, W] -> [B, C, 2T, H, W]: each output frame splits into
    two consecutive frames (channel halves)."""
    B, C2, T, H, W = y.shape
    y = y.reshape(B, 2, C2 // 2, T, H, W).permute(0, 2, 3, 1, 4, 5)
    return y.reshape(B, C2 // 2, 2 * T, H, W)


def _temporal_upsample(p: Conv, x):
    """Wan upsample3d: cat([x[:1], interleave2(causal_conv(x[1:]))])."""
    first, rest = x[:, :, :1], x[:, :, 1:]
    if rest.shape[2] == 0:
        return first
    return torch.cat([first, _interleave2(causal_conv3d(p, rest))], dim=2)


def _spatial_downsample(p: Conv, x):
    return _conv(p, x, (0, 0), stride=(1, 2, 2), spad=((0, 1), (0, 1)))


def _spatial_upsample(p: Conv, x):
    x = x.repeat_interleave(2, dim=3).repeat_interleave(2, dim=4)
    return causal_conv3d(p, x)


# ---------------------------------------------------------------------------
# Encode / decode
# ---------------------------------------------------------------------------


def vae_encode_moments(vae: WanVAE, video: torch.Tensor):
    """video [B, 3, T, H, W] in [-1, 1] -> (mean, logvar) each fp32
    [B, z_dim, T_lat, H/8, W/8] with T_lat = 1 + (T-1)//4."""
    cfg = vae.cfg
    x = video.to(resolve_dtype(cfg.compute_dtype))
    e = vae.enc
    x = causal_conv3d(e.conv_in, x)
    n_scales = len(cfg.dim_mults)
    for i, sp in enumerate(e.scales):
        for rp in sp.res:
            x = _resblock(rp, x)
        if i < n_scales - 1:
            x = _spatial_downsample(sp.sdown, x)
            if cfg.temporal_downsample[i]:
                x = _temporal_downsample(sp.tdown, x)
    x = _resblock(e.mid.res1, x)
    x = _spatial_attn(e.mid.attn, x)
    x = _resblock(e.mid.res2, x)
    x = causal_conv3d(e.conv_out, F.silu(wan_rms_norm(e.norm_out, x)))
    x = causal_conv3d(e.quant, x)
    mean, logvar = x.chunk(2, dim=1)
    return mean.float(), logvar.float()


def vae_encode(vae: WanVAE, video: torch.Tensor, normalize: bool = True):
    """Encode to (normalized) latent means (deterministic mode)."""
    z, _ = vae_encode_moments(vae, video)
    return normalize_latents(vae.cfg, z) if normalize else z


def _vae_decode_core(vae: WanVAE, z: torch.Tensor):
    cfg = vae.cfg
    x = z.to(resolve_dtype(cfg.compute_dtype))
    d = vae.dec
    x = causal_conv3d(d.post_quant, x)
    x = causal_conv3d(d.conv_in, x)
    x = _resblock(d.mid.res1, x)
    x = _spatial_attn(d.mid.attn, x)
    x = _resblock(d.mid.res2, x)
    for sp, (_, _, has_rs, has_t) in zip(d.scales, decoder_channel_plan(cfg)):
        for rp in sp.res:
            x = _resblock(rp, x)
        if has_rs:
            # Wan Resample order: temporal first, then spatial
            if has_t:
                x = _temporal_upsample(sp.tup, x)
            x = _spatial_upsample(sp.sup, x)
    x = causal_conv3d(d.conv_out, F.silu(wan_rms_norm(d.norm_out, x)))
    return x.float()


def vae_decode(vae: WanVAE, latents: torch.Tensor, denormalize: bool = True,
               chunk_latents: int = 1, context_latents: int = 3) -> torch.Tensor:
    """Latents -> pixels in [0, 1]. Long clips decode in sliding
    temporal windows, each with ``context_latents`` preceding latents
    whose pixels are discarded (exact up to the receptive field)."""
    cfg = vae.cfg
    if denormalize:
        latents = denormalize_latents(cfg, latents)
    L = latents.shape[2]
    if L <= context_latents + chunk_latents:
        video = _vae_decode_core(vae, latents)
        return torch.clamp((video + 1.0) / 2.0, 0.0, 1.0)
    tf = cfg.temporal_factor
    pieces = [_vae_decode_core(vae, latents[:, :, :chunk_latents])]
    for j in range(chunk_latents, L, chunk_latents):
        lo = max(0, j - context_latents)
        dec = _vae_decode_core(vae, latents[:, :, lo:j + chunk_latents])
        n_keep = (min(j + chunk_latents, L) - j) * tf
        pieces.append(dec[:, :, -n_keep:])
    video = torch.cat(pieces, dim=2)
    return torch.clamp((video + 1.0) / 2.0, 0.0, 1.0)


# ---------------------------------------------------------------------------
# Latent normalization
# ---------------------------------------------------------------------------


def _stats(cfg: VAEConfig, z: torch.Tensor):
    mean = torch.tensor(cfg.latents_mean, dtype=z.dtype, device=z.device)
    std = torch.tensor(cfg.latents_std, dtype=z.dtype, device=z.device)
    return mean.view(1, -1, 1, 1, 1), std.view(1, -1, 1, 1, 1)


def normalize_latents(cfg: VAEConfig, z: torch.Tensor) -> torch.Tensor:
    mean, std = _stats(cfg, z)
    return (z - mean) / std


def denormalize_latents(cfg: VAEConfig, z: torch.Tensor) -> torch.Tensor:
    mean, std = _stats(cfg, z)
    return z * std + mean


def latent_len(num_pixel_frames: int, temporal_factor: int = 4) -> int:
    """T_lat = 1 + (T-1)//factor."""
    n = max(1, int(num_pixel_frames))
    return 1 + (n - 1) // temporal_factor


# ---------------------------------------------------------------------------
# Streaming decode / encode with exact causal feature caches
# ---------------------------------------------------------------------------
#
# Every temporal conv carries its (kt-1)-frame input tail between chunks,
# so long clips decode (encode) in constant memory and the result equals
# the monolithic pass up to float reassociation.


def _causal_conv3d_cached(p: Conv, x, cache):
    """Causal conv with explicit temporal state. cache: [B, C, kt-1, H, W]
    input tail from the previous chunk, or None (zero history). Returns
    (y, new_cache); kt == 1 convs are stateless (cache None)."""
    kt = p.weight.shape[2]
    if kt == 1:
        return causal_conv3d(p, x), None
    if cache is None:
        cache = x.new_zeros(x.shape[:2] + (kt - 1,) + x.shape[3:])
    ext = torch.cat([cache.to(x.dtype), x], dim=2)
    return _conv(p, ext, (0, 0)), ext[:, :, -(kt - 1):]


class _CacheIO:
    """Threads the per-op cache list through a traversal."""

    def __init__(self, caches):
        self._in = iter(caches) if caches is not None else None
        self.out: List = []

    def conv(self, p, x):
        c = next(self._in) if self._in is not None else None
        y, nc = _causal_conv3d_cached(p, x, c)
        self.out.append(nc)
        return y

    def pull(self):
        return next(self._in) if self._in is not None else None

    def push(self, c):
        self.out.append(c)


def _resblock_cached(p: ResBlock, x, cio: _CacheIO):
    h = cio.conv(p.conv1, F.silu(wan_rms_norm(p.norm1, x)))
    h = cio.conv(p.conv2, F.silu(wan_rms_norm(p.norm2, h)))
    if p.shortcut is not None:
        x = causal_conv3d(p.shortcut, x)  # 1x1x1, stateless
    return x + h


def _temporal_upsample_cached(p: Conv, x, cio: _CacheIO, first: bool):
    """Streaming _temporal_upsample: the first latent frame (first chunk
    only) passes through and never feeds the time conv, whose cache
    starts at zeros."""
    cache = cio.pull()
    head, rest = (x[:, :, :1], x[:, :, 1:]) if first else (None, x)
    if cache is None:
        cache = x.new_zeros(x.shape[:2] + (2,) + rest.shape[3:])
    if rest.shape[2] == 0:
        cio.push(cache)
        return head
    ext = torch.cat([cache.to(x.dtype), rest], dim=2)
    cio.push(ext[:, :, -2:])
    y = _interleave2(_conv(p, ext, (0, 0)))
    return y if head is None else torch.cat([head, y], dim=2)


def _vae_decode_chunk(vae: WanVAE, z: torch.Tensor, caches, first: bool):
    """Decode one latent chunk with carried caches. Returns (pixels
    [B, 3, t, H, W] fp32 before the [0, 1] mapping, new caches)."""
    cfg = vae.cfg
    x = z.to(resolve_dtype(cfg.compute_dtype))
    d = vae.dec
    cio = _CacheIO(caches)
    x = causal_conv3d(d.post_quant, x)
    x = cio.conv(d.conv_in, x)
    x = _resblock_cached(d.mid.res1, x, cio)
    x = _spatial_attn(d.mid.attn, x)
    x = _resblock_cached(d.mid.res2, x, cio)
    for sp, (_, _, has_rs, has_t) in zip(d.scales, decoder_channel_plan(cfg)):
        for rp in sp.res:
            x = _resblock_cached(rp, x, cio)
        if has_rs:
            if has_t:
                x = _temporal_upsample_cached(sp.tup, x, cio, first)
            x = _spatial_upsample(sp.sup, x)
    x = cio.conv(d.conv_out, F.silu(wan_rms_norm(d.norm_out, x)))
    return x.float(), tuple(cio.out)


def vae_decode_streamed(vae: WanVAE, latents: torch.Tensor,
                        denormalize: bool = True,
                        chunk_latents: int = 2) -> torch.Tensor:
    """Streaming decode: latents -> pixels in [0, 1], constant
    activation memory in clip length. The first chunk is the first
    latent frame alone (it carries the first-frame paths)."""
    if denormalize:
        latents = denormalize_latents(vae.cfg, latents)
    L = latents.shape[2]
    x0, caches = _vae_decode_chunk(vae, latents[:, :, :1], None, True)
    pieces = [x0]
    j = 1
    while j < L:
        c = min(chunk_latents, L - j)
        xj, caches = _vae_decode_chunk(vae, latents[:, :, j:j + c], caches, False)
        pieces.append(xj)
        j += c
    video = torch.cat(pieces, dim=2)
    return torch.clamp((video + 1.0) / 2.0, 0.0, 1.0)


def _temporal_downsample_cached(p: Conv, x, cio: _CacheIO, first: bool):
    """Streaming _temporal_downsample (stride-2 k=3 unpadded conv; carry
    = one input frame). The first frame (chunk 0 only) passes through and
    seeds the carry."""
    cache = cio.pull()
    if first:
        cio.push(x[:, :, :1])
        return x[:, :, :1]
    ext = torch.cat([cache.to(x.dtype), x], dim=2)
    n_out = (ext.shape[2] - 3) // 2 + 1
    if n_out < 1:
        raise ValueError("streaming chunk too small for the stride-2 window")
    cio.push(ext[:, :, 2 * n_out:])
    return _conv(p, ext, (0, 0), stride=(2, 1, 1))


def _vae_encode_chunk(vae: WanVAE, video: torch.Tensor, caches, first: bool):
    """Encode one pixel-frame chunk with carried caches. Returns (latent
    mean for the chunk, new caches)."""
    cfg = vae.cfg
    x = video.to(resolve_dtype(cfg.compute_dtype))
    e = vae.enc
    cio = _CacheIO(caches)
    x = cio.conv(e.conv_in, x)
    n_scales = len(cfg.dim_mults)
    for i, sp in enumerate(e.scales):
        for rp in sp.res:
            x = _resblock_cached(rp, x, cio)
        if i < n_scales - 1:
            x = _spatial_downsample(sp.sdown, x)
            if cfg.temporal_downsample[i]:
                x = _temporal_downsample_cached(sp.tdown, x, cio, first)
    x = _resblock_cached(e.mid.res1, x, cio)
    x = _spatial_attn(e.mid.attn, x)
    x = _resblock_cached(e.mid.res2, x, cio)
    x = cio.conv(e.conv_out, F.silu(wan_rms_norm(e.norm_out, x)))
    x = causal_conv3d(e.quant, x)
    mean, _ = x.chunk(2, dim=1)
    return mean.float(), tuple(cio.out)


def vae_encode_streamed(vae: WanVAE, video: torch.Tensor, normalize: bool = True,
                        chunk_frames: int = 8) -> torch.Tensor:
    """Streaming encode: pixels [B, 3, T, H, W] in [-1, 1] -> (normalized)
    latent means in constant activation memory. ``chunk_frames`` must be a
    multiple of the temporal factor; T must be 1 (mod temporal factor)."""
    tf = vae.cfg.temporal_factor
    if chunk_frames % tf:
        raise ValueError(f"chunk_frames {chunk_frames} must be a multiple of {tf}")
    T = video.shape[2]
    mean0, caches = _vae_encode_chunk(vae, video[:, :, :1], None, True)
    pieces = [mean0]
    j = 1
    while j < T:
        c = min(chunk_frames, T - j)
        # absorb a ragged remainder (< temporal factor) into this chunk
        if 0 < T - (j + c) < tf:
            c = T - j
        mj, caches = _vae_encode_chunk(vae, video[:, :, j:j + c], caches, False)
        pieces.append(mj)
        j += c
    z = torch.cat(pieces, dim=2)
    return normalize_latents(vae.cfg, z) if normalize else z
