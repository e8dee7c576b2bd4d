"""Plain float32 reference of the LongCat-Video DiT (meituan-longcat/
LongCat-Video, ``longcat_video_dit.py``) and of the two uses the cells
time: the conditioned flow-matching TTA loss with its anchor, and the CFG
Euler continuation against the conditioning tokens' keys and values.

The block, as published: adaLN from the t-embedding (6 chunks: shift,
scale, gate for the self-attention and for the SwiGLU feed-forward, one
set per latent frame), self-attention with a fused qkv, per-head RMS q/k
norm and half-split 3D RoPE, where the first ``ncond`` tokens (the clean
conditioning frames) see only themselves; pre-norm (affine LayerNorm)
cross-attention over the text tokens, whose padding is zeroed and still
attended to; the gated SwiGLU feed-forward. The final layer is adaLN
(shift, scale) and a linear to the patch's channels.

Weights are read by the checkpoint's own names from the dict the
benchmark drew; they are cast to float32 one block at a time. Every
product is float32 with TF32 off (the caller holds ``fp32_matmuls``);
with ``lowp`` the products' operands are rounded to float8 first (the
control). Departures from the published module: none in the equations;
the t-embedder and the text embedder take the widths of the
configuration file.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .common import attention, layer_norm, linear, rms_norm, rope, rope_tables, \
    timestep_embedding

KV = Tuple[torch.Tensor, torch.Tensor]


def patchify(x: torch.Tensor, patch) -> torch.Tensor:
    """[B, C, T, H, W] -> [B, T' * H' * W', pt * ph * pw * C], tokens
    frame-major, features (pt, ph, pw, C)."""
    B, C, T, H, W = x.shape
    pt, ph, pw = patch
    x = x.reshape(B, C, T // pt, pt, H // ph, ph, W // pw, pw)
    x = x.permute(0, 2, 4, 6, 3, 5, 7, 1)
    return x.reshape(B, (T // pt) * (H // ph) * (W // pw), pt * ph * pw * C)


def unpatchify(x: torch.Tensor, patch, nt: int, nh: int, nw: int, C: int) -> torch.Tensor:
    B = x.shape[0]
    pt, ph, pw = patch
    x = x.reshape(B, nt, nh, nw, pt, ph, pw, C)
    return x.permute(0, 7, 1, 4, 2, 5, 3, 6).reshape(B, C, nt * pt, nh * ph, nw * pw)


class LongCat:
    """``cfg``: the configuration file's model keys (``hidden_size``,
    ``depth``, ``num_heads``, ``ffn_dim``, ``rope_dims``, ...);
    ``weights``: name -> tensor."""

    def __init__(self, cfg: Dict, weights: Dict[str, torch.Tensor], lowp: bool = False):
        self.cfg, self.w, self.lowp = cfg, weights, lowp
        self.D = cfg["hidden_size"]
        self.H = cfg["num_heads"]
        self.dh = self.D // self.H
        self.patch = tuple(cfg["patch_size"])

    def _lin(self, x, name, bias: bool = True):
        return linear(x, self.w[name + ".weight"], self.w[name + ".bias"] if bias else None,
                      self.lowp)

    # -- embedders ---------------------------------------------------------
    def t_embed(self, timesteps: torch.Tensor, delta: Optional[torch.Tensor] = None):
        """timesteps [B, nt] (sigma * 1000) -> [B, nt, C_t] float32."""
        f = timestep_embedding(timesteps, self.cfg["frequency_embedding_size"])
        e = F.linear(F.silu(F.linear(f, self.w["t_embed.w1.weight"].float(),
                                     self.w["t_embed.w1.bias"].float())),
                     self.w["t_embed.w2.weight"].float(), self.w["t_embed.w2.bias"].float())
        return e if delta is None else e + delta.float()

    def y_embed(self, text: torch.Tensor, mask: Optional[torch.Tensor]):
        y = self._lin(F.gelu(self._lin(text.float(), "y_embed.in"), approximate="tanh"),
                      "y_embed.out")
        return y if mask is None else y * mask.float()[:, :, None]

    # -- the block ---------------------------------------------------------
    def _qkv(self, i: int, h, cos, sin):
        B, S, _ = h.shape
        p = f"blocks.{i}.attn"
        qkv = self._lin(h, p + ".qkv").reshape(B, S, 3, self.H, self.dh)
        q = rope(rms_norm(qkv[:, :, 0], self.w[p + ".q_norm"]), cos, sin)
        k = rope(rms_norm(qkv[:, :, 1], self.w[p + ".k_norm"]), cos, sin)
        return q, k, qkv[:, :, 2]

    def block(self, i: int, x, temb, y, cos, sin, nhw: int, ncond: int,
              cache: Optional[KV] = None):
        """x [B, S, D] -> (x, (k, v) of x's tokens). ``cache``: keys and
        values prepended to the self-attention's (the continuation)."""
        B, S, D = x.shape
        nt = S // nhw
        mod = self._lin(F.silu(temb), f"blocks.{i}.adaln")  # [B, nt, 6D]
        per_tok = lambda m: m[:, :, None, :].expand(B, nt, nhw, D).reshape(B, S, D)
        sh1, sc1, g1, sh2, sc2, g2 = (per_tok(m) for m in mod.chunk(6, dim=-1))
        h = layer_norm(x) * (1 + sc1) + sh1
        q, k, v = self._qkv(i, h, cos, sin)
        kk, vv = (k, v) if cache is None else (torch.cat([cache[0], k], 1),
                                               torch.cat([cache[1], v], 1))
        o = attention(q, kk, vv, ncond, self.lowp).reshape(B, S, D)
        x = x + g1 * self._lin(o, f"blocks.{i}.attn.proj")
        p = f"blocks.{i}.cross_attn"
        h = layer_norm(x, self.w[f"blocks.{i}.pre_crs_norm.weight"],
                       self.w[f"blocks.{i}.pre_crs_norm.bias"])
        L = y.shape[1]
        cq = rms_norm(self._lin(h, p + ".q").reshape(B, S, self.H, self.dh), self.w[p + ".q_norm"])
        ckv = self._lin(y, p + ".kv").reshape(B, L, 2, self.H, self.dh)
        ck = rms_norm(ckv[:, :, 0], self.w[p + ".k_norm"])
        o = attention(cq, ck, ckv[:, :, 1], 0, self.lowp).reshape(B, S, D)
        x = x + self._lin(o, p + ".proj")
        h = layer_norm(x) * (1 + sc2) + sh2
        f = f"blocks.{i}.ffn"
        ff = self._lin(F.silu(self._lin(h, f + ".w1", False)) * self._lin(h, f + ".w3", False),
                       f + ".w2", False)
        return x + g2 * ff, (k, v)

    def final(self, x, temb, nhw: int):
        B, S, D = x.shape
        nt = S // nhw
        shift, scale = self._lin(F.silu(temb), "final.adaln").chunk(2, dim=-1)
        per_tok = lambda m: m[:, :, None, :].expand(B, nt, nhw, D).reshape(B, S, D)
        return self._lin(layer_norm(x) * (1 + per_tok(scale)) + per_tok(shift), "final.proj")

    # -- whole forwards ----------------------------------------------------
    def forward(self, latents, timesteps, text, mask, num_cond_latents: int = 0,
                delta: Optional[torch.Tensor] = None, remat: bool = False):
        """Velocity [B, C, T, H, W] float32 of ``latents`` [B, C, T, H, W]
        at ``timesteps`` [B, T] (sigma * 1000 per latent frame), the first
        ``num_cond_latents`` frames the prefix. ``remat``: recompute each
        block in the backward (only its input is kept)."""
        B, C, T, Hh, Ww = latents.shape
        pt, ph, pw = self.patch
        nt, nh, nw = T // pt, Hh // ph, Ww // pw
        x = self._lin(patchify(latents.float(), self.patch), "x_embed")
        temb = self.t_embed(timesteps, delta)
        y = self.y_embed(text, mask)
        cos, sin = rope_tables(nt, nh, nw, self.cfg["rope_dims"], self.cfg["rope_theta"],
                               device=x.device)
        ncond = (num_cond_latents // pt) * nh * nw
        for i in range(self.cfg["depth"]):
            fn = lambda x, temb, y, i=i: self.block(i, x, temb, y, cos, sin, nh * nw, ncond)[0]
            x = checkpoint(fn, x, temb, y, use_reentrant=False) if remat else fn(x, temb, y)
        out = self.final(x, temb, nh * nw)
        return unpatchify(out, self.patch, nt, nh, nw, self.cfg["out_channels"])

    def cond_cache(self, cond_latents, text, mask) -> List[KV]:
        """Each block's (k, v) of the conditioning tokens at timestep 0."""
        B, C, T, Hh, Ww = cond_latents.shape
        pt, ph, pw = self.patch
        nt, nh, nw = T // pt, Hh // ph, Ww // pw
        x = self._lin(patchify(cond_latents.float(), self.patch), "x_embed")
        temb = self.t_embed(torch.zeros((B, nt), device=x.device))
        y = self.y_embed(text, mask)
        cos, sin = rope_tables(nt, nh, nw, self.cfg["rope_dims"], self.cfg["rope_theta"],
                               device=x.device)
        out = []
        for i in range(self.cfg["depth"]):
            x, kv = self.block(i, x, temb, y, cos, sin, nh * nw, nt * nh * nw)
            out.append(kv)
        return out

    def forward_with_cache(self, noise_latents, t, text, mask, cache: List[KV],
                           num_cond_latents: int):
        """Velocity of the generated frames at timestep ``t`` [B], their
        tokens placed after the conditioning frames in RoPE time and
        seeing every cached key."""
        B, C, T, Hh, Ww = noise_latents.shape
        pt, ph, pw = self.patch
        nt, nh, nw = T // pt, Hh // ph, Ww // pw
        x = self._lin(patchify(noise_latents.float(), self.patch), "x_embed")
        temb = self.t_embed(t.float()[:, None].expand(B, nt))
        y = self.y_embed(text, mask)
        cos, sin = rope_tables(nt, nh, nw, self.cfg["rope_dims"], self.cfg["rope_theta"],
                               t_offset=num_cond_latents // pt, device=x.device)
        for i in range(self.cfg["depth"]):
            x, _ = self.block(i, x, temb, y, cos, sin, nh * nw, 0, cache=cache[i])
        out = self.final(x, temb, nh * nw)
        return unpatchify(out, self.patch, nt, nh, nw, self.cfg["out_channels"])


MODEL = LongCat


# ---------------------------------------------------------------------------
# the cells' uses
# ---------------------------------------------------------------------------


def _frame_timesteps(sigma: torch.Tensor, n_cond: int, n_tgt: int) -> torch.Tensor:
    B = sigma.shape[0]
    return torch.cat([torch.zeros((B, n_cond), device=sigma.device),
                      (sigma.float() * 1000.0)[:, None].expand(B, n_tgt)], dim=1)


def tta_loss(ref: LongCat, cond, target, text, mask, sigma, noise, delta,
             remat: bool = True, half: bool = False):
    """The conditioned flow-matching loss: the clean conditioning frames
    (timestep 0) then the target frames at x = (1 - s) x0 + s e (timestep
    s * 1000) in one forward, the mean squared error of the target
    frames' velocity against e - x0."""
    tc, tt = cond.shape[2], target.shape[2]
    s = sigma.float().reshape(-1, 1, 1, 1, 1)
    noisy = (1 - s) * target.float() + s * noise.float()
    pred = ref.forward(torch.cat([cond.float(), noisy], 2), _frame_timesteps(sigma, tc, tt),
                       text, mask, tc, delta, remat=remat)
    return _mean(((pred[:, :, tc:] - (noise.float() - target.float())) ** 2), half)


def _mean(err: torch.Tensor, half: bool) -> torch.Tensor:
    """The mean of ``err``; with ``half`` (a planted fault) of its first
    half only."""
    err = err.flatten()
    return err[: err.numel() // 2].mean() if half else err.mean()


def anchor_loss(ref: LongCat, cond, val, text, mask, fixed_noises, sigmas, delta) -> float:
    """The early stopper's anchor: the mean over (sigma, draw), sigma
    major, of the loss above at fixed sigmas and fixed noises; one
    forward per pair, without a gradient."""
    total = 0.0
    with torch.no_grad():
        for s in sigmas:
            for noise in fixed_noises:
                sig = torch.full((cond.shape[0],), float(s), device=cond.device)
                total += float(tta_loss(ref, cond, val, text, mask, sig, noise, delta,
                                        remat=False))
    return total / (len(sigmas) * len(fixed_noises))


def sigmas(num_steps: int, shift: float, sigma_max: float = 1.0, device=None):
    """The flow-match schedule: linspace(1, 1/n, n) shifted by
    s sigma / (1 + (s - 1) sigma), times sigma_max, then 0."""
    s = torch.linspace(1.0, 1.0 / num_steps, num_steps, dtype=torch.float32, device=device)
    s = shift * s / (1.0 + (shift - 1.0) * s) * sigma_max
    return torch.cat([s, s.new_zeros(1)])


def denoise_step(ref: LongCat, x, sigma, sigma_next, text2, mask2, cache, num_cond_latents,
                 guidance: float):
    """One CFG Euler step of the continuation from x [1, C, T, H, W]:
    the [negative; positive] pair at timestep sigma * 1000, v = v_u + g
    (v_c - v_u), x + (sigma_next - sigma) v."""
    with torch.no_grad():
        t = (sigma * 1000.0).reshape(1).expand(2)
        v2 = ref.forward_with_cache(torch.cat([x, x], 0), t, text2, mask2, cache,
                                    num_cond_latents)
        v = v2[:1] + guidance * (v2[1:] - v2[:1])
        return x.float() + (sigma_next - sigma) * v
