"""Plain float32 reference of the CogVideoX-5B-I2V transformer
(THUDM/CogVideoX-5b-I2V, ``transformer/config.json``; the diffusers
``CogVideoXTransformer3DModel``) and of the TTA loss and anchor the cells
time.

The model, as published: the I2V input is the noisy latents and the
image latents (the first conditioning latent, zeros after it)
concatenated on the channels, embedded per 2 x 2 patch; the text
projected to the hidden width; the joint [text | video] sequence through
blocks of {CogVideoXLayerNormZero (one linear of silu(temb) into shift,
scale and gate for the video and the text stream, a shared affine
LayerNorm), q/k/v projections, LayerNorm of q and k over the head
dimension, half-split 3D RoPE on the video tokens only, full softmax
attention over the joint sequence, the output projection with gated
residuals; a second LayerNormZero and the tanh-GELU feed-forward over the
joint sequence}; then ``norm_final``, ``norm_out`` (shift first) and the
linear to the patch's channels. The time embedding is the sinusoid of
width ``hidden_size`` through a 2-layer SiLU MLP, in float32.

Departure from the published checkpoint: no learned positional table
(``use_learned_positional_embeddings``), whose rows are tied to the
published 480 x 720 grid; the configuration file lists it.
Weights are read by name from the dict the benchmark drew, cast to
float32 one block at a time; with ``lowp`` the products' operands are
rounded to float8 first (the control).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .common import attention, layer_norm, linear, rope, rope_tables, timestep_embedding


def pack(x: torch.Tensor, p: int) -> torch.Tensor:
    """[B, C, T, H, W] -> [B, T * H/p * W/p, C * p * p], tokens frame-major,
    features (C, ph, pw)."""
    B, C, T, H, W = x.shape
    x = x.reshape(B, C, T, H // p, p, W // p, p).permute(0, 2, 3, 5, 1, 4, 6)
    return x.reshape(B, T * (H // p) * (W // p), C * p * p)


def unpack(x: torch.Tensor, T: int, H: int, W: int, p: int) -> torch.Tensor:
    B, _, Cpp = x.shape
    C = Cpp // (p * p)
    x = x.reshape(B, T, H // p, W // p, C, p, p).permute(0, 4, 1, 2, 5, 3, 6)
    return x.reshape(B, C, T, H, W)


class CogVideoX:
    """``cfg``: the configuration file's model keys; ``weights``: name ->
    tensor."""

    def __init__(self, cfg: Dict, weights: Dict[str, torch.Tensor], lowp: bool = False):
        self.cfg, self.w, self.lowp = cfg, weights, lowp
        self.D = cfg["hidden_size"]
        self.H = cfg["num_attention_heads"]
        self.dh = cfg["attention_head_dim"]
        self.p = cfg["patch_size"]
        self.eps = cfg["norm_eps"]

    def _lin(self, x, name):
        return linear(x, self.w[name + ".weight"], self.w[name + ".bias"], self.lowp)

    def temb(self, t: torch.Tensor, delta: Optional[torch.Tensor] = None):
        f = timestep_embedding(t.float(), self.D)
        e = F.linear(F.silu(F.linear(f, self.w["time_embed.w1.weight"].float(),
                                     self.w["time_embed.w1.bias"].float())),
                     self.w["time_embed.w2.weight"].float(), self.w["time_embed.w2.bias"].float())
        return e if delta is None else e + delta.float()

    def _ln_zero(self, name, temb, vid, txt):
        mod = self._lin(F.silu(temb), name + ".lin")[:, None, :]
        sh, sc, g, e_sh, e_sc, e_g = mod.chunk(6, dim=-1)
        w, b = self.w[name + ".ln.weight"], self.w[name + ".ln.bias"]
        return (layer_norm(vid, w, b) * (1 + sc) + sh, layer_norm(txt, w, b) * (1 + e_sc) + e_sh,
                g, e_g)

    def block(self, i: int, vid, txt, temb, cos, sin):
        B, L, _ = txt.shape
        S = vid.shape[1]
        p = f"blocks.{i}"
        vid_n, txt_n, g, eg = self._ln_zero(p + ".norm1", temb, vid, txt)
        joint = torch.cat([txt_n, vid_n], dim=1)
        q, k, v = (self._lin(joint, f"{p}.attn.{n}").reshape(B, L + S, self.H, self.dh)
                   for n in ("to_q", "to_k", "to_v"))
        q = layer_norm(q, self.w[p + ".attn.norm_q.weight"], self.w[p + ".attn.norm_q.bias"],
                       self.eps)
        k = layer_norm(k, self.w[p + ".attn.norm_k.weight"], self.w[p + ".attn.norm_k.bias"],
                       self.eps)
        q = torch.cat([q[:, :L], rope(q[:, L:], cos, sin)], dim=1)
        k = torch.cat([k[:, :L], rope(k[:, L:], cos, sin)], dim=1)
        o = self._lin(attention(q, k, v, 0, self.lowp).reshape(B, L + S, self.D),
                      p + ".attn.to_out")
        txt = txt + eg * o[:, :L]
        vid = vid + g * o[:, L:]
        vid_n, txt_n, g, eg = self._ln_zero(p + ".norm2", temb, vid, txt)
        h = self._lin(F.gelu(self._lin(torch.cat([txt_n, vid_n], dim=1), p + ".ff.w_in"),
                             approximate="tanh"), p + ".ff.w_out")
        return vid + g * h[:, L:], txt + eg * h[:, :L]

    def forward(self, latents, t, text, image_latents, delta=None, remat: bool = False):
        """Prediction [B, 16, T, H, W] float32 from latents [B, 16, T, H, W],
        t [B] (sigma * 1000), text [B, L, text_dim], image_latents like
        latents."""
        B, _, T, Hh, Ww = latents.shape
        p = self.p
        x = torch.cat([latents.float(), image_latents.float()], dim=1)
        vid = self._lin(pack(x, p), "patch_embed")
        txt = self._lin(text.float(), "text_proj")
        temb = self.temb(t, delta)
        cos, sin = rope_tables(T, Hh // p, Ww // p, self.cfg["rope_dims"],
                               self.cfg["rope_theta"], device=vid.device)
        for i in range(self.cfg["num_layers"]):
            fn = lambda vid, txt, temb, i=i: self.block(i, vid, txt, temb, cos, sin)
            vid, txt = (checkpoint(fn, vid, txt, temb, use_reentrant=False) if remat
                        else fn(vid, txt, temb))
        vid = layer_norm(vid, self.w["norm_final.weight"], self.w["norm_final.bias"], self.eps)
        shift, scale = self._lin(F.silu(temb), "norm_out.lin")[:, None, :].chunk(2, dim=-1)
        vid = layer_norm(vid, self.w["norm_out.ln.weight"], self.w["norm_out.ln.bias"],
                         self.eps) * (1 + scale) + shift
        return unpack(self._lin(vid, "proj_out"), T, Hh, Ww, p)


MODEL = CogVideoX


def image_latents(cond: torch.Tensor, t_total: int) -> torch.Tensor:
    """The I2V channel input: the first conditioning latent, zeros after."""
    B, C, _, H, W = cond.shape
    out = torch.zeros((B, C, t_total, H, W), dtype=torch.float32, device=cond.device)
    out[:, :, :1] = cond[:, :, :1].float()
    return out


def tta_loss(ref: CogVideoX, cond, target, text, mask, sigma, noise, delta,
             remat: bool = True, half: bool = False):
    """The TTA loss as CogVideoX trains it: the whole [cond | target]
    window noised at one sigma, x = (1 - s) x0 + s e, timestep s * 1000,
    the mean squared error of the prediction against e - x0 over the
    window. ``mask`` is unread (the text is not masked)."""
    full = torch.cat([cond.float(), target.float()], dim=2)
    s = sigma.float().reshape(-1, 1, 1, 1, 1)
    noisy = (1 - s) * full + s * noise.float()
    pred = ref.forward(noisy, sigma.float() * 1000.0, text, image_latents(cond, full.shape[2]),
                       delta, remat=remat)
    err = ((pred - (noise.float() - full)) ** 2).flatten()
    return err[: err.numel() // 2].mean() if half else err.mean()


def anchor_loss(ref: CogVideoX, cond, val, text, mask, fixed_noises, sigmas, delta) -> float:
    """The anchor: for each (sigma, draw), sigma major, the clean
    conditioning frames then the val frames noised at that sigma, all at
    timestep sigma * 1000, the mean squared error on the val frames; the
    mean over the pairs."""
    tc = cond.shape[2]
    img = image_latents(cond, tc + val.shape[2])
    total = 0.0
    with torch.no_grad():
        for s in sigmas:
            for noise in fixed_noises:
                noisy = (1 - s) * val.float() + s * noise.float()
                t = torch.full((cond.shape[0],), float(s) * 1000.0, device=cond.device)
                pred = ref.forward(torch.cat([cond.float(), noisy], 2), t, text, img, delta)
                total += float(((pred[:, :, tc:] - (noise.float() - val.float())) ** 2).mean())
    return total / (len(sigmas) * len(fixed_noises))
