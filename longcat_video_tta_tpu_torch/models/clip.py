"""CLIP vision tower and dual-encoder gate scorer (counterpart of
``longcat_video_tta_tpu/models/clip.py``).

The vision tower is a ViT in the Hugging Face ``CLIPVisionTransformer``
layout: class token, patch convolution (no bias), learned positions,
pre-LN, the non-causal ``CLIPEncoder``, post-LN on the class token.
``CLIPModel`` adds the text tower and both projections; its embeddings
are L2-normalised.

``preprocess_frames`` is the reference's resize: frames quantised to
uint8 levels, the shorter side resized to ``image_size`` with Keys' cubic
(a = -0.5) that widens its support by the downscale factor (the
antialiasing of ``jax.image.resize(..., "cubic")``), a center crop, CLIP's
normalisation. The separable weight matrices are built on the host as
``jax.image.scale_and_translate`` builds them, only for the rows and
columns the crop keeps, and applied with two products on the device
(``F.interpolate`` has neither this kernel nor its edge renormalisation).
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..config import CLIPTextConfig, CLIPVisionConfig
from ..utils.device import full_fp32
from .clip_text import LN_EPS, CLIPEncoder, CLIPTextTower

# CLIPProcessor / OPENAI_CLIP normalisation
CLIP_IMAGE_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_IMAGE_STD = (0.26862954, 0.26130258, 0.27577711)


class CLIPVisionTower(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig, encoder: nn.Module = None):
        super().__init__()
        self.cfg = cfg
        W, p = cfg.width, cfg.patch_size
        self.class_embedding = nn.Parameter(torch.empty(W))
        self.patch_embedding = nn.Conv2d(3, W, p, stride=p, bias=False)
        self.position_embedding = nn.Parameter(
            torch.empty((cfg.image_size // p) ** 2 + 1, W))
        self.pre_ln = nn.LayerNorm(W, eps=LN_EPS)
        self.encoder = encoder if encoder is not None else CLIPEncoder(
            W, cfg.num_layers, cfg.num_heads)
        self.post_ln = nn.LayerNorm(W, eps=LN_EPS)

    def embed_tokens(self, pixels: torch.Tensor) -> torch.Tensor:
        """[B, S, S, 3] preprocessed -> tokens [B, N + 1, W], class token
        first, before the pre-LN."""
        feat = self.patch_embedding(pixels.permute(0, 3, 1, 2))
        tokens = feat.flatten(2).transpose(1, 2)           # (h, w) row-major
        cls = self.class_embedding.expand(tokens.shape[0], 1, -1)
        return torch.cat([cls, tokens], dim=1) + self.position_embedding[None]

    def pooled(self, pixels: torch.Tensor) -> torch.Tensor:
        """-> [B, W]: the post-LN hidden state at the class token."""
        x = self.encoder(self.pre_ln(self.embed_tokens(pixels)))
        return self.post_ln(x[:, 0])


class CLIPModel(nn.Module):
    """The dual encoder: vision + text towers, their projections."""

    def __init__(self, vcfg: CLIPVisionConfig, tcfg: CLIPTextConfig):
        super().__init__()
        self.vision = CLIPVisionTower(vcfg)
        self.text = CLIPTextTower(tcfg)
        self.visual_projection = nn.Linear(vcfg.width, vcfg.projection_dim, bias=False)
        self.text_projection = nn.Linear(tcfg.width, vcfg.projection_dim, bias=False)
        self.logit_scale = nn.Parameter(torch.empty(()))

    def image_embed(self, pixels: torch.Tensor) -> torch.Tensor:
        """[B, S, S, 3] -> L2-normalised projected image embeddings."""
        return F.normalize(self.visual_projection(self.vision.pooled(pixels)), dim=-1,
                           eps=0.0)

    def text_embed(self, input_ids: torch.Tensor) -> torch.Tensor:
        """[B, L] -> L2-normalised projected text embeddings."""
        return F.normalize(self.text_projection(self.text.pooled(input_ids)), dim=-1,
                           eps=0.0)


def _fma32(a: np.ndarray, b, c) -> np.ndarray:
    """fp32 a * b + c rounded once (a fused multiply-add)."""
    return (np.asarray(a, np.float64) * np.float64(b) + np.float64(c)).astype(np.float32)


def _keys_cubic(x: np.ndarray) -> np.ndarray:
    """Keys' cubic (a = -0.5) in fp32 through fused multiply-adds."""
    inner = _fma32((_fma32(x, 1.5, -2.5) * x).astype(np.float32), x, 1.0)
    outer = _fma32(_fma32(_fma32(x, -0.5, 2.5), x, -4.0), x, 2.0)
    out = np.where(x >= 1.0, outer, inner)
    return np.where(x >= 2.0, np.float32(0.0), out).astype(np.float32)


def _triangle(x: np.ndarray) -> np.ndarray:
    """The bilinear (triangle) kernel max(0, 1 - |x|) in fp32."""
    return np.maximum(np.float32(0.0), np.float32(1.0) - np.abs(x)).astype(np.float32)


def _resize_matrix(in_size: int, out_size: int, kernel) -> np.ndarray:
    """[out_size, in_size] fp32 weights of ``jax.image.resize`` with
    ``kernel`` along one axis (``compute_weight_mat``: half-pixel centres,
    support widened by the downscale factor, weights renormalised to sum
    1), computed in fp32 as the reference's compiled resize computes them
    (sample positions and the kernel through fused multiply-adds, the
    division by the support factor as a product with its reciprocal). A
    sample position near 255 has an fp32 spacing of 3e-5, so the order of
    these roundings moves single weights by about 1e-5."""
    if in_size == out_size:
        return np.eye(out_size, dtype=np.float32)
    f = np.float32
    inv_scale = f(1.0 / (out_size / in_size))
    sample = _fma32(np.arange(out_size, dtype=f) + f(0.5), inv_scale, -0.5)
    x = np.abs(sample[None, :] - np.arange(in_size, dtype=f)[:, None]) \
        * (f(1.0) / max(inv_scale, f(1.0)))
    w = kernel(x)
    total = w.sum(0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, f(1.0)), f(0.0))
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return np.where(inside[None, :], w, f(0.0)).T


def cubic_resize_matrix(in_size: int, out_size: int) -> np.ndarray:
    """``jax.image.resize(..., "cubic")`` weights along one axis (Keys'
    cubic, a = -0.5; see ``_resize_matrix``)."""
    return _resize_matrix(in_size, out_size, _keys_cubic)


def linear_resize_matrix(in_size: int, out_size: int) -> np.ndarray:
    """``jax.image.resize(..., "bilinear")`` weights along one axis (the
    triangle kernel, antialiased when downscaling; see
    ``_resize_matrix``)."""
    return _resize_matrix(in_size, out_size, _triangle)


def preprocess_frames(frames, image_size: int, device="cpu", mean=CLIP_IMAGE_MEAN,
                      std=CLIP_IMAGE_STD) -> torch.Tensor:
    """[T, H, W, 3] float in [0, 1] -> [T, S, S, 3] normalised on
    ``device``: uint8 levels, the shorter side resized to S (Keys cubic,
    antialiased), center crop, clip to [0, 1], then (x - mean) / std
    (CLIP's by default; VBench's DINO passes ImageNet's)."""
    x = torch.as_tensor(np.asarray(frames), dtype=torch.float32, device=device)
    _, h, w, _ = x.shape
    scale = image_size / min(h, w)
    nh = max(image_size, int(round(h * scale)))
    nw = max(image_size, int(round(w * scale)))
    y0, x0 = (nh - image_size) // 2, (nw - image_size) // 2
    rows = cubic_resize_matrix(h, nh)[y0:y0 + image_size]
    cols = cubic_resize_matrix(w, nw)[x0:x0 + image_size]
    rows = torch.as_tensor(rows, dtype=torch.float32, device=device)
    cols = torch.as_tensor(cols, dtype=torch.float32, device=device)
    x = torch.round(x.clamp(0.0, 1.0) * 255.0) / 255.0
    with full_fp32():
        x = torch.einsum("oh,thwc->towc", rows, x)
        x = torch.einsum("pw,towc->topc", cols, x)
    x = x.clamp(0.0, 1.0)
    mean = torch.tensor(mean, dtype=torch.float32, device=device)
    std = torch.tensor(std, dtype=torch.float32, device=device)
    return (x - mean) / std


def make_tower_scorer(model: CLIPModel, tokenize: Callable[[str], np.ndarray]) -> Callable:
    """-> the gate's scorer: (frames [k, H, W, 3] in [0, 1], caption) ->
    [k] cosines, computed on the model's device in fp32."""
    device = model.logit_scale.device

    def score(frames: np.ndarray, caption: str) -> np.ndarray:
        with torch.no_grad(), full_fp32():
            img = model.image_embed(preprocess_frames(frames, model.vision.cfg.image_size,
                                                      device))
            ids = torch.as_tensor(np.asarray(tokenize(caption)), dtype=torch.long,
                                  device=device)[None]
            txt = model.text_embed(ids)
            return (img @ txt.sum(0)).cpu().numpy()

    return score


def clip_hash_tokenize(caption: str, max_length: int = 77,
                       vocab_size: int = 49408) -> np.ndarray:
    """Deterministic hash tokenizer for synthetic weights: BOS = vocab - 2
    first, EOT = vocab - 1 last (so pooling at the argmax holds), the
    words' crc32 in between (``hash()`` is salted per process)."""
    import zlib

    words = caption.lower().split()[: max_length - 2]
    ids = [vocab_size - 2] + [
        2 + (zlib.crc32(w.encode()) % (vocab_size - 4)) for w in words
    ] + [vocab_size - 1]
    out = np.zeros((max_length,), np.int32)
    out[: len(ids)] = ids
    return out


def pad_or_subsample_frames(frames: np.ndarray, n: int) -> np.ndarray:
    """[T, ...] -> exactly n frames: the last frame repeated when short,
    a rounded linspace when long (the X-CLIP 8-frame protocol; both
    scorer paths use it)."""
    t = frames.shape[0]
    if t < n:
        return np.concatenate([frames, np.repeat(frames[-1:], n - t, 0)], axis=0)
    if t > n:
        idx = np.linspace(0, t - 1, n).round().astype(int)
        return frames[idx]
    return frames
