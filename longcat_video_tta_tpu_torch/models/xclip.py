"""X-CLIP video-text scorer (counterpart of
``longcat_video_tta_tpu/models/xclip.py``), the Hugging Face
``XCLIPModel`` graph:

- the vision tower is CLIP's ViT whose every layer first runs message
  attention: each frame's class token -> message_fc -> LN -> attention
  across the frames -> appended to that frame's tokens as one extra
  token for the spatial attention, and dropped after it;
- the MIT: learned frame positions + a CLIP encoder over the projected
  per-frame class embeddings, a residual, the mean over frames -> the
  video embedding;
- the prompt generator: the text embedding attends into the
  frame-averaged patch features (LN + projection) through ``prompt_layers``
  cross-attention blocks, scaled by a learned alpha and added;
- scores = cosine(video, prompted text), without the logit scale.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..config import XCLIPConfig
from ..utils.device import full_fp32
from .clip import CLIPVisionTower, pad_or_subsample_frames, preprocess_frames
from .clip_text import LN_EPS, CLIPEncoder, CLIPTextTower, mha, quick_gelu


class XCLIPVisionLayer(nn.Module):
    def __init__(self, width: int):
        super().__init__()
        self.msg_fc = nn.Linear(width, width)
        self.msg_ln = nn.LayerNorm(width, eps=LN_EPS)
        self.msg_q = nn.Linear(width, width)
        self.msg_k = nn.Linear(width, width)
        self.msg_v = nn.Linear(width, width)
        self.msg_out = nn.Linear(width, width)
        self.ln1 = nn.LayerNorm(width, eps=LN_EPS)
        self.q = nn.Linear(width, width)
        self.k = nn.Linear(width, width)
        self.v = nn.Linear(width, width)
        self.out = nn.Linear(width, width)
        self.ln2 = nn.LayerNorm(width, eps=LN_EPS)
        self.fc1 = nn.Linear(width, 4 * width)
        self.fc2 = nn.Linear(4 * width, width)

    def forward(self, x: torch.Tensor, num_frames: int, num_heads: int) -> torch.Tensor:
        """x [B*T, L, W], frame-major."""
        BT, L, W = x.shape
        msg = self.msg_fc(x[:, 0]).reshape(BT // num_frames, num_frames, W)
        m = self.msg_ln(msg)
        msg = msg + self.msg_out(mha(self.msg_q(m), self.msg_k(m), self.msg_v(m),
                                     num_heads))
        x = torch.cat([x, msg.reshape(BT, 1, W)], dim=1)   # token L: the message
        h = self.ln1(x)
        x = (x + self.out(mha(self.q(h), self.k(h), self.v(h), num_heads)))[:, :L]
        return x + self.fc2(quick_gelu(self.fc1(self.ln2(x))))


class XCLIPVisionEncoder(nn.Module):
    def __init__(self, width: int, num_layers: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.layers = nn.ModuleList(XCLIPVisionLayer(width) for _ in range(num_layers))

    def forward(self, x: torch.Tensor, num_frames: int) -> torch.Tensor:
        for layer in self.layers:
            x = layer(x, num_frames, self.num_heads)
        return x


class MIT(nn.Module):
    """Multi-frame integration transformer: [B, T, P] -> [B, P]."""

    def __init__(self, cfg: XCLIPConfig):
        super().__init__()
        P = cfg.projection_dim
        self.position_embedding = nn.Parameter(torch.empty(cfg.num_frames, P))
        self.encoder = CLIPEncoder(P, cfg.mit_layers, cfg.mit_heads)

    def forward(self, cls_features: torch.Tensor) -> torch.Tensor:
        x = self.encoder(cls_features + self.position_embedding[None])
        return torch.mean(x + cls_features, dim=1)


class PromptLayer(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.q = nn.Linear(dim, dim, bias=False)
        self.k = nn.Linear(dim, dim, bias=False)
        self.v = nn.Linear(dim, dim, bias=False)
        self.proj = nn.Linear(dim, dim)
        self.norm3 = nn.LayerNorm(dim, eps=LN_EPS)
        self.fc1 = nn.Linear(dim, 4 * dim)
        self.fc2 = nn.Linear(4 * dim, dim)

    def forward(self, x, visual, num_heads: int):
        h = self.norm1(x)
        x = x + self.proj(mha(self.q(h), self.k(visual), self.v(visual), num_heads))
        return x + self.fc2(quick_gelu(self.fc1(self.norm3(x))))


class PromptGenerator(nn.Module):
    """Video-specific prompts: alpha * (text attending into visual)."""

    def __init__(self, cfg: XCLIPConfig):
        super().__init__()
        P = cfg.projection_dim
        self.num_heads = cfg.prompt_heads
        self.ln = nn.LayerNorm(P, eps=LN_EPS)
        self.alpha = nn.Parameter(torch.empty(P))
        self.layers = nn.ModuleList(PromptLayer(P) for _ in range(cfg.prompt_layers))

    def forward(self, text: torch.Tensor, visual: torch.Tensor) -> torch.Tensor:
        visual = self.ln(visual)
        x = text
        for layer in self.layers:
            x = layer(x, visual, self.num_heads)
        return self.alpha * x


class XCLIPModel(nn.Module):
    def __init__(self, cfg: XCLIPConfig):
        super().__init__()
        self.cfg = cfg
        v, P = cfg.vision, cfg.projection_dim
        self.vision = CLIPVisionTower(v, encoder=XCLIPVisionEncoder(
            v.width, v.num_layers, cfg.vision_heads))
        self.text = CLIPTextTower(cfg.text)
        self.mit = MIT(cfg)
        self.prompts = PromptGenerator(cfg)
        self.visual_projection = nn.Linear(v.width, P, bias=False)
        self.text_projection = nn.Linear(cfg.text.width, P, bias=False)
        self.prompts_visual_ln = nn.LayerNorm(v.width, eps=LN_EPS)
        self.prompts_visual_projection = nn.Parameter(torch.empty(v.width, P))
        self.logit_scale = nn.Parameter(torch.empty(()))

    def scores(self, pixels: torch.Tensor, input_ids: torch.Tensor) -> torch.Tensor:
        """pixels [B, T, S, S, 3] preprocessed, input_ids [K, L] -> cosine
        similarities [B, K] (``xclip_scores``)."""
        B, T = pixels.shape[:2]
        vt = self.vision
        x = vt.pre_ln(vt.embed_tokens(pixels.reshape((B * T,) + pixels.shape[2:])))
        x = vt.encoder(x, T)
        pooled = vt.post_ln(x[:, 0])
        video = self.mit(self.visual_projection(pooled).reshape(B, T, -1))

        img = self.prompts_visual_ln(x[:, 1:]) @ self.prompts_visual_projection
        img = img.reshape(B, T, img.shape[1], -1).mean(dim=1)

        text = self.text_projection(self.text.pooled(input_ids))
        text = text[None].expand((B,) + text.shape)
        text = text + self.prompts(text, img)
        return torch.einsum("bd,bkd->bk", F.normalize(video, dim=-1, eps=0.0),
                            F.normalize(text, dim=-1, eps=0.0))


def xclip_scores(model: XCLIPModel, pixels: torch.Tensor,
                 input_ids: torch.Tensor) -> torch.Tensor:
    """[B, T, S, S, 3] x [K, L] -> [B, K] in fp32."""
    with torch.no_grad(), full_fp32():
        return model.scores(pixels, input_ids)


def make_tower_scorer(model: XCLIPModel, tokenize: Callable[[str], np.ndarray]) -> Callable:
    """-> the gate's scorer: (frames [k, H, W, 3] in [0, 1], caption) ->
    [1], the video-level cosine of the frames padded or subsampled to
    ``num_frames``."""
    cfg = model.cfg
    device = model.logit_scale.device

    def score(frames: np.ndarray, caption: str) -> np.ndarray:
        frames = pad_or_subsample_frames(np.asarray(frames), cfg.num_frames)
        pixels = preprocess_frames(frames, cfg.vision.image_size, device)[None]
        ids = torch.as_tensor(np.asarray(tokenize(caption)), dtype=torch.long,
                              device=device)[None]
        return xclip_scores(model, pixels, ids).cpu().numpy().reshape(-1)

    return score
