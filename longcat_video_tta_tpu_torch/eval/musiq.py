"""MUSIQ, the VBench ``imaging_quality`` tower, on the port (counterpart
of ``longcat_video_tta_tpu/eval/musiq.py``).

- Multi-scale input: the native-resolution frame plus aspect-ratio-
  preserving resizes to longer side 224 and 384, each cut into 32 x 32
  patches (zero-padded at the edges) and joined into one token sequence
  behind one CLS token, built on the host in numpy.
- Hash-based 2D positions: a patch at grid position (i, j) of its scale
  reads a shared [G, G, W] table at (i * G // rows, j * G // cols),
  G = 10; a learned [num_scales, W] table is added per token.
- A pre-LN ViT (width 384, 14 layers, 6 heads, exact GELU, LN eps 1e-6)
  whose attention masks the padding tokens (logit bias -1e9), and a
  regression head on the CLS token.

VBench protocol: imaging_quality = clip(MUSIQ-SPAQ(frame), 0, 100) / 100
averaged over frames. The state-dict layout is the reference's
(``convert_torch_musiq_state``); a real pyiqa checkpoint would need a key
map on top of it, as in the reference.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from ..utils.device import full_fp32
from .vbench_native import LN_EPS, ViTBlock


@dataclasses.dataclass(frozen=True)
class MUSIQConfig:
    """MUSIQ-SPAQ geometry (google-research/musiq defaults)."""

    width: int = 384
    num_layers: int = 14
    num_heads: int = 6
    patch_size: int = 32
    grid_size: int = 10           # the hash table is [G, G, width]
    longer_sides: Tuple[int, ...] = (224, 384)  # + the native scale
    max_tokens: int = 512         # sequence cap (the native scale trimmed)

    @property
    def num_scales(self) -> int:
        return 1 + len(self.longer_sides)

    @property
    def head_dim(self) -> int:
        return self.width // self.num_heads

    @property
    def patch_dim(self) -> int:
        return 3 * self.patch_size * self.patch_size

    def as_dict(self) -> Dict[str, Any]:
        return {"width": self.width, "num_layers": self.num_layers,
                "num_heads": self.num_heads, "patch_size": self.patch_size,
                "grid_size": self.grid_size, "longer_sides": list(self.longer_sides),
                "max_tokens": self.max_tokens}

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "MUSIQConfig":
        d = dict(d)
        if "longer_sides" in d:
            d["longer_sides"] = tuple(d["longer_sides"])
        return MUSIQConfig(**d)


class MUSIQ(nn.Module):
    """The MUSIQ transformer in the reference's state-dict layout."""

    def __init__(self, cfg: MUSIQConfig):
        super().__init__()
        self.cfg = cfg
        W, G = cfg.width, cfg.grid_size
        self.patch_embedding = nn.Linear(cfg.patch_dim, W)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, W))
        self.hash_pos_embed = nn.Parameter(torch.zeros(G, G, W))
        self.scale_embed = nn.Parameter(torch.zeros(cfg.num_scales, W))
        self.blocks = nn.ModuleList(ViTBlock(W, cfg.num_heads)
                                    for _ in range(cfg.num_layers))
        self.norm = nn.LayerNorm(W, eps=LN_EPS)
        self.head = nn.Linear(W, 1)

    def forward(self, patches, rows, cols, scales, n_valid) -> torch.Tensor:
        """patches [B, T, patch_dim], rows / cols / scales [B, T] int,
        n_valid [B] -> scores [B] (SPAQ scale, about 0-100)."""
        B, T = patches.shape[:2]
        x = (self.patch_embedding(patches) + self.hash_pos_embed[rows, cols]
             + self.scale_embed[scales])
        x = torch.cat([self.cls_token.expand(B, -1, -1), x], 1)
        valid = torch.arange(T + 1, device=x.device)[None] < (n_valid[:, None] + 1)
        bias = torch.where(valid, 0.0, -1e9)[:, None, None, :]  # CLS always on
        for blk in self.blocks:
            x = blk(x, bias)
        return self.head(self.norm(x)[:, 0])[:, 0]


# --------------------------------------------------------------------------
# Host-side multi-scale tokens
# --------------------------------------------------------------------------


def _arp_resize(frame: np.ndarray, longer: int) -> np.ndarray:
    """Aspect-ratio-preserving resize of [H, W, 3] so that max(H', W') ==
    ``longer``: the reference's ``jax.image.resize(..., "bilinear")``
    (antialiased when downscaling) as two fp32 products with its weight
    matrices (``models/clip.py::linear_resize_matrix``)."""
    from ..models.clip import linear_resize_matrix

    h, w, _ = frame.shape
    scale = longer / max(h, w)
    nh, nw = max(1, int(round(h * scale))), max(1, int(round(w * scale)))
    if (nh, nw) == (h, w):
        return frame
    x = np.asarray(frame, np.float32)
    x = np.einsum("oh,hwc->owc", linear_resize_matrix(h, nh), x)
    return np.einsum("pw,owc->opc", linear_resize_matrix(w, nw), x).astype(np.float32)


def _patchify(frame: np.ndarray, cfg: MUSIQConfig
              ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """[H, W, 3] -> (patches [N, patch_dim], row [N], col [N]): zero-padded
    to whole 32 x 32 tiles, with the hash-grid indices."""
    p, G = cfg.patch_size, cfg.grid_size
    h, w, _ = frame.shape
    nr, nc = -(-h // p), -(-w // p)
    pad = np.zeros((nr * p, nc * p, 3), np.float32)
    pad[:h, :w] = frame
    patches = pad.reshape(nr, p, nc, p, 3).transpose(0, 2, 1, 3, 4).reshape(
        nr * nc, cfg.patch_dim)
    ri, ci = np.meshgrid(np.arange(nr), np.arange(nc), indexing="ij")
    return (patches, (ri.reshape(-1) * G // nr).astype(np.int32),
            (ci.reshape(-1) * G // nc).astype(np.int32))


def build_multiscale_tokens(frame: np.ndarray, cfg: MUSIQConfig
                            ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, int]:
    """[H, W, 3] in [0, 1] -> (patches [T, patch_dim], row [T], col [T],
    scale [T], n_valid), padded or trimmed to ``cfg.max_tokens`` (CLS
    excluded). Scale 0 is the native frame, then ``longer_sides``
    ascending. Past the budget the native scale is trimmed (an even
    subsample of its patches); if the resized scales alone exceed it, the
    sequence is cut."""
    frame = np.asarray(frame, np.float32)
    per_scale: List[Tuple[np.ndarray, np.ndarray, np.ndarray, int]] = []
    for s, img in enumerate([frame] + [_arp_resize(frame, ls)
                                       for ls in sorted(cfg.longer_sides)]):
        pt, ri, ci = _patchify(img, cfg)
        per_scale.append((pt, ri, ci, s))
    n_resized = sum(p[0].shape[0] for p in per_scale[1:])
    native_budget = max(0, cfg.max_tokens - n_resized)
    pt0, ri0, ci0, _ = per_scale[0]
    if pt0.shape[0] > native_budget:
        keep = (np.linspace(0, pt0.shape[0] - 1, native_budget).astype(int)
                if native_budget else np.zeros((0,), int))
        per_scale[0] = (pt0[keep], ri0[keep], ci0[keep], 0)
    patches = np.concatenate([p[0] for p in per_scale], 0)
    rows = np.concatenate([p[1] for p in per_scale], 0)
    cols = np.concatenate([p[2] for p in per_scale], 0)
    scales = np.concatenate([np.full(p[0].shape[0], p[3], np.int32) for p in per_scale], 0)
    n = patches.shape[0]
    if n > cfg.max_tokens:
        patches, rows, cols, scales = (a[:cfg.max_tokens]
                                       for a in (patches, rows, cols, scales))
        n = cfg.max_tokens
    out = (np.zeros((cfg.max_tokens, cfg.patch_dim), np.float32),
           np.zeros((cfg.max_tokens,), np.int32), np.zeros((cfg.max_tokens,), np.int32),
           np.zeros((cfg.max_tokens,), np.int32))
    out[0][:n], out[1][:n], out[2][:n], out[3][:n] = patches, rows, cols, scales
    return (*out, n)


@torch.no_grad()
def musiq_score(model: MUSIQ, patches, rows, cols, scales, n_valid) -> torch.Tensor:
    """Batched scores on the model's device in fp32 (numpy or tensor
    inputs, shapes as ``MUSIQ.forward``)."""
    device = model.cls_token.device
    as_t = lambda a, dt: torch.as_tensor(np.asarray(a), dtype=dt, device=device)
    with full_fp32():
        return model(as_t(patches, torch.float32), as_t(rows, torch.long),
                     as_t(cols, torch.long), as_t(scales, torch.long),
                     as_t(n_valid, torch.long))


def convert_torch_musiq_state(sd, cfg: MUSIQConfig, device="cpu") -> MUSIQ:
    """A state dict in the reference's layout (patch_embedding, cls_token
    [1, 1, W], hash_pos_embed [G, G, W], scale_embed [S, W],
    blocks.{i}.{norm1, attn.qkv, attn.proj, norm2, mlp.fc1, mlp.fc2},
    norm, head) -> ``MUSIQ`` on ``device``, fp32. A key it does not know
    raises, so a checkpoint in another layout is never half converted."""
    from ..models.convert import TrackedStateDict, load_mapped

    with torch.device("meta"):
        names = list(MUSIQ(cfg).state_dict())
    grid = lambda t: t.reshape(cfg.grid_size, cfg.grid_size, cfg.width)
    pairs = [(k, k, grid) if k == "hash_pos_embed" else (k, k) for k in names]
    return load_mapped(lambda: MUSIQ(cfg), TrackedStateDict(sd), pairs, "MUSIQ", device)


def load_musiq_params(path: str, cfg: Optional[MUSIQConfig] = None,
                      device="cpu") -> Tuple[MUSIQ, MUSIQConfig]:
    """(tower, geometry) from ``musiq_spaq.pth``; without ``cfg`` a
    ``musiq_config.json`` beside the file (the synthetic towers' layout)
    sets the geometry, else MUSIQ-SPAQ's."""
    import json
    import os

    if cfg is None:
        side = os.path.join(os.path.dirname(path), "musiq_config.json")
        if os.path.exists(side):
            with open(side) as f:
                cfg = MUSIQConfig.from_dict(json.load(f))
        else:
            cfg = MUSIQConfig()
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return convert_torch_musiq_state(sd, cfg, device), cfg


def imaging_quality(model: MUSIQ, cfg: MUSIQConfig, frames: np.ndarray,
                    batch: int = 8) -> float:
    """frames [T, H, W, 3] in [0, 1] -> VBench imaging_quality: the mean of
    clip(MUSIQ(frame), 0, 100) / 100 over frames."""
    frames = np.asarray(frames, np.float32)
    toks = [build_multiscale_tokens(f, cfg) for f in frames]
    scores = []
    for i in range(0, len(toks), batch):
        chunk = toks[i:i + batch]
        args = [np.stack([t[j] for t in chunk]) for j in range(4)]
        n = np.asarray([t[4] for t in chunk], np.int32)
        scores.append(musiq_score(model, *args, n).cpu().numpy())
    return float(np.clip(np.concatenate(scores), 0.0, 100.0).mean() / 100.0)
