"""The VBench dimensions on the port's own towers (counterpart of
``longcat_video_tta_tpu/eval/vbench_native.py``; no vbench package).

- ``temporal_flickering``: exact, weight-free: the mean over consecutive
  frame pairs of (255 - MAE) / 255 in the uint8 domain.
- ``motion_smoothness``: the VBench protocol (drop the odd frames,
  rebuild each from its even neighbours, score (255 - MAE) / 255 against
  the real ones) with the linear frame blend in place of VBench's AMT-S
  network, labelled ``native_variant``.
- ``subject_consistency``: DINO ViT-S/16 CLS features per frame
  (``DINOViT``: the facebookresearch/dino ``VisionTransformer`` layout, so
  its state dict loads as it is), score = the mean over t >= 1 of
  (max(0, cos(f_{t-1}, f_t)) + max(0, cos(f_0, f_t))) / 2.
- ``aesthetic_quality``: the LAION aesthetic predictor v2 on CLIP
  ViT-L/14 image embeds (the port's ``models/clip.py`` tower): the L2-
  normalised projected embed through five linears with no activation
  between them, the mean over frames / 10, clipped to [0, 1].
- ``imaging_quality``: MUSIQ-SPAQ (``eval/musiq.py``), clip(score, 0,
  100) / 100 averaged over frames.

The towers run in fp32 on their device with plain torch products (the
reference computes their attention with plain einsums too). DINO's
input is torchvision's Resize(shortest edge) -> CenterCrop -> ImageNet
normalisation, with the reference's antialiased Keys-cubic resize
(``models/clip.py::preprocess_frames``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..utils.device import full_fp32

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
LN_EPS = 1e-6

# openai/clip-vit-large-patch14's vision geometry (the aesthetic head's
# input is its 768-d projected image embedding)
CLIP_L14 = dict(width=1024, num_layers=24, num_heads=16, patch_size=14,
                image_size=224, projection_dim=768)


# --------------------------------------------------------------------------
# DINO ViT-S/16 (subject_consistency)
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class DINOViTConfig:
    """facebookresearch/dino ``dino_vits16`` geometry (ViT-S/16)."""

    width: int = 384
    num_layers: int = 12
    num_heads: int = 6
    patch_size: int = 16
    image_size: int = 224

    @property
    def head_dim(self) -> int:
        return self.width // self.num_heads


class ViTBlock(nn.Module):
    """A pre-LN ViT block in the timm / DINO layout: fused ``attn.qkv``,
    ``attn.proj``, exact-GELU ``mlp.fc1`` / ``mlp.fc2``, LN eps 1e-6.
    ``bias`` (broadcast to [B, H, S, S]) is added to the attention logits."""

    def __init__(self, width: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.norm1 = nn.LayerNorm(width, eps=LN_EPS)
        self.attn = nn.Module()
        self.attn.qkv = nn.Linear(width, 3 * width)
        self.attn.proj = nn.Linear(width, width)
        self.norm2 = nn.LayerNorm(width, eps=LN_EPS)
        self.mlp = nn.Module()
        self.mlp.fc1 = nn.Linear(width, 4 * width)
        self.mlp.fc2 = nn.Linear(4 * width, width)

    def forward(self, x: torch.Tensor, bias: Optional[torch.Tensor] = None) -> torch.Tensor:
        B, S, W = x.shape
        H = self.num_heads
        D = W // H
        qkv = self.attn.qkv(self.norm1(x)).reshape(B, S, 3, H, D)
        q, k, v = qkv.unbind(2)
        logits = torch.einsum("bqhd,bkhd->bhqk", q, k) * (D ** -0.5)
        if bias is not None:
            logits = logits + bias
        o = torch.einsum("bhqk,bkhd->bqhd", logits.softmax(-1), v)
        x = x + self.attn.proj(o.reshape(B, S, W))
        return x + self.mlp.fc2(F.gelu(self.mlp.fc1(self.norm2(x))))


class DINOViT(nn.Module):
    """DINO's ViT: patch convolution, class token, learned positions,
    pre-LN blocks, final LN; ``forward`` returns the CLS features."""

    def __init__(self, cfg: DINOViTConfig):
        super().__init__()
        self.cfg = cfg
        W, p = cfg.width, cfg.patch_size
        self.cls_token = nn.Parameter(torch.zeros(1, 1, W))
        self.pos_embed = nn.Parameter(torch.zeros(1, (cfg.image_size // p) ** 2 + 1, W))
        self.patch_embed = nn.Module()
        self.patch_embed.proj = nn.Conv2d(3, W, p, stride=p)
        self.blocks = nn.ModuleList(ViTBlock(W, cfg.num_heads)
                                    for _ in range(cfg.num_layers))
        self.norm = nn.LayerNorm(W, eps=LN_EPS)

    def forward(self, pixels: torch.Tensor) -> torch.Tensor:
        """[B, S, S, 3] ImageNet-normalised -> CLS features [B, W]."""
        tokens = self.patch_embed.proj(pixels.permute(0, 3, 1, 2)).flatten(2).transpose(1, 2)
        x = torch.cat([self.cls_token.expand(tokens.shape[0], -1, -1), tokens], 1)
        x = x + self.pos_embed
        for blk in self.blocks:
            x = blk(x)
        return self.norm(x)[:, 0]


def convert_torch_dino_state(sd, cfg: DINOViTConfig, device="cpu") -> DINOViT:
    """A torch.hub ``dino_vits16`` state dict (tensors or numpy arrays) ->
    ``DINOViT`` on ``device`` in eval mode, fp32. The module has the hub
    layout, so every key maps to itself; a missing, unread or misshapen
    key raises (``models/convert.py::load_mapped``)."""
    from ..models.convert import TrackedStateDict, load_mapped

    sd = TrackedStateDict(sd)
    with torch.device("meta"):
        names = list(DINOViT(cfg).state_dict())
    return load_mapped(lambda: DINOViT(cfg), sd, [(k, k) for k in names],
                       "dino_vits16", device)


def load_dino_params(path: str, cfg: Optional[DINOViTConfig] = None,
                     device="cpu") -> DINOViT:
    """The tower from a ``dino_vits16.pth`` state dict; without ``cfg``
    the geometry comes from a ``dino_config.json`` beside the file (the
    synthetic towers' layout), else ViT-S/16."""
    import json
    import os

    if cfg is None:
        side = os.path.join(os.path.dirname(path), "dino_config.json")
        cfg = DINOViTConfig()
        if os.path.exists(side):
            with open(side) as f:
                cfg = DINOViTConfig(**json.load(f))
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return convert_torch_dino_state(sd, cfg, device)


def preprocess_imagenet(frames: np.ndarray, image_size: int, device="cpu") -> torch.Tensor:
    """[T, H, W, 3] float [0, 1] -> [T, S, S, 3] ImageNet-normalised on
    ``device`` (uint8 levels, the shorter side resized to S with the
    reference's antialiased cubic, center crop, clip, normalise)."""
    from ..models.clip import preprocess_frames

    return preprocess_frames(frames, image_size, device, mean=IMAGENET_MEAN,
                             std=IMAGENET_STD)


# --------------------------------------------------------------------------
# Dimension scores
# --------------------------------------------------------------------------


def consistency_score_from_features(feats: np.ndarray) -> float:
    """VBench's consistency formula over per-frame features [T, D]: the
    mean over t >= 1 of (max(0, cos(prev, cur)) + max(0, cos(first,
    cur))) / 2 on L2-normalised features."""
    f = np.asarray(feats, np.float64)
    f = f / np.linalg.norm(f, axis=-1, keepdims=True)
    if f.shape[0] < 2:
        return 1.0
    sim_prev = np.clip((f[:-1] * f[1:]).sum(-1), 0.0, None)
    sim_first = np.clip((f[0] * f[1:]).sum(-1), 0.0, None)
    return float(((sim_prev + sim_first) / 2.0).mean())


@torch.no_grad()
def subject_consistency(dino: DINOViT, cfg: DINOViTConfig, frames: np.ndarray,
                        batch: int = 16) -> float:
    """frames [T, H, W, 3] in [0, 1] -> VBench subject_consistency."""
    device = dino.cls_token.device
    with full_fp32():
        pixels = preprocess_imagenet(np.asarray(frames), cfg.image_size, device)
        feats = [dino(pixels[i:i + batch]).cpu().numpy()
                 for i in range(0, pixels.shape[0], batch)]
    return consistency_score_from_features(np.concatenate(feats, 0))


def _as_uint8(frames: np.ndarray) -> np.ndarray:
    x = np.asarray(frames)
    if x.dtype != np.uint8:
        x = (np.clip(x, 0.0, 1.0) * 255.0).round().astype(np.uint8)
    return x


def temporal_flickering(frames: np.ndarray) -> float:
    """frames [T, H, W, 3] in [0, 1] (or uint8) -> the mean over
    consecutive pairs of (255 - MAE) / 255 in the uint8 domain."""
    x = _as_uint8(frames)
    if x.shape[0] < 2:
        return 1.0
    a = x[:-1].astype(np.float64)
    b = x[1:].astype(np.float64)
    mae = np.abs(a - b).reshape(x.shape[0] - 1, -1).mean(axis=1)
    return float(((255.0 - mae) / 255.0).mean())


def motion_smoothness(
    frames: np.ndarray,
    interpolate_fn: Optional[Callable[[np.ndarray, np.ndarray], np.ndarray]] = None,
) -> Dict[str, Any]:
    """Drop the odd frames, rebuild each from its even neighbours with
    ``interpolate_fn(prev, nxt)`` (default: the linear blend; VBench uses
    AMT-S) and score (255 - MAE) / 255 against the real odd frames. The
    result carries ``native_variant``: it is comparable across this
    package's runs, not against published VBench numbers."""
    x = _as_uint8(frames)
    if x.shape[0] < 3:
        return {"value": 1.0, "native_variant": "linear-interp"}
    fn = interpolate_fn or (
        lambda a, b: ((a.astype(np.float64) + b.astype(np.float64)) / 2.0))
    maes = []
    for t in range(1, x.shape[0] - 1, 2):
        pred = np.asarray(fn(x[t - 1], x[t + 1]), np.float64)
        maes.append(np.abs(pred - x[t].astype(np.float64)).mean())
    return {
        "value": float(((255.0 - np.asarray(maes)) / 255.0).mean()),
        "native_variant": "linear-interp" if interpolate_fn is None else "custom",
    }


# --------------------------------------------------------------------------
# Aesthetic quality (LAION predictor v2 on CLIP ViT-L/14 embeds)
# --------------------------------------------------------------------------


class AestheticHead(nn.Module):
    """The LAION aesthetic v2 head: Linear layers with no activation
    between them (the published predictor is linear-only, with dropout at
    train time), kept separate so their state-dict keys convert."""

    def __init__(self, dims):
        super().__init__()
        self.linears = nn.ModuleList(nn.Linear(a, b) for a, b in zip(dims[:-1], dims[1:]))

    def forward(self, feats: torch.Tensor) -> torch.Tensor:
        """[B, 768] image embeds -> [B] predictor scores."""
        x = feats
        for layer in self.linears:
            x = layer(x)
        return x[..., 0]


def convert_torch_aesthetic_head(sd, device="cpu") -> AestheticHead:
    """``sac+logos+ava1-l14-linearMSE.pth``: keys ``layers.{n}.weight/bias``
    with gaps at the Dropout indices, taken in numeric order; any other
    key raises."""
    from ..models.convert import TrackedStateDict, load_mapped

    idx = sorted({int(k.split(".")[1]) for k in sd
                  if k.startswith("layers.") and k.endswith(".weight")})
    dims = [int(sd[f"layers.{idx[0]}.weight"].shape[1])] + [
        int(sd[f"layers.{i}.weight"].shape[0]) for i in idx]
    pairs = [(f"linears.{j}.{n}", f"layers.{i}.{n}") for j, i in enumerate(idx)
             for n in ("weight", "bias")]
    return load_mapped(lambda: AestheticHead(dims), TrackedStateDict(sd), pairs,
                       "aesthetic head", device)


def load_aesthetic_head(path: str, device="cpu") -> AestheticHead:
    return convert_torch_aesthetic_head(
        torch.load(path, map_location="cpu", weights_only=True), device)


@torch.no_grad()
def aesthetic_quality(clip_model, vcfg, head: AestheticHead, frames: np.ndarray,
                      batch: int = 8) -> float:
    """frames [T, H, W, 3] in [0, 1] -> VBench aesthetic_quality: the mean
    predictor score over frames, / 10, clipped to [0, 1]."""
    from ..models.clip import preprocess_frames

    device = clip_model.logit_scale.device
    scores = []
    with full_fp32():
        pixels = preprocess_frames(np.asarray(frames), vcfg.image_size, device)
        for i in range(0, pixels.shape[0], batch):
            emb = clip_model.image_embed(pixels[i:i + batch])
            scores.append(head(emb).cpu().numpy())
    return float(np.clip(np.concatenate(scores).mean() / 10.0, 0.0, 1.0))


# --------------------------------------------------------------------------
# Native dispatcher
# --------------------------------------------------------------------------


def load_clip_l14(clip_dir: str, device="cpu"):
    """(CLIPModel, its CLIPVisionConfig) from a Hugging Face CLIP folder,
    the geometry from its config.json (ViT-L/14 where a key is absent)."""
    from ..config import CLIPTextConfig, CLIPVisionConfig
    from ..models.convert import convert_torch_clip_model_state, read_hf_clip_dir

    sd, hf = read_hf_clip_dir(clip_dir)
    vc, tc = hf["vision_config"], hf["text_config"]
    vcfg = CLIPVisionConfig(
        width=vc.get("hidden_size", CLIP_L14["width"]),
        num_layers=vc.get("num_hidden_layers", CLIP_L14["num_layers"]),
        num_heads=vc.get("num_attention_heads", CLIP_L14["num_heads"]),
        patch_size=vc.get("patch_size", CLIP_L14["patch_size"]),
        image_size=vc.get("image_size", CLIP_L14["image_size"]),
        projection_dim=hf.get("projection_dim", CLIP_L14["projection_dim"]))
    tcfg = CLIPTextConfig(
        vocab_size=tc.get("vocab_size", 49408),
        width=tc.get("hidden_size", 768),
        num_layers=tc.get("num_hidden_layers", 12),
        num_heads=tc.get("num_attention_heads", 12),
        max_length=tc.get("max_position_embeddings", 77))
    return convert_torch_clip_model_state(sd, vcfg, tcfg, device), vcfg


def load_native_towers(towers_dir: str, device="cpu") -> Dict[str, Any]:
    """The towers under ``towers_dir`` onto ``device``: dino_vits16.pth
    (optional dino_config.json), aesthetic_l14.pth + clip_l14/ (a Hugging
    Face snapshot), musiq_spaq.pth (optional musiq_config.json). A missing
    file leaves its dimension out with a reason, not a failure."""
    import os

    towers: Dict[str, Any] = {}
    dino_path = os.path.join(towers_dir, "dino_vits16.pth")
    if os.path.exists(dino_path):
        dino = load_dino_params(dino_path, device=device)
        towers["dino"] = (dino, dino.cfg)
    musiq_path = os.path.join(towers_dir, "musiq_spaq.pth")
    if os.path.exists(musiq_path):
        from .musiq import load_musiq_params

        towers["musiq"] = load_musiq_params(musiq_path, device=device)
    head_path = os.path.join(towers_dir, "aesthetic_l14.pth")
    clip_dir = os.path.join(towers_dir, "clip_l14")
    if os.path.exists(head_path) and os.path.isdir(clip_dir):
        model, vcfg = load_clip_l14(clip_dir, device)
        towers["aesthetic"] = (model, vcfg, load_aesthetic_head(head_path, device))
    return towers


def resolve_unavailable_dimensions(towers: Dict[str, Any], dims: list) -> Dict[str, str]:
    """Which of ``dims`` the towers cannot score, and why, resolved once
    so the per-video loop never loads a clip for a dimension that cannot
    run."""
    unavailable: Dict[str, str] = {}
    for dim in dims:
        if dim in ("temporal_flickering", "motion_smoothness"):
            continue
        if dim == "subject_consistency":
            if "dino" not in towers:
                unavailable[dim] = "dino_vits16.pth not in towers dir"
        elif dim == "aesthetic_quality":
            if "aesthetic" not in towers:
                unavailable[dim] = "aesthetic_l14.pth + clip_l14/ not in towers dir"
        elif dim == "imaging_quality":
            if "musiq" not in towers:
                unavailable[dim] = "musiq_spaq.pth not in towers dir"
        else:
            unavailable[dim] = "unknown dimension"
    return unavailable


def score_video_dimensions(frames: np.ndarray, towers: Dict[str, Any], dims: list,
                           unavailable: Dict[str, str]) -> Dict[str, float]:
    """Every available dimension's score for one clip ([T, H, W, 3] in
    [0, 1])."""
    out: Dict[str, float] = {}
    for dim in dims:
        if dim in unavailable:
            continue
        if dim == "temporal_flickering":
            out[dim] = temporal_flickering(frames)
        elif dim == "motion_smoothness":
            out[dim] = motion_smoothness(frames)["value"]
        elif dim == "subject_consistency":
            dino, dcfg = towers["dino"]
            out[dim] = subject_consistency(dino, dcfg, frames)
        elif dim == "aesthetic_quality":
            model, vcfg, head = towers["aesthetic"]
            out[dim] = aesthetic_quality(model, vcfg, head, frames)
        elif dim == "imaging_quality":
            from .musiq import imaging_quality

            model, mcfg = towers["musiq"]
            out[dim] = imaging_quality(model, mcfg, frames)
    return out


def native_vbench_scores(frames_per_video: Dict[str, Any],
                         towers: Optional[Dict[str, Any]] = None,
                         dimensions: Optional[list] = None) -> Dict[str, Any]:
    """Score clips ({name: [T, H, W, 3] in [0, 1], or a zero-argument
    loader of one}) on every requested dimension the towers can serve.
    Returns {"results": {dim: mean}, "per_video": {...}, "unavailable":
    {dim: reason}}. Loaders are called, scored and freed one at a time, so
    a folder of clips never stands in memory at once."""
    towers = towers or {}
    dims = list(dimensions or (
        "subject_consistency", "motion_smoothness", "temporal_flickering",
        "aesthetic_quality", "imaging_quality"))
    unavailable = resolve_unavailable_dimensions(towers, dims)
    per_video: Dict[str, Dict[str, float]] = {}
    for n, f in frames_per_video.items():
        arr = f() if callable(f) else f
        per_video[n] = score_video_dimensions(arr, towers, dims, unavailable)
        del arr

    results: Dict[str, Any] = {}
    for dim in dims:
        vals = [v[dim] for v in per_video.values() if dim in v]
        if vals:
            results[dim] = float(np.mean(vals))
            if dim == "motion_smoothness":
                results["motion_smoothness_variant"] = "linear-interp"
    return {"results": results, "per_video": per_video, "unavailable": unavailable}
