"""The CLIP gate: a per-video caption <-> frames check in front of TTA
(counterpart of ``longcat_video_tta_tpu/tta/clip_gate.py``).

k frame offsets are sampled from the TTA window (a linspace over the
whole window, or over its last ``late_fraction``), scored against the
caption by CLIP (per image) or X-CLIP (per video, 8 frames padded or
subsampled), aggregated by mean, min or max; the video skips TTA when
the score is below the threshold. Log-only records the score and never
skips; a scorer that fails skips TTA only when the gate fails closed.

Scorers: ``make_clip_scorer`` converts a local Hugging Face CLIP or
X-CLIP checkpoint into the port's towers (``models/clip.py``,
``models/xclip.py``) on ``device``; ``make_hf_clip_scorer`` /
``make_hf_xclip_scorer`` run the ``transformers`` models (the
``--clip-gate-scorer torch`` path) and raise where that package is not
installed.
"""

from __future__ import annotations

import os
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from ..config import ClipGateConfig

# scorer: (frames [k, H, W, 3] float [0, 1], caption) -> [k] scores
ScorerFn = Callable[[np.ndarray, str], np.ndarray]

_TOKENIZER_FILES = ("tokenizer.json", "vocab.json", "merges.txt", "tokenizer_config.json",
                    "spiece.model")


def sample_clip_frame_offsets(window_len: int, cfg: ClipGateConfig) -> List[int]:
    """Frame offsets inside the TTA window."""
    k = max(1, cfg.sample_frames)
    if cfg.sampling_mode == "late_only":
        frac = min(max(cfg.late_fraction, 1e-6), 1.0)
        start = window_len - max(1, int(round(window_len * frac)))
        candidates = list(range(start, window_len))
    else:
        candidates = list(range(window_len))
    if len(candidates) <= k:
        return candidates
    idx = np.linspace(0, len(candidates) - 1, k).round().astype(int)
    return [candidates[i] for i in idx]


def _import_transformers(what: str):
    try:
        import transformers
    except ImportError as e:
        raise RuntimeError(f"{what} needs the transformers package, which cannot be "
                           f"imported ({e})") from e
    return transformers


def make_hf_clip_scorer(model_path: str, device="cpu") -> ScorerFn:
    """Per-image score of a ``transformers`` ``CLIPModel`` (the reference's
    runtime scorer)."""
    import torch

    tf = _import_transformers("--clip-gate-scorer torch")
    model = tf.CLIPModel.from_pretrained(model_path).eval().to(device)
    proc = tf.CLIPProcessor.from_pretrained(model_path)

    def score(frames: np.ndarray, caption: str) -> np.ndarray:
        images = [(f * 255).astype(np.uint8) for f in frames]
        inputs = proc(text=[caption], images=images, return_tensors="pt", padding=True,
                      truncation=True).to(device)
        with torch.no_grad():
            out = model(**inputs)
            img = out.image_embeds / out.image_embeds.norm(dim=-1, keepdim=True)
            txt = out.text_embeds / out.text_embeds.norm(dim=-1, keepdim=True)
        return (img @ txt.T).squeeze(-1).cpu().numpy()

    return score


def make_hf_xclip_scorer(model_path: str, device="cpu") -> ScorerFn:
    """Video-level score of a ``transformers`` ``XCLIPModel`` on 8 frames."""
    import torch

    from ..models.clip import pad_or_subsample_frames

    tf = _import_transformers("--clip-gate-scorer torch")
    model = tf.XCLIPModel.from_pretrained(model_path).eval().to(device)
    proc = tf.XCLIPProcessor.from_pretrained(model_path)

    def score(frames: np.ndarray, caption: str) -> np.ndarray:
        frames = pad_or_subsample_frames(np.asarray(frames), 8)
        vid = [(f * 255).astype(np.uint8) for f in frames]
        inputs = proc(text=[caption], videos=[vid], return_tensors="pt", padding=True,
                      truncation=True).to(device)
        with torch.no_grad():
            out = model(**inputs)
            v = out.video_embeds / out.video_embeds.norm(dim=-1, keepdim=True)
            tx = out.text_embeds / out.text_embeds.norm(dim=-1, keepdim=True)
        return (v @ tx.T).reshape(-1).cpu().numpy()

    return score


def _tokenizer(model_path: str, tcfg, allow_hash_tokenizer: bool):
    """The checkpoint's tokenizer through ``AutoTokenizer`` when the folder
    holds tokenizer files (raising when ``transformers`` cannot be
    imported), else the hash tokenizer, only with ``allow_hash_tokenizer``:
    real weights never score hash ids."""
    from ..models.clip import clip_hash_tokenize

    if any(os.path.exists(os.path.join(model_path, f)) for f in _TOKENIZER_FILES):
        tok = _import_transformers(f"the tokenizer in {model_path}").AutoTokenizer \
            .from_pretrained(model_path)

        def tokenize(caption: str) -> np.ndarray:
            return np.asarray(tok(caption, padding="max_length", truncation=True,
                                  max_length=tcfg.max_length).input_ids, np.int32)
        return tokenize
    if not allow_hash_tokenizer:
        raise ValueError(
            f"no tokenizer files in {model_path}; refusing to score real weights with "
            "the hash tokenizer. Add the tokenizer files to the checkpoint folder, or "
            "opt in for synthetic weights (--clip-gate-hash-tokenizer / "
            "allow_hash_tokenizer=True)")
    print(f"[clip_gate] WARNING: no tokenizer files in {model_path}; using the "
          "deterministic hash tokenizer: gate scores are meaningful only for "
          "synthetic or test weights")
    return lambda caption: clip_hash_tokenize(caption, tcfg.max_length, tcfg.vocab_size)


def make_clip_scorer(model_path: str, backend: str = "clip", device="cuda",
                     allow_hash_tokenizer: bool = False) -> ScorerFn:
    """A local Hugging Face CLIP / X-CLIP checkpoint converted into the
    port's towers on ``device`` (fp32), as the gate's scorer. The
    geometry comes from the checkpoint's ``config.json`` with the
    ViT-B/32 defaults; a checkpoint that does not convert raises."""
    from ..config import CLIPTextConfig, CLIPVisionConfig, XCLIPConfig
    from ..models import clip, convert, xclip
    from ..utils.device import resolve_device

    device = resolve_device(device)
    sd, hf = convert.read_hf_clip_dir(model_path)
    tc, vc = hf.get("text_config", {}), hf.get("vision_config", {})
    tcfg = CLIPTextConfig(
        vocab_size=tc.get("vocab_size", 49408), width=tc.get("hidden_size", 512),
        num_layers=tc.get("num_hidden_layers", 12),
        num_heads=tc.get("num_attention_heads", 8),
        max_length=tc.get("max_position_embeddings", 77))
    vcfg = CLIPVisionConfig(
        width=vc.get("hidden_size", 768), num_layers=vc.get("num_hidden_layers", 12),
        num_heads=vc.get("num_attention_heads", 12), patch_size=vc.get("patch_size", 32),
        image_size=vc.get("image_size", 224), projection_dim=hf.get("projection_dim", 512))
    tokenize = _tokenizer(model_path, tcfg, allow_hash_tokenizer)
    if backend == "xclip":
        cfg = XCLIPConfig(
            vision=vcfg, text=tcfg, num_frames=vc.get("num_frames", 8),
            mit_layers=vc.get("mit_num_hidden_layers", 1),
            mit_heads=vc.get("mit_num_attention_heads", 8),
            prompt_layers=hf.get("prompt_layers", 2),
            prompt_heads=hf.get("prompt_num_attention_heads", 8))
        return xclip.make_tower_scorer(convert.convert_torch_xclip_state(sd, cfg, device),
                                       tokenize)
    return clip.make_tower_scorer(
        convert.convert_torch_clip_model_state(sd, vcfg, tcfg, device), tokenize)


def evaluate_clip_gate(frames: np.ndarray, caption: str, cfg: ClipGateConfig,
                       scorer: Optional[ScorerFn] = None) -> Dict[str, Any]:
    """The gate's record for one video, merged into its result. ``frames``:
    the TTA window [T, H, W, 3] in [0, 1]."""
    info: Dict[str, Any] = {
        "clip_gate_enabled": cfg.enabled,
        "clip_gate_backend": cfg.backend,
        "clip_gate_threshold": cfg.threshold,
        "clip_gate_log_only": cfg.log_only,
        "skip_tta": False,
        "clip_gate_score": None,
        "clip_gate_error": None,
    }
    if not cfg.enabled:
        return info
    try:
        if scorer is None:
            raise RuntimeError("no CLIP scorer available (no local checkpoint configured)")
        offsets = sample_clip_frame_offsets(frames.shape[0], cfg)
        info["clip_gate_frame_offsets"] = offsets
        scores = np.asarray(scorer(frames[np.asarray(offsets)], caption), np.float64)
        agg = {"mean": np.mean, "min": np.min, "max": np.max}[cfg.aggregate]
        score = float(agg(scores))
        info["clip_gate_score"] = score
        info["clip_gate_scores"] = [float(s) for s in scores]
        if not cfg.log_only and score < cfg.threshold:
            info["skip_tta"] = True
    except Exception as e:  # fail open (run TTA) or fail closed (skip it)
        info["clip_gate_error"] = f"{type(e).__name__}: {e}"
        info["skip_tta"] = not cfg.fail_open
    return info


def summarize_clip_gate_stats(results: List[Dict]) -> Dict[str, Any]:
    """The run's gate statistics."""
    infos = [r for r in results if r.get("clip_gate_enabled")]
    if not infos:
        return {"clip_gate_enabled": False}
    scores = [r["clip_gate_score"] for r in infos if r.get("clip_gate_score") is not None]
    skipped = sum(1 for r in infos if r.get("skip_tta"))
    return {
        "clip_gate_enabled": True,
        "num_evaluated": len(infos),
        "num_skipped": skipped,
        "num_errors": sum(1 for r in infos if r.get("clip_gate_error")),
        "skip_ratio": skipped / len(infos),
        "score_mean": float(np.mean(scores)) if scores else None,
        "score_min": float(np.min(scores)) if scores else None,
        "score_max": float(np.max(scores)) if scores else None,
    }
