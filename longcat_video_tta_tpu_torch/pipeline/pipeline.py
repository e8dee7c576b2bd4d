"""High-level video pipeline (counterpart of
``longcat_video_tta_tpu/pipeline/pipeline.py``, LongCat branch):
``ModelBundle`` holds the DiT, VAE and UMT5 modules on one device, and
``generate_vc`` runs video continuation: VAE-encode the conditioning
clip, encode the prompt and the negative prompt, sample the generated
latents with CFG, decode [cond | gen] and slice the generated frames.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ..config import BSAConfig, CFGReuseConfig, ModelConfig, PABConfig
from ..models import vae as vae_mod
from ..models.dit import LongCatDiT
from ..models.umt5 import UMT5Encoder, umt5_encode
from ..models.vae import WanVAE
from ..models.weights import (
    init_random,
    load_dit_from_numpy,
    load_umt5_from_numpy,
    load_vae_from_numpy,
)
from ..ops.quant import quantize_dit_blocks_int8
from ..tta.bucket import bucket_len
from ..utils.device import resolve_device
from .sampler import sample_latents, sample_latents_segmented


class HashTokenizer:
    """Deterministic whitespace+hash tokenizer for synthetic runs and
    tests: (ids [1, L], mask [1, L]) padded to max_length. Identical ids
    to the reference's HashTokenizer (crc32, not the salted hash())."""

    def __init__(self, vocab_size: int, max_length: int):
        self.vocab_size = vocab_size
        self.max_length = max_length

    def __call__(self, text: str) -> Tuple[np.ndarray, np.ndarray]:
        import zlib

        words = text.lower().split()[: self.max_length - 1]
        ids = [(zlib.crc32(w.encode()) % (self.vocab_size - 2)) + 2
               for w in words]
        ids.append(1)  # eos
        n = len(ids)
        ids = ids + [0] * (self.max_length - n)
        mask = [1] * n + [0] * (self.max_length - n)
        return (np.asarray(ids, np.int32)[None],
                np.asarray(mask, np.int32)[None])


@dataclass
class ModelBundle:
    """All model state for the LongCat backbone, on one device."""

    cfg: ModelConfig
    dit: LongCatDiT
    vae: WanVAE
    text: UMT5Encoder
    tokenize: Callable[[str], Tuple[np.ndarray, np.ndarray]]
    device: torch.device
    # the int8 decode DiT of ``quantized_dit``: {id(dit): (dit, int8 dit)}
    int8_cache: Dict = field(default_factory=dict, repr=False)

    @classmethod
    def init_random(cls, cfg: ModelConfig, seed: int = 0,
                    device="cuda") -> "ModelBundle":
        """Random-weight bundle drawn on ``device`` from ``seed``."""
        device = resolve_device(device)
        gen = torch.Generator(device=device).manual_seed(seed)
        dit, vae, text = init_random(cfg, device, gen)
        return cls(cfg, dit, vae, text,
                   HashTokenizer(cfg.text.vocab_size, cfg.text.max_length), device)

    @classmethod
    def from_numpy(cls, cfg: ModelConfig, dit_params: Dict, vae_params: Dict,
                   text_params: Dict, device="cuda") -> "ModelBundle":
        """Bundle from the reference's parameter trees as numpy arrays."""
        device = resolve_device(device)
        return cls(cfg,
                   load_dit_from_numpy(dit_params, cfg.dit, device),
                   load_vae_from_numpy(vae_params, cfg.vae, device),
                   load_umt5_from_numpy(text_params, cfg.text, device),
                   HashTokenizer(cfg.text.vocab_size, cfg.text.max_length), device)

    def encode_prompt(self, prompt: str) -> Tuple[torch.Tensor, torch.Tensor]:
        """-> (embeds [1, L, C], mask [1, L])."""
        ids, mask = self.tokenize(prompt)
        ids = torch.from_numpy(ids).to(self.device)
        mask = torch.from_numpy(mask).to(self.device)
        return umt5_encode(self.text, ids, mask), mask

    def encode_video(self, pixels: torch.Tensor) -> torch.Tensor:
        """pixels [B, 3, T, H, W] in [-1, 1] -> normalized latents; clips
        longer than 17 frames use the streaming encoder."""
        pixels = pixels.to(self.device)
        if pixels.shape[2] > 17:
            return vae_mod.vae_encode_streamed(self.vae, pixels)
        return vae_mod.vae_encode(self.vae, pixels)

    def decode_latents(self, latents: torch.Tensor) -> torch.Tensor:
        """normalized latents -> pixels [B, 3, T, H, W] in [0, 1]; more
        than 3 latents use the streaming decoder."""
        if latents.shape[2] > 3:
            return vae_mod.vae_decode_streamed(self.vae, latents)
        return vae_mod.vae_decode(self.vae, latents)


def _quantized_cached(bundle: ModelBundle, dit: LongCatDiT) -> LongCatDiT:
    """The W8A8 decode DiT of ``dit``, quantized once and kept on the
    bundle for later requests (keyed by the 16-bit DiT's identity, the
    entry holding a reference to it so the key stays valid). A stale entry
    is dropped before quantizing, so two int8 copies never coexist; the
    int8 DiT shares every non-block parameter with ``dit``."""
    hit = bundle.int8_cache.get(id(dit))
    if hit is not None and hit[0] is dit:
        return hit[1]
    bundle.int8_cache.clear()
    q = quantize_dit_blocks_int8(dit)
    bundle.int8_cache[id(dit)] = (dit, q)
    return q


def round_frames_4k1(num_frames: int) -> int:
    """Round the generated-frame count up to 4k+1."""
    f = 4
    return ((num_frames - 1 + f - 1) // f) * f + 1


@torch.inference_mode()
def generate_vc(
    bundle: ModelBundle,
    cond_pixels,                  # [1, 3, T_cond, H, W] in [-1, 1]
    prompt: str,
    *,
    num_frames: int = 93,
    num_inference_steps: int = 50,
    guidance_scale: float = 4.0,
    seed: int = 42,
    negative_prompt: str = "",
    use_kv_cache: bool = True,
    init_noise: Optional[torch.Tensor] = None,
    adapters: Optional[Dict[str, torch.Tensor]] = None,
    bsa_cfg: Optional[BSAConfig] = None,
    quantize_decode: str = "none",
    bucket_gen: bool = False,
    gen_segment_steps: int = 0,
    pab_cfg: Optional[PABConfig] = None,
    cfgr_cfg: Optional[CFGReuseConfig] = None,
    on_phase: Optional[Callable[[str], None]] = None,
) -> np.ndarray:
    """Video continuation. Returns the generated frames [N, H, W, 3] in
    [0, 1] (N = num_frames rounded up to 4k+1).

    The initial noise is drawn on the bundle's device from ``seed``.
    ``init_noise`` ([1, C, L*, lat_h, lat_w], unit variance) overwrites
    its leading L* latent frames (the reference's carried-noise rule;
    tests pass a full-size draw so both packages start from the same
    noise). ``adapters`` (a TTA scheme's ``to_forward`` output) reach
    every DiT call of the sampler.

    Decode levers (the reference's, with its meaning): ``bsa_cfg``
    block-sparse decode attention; ``quantize_decode="int8"`` W8A8 block
    linears (``_quantized_cached``), ``"int8qk"`` also int8 QK^T in the
    BSA kernel (``BSAConfig(keep_ratio=1.0)`` when no BSA was asked for:
    every block kept, dense up to the 8-bit rounding of q and k);
    ``bucket_gen`` pads the generated horizon to its ``tta.bucket`` size
    and masks the padding (the noise is drawn at the bucket's shape, so
    the sample differs from the unbucketed one for the same seed);
    ``gen_segment_steps`` synchronizes the device every that many steps;
    ``pab_cfg`` / ``cfgr_cfg`` PAB and CFG-delta reuse (sampler.py).

    ``on_phase(name)``, if given, is called as each phase begins:
    "vae_encode", "prompt_encode", "cond_cache" (KV-cache path only), one
    "step" per denoising step, "vae_decode" (which ends with the copy to
    the host), and "end" once the frames are on the host. A profiler
    records a CUDA event there to time each phase on the stream."""
    mark = on_phase or (lambda name: None)
    cfg = bundle.cfg
    device = bundle.device
    nf = round_frames_4k1(num_frames)
    n_gen_latents = (nf - 1) // 4 + 1

    mark("vae_encode")
    cond_latents = bundle.encode_video(torch.as_tensor(cond_pixels))
    mark("prompt_encode")
    emb, mask = bundle.encode_prompt(prompt)
    nemb, nmask = bundle.encode_prompt(negative_prompt)
    lat_h, lat_w = cond_latents.shape[3], cond_latents.shape[4]

    decode_dit = bundle.dit
    if quantize_decode == "int8qk":
        bsa_cfg = dataclasses.replace(
            bsa_cfg if bsa_cfg is not None else BSAConfig(keep_ratio=1.0),
            qk_int8=True)
    if quantize_decode in ("int8", "int8qk"):
        decode_dit = _quantized_cached(bundle, bundle.dit)
    elif quantize_decode != "none":
        raise ValueError(f"quantize_decode {quantize_decode!r} is not one of "
                         "none, int8, int8qk")
    if pab_cfg is not None and not use_kv_cache:
        raise NotImplementedError(
            "pab_cfg requires the KV-cache decode path (use_kv_cache)")
    gen_bucket, num_valid = n_gen_latents, None
    if bucket_gen:
        gen_bucket, num_valid = bucket_len(n_gen_latents), n_gen_latents

    gen = torch.Generator(device=device).manual_seed(seed)
    noise = torch.randn((1, cfg.dit.in_channels, gen_bucket, lat_h, lat_w),
                        generator=gen, dtype=torch.float32, device=device)
    if init_noise is not None:
        L = min(init_noise.shape[2], gen_bucket)
        noise[:, :, :L] = torch.as_tensor(init_noise)[:, :, :L].to(noise)

    kw = dict(num_gen_latents=gen_bucket, num_steps=num_inference_steps,
              lat_h=lat_h, lat_w=lat_w, cond_latents=cond_latents,
              use_kv_cache=use_kv_cache, init_noise=noise, adapters=adapters,
              bsa_cfg=bsa_cfg, pab_cfg=pab_cfg, cfgr_cfg=cfgr_cfg,
              num_valid_gen_latents=num_valid, on_phase=on_phase)
    if gen_segment_steps > 0:
        gen_latents = sample_latents_segmented(
            decode_dit, cfg.scheduler, emb, mask, nemb, nmask, guidance_scale,
            segment_steps=gen_segment_steps, **kw)
    else:
        gen_latents = sample_latents(decode_dit, cfg.scheduler, emb, mask, nemb,
                                     nmask, guidance_scale, **kw)
    gen_latents = gen_latents[:, :, :n_gen_latents]

    # Decode [cond | gen] together so the causal decoder sees the real
    # temporal context; n_cond latents decode to 1 + (n_cond-1)*tf
    # frames, and the generated clip is the nf frames right after them.
    tf = cfg.vae.temporal_factor
    mark("vae_decode")
    full = torch.cat([cond_latents, gen_latents], dim=2)
    pixels = bundle.decode_latents(full)
    t_cond_px = 1 + (cond_latents.shape[2] - 1) * tf
    gen_px = pixels[0, :, t_cond_px:t_cond_px + nf]
    out = gen_px.permute(1, 2, 3, 0).float().cpu().numpy()
    mark("end")
    return out
