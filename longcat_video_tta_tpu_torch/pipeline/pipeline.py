"""High-level video pipeline (counterpart of
``longcat_video_tta_tpu/pipeline/pipeline.py``, LongCat, MMDiT and
CogVideoX branches): ``ModelBundle`` holds the DiT (LongCat, the MMDiT of
Open-Sora v2 with its CLIP text tower, or CogVideoX), the VAE and the
UMT5/T5 encoder on one device, and ``generate_vc`` runs video continuation: VAE-encode the
conditioning clip, encode the prompt and the negative prompt, sample the
generated latents with CFG, decode [cond | gen] and slice the generated
frames.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..config import BSAConfig, CFGReuseConfig, ModelConfig, PABConfig
from ..models import vae as vae_mod
from ..models.clip_text import CLIPTextTower
from ..models.umt5 import UMT5Encoder, umt5_encode
from ..models.vae import WanVAE, latent_len
from ..archs import get_arch
from ..models.weights import (
    init_random,
    init_random_clip_text,
    load_clip_text_from_numpy,
    load_umt5_from_numpy,
    load_vae_from_numpy,
)
from ..tta.bucket import bucket_len
from ..utils.device import resolve_device
from .sampler import (
    sample_latents,
    sample_latents_cogvideox,
    sample_latents_cogvideox_segmented,
    sample_latents_mmdit,
    sample_latents_mmdit_segmented,
    sample_latents_segmented,
)


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


def load_hf_tokenizer(checkpoint_dir: str, max_length: int,
                      subfolder: str = "tokenizer"):
    """The HF tokenizer of ``<checkpoint_dir>/<subfolder>`` as a callable
    text -> (ids [1, L] int32, mask [1, L] int32) padded to ``max_length``
    (the reference's ``load_hf_tokenizer``)."""
    from transformers import AutoTokenizer

    tok = AutoTokenizer.from_pretrained(checkpoint_dir, subfolder=subfolder)

    def tokenize(text: str):
        out = tok([text], padding="max_length", max_length=max_length,
                  truncation=True, add_special_tokens=True,
                  return_attention_mask=True, return_tensors="np")
        return (out["input_ids"].astype(np.int32),
                out["attention_mask"].astype(np.int32))

    return tokenize


def load_hf_clip_tokenizer(checkpoint_dir: str, max_length: int):
    """The CLIP BPE tokenizer of an MMDiT checkpoint folder (the first of
    the Flux / Open-Sora subfolder names present), or None."""
    import os

    for sub in ("tokenizer_2", "clip_tokenizer", "tokenizer_clip"):
        if os.path.exists(os.path.join(checkpoint_dir, sub)):
            return load_hf_tokenizer(checkpoint_dir, max_length, subfolder=sub)
    return None


def load_tokenizer(ckpt_dir: str, cfg: ModelConfig):
    """The tokenizer of a checkpoint folder: ``<ckpt_dir>/tokenizer``
    through ``transformers``' ``AutoTokenizer`` where the folder exists
    (raising when ``transformers`` cannot be imported: real weights never
    run on hash ids), else the ``HashTokenizer``, as the reference's
    loader does for a bundle without a tokenizer (``convert.py:108-112``)."""
    import os

    if not os.path.isdir(os.path.join(ckpt_dir, "tokenizer")):
        return HashTokenizer(cfg.text.vocab_size, cfg.text.max_length)
    try:
        import transformers  # noqa: F401
    except ImportError as e:
        raise RuntimeError(
            f"{ckpt_dir}/tokenizer needs the transformers package, which cannot be "
            f"imported ({e}); refusing to run real weights on hash token ids") from e
    return load_hf_tokenizer(ckpt_dir, cfg.text.max_length)


@dataclass
class ModelBundle:
    """All model state for one backbone, on one device. ``cfg.arch``
    "longcat": ``dit`` a LongCatDiT; "cogvideox": a CogVideoX; "mmdit": an
    MMDiT, with the CLIP text tower ``clip`` for the pooled y_vec and
    ``clip_tokenize`` (a checkpoint's CLIP BPE tokenizer; None = hash ids
    capped into the CLIP vocab, for random weights only)."""

    cfg: ModelConfig
    dit: nn.Module
    vae: WanVAE
    text: UMT5Encoder
    tokenize: Callable[[str], Tuple[np.ndarray, np.ndarray]]
    device: torch.device
    # the int8 decode DiT of ``quantized_dit``: {id(dit): (dit, int8 dit)}
    int8_cache: Dict = field(default_factory=dict, repr=False)
    clip: Optional[CLIPTextTower] = None
    clip_tokenize: Optional[Callable[[str], Tuple[np.ndarray, np.ndarray]]] = None

    @classmethod
    def init_random(cls, cfg: ModelConfig, seed: int = 0,
                    device="cuda") -> "ModelBundle":
        """Random-weight bundle drawn on ``device`` from ``seed``."""
        device = resolve_device(device)
        gen = torch.Generator(device=device).manual_seed(seed)
        dit, vae, text = init_random(cfg, device, gen)
        clip = (None if cfg.clip is None
                else init_random_clip_text(cfg.clip, device, gen))
        return cls(cfg, dit, vae, text,
                   HashTokenizer(cfg.text.vocab_size, cfg.text.max_length), device,
                   clip=clip)

    @classmethod
    def from_numpy(cls, cfg: ModelConfig, dit_params: Dict, vae_params: Dict,
                   text_params: Dict, device="cuda",
                   clip_params: Optional[Dict] = None) -> "ModelBundle":
        """Bundle from the reference's parameter trees as numpy arrays
        (``clip_params``: the MMDiT's CLIP text tree)."""
        device = resolve_device(device)
        clip = (None if clip_params is None
                else load_clip_text_from_numpy(clip_params, cfg.clip, device))
        return cls(cfg,
                   get_arch(cfg.arch).from_numpy(dit_params, cfg.dit, device),
                   load_vae_from_numpy(vae_params, cfg.vae, device),
                   load_umt5_from_numpy(text_params, cfg.text, device),
                   HashTokenizer(cfg.text.vocab_size, cfg.text.max_length), device,
                   clip=clip)

    @classmethod
    def from_checkpoint_dir(cls, cfg: ModelConfig, ckpt_dir: str,
                            device="cuda") -> "ModelBundle":
        """Bundle from a checkpoint folder in the upstream torch layout:
        ``<ckpt_dir>/{dit,vae,text_encoder}`` (an MMDiT's also ``clip``, a
        HF CLIPTextModel) as ``.safetensors`` (or ``.bin``) shards,
        converted tensor by tensor onto ``device`` (``models/convert.py``),
        and the tokenizer of ``load_tokenizer`` (an MMDiT's CLIP tokenizer
        from ``load_hf_clip_tokenizer``, with a warning when there is none).
        The VAE's latent statistics come from ``vae/config.json``'s
        ``latents_mean``/``latents_std`` where it has them (the diffusers
        convention), else from the preset. Differs from the reference by
        design: the reference reads the orbax bundle that
        ``scripts/convert_checkpoint.py`` writes, the port reads the torch
        layout directly."""
        import json
        import os

        from ..models.convert import (
            load_clip_text_checkpoint,
            load_umt5_checkpoint,
            load_vae_checkpoint,
        )

        device = resolve_device(device)
        vae_json = os.path.join(ckpt_dir, "vae", "config.json")
        if os.path.exists(vae_json):
            with open(vae_json) as f:
                vmeta = json.load(f)
            if "latents_mean" in vmeta:
                cfg = dataclasses.replace(cfg, vae=dataclasses.replace(
                    cfg.vae, latents_mean=tuple(vmeta["latents_mean"]),
                    latents_std=tuple(vmeta["latents_std"])))
        tokenize = load_tokenizer(ckpt_dir, cfg)
        clip = clip_tokenize = None
        if cfg.arch == "mmdit":
            clip = load_clip_text_checkpoint(os.path.join(ckpt_dir, "clip"), cfg.clip,
                                             device)
            clip_tokenize = load_hf_clip_tokenizer(ckpt_dir, cfg.clip.max_length)
            if clip_tokenize is None:
                print("WARNING: no CLIP tokenizer subfolder in the checkpoint: the MMDiT "
                      "y_vec conditioning will use hash ids capped into the CLIP vocab "
                      "(meaningless with real CLIP weights). Copy the checkpoint's CLIP "
                      f"tokenizer to {os.path.join(ckpt_dir, 'tokenizer_2')}.")
        return cls(cfg,
                   get_arch(cfg.arch).from_checkpoint(os.path.join(ckpt_dir, "dit"),
                                                      cfg.dit, device),
                   load_vae_checkpoint(os.path.join(ckpt_dir, "vae"), cfg.vae, device),
                   load_umt5_checkpoint(os.path.join(ckpt_dir, "text_encoder"),
                                        cfg.text, device),
                   tokenize, device, clip=clip, clip_tokenize=clip_tokenize)

    def encode_prompt(self, prompt: str) -> Tuple[torch.Tensor, torch.Tensor]:
        """longcat, cogvideox -> (embeds [1, L, C], mask [1, L]); mmdit -> (txt
        [1, L, C_t5], y_vec [1, C_clip]): the T5 tokens and the CLIP pooled
        vector. Without a CLIP tokenizer the CLIP ids are the T5 (hash)
        ids capped at the CLIP vocab's last id and cut to its
        max_length."""
        ids, mask = self.tokenize(prompt)
        emb = umt5_encode(self.text, torch.from_numpy(ids).to(self.device),
                          torch.from_numpy(mask).to(self.device))
        if self.cfg.arch != "mmdit":
            return emb, torch.from_numpy(mask).to(self.device)
        ccfg = self.cfg.clip
        if self.clip_tokenize is not None:
            clip_ids = np.asarray(self.clip_tokenize(prompt)[0])[:, :ccfg.max_length]
        else:
            clip_ids = np.minimum(ids, ccfg.vocab_size - 1)[:, :ccfg.max_length]
        y_vec = self.clip.pooled(torch.from_numpy(clip_ids.astype(np.int64)).to(
            self.device))
        return emb, y_vec

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


def _quantized_cached(bundle: ModelBundle, dit: nn.Module) -> nn.Module:
    """The W8A8 decode DiT of ``dit``, quantized once and kept on the
    bundle for later requests (keyed by the 16-bit DiT's identity, the
    entry holding a reference to it so the key stays valid). A stale entry
    is dropped before quantizing, so two int8 copies never coexist; the
    int8 DiT shares every non-block parameter with ``dit``."""
    hit = bundle.int8_cache.get(id(dit))
    if hit is not None and hit[0] is dit:
        return hit[1]
    bundle.int8_cache.clear()
    q = get_arch(bundle.cfg.arch).quantize(dit)
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
    dit: Optional[nn.Module] = None,
    bsa_cfg: Optional[BSAConfig] = None,
    quantize_decode: str = "none",
    bucket_gen: bool = False,
    gen_segment_steps: int = 0,
    pab_cfg: Optional[PABConfig] = None,
    cfgr_cfg: Optional[CFGReuseConfig] = None,
    on_phase: Optional[Callable[[str], None]] = None,
    init_x: Optional[torch.Tensor] = None,
) -> np.ndarray:
    """Video continuation. Returns the generated frames [N, H, W, 3] in
    [0, 1] (N = num_frames rounded up to 4k+1).

    On an MMDiT bundle (``cfg.arch == "mmdit"``) the triple-CFG sampler
    (``sample_latents_mmdit``), on a CogVideoX bundle the 2-row CFG DDIM
    sampler (``sample_latents_cogvideox``, rows [neg, pos], the image
    latents of the first cond latent), denoises the whole [cond | gen]
    volume from ``init_x`` (the initial volume [1, C, T_cond + T_gen,
    lat_h, lat_w]; tests inject the reference's draw) or from a draw on the
    device from ``seed``, and the cond region is set back to the exact cond
    latents before decoding. BSA, ``bucket_gen``, ``init_noise`` and int8qk
    are refused there, as in the reference; ``use_kv_cache`` does not
    apply.

    The initial noise is drawn on the bundle's device from ``seed``.
    ``init_noise`` ([1, C, L*, lat_h, lat_w], unit variance) overwrites
    its leading L* latent frames (the reference's carried-noise rule;
    tests pass a full-size draw so both packages start from the same
    noise). ``adapters`` (a TTA scheme's ``to_forward`` output) reach
    every DiT call of the sampler. ``dit``: a per-video adapted DiT
    (norm_tune, full, builtin LoRA) to sample with in place of
    ``bundle.dit``; under W8A8 it is quantized uncached, so the bundle's
    cache never pins one video's adapted model through the next video.

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

    decode_dit = bundle.dit if dit is None else dit
    if init_x is not None and cfg.arch == "longcat":
        raise ValueError("init_x is the joint-volume samplers' initial volume; the "
                         "LongCat sampler takes init_noise")
    if cfg.arch != "longcat":
        return _generate_vc_joint(
            bundle, decode_dit, dit is not None, cond_latents, emb, mask, nemb, nmask,
            nf=nf, n_gen_latents=n_gen_latents, num_inference_steps=num_inference_steps,
            guidance_scale=guidance_scale, seed=seed, init_noise=init_noise,
            init_x=init_x, adapters=adapters, bsa_cfg=bsa_cfg,
            quantize_decode=quantize_decode, bucket_gen=bucket_gen,
            gen_segment_steps=gen_segment_steps, pab_cfg=pab_cfg, cfgr_cfg=cfgr_cfg,
            mark=mark, on_phase=on_phase)
    if quantize_decode == "int8qk":
        bsa_cfg = dataclasses.replace(
            bsa_cfg if bsa_cfg is not None else BSAConfig(keep_ratio=1.0),
            qk_int8=True)
    if quantize_decode in ("int8", "int8qk"):
        decode_dit = (_quantized_cached(bundle, bundle.dit) if dit is None
                      else get_arch(cfg.arch).quantize(dit))
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
    return _decode_generated(bundle, cond_latents, gen_latents[:, :, :n_gen_latents],
                             nf, mark)


def _decode_generated(bundle: ModelBundle, cond_latents, gen_latents, nf: int, mark):
    """Decode [cond | gen] together so the causal decoder sees the real
    temporal context; n_cond latents decode to 1 + (n_cond-1)*tf frames,
    and the generated clip is the nf frames right after them."""
    tf = bundle.cfg.vae.temporal_factor
    mark("vae_decode")
    full = torch.cat([cond_latents, gen_latents], dim=2)
    pixels = bundle.decode_latents(full)
    t_cond_px = 1 + (cond_latents.shape[2] - 1) * tf
    gen_px = pixels[0, :, t_cond_px:t_cond_px + nf]
    out = gen_px.permute(1, 2, 3, 0).float().cpu().numpy()
    mark("end")
    return out


def _generate_vc_joint(bundle: ModelBundle, decode_dit, adapted: bool, cond_latents,
                       emb, aux, nemb, naux, *, nf, n_gen_latents,
                       num_inference_steps, guidance_scale, seed, init_noise, init_x,
                       adapters, bsa_cfg, quantize_decode, bucket_gen, gen_segment_steps,
                       pab_cfg, cfgr_cfg, mark, on_phase) -> np.ndarray:
    """``generate_vc``'s Open-Sora v2 and CogVideoX branches: the MMDiT's
    triple-CFG batch [prompt, neg, neg] (``aux`` its CLIP y_vec) or
    CogVideoX's [neg, pos] (``aux`` the mask, unread), the sampler's whole
    volume with its cond region swapped back to the exact latents, then
    the decode."""
    cfg = bundle.cfg
    for flag, name in ((bsa_cfg, "bsa_cfg"), (bucket_gen, "bucket_gen"),
                       (init_noise is not None, "init_noise")):
        if flag:
            raise NotImplementedError(
                f"{name} is not supported on the {cfg.arch} decode path (LongCat only): "
                "no cond-KV/noise split to exploit in the joint-volume sampler — see "
                "generate_vc")
    if quantize_decode == "int8qk":
        raise NotImplementedError("quantize_decode='int8qk' rides the BSA kernel "
                                  "(LongCat decode only); use 'int8' here")
    if quantize_decode == "int8":
        decode_dit = (get_arch(cfg.arch).quantize(decode_dit) if adapted
                      else _quantized_cached(bundle, decode_dit))
    elif quantize_decode != "none":
        raise ValueError(f"quantize_decode {quantize_decode!r} is not one of "
                         "none, int8, int8qk")
    lat_h, lat_w = cond_latents.shape[3], cond_latents.shape[4]
    gen = torch.Generator(device=bundle.device).manual_seed(seed)
    kw = dict(num_gen_latents=n_gen_latents, num_steps=num_inference_steps,
              lat_h=lat_h, lat_w=lat_w, cond_latents=cond_latents, adapters=adapters,
              guidance=float(guidance_scale), pab_cfg=pab_cfg, cfgr_cfg=cfgr_cfg,
              init_x=init_x, generator=gen, on_phase=on_phase)
    seg = dict(segment_steps=gen_segment_steps) if gen_segment_steps > 0 else {}
    if cfg.arch == "mmdit":
        txt3 = torch.cat([emb, nemb, nemb], dim=0)
        yv3 = torch.cat([aux, naux, naux], dim=0)
        fn = sample_latents_mmdit_segmented if seg else sample_latents_mmdit
        full = fn(decode_dit, txt3, yv3, **seg, **kw)
    else:
        fn = sample_latents_cogvideox_segmented if seg else sample_latents_cogvideox
        full = fn(decode_dit, torch.cat([nemb, emb], dim=0), **seg, **kw)
    n_cond = cond_latents.shape[2]
    return _decode_generated(bundle, cond_latents, full[:, :, n_cond:], nf, mark)


@torch.inference_mode()
def generate_t2v(
    bundle: ModelBundle,
    prompt: str,
    *,
    num_frames: int = 93,
    height: int = 480,
    width: int = 832,
    num_inference_steps: int = 50,
    guidance_scale: float = 4.0,
    seed: int = 42,
    negative_prompt: str = "",
    adapters: Optional[Dict[str, torch.Tensor]] = None,
    pab_cfg: Optional[PABConfig] = None,
    cfgr_cfg: Optional[CFGReuseConfig] = None,
    generator: Optional[torch.Generator] = None,
    init_noise: Optional[torch.Tensor] = None,
    on_phase: Optional[Callable[[str], None]] = None,
) -> np.ndarray:
    """LongCat text-to-video. Returns [N, H, W, 3] in [0, 1], N =
    ``num_frames`` rounded up to 4k+1.

    The CFG Euler sampler with no conditioning latents (every token is
    noise, so there is no cond cache), then the VAE decode. The initial
    noise [1, C, L, height/8, width/8] comes from ``init_noise`` (unit
    variance; tests inject the reference's draw) or is drawn on the
    bundle's device from ``generator``, else from a generator seeded with
    ``seed``. ``pab_cfg`` / ``cfgr_cfg``: PAB and CFG-delta reuse on the
    dense loop. ``on_phase(name)`` is called as "prompt_encode", each
    "step", "vae_decode" and "end" begin. LongCat only: the joint-volume
    backbones raise, as in the reference (its ``sample_latents``)."""
    cfg = bundle.cfg
    if cfg.arch != "longcat":
        raise NotImplementedError(
            f"generate_t2v runs the LongCat sampler; the {cfg.arch} backbone has no "
            "text-to-video path")
    mark = on_phase or (lambda name: None)
    nf = round_frames_4k1(num_frames)
    n_lat = latent_len(nf, cfg.vae.temporal_factor)
    sf = cfg.vae.spatial_factor
    mark("prompt_encode")
    emb, mask = bundle.encode_prompt(prompt)
    nemb, nmask = bundle.encode_prompt(negative_prompt)
    if init_noise is None:
        if generator is None:
            generator = torch.Generator(device=bundle.device).manual_seed(seed)
        init_noise = torch.randn((1, cfg.dit.in_channels, n_lat, height // sf, width // sf),
                                 generator=generator, dtype=torch.float32,
                                 device=bundle.device)
    latents = sample_latents(bundle.dit, cfg.scheduler, emb, mask, nemb, nmask,
                             guidance_scale, num_gen_latents=n_lat,
                             num_steps=num_inference_steps, lat_h=height // sf,
                             lat_w=width // sf, cond_latents=None,
                             init_noise=torch.as_tensor(init_noise), adapters=adapters,
                             pab_cfg=pab_cfg, cfgr_cfg=cfgr_cfg, on_phase=on_phase)
    mark("vae_decode")
    pixels = bundle.decode_latents(latents)
    out = pixels[0].permute(1, 2, 3, 0)[:nf].float().cpu().numpy()
    mark("end")
    return out
