"""Typed configuration for the PyTorch port (its own copy of the
reference's ``config.py``: the model dataclasses, the frame and
generation configs, and the LongCat presets; the Open-Sora v2 and
CogVideoX presets live in ``models/backbones.py``).

Dtypes are stored by name so the dataclasses stay JSON-serializable;
``resolve_dtype`` maps a name to the ``torch.dtype``.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import ClassVar, Optional, Tuple

import torch

_DTYPES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
}


def resolve_dtype(name: str) -> torch.dtype:
    return _DTYPES[name]


# ---------------------------------------------------------------------------
# Model configs
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class DiTConfig:
    """LongCat-style video diffusion transformer: adaLN blocks with fused
    qkv self-attention (RMS qk-norm, 3D RoPE), affine pre-norm
    cross-attention over packed text, SwiGLU ffn w1/w2/w3."""

    arch: ClassVar[str] = "longcat"  # the backbone's record in archs.py
    hidden_size: int = 4096
    depth: int = 48
    num_heads: int = 32
    in_channels: int = 16
    out_channels: int = 16
    patch_size: Tuple[int, int, int] = (1, 2, 2)  # (p_t, p_h, p_w)
    adaln_tembed_dim: int = 512
    ffn_dim: int = 11008  # SwiGLU inner dim (w1/w3 out, w2 in)
    text_dim: int = 4096  # UMT5-XXL hidden size
    text_len: int = 512
    qk_norm: bool = True
    cross_qk_norm: bool = True
    text_tokens_zero_pad: bool = True
    # 3D RoPE per-axis channel split; must sum to head_dim and be even.
    rope_dims: Tuple[int, int, int] = (32, 48, 48)
    rope_theta: float = 10000.0
    t_embed_freq_dim: int = 256
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    # per-block gradient checkpoint in training (ops/layers.py::remat_wrap):
    # "full" recomputes the whole block in the backward; the reference's
    # "dots" / "dots_attn" policies are not ported yet
    remat: bool = True
    remat_policy: str = "full"

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    def __post_init__(self):
        if self.hidden_size % self.num_heads != 0:
            raise ValueError("hidden_size must be divisible by num_heads")
        if sum(self.rope_dims) != self.head_dim:
            raise ValueError(f"rope_dims {self.rope_dims} must sum to "
                             f"head_dim {self.head_dim}")


@dataclass(frozen=True)
class MMDiTConfig:
    """Open-Sora v2.0 / Flux-style MMDiT (``models/mmdit.py``):
    ``depth_double`` dual-stream blocks (separate img/txt weights, joint
    attention over [txt | img]) then ``depth_single`` fused blocks over
    the concatenated sequence. Defaults are the Open-Sora v2 geometry:
    19 double + 38 single blocks, 24 heads of 128, hidden 3072."""

    arch: ClassVar[str] = "mmdit"
    hidden_size: int = 3072
    num_heads: int = 24
    depth_double: int = 19
    depth_single: int = 38
    mlp_ratio: float = 4.0
    in_channels: int = 16          # latent channels (before packing)
    patch_size: int = 2            # spatial; the temporal patch is 1
    cond_embed: bool = True        # v2v/i2v [masks | masked_ref] channel input
    vec_in_dim: int = 768          # CLIP pooled text
    context_in_dim: int = 4096     # T5 token embeddings
    t_embed_freq_dim: int = 256
    guidance_embed: bool = False
    # RoPE over (t, h, w) position ids; text tokens get the identity
    axes_dims: Tuple[int, int, int] = (16, 56, 56)
    rope_theta: float = 10000.0
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    remat: bool = True
    remat_policy: str = "full"

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @property
    def mlp_dim(self) -> int:
        return int(self.hidden_size * self.mlp_ratio)

    @property
    def packed_channels(self) -> int:
        return self.in_channels * self.patch_size ** 2

    @property
    def cond_channels(self) -> int:
        return (1 + self.in_channels) * self.patch_size ** 2

    @property
    def adaln_tembed_dim(self) -> int:
        """The delta_a site's width: the MMDiT vec is hidden-sized."""
        return self.hidden_size

    def __post_init__(self):
        if self.hidden_size % self.num_heads != 0:
            raise ValueError("hidden_size must be divisible by num_heads")
        if sum(self.axes_dims) != self.head_dim:
            raise ValueError(f"axes_dims {self.axes_dims} must sum to "
                             f"head_dim {self.head_dim}")


@dataclass(frozen=True)
class CogVideoXConfig:
    """CogVideoX-5B(-I2V) transformer (``models/cogvideox.py``, the
    diffusers ``CogVideoXTransformer3DModel`` layout): joint [text | video]
    attention blocks with CogVideoXLayerNormZero (6-chunk modulation of
    both streams from the time embedding), q/k LayerNorm, 3D RoPE on the
    video tokens only, I2V through channel-concatenated image latents
    (in_channels 32 = 16 noisy + 16 image). Defaults are the 5B geometry:
    42 blocks, 48 heads of 64, hidden 3072."""

    arch: ClassVar[str] = "cogvideox"
    hidden_size: int = 3072
    depth: int = 42
    num_heads: int = 48
    in_channels: int = 32          # I2V: 16 latent + 16 image-conditioning
    latent_channels: int = 16
    out_channels: int = 16
    patch_size: int = 2            # spatial; the temporal patch is 1
    text_dim: int = 4096           # T5-XXL
    time_embed_dim: int = 512      # the delta_a site
    ffn_mult: float = 4.0
    rope_dims: Tuple[int, int, int] = (16, 24, 24)
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    # > 0: a learned joint-sequence positional table [len, hidden]
    # (diffusers use_learned_positional_embeddings, the I2V checkpoints'
    # patch_embed.pos_embedding) added to the [text | video] tokens
    learned_pos_embed_len: int = 0
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    remat: bool = True
    remat_policy: str = "full"

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @property
    def ffn_dim(self) -> int:
        return int(self.hidden_size * self.ffn_mult)

    @property
    def adaln_tembed_dim(self) -> int:
        """The delta_a site's width: the time embedding's output."""
        return self.time_embed_dim

    def __post_init__(self):
        if self.hidden_size % self.num_heads != 0:
            raise ValueError("hidden_size must be divisible by num_heads")
        if sum(self.rope_dims) != self.head_dim:
            raise ValueError(f"rope_dims {self.rope_dims} must sum to "
                             f"head_dim {self.head_dim}")


@dataclass(frozen=True)
class VAEConfig:
    """Causal WAN-style 3D VAE: 4x temporal / 8x spatial factors,
    z_dim-channel latents with per-channel latents_mean/latents_std."""

    z_dim: int = 16
    base_dim: int = 96
    dim_mults: Tuple[int, ...] = (1, 2, 4, 4)
    num_res_blocks: int = 2
    # spatial downsample between scales 0-1, 1-2, 2-3 (8x total);
    # temporal downsample between scales 1-2 and 2-3 (4x total)
    temporal_downsample: Tuple[bool, ...] = (False, True, True)
    attn_mid_block: bool = True
    latents_mean: Tuple[float, ...] = (
        -0.7571, -0.7089, -0.9113, 0.1075, -0.1745, 0.9653, -0.1517, 1.5508,
        0.4134, -0.0715, 0.5517, -0.3632, -0.1922, -0.9497, 0.2503, -0.2921,
    )
    latents_std: Tuple[float, ...] = (
        2.8184, 1.4541, 2.3275, 2.6558, 1.2196, 1.7708, 2.6052, 2.0743,
        3.2687, 2.1526, 2.8652, 1.5579, 1.6382, 1.1253, 2.8251, 1.9160,
    )
    param_dtype: str = "float32"
    compute_dtype: str = "float32"

    @property
    def temporal_factor(self) -> int:
        return 2 ** sum(self.temporal_downsample)

    @property
    def spatial_factor(self) -> int:
        return 2 ** (len(self.dim_mults) - 1)


@dataclass(frozen=True)
class TextEncoderConfig:
    """UMT5 encoder, padded to max_length."""

    vocab_size: int = 256384
    d_model: int = 4096
    d_kv: int = 64
    num_heads: int = 64
    d_ff: int = 10240
    num_layers: int = 24
    relative_attention_num_buckets: int = 32
    relative_attention_max_distance: int = 128
    layer_norm_eps: float = 1e-6
    max_length: int = 512
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"


@dataclass(frozen=True)
class CLIPTextConfig:
    """CLIP text tower (``models/clip_text.py``). The dataclass defaults
    are CLIP-L/14's text geometry; the gate's ViT-B/32 checkpoint is read
    from its ``config.json`` (``tta/clip_gate.py::make_clip_scorer``)."""

    vocab_size: int = 49408
    width: int = 768
    num_layers: int = 12
    num_heads: int = 12
    max_length: int = 77
    param_dtype: str = "float32"

    @property
    def head_dim(self) -> int:
        return self.width // self.num_heads


@dataclass(frozen=True)
class CLIPVisionConfig:
    """CLIP ViT vision tower of the gate scorer (``models/clip.py``).
    Defaults: ViT-B/32 at 224."""

    width: int = 768
    num_layers: int = 12
    num_heads: int = 12
    patch_size: int = 32
    image_size: int = 224
    projection_dim: int = 512
    param_dtype: str = "float32"

    @property
    def head_dim(self) -> int:
        return self.width // self.num_heads


@dataclass(frozen=True)
class XCLIPConfig:
    """X-CLIP video-text scorer (``models/xclip.py``). Defaults:
    xclip-base-patch32. The MIT width equals the projection dim (frame
    class embeddings are projected before integration)."""

    vision: "CLIPVisionConfig" = None  # type: ignore[assignment]
    text: "CLIPTextConfig" = None      # type: ignore[assignment]
    num_frames: int = 8
    mit_layers: int = 1
    mit_heads: int = 8
    prompt_layers: int = 2
    prompt_heads: int = 8

    def __post_init__(self):
        if self.vision is None:
            object.__setattr__(self, "vision", CLIPVisionConfig())
        if self.text is None:
            object.__setattr__(self, "text", CLIPTextConfig())

    @property
    def vision_heads(self) -> int:
        return self.vision.num_heads

    @property
    def projection_dim(self) -> int:
        return self.vision.projection_dim


@dataclass(frozen=True)
class SchedulerConfig:
    """Flow-match Euler discrete scheduler."""

    num_train_timesteps: int = 1000
    shift: float = 5.0  # resolution-dependent timestep shift
    sigma_min: float = 0.001
    sigma_max: float = 1.0


@dataclass(frozen=True)
class ModelConfig:
    """``arch`` names the backbone, from the type of ``dit``: "longcat"
    (a DiTConfig), "mmdit" (an MMDiTConfig, with the CLIP text tower
    ``clip`` for the pooled y_vec) or "cogvideox" (a CogVideoXConfig)."""

    dit: DiTConfig = field(default_factory=DiTConfig)
    vae: VAEConfig = field(default_factory=VAEConfig)
    text: TextEncoderConfig = field(default_factory=TextEncoderConfig)
    scheduler: SchedulerConfig = field(default_factory=SchedulerConfig)
    clip: Optional[CLIPTextConfig] = None

    @property
    def arch(self) -> str:
        return self.dit.arch


# ---------------------------------------------------------------------------
# Presets (same geometry as the reference presets of the same name)
# ---------------------------------------------------------------------------


def longcat_13b() -> ModelConfig:
    """The 13.6B-param LongCat-Video DiT geometry (48 blocks, hidden
    4096, 32 heads of 128, t-embed 512) with UMT5-XXL and the WAN VAE."""
    return ModelConfig(
        vae=VAEConfig(param_dtype="bfloat16", compute_dtype="bfloat16"),
    )


def longcat_tiny() -> ModelConfig:
    """Tiny config for unit tests and CPU dry runs."""
    return ModelConfig(
        dit=DiTConfig(
            hidden_size=64,
            depth=2,
            num_heads=2,
            ffn_dim=128,
            adaln_tembed_dim=32,
            text_dim=48,
            text_len=16,
            rope_dims=(8, 12, 12),
            t_embed_freq_dim=32,
            param_dtype="float32",
            compute_dtype="float32",
            remat=False,
        ),
        vae=VAEConfig(
            z_dim=16,
            base_dim=8,
            dim_mults=(1, 2, 4, 4),
            num_res_blocks=1,
        ),
        text=TextEncoderConfig(
            vocab_size=512,
            d_model=48,
            d_kv=8,
            num_heads=2,
            d_ff=64,
            num_layers=2,
            max_length=16,
            param_dtype="float32",
            compute_dtype="float32",
        ),
    )


def longcat_bench() -> ModelConfig:
    """Full 480p token geometry with a 1.2B DiT (hidden 2048, 16 blocks,
    16 heads of 128)."""
    return ModelConfig(
        dit=DiTConfig(
            hidden_size=2048,
            depth=16,
            num_heads=16,
            ffn_dim=5504,
            adaln_tembed_dim=512,
            text_dim=2048,
            text_len=512,
            rope_dims=(32, 48, 48),
            remat_policy="dots_attn",
        ),
        vae=VAEConfig(param_dtype="bfloat16", compute_dtype="bfloat16"),
        text=TextEncoderConfig(
            vocab_size=32128,
            d_model=2048,
            d_kv=64,
            num_heads=32,
            d_ff=5120,
            num_layers=8,
        ),
    )


def longcat_demo() -> ModelConfig:
    """~93M-param demo DiT with the flagship's kernel layout (head_dim
    128); pairs with 192x320 video (latents 24x40, 240 tokens/frame)."""
    return ModelConfig(
        dit=DiTConfig(
            hidden_size=768,
            depth=8,
            num_heads=6,
            ffn_dim=2048,
            adaln_tembed_dim=256,
            text_dim=256,
            text_len=64,
            rope_dims=(32, 48, 48),
            remat=False,
        ),
        vae=VAEConfig(
            base_dim=32,
            num_res_blocks=1,
        ),
        text=TextEncoderConfig(
            vocab_size=512,
            d_model=256,
            d_kv=32,
            num_heads=8,
            d_ff=512,
            num_layers=2,
            max_length=64,
            param_dtype="float32",
            compute_dtype="float32",
        ),
    )


def longcat_bench_3b() -> ModelConfig:
    """``longcat_bench`` at about 3.2B DiT parameters (hidden 2560, 24
    blocks, 20 heads of 128, ffn 6912) with full remat: a model whose
    full-weight TTA (weights, gradients, AdamW state and the best
    snapshot) fits one card."""
    base = longcat_bench()
    return dataclasses.replace(base, dit=dataclasses.replace(
        base.dit, hidden_size=2560, depth=24, num_heads=20, ffn_dim=6912,
        remat_policy="full"))


MODEL_PRESETS = {
    "longcat_13b": longcat_13b,
    "longcat_tiny": longcat_tiny,
    "longcat_bench": longcat_bench,
    "longcat_bench_3b": longcat_bench_3b,
    "longcat_demo": longcat_demo,
}


# the other backbones' presets are in models/backbones.py; this is every
# name the runner's --preset takes
BACKBONE_PRESET_NAMES = ("cogvideox_5b", "cogvideox_tiny", "opensora_v2",
                         "opensora_v2_tiny")
ALL_PRESET_NAMES = tuple(MODEL_PRESETS) + BACKBONE_PRESET_NAMES


def get_model_config(preset: str) -> ModelConfig:
    if preset in MODEL_PRESETS:
        return MODEL_PRESETS[preset]()
    if preset in BACKBONE_PRESET_NAMES:
        from .models import backbones

        return getattr(backbones, preset)()
    raise KeyError(f"unknown model preset {preset!r}")


# ---------------------------------------------------------------------------
# Run / TTA configs
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class AugmentationConfig:
    """TTA clip augmentation (the reference's ``AugmentationConfig``)."""

    enabled: bool = False
    hflip: bool = False
    rotate_degrees: Tuple[float, ...] = ()
    random_rotate: bool = False
    random_rotate_max_deg: float = 15.0
    num_random_rotations: int = 0
    speed_factors: Tuple[float, ...] = ()
    latent_space: bool = True  # re-encode variants through the VAE


@dataclass(frozen=True)
class EarlyStoppingConfig:
    """Anchored early stopping (the reference's ``EarlyStoppingConfig``)."""

    enabled: bool = True
    check_every: int = 5
    patience: int = 3
    anchor_sigmas: Tuple[float, ...] = (0.25, 0.5, 0.75)
    noise_draws: int = 2
    strategy: str = "patience"  # "patience" | "first_rise"
    holdout_fraction: float = 0.25


@dataclass(frozen=True)
class AdapterConfig:
    """One config covering the seven TTA methods (the reference's
    ``AdapterConfig``): full | lora | delta_a | delta_b | delta_c |
    norm_tune | film."""

    method: str = "delta_a"
    # lora: rank-r side branch on the targeted block linears, scale
    # alpha / rank; ``lora_builtin`` merges scale * a @ b into the weights
    # instead (same function, a merged weight copy per step)
    lora_rank: int = 8
    lora_alpha: float = 16.0
    lora_target_modules: Tuple[str, ...] = ("qkv", "proj")
    lora_target_ffn: bool = False
    lora_builtin: bool = False
    # delta_b: G group deltas on the t-embedding or the block outputs,
    # optionally on the first ``delta_dim`` channels only
    num_groups: int = 4
    delta_target: str = "timestep"  # "timestep" | "hidden"
    delta_dim: Optional[int] = None
    # delta_b / lora block scoping: "all" | "last_N" | "i,j,k"
    target_blocks: str = "all"
    # norm_tune: cross_attn_norm | qk_norm | all_norm, optionally with a
    # delta_a vector trained alongside
    norm_target: str = "cross_attn_norm"
    also_tune_delta: bool = False
    # film: which adaLN chunks get a correction
    film_mode: str = "full"  # full | shift_scale | scale_only


@dataclass(frozen=True)
class OptimConfig:
    optimizer: str = "adamw"  # "adamw" | "sgd"
    lr: float = 1e-3
    betas: Tuple[float, float] = (0.9, 0.999)
    eps: float = 1e-15
    momentum: float = 0.0  # sgd (momentum-free by default)
    grad_clip_norm: float = 1.0
    steps: int = 20
    warmup_steps: int = 0  # linear warmup 0 -> lr, then constant
    weight_decay: float = 0.01


@dataclass(frozen=True)
class FrameConfig:
    """Anchor-based frame layout: conditioning frames end at
    ``gen_start_frame``; generated frames start there."""

    num_cond_frames: int = 14
    num_frames: int = 28  # generated frames (rounded up to 4k+1)
    gen_start_frame: int = 32  # anchor
    tta_total_frames: Optional[int] = None  # default: num_cond_frames
    tta_context_frames: Optional[int] = None  # default: num_cond_frames
    height: int = 480
    width: int = 832
    fps: int = 24


@dataclass(frozen=True)
class GenerationConfig:
    num_inference_steps: int = 50
    guidance_scale: float = 4.0
    use_kv_cache: bool = True
    negative_prompt: str = ""


@dataclass(frozen=True)
class BSAConfig:
    """Block-sparse decode attention (``ops/bsa.py``): keep ``keep_ratio``
    of the key blocks per query block (at least ``min_blocks``); the
    conditioning-prefix blocks and each query block's own block are always
    kept. ``qk_int8`` runs QK^T in int8 with per-token scales
    (``--quantize-decode int8qk``)."""

    keep_ratio: float = 0.35
    block_q: int = 1024
    block_k: int = 1024
    min_blocks: int = 4
    qk_int8: bool = False


@dataclass(frozen=True)
class PABConfig:
    """Pyramid Attention Broadcast (arXiv:2408.12588): inside
    [start_frac, end_frac) of the denoising steps, self-attention is
    computed every ``every``-th step and the other steps reuse each
    block's last computed output."""

    every: int = 2
    start_frac: float = 0.1
    end_frac: float = 0.9


@dataclass(frozen=True)
class CFGReuseConfig:
    """CFG guidance-delta reuse (FasterCache, arXiv:2410.19355): inside
    [start_frac, end_frac) only every ``every``-th step runs both CFG
    branches; the others run the conditional branch alone and take
    ``v_uncond = v_cond - delta`` with the delta of the last full step."""

    every: int = 2
    start_frac: float = 0.1
    end_frac: float = 0.9


@dataclass(frozen=True)
class ClipGateConfig:
    """The per-video CLIP gate in front of TTA (``tta/clip_gate.py``)."""

    enabled: bool = False
    backend: str = "clip"  # "clip" | "xclip"
    threshold: float = 0.2
    sample_frames: int = 4
    sampling_mode: str = "full_window"  # "full_window" | "late_only"
    late_fraction: float = 0.4
    aggregate: str = "mean"  # "mean" | "min" | "max"
    log_only: bool = False
    fail_open: bool = True


@dataclass(frozen=True)
class OnlineEvalConfig:
    """Online FVD / FID over the run (``eval/frechet.py``)."""

    fvd_enabled: bool = False
    fid_enabled: bool = False
    vbench_enabled: bool = False
    min_videos: int = 256


@dataclass(frozen=True)
class MeshConfig:
    """Process mesh: data x context x tensor axes (the reference's
    ``config.MeshConfig``); one rank per mesh point."""

    data: int = 1
    context: int = 1
    tensor: int = 1

    @property
    def num_devices(self) -> int:
        return self.data * self.context * self.tensor


@dataclass(frozen=True)
class CaptionGuardConfig:
    mode: str = "fail"  # "fail" | "warn" | "off"
    min_nonempty_ratio: float = 0.95
    min_unique_ratio: float = 0.10
    max_top1_ratio: float = 0.50
    max_generic_top1_ratio: float = 0.20
    topk: int = 5
