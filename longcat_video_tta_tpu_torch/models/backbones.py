"""The other backbones' presets (counterpart of
``longcat_video_tta_tpu/models/backbones.py``):

- CogVideoX-5B-I2V (``models/cogvideox.py``): 42 joint-attention blocks
  of 48 heads of 64 (hidden 3072), CogVideoXLayerNormZero, I2V image
  latents concatenated on the channels, a T5-XXL-sized encoder (226
  tokens), the DDIM v-prediction sampler; the VAE is the WAN machinery
  at z_dim 16 with CogVideoX's uniform scaling (std 1/0.7).
- Open-Sora v2.0 MMDiT (``models/mmdit.py``): 19 double + 38 single
  blocks, hidden 3072, joint [txt | img] attention with (t, h, w) RoPE,
  cond_embed v2v conditioning, T5 token embeddings and the CLIP-L/14
  pooled y_vec, the WAN VAE.
"""

from __future__ import annotations

from ..config import (
    CLIPTextConfig,
    CogVideoXConfig,
    MMDiTConfig,
    ModelConfig,
    SchedulerConfig,
    TextEncoderConfig,
    VAEConfig,
)


def cogvideox_5b() -> ModelConfig:
    """CogVideoX-5B-I2V at its published widths and depth: the 5.5B
    joint-attention DiT, a T5-XXL-sized encoder (vocab 32128, 226
    tokens), the WAN VAE at base 128 normalised by CogVideoX's global
    scaling factor 0.7 (a uniform std of 1/0.7), in bf16."""
    return ModelConfig(
        dit=CogVideoXConfig(),
        vae=VAEConfig(z_dim=16, base_dim=128, param_dtype="bfloat16",
                      compute_dtype="bfloat16", latents_mean=(0.0,) * 16,
                      latents_std=(1.0 / 0.7,) * 16),
        text=TextEncoderConfig(vocab_size=32128, d_model=4096, d_kv=64, num_heads=64,
                               d_ff=10240, num_layers=24, max_length=226),
        scheduler=SchedulerConfig(shift=1.0),
    )


def cogvideox_tiny() -> ModelConfig:
    """A scaled-down CogVideoX for tests and CPU runs (head_dim 16: the
    CPU path only, since the kernels take head_dim 32, 64 or 128)."""
    return ModelConfig(
        dit=CogVideoXConfig(
            hidden_size=64, depth=2, num_heads=4, in_channels=32, latent_channels=16,
            out_channels=16, text_dim=32, time_embed_dim=32, rope_dims=(4, 6, 6),
            param_dtype="float32", compute_dtype="float32",
        ),
        vae=VAEConfig(base_dim=16, dim_mults=(1, 1, 2, 2), num_res_blocks=1,
                      attn_mid_block=False, latents_mean=(0.0,) * 16,
                      latents_std=(1.0 / 0.7,) * 16),
        text=TextEncoderConfig(vocab_size=512, d_model=32, d_kv=8, num_heads=4, d_ff=64,
                               num_layers=2, max_length=16, param_dtype="float32",
                               compute_dtype="float32"),
        scheduler=SchedulerConfig(shift=1.0),
    )


def opensora_v2() -> ModelConfig:
    """Open-Sora v2.0 at its published widths and depth: the 11.8B MMDiT,
    a T5-XXL-sized encoder (vocab 32128, max_length 512), CLIP-L/14 text
    and the WAN VAE, in bf16 (the CLIP tower fp32)."""
    return ModelConfig(
        dit=MMDiTConfig(),
        vae=VAEConfig(param_dtype="bfloat16", compute_dtype="bfloat16"),
        text=TextEncoderConfig(vocab_size=32128, max_length=512),
        clip=CLIPTextConfig(),
        scheduler=SchedulerConfig(shift=3.0),
    )


def opensora_v2_tiny() -> ModelConfig:
    """A scaled-down MMDiT for tests and CPU runs (head_dim 16: the CPU
    path only, since the kernels take head_dim 32, 64 or 128)."""
    return ModelConfig(
        dit=MMDiTConfig(
            hidden_size=64, num_heads=4, depth_double=2, depth_single=2,
            mlp_ratio=2.0, in_channels=16, patch_size=2, vec_in_dim=16,
            context_in_dim=32, axes_dims=(4, 6, 6),
            param_dtype="float32", compute_dtype="float32",
        ),
        vae=VAEConfig(base_dim=16, dim_mults=(1, 1, 2, 2),
                      num_res_blocks=1, attn_mid_block=False),
        text=TextEncoderConfig(vocab_size=512, d_model=32, d_kv=8,
                               num_heads=4, d_ff=64, num_layers=2,
                               max_length=16, param_dtype="float32",
                               compute_dtype="float32"),
        clip=CLIPTextConfig(vocab_size=512, width=16, num_layers=2,
                            num_heads=2, max_length=16),
        scheduler=SchedulerConfig(shift=3.0),
    )

