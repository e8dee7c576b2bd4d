"""The LongCat-Video DiT of the program under test, built from a
configuration file of ``benchmark/configs/`` with ``"backbone":
"longcat"``, its weights drawn by the benchmark."""

from __future__ import annotations

from types import SimpleNamespace

import torch

from ..draws import draw_weights, generator

_ONES = ("q_norm", "k_norm", "pre_crs_norm.weight")


def init_rule(name: str):
    """Matrices N(0, 0.02); norm scales 1; biases and the final adaLN 0
    (the published initialisation's kinds)."""
    if name.endswith(_ONES):
        return ("ones", 0.0)
    if name.endswith(".bias") or name == "final.adaln.weight":
        return ("zeros", 0.0)
    return ("normal", 0.02)


def program_config(cfg: dict):
    from longcat_video_tta_tpu_torch.config import DiTConfig

    return DiTConfig(
        hidden_size=cfg["hidden_size"], depth=cfg["depth"], num_heads=cfg["num_heads"],
        in_channels=cfg["in_channels"], out_channels=cfg["out_channels"],
        patch_size=tuple(cfg["patch_size"]), adaln_tembed_dim=cfg["adaln_tembed_dim"],
        ffn_dim=cfg["ffn_dim"], text_dim=cfg["caption_channels"], text_len=cfg["text_len"],
        text_tokens_zero_pad=cfg["text_tokens_zero_pad"], rope_dims=tuple(cfg["rope_dims"]),
        rope_theta=cfg["rope_theta"], t_embed_freq_dim=cfg["frequency_embedding_size"],
        param_dtype=cfg["dtype"], compute_dtype=cfg["dtype"],
        remat=cfg.get("remat_policy") is not None,
        remat_policy=cfg.get("remat_policy") or "full")


def build(cfg: dict, seed: int, device) -> SimpleNamespace:
    """The program's DiT on ``device`` with the benchmark's weights, and
    what the drivers need to feed it."""
    from longcat_video_tta_tpu_torch.archs import get_arch
    from longcat_video_tta_tpu_torch.config import SchedulerConfig
    from longcat_video_tta_tpu_torch.models.dit import LongCatDiT

    dcfg = program_config(cfg)
    with torch.device("meta"):
        dit = LongCatDiT(dcfg)
    weights = draw_weights(dit, init_rule, generator(device, seed, "weights"), device)
    dit.eval().requires_grad_(False)
    return SimpleNamespace(
        dit=dit, weights=weights, dit_cfg=dcfg, arch=get_arch("longcat"),
        scheduler=SchedulerConfig(shift=cfg["scheduler_shift"]),
        latent_channels=cfg["in_channels"], text_shape=(cfg["text_len"], cfg["caption_channels"]),
        dtype=getattr(torch, cfg["dtype"]),
        noise_covers_cond=False)
