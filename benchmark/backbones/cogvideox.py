"""The CogVideoX transformer of the program under test, built from a
configuration file of ``benchmark/configs/`` with ``"backbone":
"cogvideox"``, its weights drawn by the benchmark."""

from __future__ import annotations

from types import SimpleNamespace

import torch

from ..draws import draw_weights, generator


def init_rule(name: str):
    """Matrices N(0, 0.02); LayerNorm scales 1; biases 0."""
    if name.endswith(("ln.weight", "norm_q.weight", "norm_k.weight", "norm_final.weight")):
        return ("ones", 0.0)
    if name.endswith(".bias"):
        return ("zeros", 0.0)
    return ("normal", 0.02)


def program_config(cfg: dict):
    from longcat_video_tta_tpu_torch.config import CogVideoXConfig

    if cfg["use_learned_positional_embeddings"]:
        raise ValueError("the learned positional table is tied to the published grid")
    return CogVideoXConfig(
        hidden_size=cfg["hidden_size"], depth=cfg["num_layers"],
        num_heads=cfg["num_attention_heads"], in_channels=cfg["in_channels"],
        latent_channels=cfg["out_channels"], out_channels=cfg["out_channels"],
        patch_size=cfg["patch_size"], text_dim=cfg["text_embed_dim"],
        time_embed_dim=cfg["time_embed_dim"], ffn_mult=float(cfg["ffn_mult"]),
        rope_dims=tuple(cfg["rope_dims"]), rope_theta=cfg["rope_theta"],
        norm_eps=cfg["norm_eps"], learned_pos_embed_len=0, param_dtype=cfg["dtype"],
        compute_dtype=cfg["dtype"], remat=cfg.get("remat_policy") is not None,
        remat_policy=cfg.get("remat_policy") or "full")


def build(cfg: dict, seed: int, device) -> SimpleNamespace:
    from longcat_video_tta_tpu_torch.archs import get_arch
    from longcat_video_tta_tpu_torch.models.cogvideox import CogVideoX

    dcfg = program_config(cfg)
    with torch.device("meta"):
        dit = CogVideoX(dcfg)
    weights = draw_weights(dit, init_rule, generator(device, seed, "weights"), device)
    dit.eval().requires_grad_(False)
    return SimpleNamespace(
        dit=dit, weights=weights, dit_cfg=dcfg, arch=get_arch("cogvideox"),
        latent_channels=cfg["out_channels"],
        text_shape=(cfg["max_text_seq_length"], cfg["text_embed_dim"]),
        dtype=getattr(torch, cfg["dtype"]),
        noise_covers_cond=True)
