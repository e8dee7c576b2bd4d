"""The work of CogVideoX's units, from the configuration file and the
cell's geometry: every product and attention the configuration asks for
over the joint [text | video] sequence (full attention, no mask). A TTA
step's backward counts the input gradients only (delta_a trains no
weight) and, under remat, no recomputed forward. Elementwise work is not
counted."""

from __future__ import annotations

from ..kernels import Work, attn, matmul


def _forward(cfg: dict, B: int, nt: int, nhw: int, grad: bool = False) -> Work:
    D, H, dh = cfg["hidden_size"], cfg["num_attention_heads"], cfg["attention_head_dim"]
    Ct, L, p = cfg["time_embed_dim"], cfg["max_text_seq_length"], cfg["patch_size"]
    F = cfg["ffn_mult"] * D
    S = nt * nhw
    rows = B * (L + S)
    w = Work()
    w += matmul(B * S, cfg["in_channels"] * p * p, D)                       # patch_embed
    w += matmul(B * L, cfg["text_embed_dim"], D)                            # text_proj
    w += matmul(B, D, Ct)                                                   # time_embed
    w += matmul(B, Ct, Ct)
    for _ in range(cfg["num_layers"]):
        w += matmul(B, Ct, 6 * D, grad)                                     # norm1
        w += matmul(rows, D, 3 * D, grad)                                   # to_q, to_k, to_v
        w += attn(B, H, L + S, L + S, dh, 0, None, "dqkv" if grad else None)
        w += matmul(rows, D, D, grad)                                       # to_out
        w += matmul(B, Ct, 6 * D, grad)                                     # norm2
        w += matmul(rows, D, F, grad)                                       # ff
        w += matmul(rows, F, D, grad)
    w += matmul(B, Ct, 2 * D, grad)                                         # norm_out
    w += matmul(B * S, D, cfg["out_channels"] * p * p, grad)                # proj_out
    return w


def train_step(cfg: dict, geo: dict) -> Work:
    """One delta_a step: the whole [cond | train] window noised, in one
    forward, then the backward."""
    return _forward(cfg, 1, geo["cond_latents"] + geo["train_latents"], geo["nhw"], grad=True)


def anchor(cfg: dict, geo: dict) -> Work:
    """The anchor: one forward of conditioning + val latents per (sigma,
    draw)."""
    w = Work()
    for _ in range(geo["anchor_rows"]):
        w += _forward(cfg, 1, geo["cond_latents"] + geo["val_latents"], geo["nhw"])
    return w
