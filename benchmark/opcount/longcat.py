"""The work of the LongCat-Video DiT's units, from the configuration file
and the cell's geometry: every product and attention the configuration
asks for, at the sizes the traffic sends, whatever implements it.
Attention counts the (query, key) pairs the prefix mask lets through.
A TTA step's backward counts the input gradients only (delta_a trains no
weight) and, under remat, no recomputed forward. Elementwise work is not
counted."""

from __future__ import annotations

from ..kernels import Work, attn, matmul


def _forward(cfg: dict, B: int, nt: int, nhw: int, ncond: int, cache: int = 0,
             grad: bool = False, final: bool = True) -> Work:
    """One forward over B rows of nt latent frames of nhw tokens, the first
    ``ncond`` tokens a prefix, ``cache`` cached keys in front of the
    self-attention's; ``grad``: with the input gradients of every product
    on the path from the t-embedding to the loss."""
    D, H = cfg["hidden_size"], cfg["num_heads"]
    dh, F, Ct, L = D // H, cfg["ffn_dim"], cfg["adaln_tembed_dim"], cfg["text_len"]
    pt, ph, pw = cfg["patch_size"]
    S = nt * nhw
    rows = B * S
    w = Work()
    w += matmul(rows, pt * ph * pw * cfg["in_channels"], D)                 # x_embed
    w += matmul(B * nt, cfg["frequency_embedding_size"], Ct)                # t_embed
    w += matmul(B * nt, Ct, Ct)
    w += matmul(B * L, cfg["caption_channels"], D)                          # y_embed
    w += matmul(B * L, D, D)
    bwd = "dqkv" if grad else None
    for _ in range(cfg["depth"]):
        w += matmul(B * nt, Ct, 6 * D, grad)                                # adaLN
        w += matmul(rows, D, 3 * D, grad)                                   # qkv
        w += attn(B, H, S, S + cache, dh, 0 if cache else ncond, None, bwd)
        w += matmul(rows, D, D, grad)                                       # proj
        w += matmul(rows, D, D, grad)                                       # cross q
        w += matmul(B * L, D, 2 * D)                                        # cross kv
        w += attn(B, H, S, L, dh, 0, None, "dq" if grad else None)
        w += matmul(rows, D, D, grad)                                       # cross proj
        w += matmul(rows, D, 2 * F, grad)                                   # w1, w3
        w += matmul(rows, F, D, grad)                                       # w2
    if final:
        w += matmul(B * nt, Ct, 2 * D, grad)
        w += matmul(rows, D, pt * ph * pw * cfg["out_channels"], grad)
    return w


def train_step(cfg: dict, geo: dict) -> Work:
    """One delta_a step: the conditioning and train latents in one forward
    (the conditioning frames the prefix), then the backward."""
    nhw, c, t = geo["nhw"], geo["cond_latents"], geo["train_latents"]
    return _forward(cfg, 1, c + t, nhw, c * nhw, grad=True)


def anchor(cfg: dict, geo: dict) -> Work:
    """The anchor: the (sigma, draw) rows of conditioning + val latents in
    one batched forward."""
    nhw, c, v = geo["nhw"], geo["cond_latents"], geo["val_latents"]
    return _forward(cfg, geo["anchor_rows"], c + v, nhw, c * nhw)


def cond_cache(cfg: dict, geo: dict) -> Work:
    """The CFG pair's conditioning tokens through every block (all prefix),
    keeping their keys and values; no final layer."""
    nhw, c = geo["nhw"], geo["cond_latents"]
    return _forward(cfg, 2, c, nhw, c * nhw, final=False)


def denoise_step(cfg: dict, geo: dict) -> Work:
    """One CFG step: the pair's generated tokens against the cached
    conditioning keys and their own."""
    nhw, c, g = geo["nhw"], geo["cond_latents"], geo["gen_latents"]
    return _forward(cfg, 2, g, nhw, 0, cache=c * nhw)
