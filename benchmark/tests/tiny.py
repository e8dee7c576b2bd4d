"""Tiny configurations of the benchmark's two backbones (the port's
``longcat_tiny`` and ``cogvideox_tiny`` geometry, float32) and tiny
traffic, for the CPU tests."""

import copy
import json
import os

from benchmark import core

LONGCAT = dict(
    name="longcat_tiny", backbone="longcat", in_channels=16, out_channels=16, hidden_size=64,
    depth=2, num_heads=2, caption_channels=48, mlp_ratio=4, adaln_tembed_dim=32,
    frequency_embedding_size=32, patch_size=[1, 2, 2], text_tokens_zero_pad=True, ffn_dim=128,
    text_len=16, rope_dims=[8, 12, 12], rope_theta=10000.0, scheduler_shift=5.0,
    dtype="float32", remat_policy="full")
COGVIDEOX = dict(
    name="cogvideox_tiny", backbone="cogvideox", num_attention_heads=4, attention_head_dim=16,
    in_channels=32, out_channels=16, time_embed_dim=32, text_embed_dim=32, num_layers=2,
    patch_size=2, max_text_seq_length=16, norm_eps=1e-5, use_learned_positional_embeddings=False,
    hidden_size=64, ffn_mult=4, rope_dims=[4, 6, 6], rope_theta=10000.0, dtype="float32",
    remat_policy="full")
PEAKS = {"bf16_flops": 989e12, "int8_ops": 1979e12, "hbm_bytes_per_s": 3.35e12}


def traffic(mix: str, **kw) -> dict:
    with open(os.path.join(core.BENCH_DIR, "traffic", mix + ".json")) as f:
        t = json.load(f)
    t.update(height=64, width=96, cond_latents=2, text_valid_tokens=[4, 12])
    if t["driver"] == "tta":
        t.update(steps_per_video=6, check_every=3)
    else:
        t.update(gen_latents=2, steps=6)
    t.update(kw)
    return t


def cell(name: str, config: dict) -> core.Cell:
    """The cell ``name`` of BENCHMARK.json with a tiny configuration and
    tiny traffic, and the cell's own limits."""
    real = core.load_cell(name)
    return core.Cell(name, 1, copy.deepcopy(config), traffic(name.split(".", 1)[1]),
                     real.limits, real.end_to_end, real.per_layer)
