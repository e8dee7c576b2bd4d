"""The op and byte counters: hand counts at each cell's shapes (the
prefix mask included), and the products' FLOPs against what the program
runs at tiny size (torch's FLOP counter over its CPU path)."""

import json
import os

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import core, kernels
from benchmark.backbones import cogvideox as cv_backbone
from benchmark.backbones import longcat as lc_backbone
from benchmark.opcount import cogvideox as cv_count
from benchmark.opcount import longcat as lc_count

from .tiny import COGVIDEOX, LONGCAT

GEO = dict(nhw=30 * 52, cond_latents=4, train_latents=3, val_latents=1, gen_latents=8,
           anchor_rows=6)


def _cfg(name):
    with open(os.path.join(core.BENCH_DIR, "configs", name + ".json")) as f:
        return json.load(f)


def test_allowed_pairs_prefix_rule():
    # 6240 conditioning tokens see only themselves; the 4680 train tokens see all 10920
    assert kernels.allowed_pairs(10920, 10920, 6240) == 6240 * 6240 + 4680 * 10920
    assert kernels.allowed_pairs(12480, 18720, 0) == 12480 * 18720
    assert kernels.allowed_pairs(8, 8, 3, kv_valid=6) == 3 * 3 + 5 * 6


def test_longcat_cells_hand_counts():
    c = _cfg("longcat_video_13b")
    D, F, L, depth = 4096, 11008, 512, 12
    # qkv, proj, cross q and proj, the SwiGLU ffn
    per_token_block = 2 * (3 * D * D + D * D + D * D + D * D + 3 * D * F)
    # a CFG step: 2 x 12480 tokens against 6240 cached + 12480 fresh keys
    w = lc_count.denoise_step(c, GEO)
    attn = depth * 4 * 2 * 32 * 128 * (12480 * 18720 + 12480 * 512)
    lin = (depth * (2 * 12480 * per_token_block + 2 * 2 * L * D * 2 * D + 2 * 2 * 8 * 512 * 6 * D)
           + 2 * 2 * 12480 * (64 * D + D * 64) + 2 * 2 * 8 * (256 * 512 + 512 * 512 + 512 * 2 * D)
           + 2 * 2 * L * (4096 * D + D * D))
    assert w.flops == pytest.approx(attn + lin, rel=1e-12)
    assert [l.kernel for l in w.launches].count("flash_fwd") == 2 * depth
    # a train step: the prefix-masked self-attention, forward and both backward kernels
    w = lc_count.train_step(c, GEO)
    pairs = 6240 * 6240 + 4680 * 10920
    self_attn = (4 + 6 + 8) * 32 * 128 * pairs
    cross = (4 + 6) * 32 * 128 * 10920 * 512
    assert w.attention_flops() == pytest.approx(depth * (self_attn + cross), rel=1e-12)
    kinds = [l.kernel for l in w.launches]
    assert kinds.count("flash_bwd_dkv") == depth and kinds.count("flash_bwd_dq") == 2 * depth


def test_cogvideox_cell_hand_counts():
    c = _cfg("cogvideox_5b_i2v")
    w = cv_count.train_step(c, GEO)
    S = 226 + 7 * 1560
    assert S == 11146
    D = 3072
    block = 2 * S * (4 * D * D + 2 * 4 * D * D) * 2 + 2 * 2 * 512 * 6 * D * 2  # fwd + input grads
    attn = (4 + 6 + 8) * 48 * 64 * S * S
    other = 2 * (7 * 1560 * 128 * D + 226 * 4096 * D + D * 512 + 512 * 512) \
        + 2 * 2 * (512 * 2 * D + 7 * 1560 * D * 64)
    assert w.flops == pytest.approx(42 * (block + attn) + other, rel=1e-12)
    a = cv_count.anchor(c, GEO)
    assert sum(l.kernel == "flash_fwd" for l in a.launches) == 6 * 42
    assert {(l.Sq, l.Sk) for l in a.launches} == {(226 + 5 * 1560,) * 2}


def test_least_time_is_the_larger_bound():
    peaks = {"bf16_flops": 1e12, "int8_ops": 2e12, "hbm_bytes_per_s": 1e9}
    l = kernels.Launch("flash_fwd", 1, 1, 8, 8, 64)
    ops = 4 * 64 * 64 / 1e12
    nbytes = (2 * 8 * 64 + 2 * 8 * 64) * 2 + 8 * 4
    assert kernels.least_s(l, peaks) == max(ops, nbytes / 1e9)


def _mm_flops(fn) -> float:
    with FlopCounterMode(display=False) as fc:
        fn()
    counts = fc.get_flop_counts()["Global"]
    return float(sum(v for op, v in counts.items() if "mm" in str(op) and "bmm" not in str(op)))


@pytest.mark.parametrize("backbone", ["longcat", "cogvideox"])
def test_products_match_the_program_at_tiny_size(backbone):
    """The op count's products (attention aside) equal the matrix products
    the program runs, forward and the delta_a backward (remat off, so no
    recomputation is counted)."""
    cfg = dict(LONGCAT if backbone == "longcat" else COGVIDEOX, remat_policy=None)
    mod = lc_backbone if backbone == "longcat" else cv_backbone
    count = lc_count if backbone == "longcat" else cv_count
    m = mod.build(cfg, 0, "cpu")
    geo = dict(nhw=4 * 6, cond_latents=2, train_latents=1, val_latents=1, anchor_rows=2)
    g = torch.Generator().manual_seed(0)
    L, dim = m.text_shape
    text = torch.randn(1, L, dim, generator=g)
    mask = torch.ones(1, L, dtype=torch.int32)
    cond, tgt = torch.randn(1, 16, 2, 8, 12, generator=g), torch.randn(1, 16, 1, 8, 12, generator=g)
    noise = torch.randn(1, 16, 3 if backbone == "cogvideox" else 1, 8, 12, generator=g)
    delta = torch.zeros(cfg.get("adaln_tembed_dim", cfg.get("time_embed_dim")), requires_grad=True)

    def step():
        with torch.enable_grad():
            loss = m.arch.loss(m.dit, cond, tgt, text, mask, adapters={"delta_t": delta},
                               sigma=torch.tensor([0.5]), noise=noise)
            torch.autograd.grad(loss, [delta])

    w = count.train_step(cfg, geo)
    assert _mm_flops(step) == pytest.approx(w.flops - w.attention_flops(), rel=1e-9)
    fixed = torch.randn(1, 1, 16, 1, 8, 12, generator=g)
    w = count.anchor(cfg, geo)
    with torch.no_grad():
        got = _mm_flops(lambda: m.arch.anchor(m.dit, cond, tgt, text, mask, fixed,
                                              fixed_sigmas=(0.25, 0.5)))
    assert got == pytest.approx(w.flops - w.attention_flops(), rel=1e-9)
