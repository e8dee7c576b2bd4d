"""The port's CUDA attention kernels (the wgmma forward, the wgmma dQ and
dK/dV backward, the block-sparse kernels, the q/k prologue) against their
plain PyTorch versions, on the card. Every test here is marked ``cuda`` and skips
without a GPU. The file imports no JAX, so it runs on the card machine,
which has none:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py

(``--noconftest``: tests/conftest.py imports JAX for the reference
tests.) Tolerance, set by the reference's own scale as in chip_smoke.py,
with eps the dtype's machine epsilon (bf16 2^-7, fp16 2^-10):
max|o - o_ref| <= 2 eps max|o_ref| (the two roundings of the 16-bit
output, plus P rounded at another running max), ||o - o_ref||_2 <=
eps ||o_ref||_2, and 1e-3 abs on the fp32 lse. Backward, per output d
of (dq, dk, dv) against ``attention_backward_reference`` on the same
o, lse and do: max|d - d_ref| <= 4 eps max|d_ref| and ||d - d_ref||_2 <=
2 eps ||d_ref||_2 (the output roundings, plus P and dS rounded to 16 bits
at fp32 values that differ in the last bits, in the kernels and in the
plain version alike).
"""

import numpy as np
import pytest
import torch

from longcat_video_tta_tpu_torch.ops import flash_attention as fa
from longcat_video_tta_tpu_torch.ops import qk_norm as qn
from longcat_video_tta_tpu_torch.ops.layers import apply_rope, rms_norm

# (B, H, Sq, Sk, D, num_cond_tokens, kv_valid_len, q_offset, k_offset)
CASES = {
    "d32_square": (2, 2, 64, 64, 32, 0, None, 0, 0),
    "d64_ragged": (1, 3, 100, 100, 64, 0, None, 0, 0),
    "d128_decode": (1, 2, 96, 160, 128, 0, None, 0, 0),
    "cond_prefix": (2, 2, 120, 120, 32, 37, None, 0, 0),
    "cond_prefix_d128": (1, 2, 136, 136, 128, 64, None, 0, 0),
    # a first query tile of conditioning rows only (it stops at the
    # first noise key tile), a mixed tile, and a noise-only tile
    "cond_prefix_multi_tile": (1, 2, 300, 300, 64, 200, None, 0, 0),
    "cross_text": (2, 2, 72, 16, 64, 0, None, 0, 0),
    "kv_valid": (1, 2, 80, 200, 64, 0, 130, 0, 0),
    "kv_valid_cond": (1, 2, 144, 144, 32, 40, 100, 0, 0),
    "q_offset": (1, 2, 96, 96, 128, 100, None, 64, 0),
    "k_offset_kv_valid": (1, 2, 96, 96, 64, 100, 150, 32, 96),
    # the 128-key tiles of the wgmma kernel: Sk not a multiple of 128, a
    # prefix that ends inside a key tile (all-conditioning, mixed and
    # noise query tiles), kv_valid inside a tile, and no visible key
    "sk_not_tile_multiple_d128": (2, 2, 130, 300, 128, 0, None, 0, 0),
    "ncond_inside_key_tile": (1, 2, 400, 400, 64, 200, None, 0, 0),
    "kv_valid_inside_tile_d128": (2, 2, 150, 400, 128, 0, 333, 0, 0),
    "no_visible_key": (1, 2, 64, 64, 64, 0, 0, 0, 0),
}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.device("cuda")


def _assert_close(o, lse, o_r, lse_r):
    eps = torch.finfo(o.dtype).eps
    d, ref = o.float() - o_r.float(), o_r.float()
    assert float(d.abs().max()) <= 2 * eps * float(ref.abs().max())
    assert float(d.norm()) <= eps * float(ref.norm())
    assert float((lse - lse_r).abs().max()) <= 1e-3


def _inputs(B, H, Sq, Sk, D, dtype, device, seed):
    g = torch.Generator(device=device).manual_seed(seed)
    return [torch.randn(shape, generator=g, device=device).to(dtype)
            for shape in ((B, Sq, H, D), (B, Sk, H, D), (B, Sk, H, D))]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("case", list(CASES))
def test_kernel_matches_plain_version(card, case, dtype):
    B, H, Sq, Sk, D, ncond, kv_valid, q_off, k_off = CASES[case]
    q, k, v = _inputs(B, H, Sq, Sk, D, dtype, card, seed=5)
    kw = dict(num_cond_tokens=ncond, kv_valid_len=kv_valid, q_offset=q_off,
              k_offset=k_off)
    fa.reset_launches()
    o, lse = fa.flash_attention(q, k, v, **kw)
    assert fa.launches == 1
    o_r, lse_r = fa.attention_reference(q, k, v, **kw)
    torch.cuda.synchronize()
    assert o.dtype == dtype and lse.dtype == torch.float32
    _assert_close(o, lse, o_r, lse_r)


@pytest.mark.cuda
def test_kernel_takes_strided_kv_views(card):
    """k, v sliced out of a fused [B, S, 2, H, D] projection (the
    cross-attention layout) need no copy."""
    g = torch.Generator(device=card).manual_seed(1)
    q = torch.randn((2, 70, 4, 64), generator=g, device=card).bfloat16()
    kv = torch.randn((2, 33, 2, 4, 64), generator=g, device=card).bfloat16()
    k, v = kv[:, :, 0], kv[:, :, 1]
    o, lse = fa.flash_attention(q, k, v)
    o_r, lse_r = fa.attention_reference(q, k, v)
    torch.cuda.synchronize()
    _assert_close(o, lse, o_r, lse_r)


@pytest.mark.cuda
def test_kernel_raises_on_what_it_does_not_take(card):
    q = torch.zeros((1, 8, 2, 32), device=card)
    with pytest.raises(TypeError, match="bf16 or fp16"):
        fa.flash_attention(q, q, q)
    q = torch.zeros((1, 8, 2, 48), device=card, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_attention(q, q, q)
    q = torch.zeros((1, 8, 2, 64), device=card, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_attention(q, q.transpose(1, 2).contiguous().transpose(1, 2), q)
    assert np.isfinite(float(fa.flash_attention(q, q, q)[1].sum()))


def _assert_grad_close(name, d, d_r):
    eps = torch.finfo(d.dtype).eps
    diff, ref = d.float() - d_r.float(), d_r.float()
    assert torch.isfinite(d).all(), name
    assert float(diff.abs().max()) <= 4 * eps * float(ref.abs().max()), name
    assert float(diff.norm()) <= 2 * eps * float(ref.norm()), name


def _backward_both(q, k, v, do, kw):
    """The kernels' (dq, dk, dv) and the plain version's, from one
    forward."""
    o, lse = fa.flash_attention(q, k, v, **kw)
    delta = (do.float() * o.float()).sum(-1)
    fa.reset_launches()
    dq = fa.flash_attention_bwd_dq(q, k, v, do, lse, delta, **kw)
    dk, dv = fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta, **kw)
    assert (fa.bwd_dq_launches, fa.bwd_dkv_launches) == (1, 1)
    ref = fa.attention_backward_reference(q, k, v, o, lse, do, **kw)
    torch.cuda.synchronize()
    return (dq, dk, dv), ref


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("case", list(CASES))
def test_backward_kernels_match_plain_version(card, case, dtype):
    B, H, Sq, Sk, D, ncond, kv_valid, q_off, k_off = CASES[case]
    q, k, v = _inputs(B, H, Sq, Sk, D, dtype, card, seed=11)
    do = _inputs(B, H, Sq, Sq, D, dtype, card, seed=12)[0]
    kw = dict(num_cond_tokens=ncond, kv_valid_len=kv_valid, q_offset=q_off,
              k_offset=k_off)
    got, ref = _backward_both(q, k, v, do, kw)
    for name, d, d_r in zip(("dq", "dk", "dv"), got, ref):
        assert d.dtype == dtype and d.shape == d_r.shape
        _assert_grad_close(name, d, d_r)


# The tiles of the wgmma backward kernels: dK/dV CTAs of 128 keys walk
# 64-query tiles, dQ CTAs of 128 rows walk 128-key tiles.
# (B, H, Sq, Sk, D, num_cond_tokens, kv_valid_len, q_offset, k_offset)
BWD_CASES = {
    # Sq and Sk not multiples of 64 or 128
    "ragged_sq_sk_d64": (1, 3, 200, 333, 64, 0, None, 0, 0),
    "ragged_sq_sk_d32_b2": (2, 2, 70, 190, 32, 0, None, 0, 0),
    # ncond 100 inside query tile 1 (64-127) and key tile 0 (0-127)
    "ncond_straddles_tiles_d128": (2, 2, 300, 300, 128, 100, None, 0, 0),
    # dQ CTAs 0, 1 all conditioning (they stop at key tile 2), CTA 2
    # mixed; dK/dV CTAs 3, 4 all noise (they start at query tile 4)
    "cond_and_noise_ctas_d64": (1, 2, 520, 520, 64, 260, None, 0, 0),
    "kv_valid_inside_tile_d128": (2, 2, 150, 400, 128, 0, 333, 0, 0),
    "kv_valid_zero_ragged_d32": (1, 2, 90, 90, 32, 0, 0, 0, 0),
    "prefix_kv_valid_offsets_d64": (1, 2, 200, 200, 64, 150, 170, 64, 32),
}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("case", list(BWD_CASES))
def test_backward_kernels_at_the_tile_edges(card, case, dtype):
    B, H, Sq, Sk, D, ncond, kv_valid, q_off, k_off = BWD_CASES[case]
    q, k, v = _inputs(B, H, Sq, Sk, D, dtype, card, seed=16)
    do = _inputs(B, H, Sq, Sq, D, dtype, card, seed=17)[0]
    kw = dict(num_cond_tokens=ncond, kv_valid_len=kv_valid, q_offset=q_off,
              k_offset=k_off)
    got, ref = _backward_both(q, k, v, do, kw)
    for name, d, d_r in zip(("dq", "dk", "dv"), got, ref):
        assert d.dtype == dtype and d.shape == d_r.shape
        _assert_grad_close(name, d, d_r)
        if kv_valid == 0:
            assert float(d.abs().max()) == 0.0, name


@pytest.mark.cuda
@pytest.mark.parametrize("D", [32, 64, 128])
def test_backward_kernels_take_fused_kv_views(card, D):
    """k, v sliced out of a fused [B, Sk, 2, H, D] projection (the
    cross-attention layout), Sk not a multiple of 128."""
    g = torch.Generator(device=card).manual_seed(D)
    q = torch.randn((2, 130, 2, D), generator=g, device=card).bfloat16()
    kv = torch.randn((2, 300, 2, 2, D), generator=g, device=card).bfloat16()
    do = torch.randn((2, 130, 2, D), generator=g, device=card).bfloat16()
    got, ref = _backward_both(q, kv[:, :, 0], kv[:, :, 1], do, {})
    for name, d, d_r in zip(("dq", "dk", "dv"), got, ref):
        _assert_grad_close(name, d, d_r)


@pytest.mark.cuda
def test_backward_row_with_no_visible_key_is_zero(card):
    """kv_valid 0: lse = -1e30 for every row; every gradient is exactly
    0 (the mask selects P = 0, never exp(inf) * 0)."""
    q, k, v = _inputs(1, 2, 64, 64, 64, torch.bfloat16, card, seed=13)
    do = _inputs(1, 2, 64, 64, 64, torch.bfloat16, card, seed=14)[0]
    got, _ = _backward_both(q, k, v, do, dict(kv_valid_len=0))
    for d in got:
        assert torch.isfinite(d).all() and float(d.abs().max()) == 0.0


@pytest.mark.cuda
def test_backward_kernels_take_strided_views(card):
    """q, k, v sliced out of a fused [B, S, 3, H, D] projection (the
    self-attention layout) need no copy in the backward either."""
    g = torch.Generator(device=card).manual_seed(3)
    qkv = torch.randn((1, 150, 3, 4, 128), generator=g, device=card).bfloat16()
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    do = torch.randn((1, 150, 4, 128), generator=g, device=card).bfloat16()
    got, ref = _backward_both(q, k, v, do, dict(num_cond_tokens=70))
    for name, d, d_r in zip(("dq", "dk", "dv"), got, ref):
        _assert_grad_close(name, d, d_r)


@pytest.mark.cuda
def test_function_backward_uses_the_kernels(card):
    """FlashAttentionFunction on CUDA tensors: dQ always, dK/dV only when
    k or v needs a gradient (cross-attention's frozen text path)."""
    q, k, v = _inputs(1, 2, 96, 40, 64, torch.bfloat16, card, seed=15)
    q.requires_grad_(True)
    fa.reset_launches()
    o = fa.FlashAttentionFunction.apply(q, k, v, 0, None, None, 0, 0)
    o.float().square().sum().backward()
    assert (fa.launches, fa.bwd_dq_launches, fa.bwd_dkv_launches) == (1, 1, 0)
    k.requires_grad_(True)
    fa.reset_launches()
    o = fa.FlashAttentionFunction.apply(q, k, v, 0, None, None, 0, 0)
    o.float().square().sum().backward()
    assert (fa.launches, fa.bwd_dq_launches, fa.bwd_dkv_launches) == (1, 1, 1)
    assert v.grad is None and torch.isfinite(k.grad).all()


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["ragged_sq_sk_d32_b2", "ncond_straddles_tiles_d128",
                                  "prefix_kv_valid_offsets_d64"])
def test_function_backward_matches_plain_version(card, case):
    """The autograd backward (delta summed straight into its rows, then the
    wrappers' entry into each kernel) against the plain backward, at
    tile-edge shapes; Sq 70 leaves padding in the rows."""
    B, H, Sq, Sk, D, ncond, kv_valid, q_off, k_off = BWD_CASES[case]
    q, k, v = _inputs(B, H, Sq, Sk, D, torch.bfloat16, card, seed=18)
    do = _inputs(B, H, Sq, Sq, D, torch.bfloat16, card, seed=19)[0]
    kw = dict(num_cond_tokens=ncond, kv_valid_len=kv_valid, q_offset=q_off,
              k_offset=k_off)
    leaves = [x.detach().requires_grad_(True) for x in (q, k, v)]
    fa.reset_launches()
    o = fa.FlashAttentionFunction.apply(*leaves, ncond, kv_valid, None, q_off, k_off)
    o.backward(do)
    assert (fa.launches, fa.bwd_dq_launches, fa.bwd_dkv_launches) == (1, 1, 1)
    o_r, lse = fa.flash_attention(q, k, v, **kw)
    ref = fa.attention_backward_reference(q, k, v, o_r, lse, do, **kw)
    for name, x, d_r in zip(("dq", "dk", "dv"), leaves, ref):
        _assert_grad_close(name, x.grad, d_r)


# ---------------------------------------------------------------------------
# Block-sparse attention (csrc/bsa.cu): kernel 4 (block sums) and kernel 5
# (gathered attention, 16-bit and int8 QK^T) against their plain versions
# on the same selection. 16-bit gates as the forward kernel's; int8-QK
# gates 4 eps max and 2 eps L2 with eps = 2^-7 whatever the output dtype
# (p is rounded to bf16 at the kernel's running maximum and at the plain
# version's row maximum: up to |s - m| * 2^-9 relative per p). Block sums:
# 1e-5 of the block's sum of |x| (fp32, another summation order).
# ---------------------------------------------------------------------------

from longcat_video_tta_tpu_torch.ops import bsa  # noqa: E402
from longcat_video_tta_tpu_torch.ops import quant  # noqa: E402

# (B, H, Sq, Sk, D, top_k, block_q, block_k, num_cond_tokens, kv_valid)
BSA_CASES = {
    "d128_blocks128": (1, 2, 256, 640, 128, 3, 128, 128, 128, None),
    "ragged_sq_sk": (1, 3, 200, 333, 64, 3, 128, 64, 64, None),
    "kv_valid": (2, 2, 256, 640, 128, 4, 128, 128, 128, 400),
    "d32_blocks32": (2, 2, 96, 160, 32, 3, 32, 32, 32, None),
    "d64_blocks512": (1, 2, 1000, 2600, 64, 4, 512, 512, 1024, None),
    "no_valid_key": (1, 2, 64, 128, 64, 2, 32, 64, 0, 0),
    # 64-row q-blocks: each 128-row query tile stores its first 64 rows
    "blocks_q64_ragged": (1, 2, 200, 640, 64, 3, 64, 128, 128, None),
}


@pytest.mark.cuda
@pytest.mark.parametrize("qk_int8", [False, True])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("case", list(BSA_CASES))
def test_bsa_kernel_matches_plain_version(card, case, dtype, qk_int8):
    B, H, Sq, Sk, D, top_k, bq, bk, ncond, kvv = BSA_CASES[case]
    q, k, v = _inputs(B, H, Sq, Sk, D, dtype, card, seed=21)
    idx = bsa.select_blocks(q, k, block_q=bq, block_k=bk, top_k=top_k,
                            num_cond_tokens=ncond, q_token_offset=Sk - Sq, kv_valid=kvv)
    kw = dict(block_q=bq, block_k=bk, kv_valid=kvv, qk_int8=qk_int8)
    bsa.reset_launches()
    o = bsa.bsa_forward(q, k, v, idx, **kw)
    assert (bsa.bsa_int8_launches, bsa.bsa_launches) == ((1, 0) if qk_int8 else (0, 1))
    o_r = bsa.bsa_reference(q, k, v, idx, **kw)
    torch.cuda.synchronize()
    assert o.dtype == dtype and o.shape == q.shape
    eps = 2.0 ** -7 if qk_int8 else torch.finfo(dtype).eps
    mx, l2 = (4, 2) if qk_int8 else (2, 1)
    d, ref = o.float() - o_r.float(), o_r.float()
    assert torch.isfinite(o).all()
    assert float(d.abs().max()) <= mx * eps * float(ref.abs().max())
    assert float(d.norm()) <= l2 * eps * float(ref.norm())


@pytest.mark.cuda
@pytest.mark.parametrize("qk_int8", [False, True])
def test_bsa_kernel_skips_negative_idx_entries(card, qk_int8):
    """A -1 entry of idx selects no block: the kernel's output equals
    the plain version over the other entries."""
    B, H, Sq, Sk, D = 1, 2, 256, 1024, 128
    q, k, v = _inputs(B, H, Sq, Sk, D, torch.bfloat16, card, seed=25)
    idx = bsa.select_blocks(q, k, block_q=128, block_k=128, top_k=4, q_token_offset=0)
    holed = idx.clone()
    holed[:, :, 1] = -1
    kw = dict(block_q=128, block_k=128, qk_int8=qk_int8)
    o = bsa.bsa_forward(q, k, v, holed, **kw)
    o_r = bsa.bsa_reference(q, k, v, idx[:, :, [0, 2, 3]].contiguous(), **kw)
    torch.cuda.synchronize()
    eps = 2.0 ** -7
    mx, l2 = (4, 2) if qk_int8 else (2, 1)
    d, ref = o.float() - o_r.float(), o_r.float()
    assert float(d.abs().max()) <= mx * eps * float(ref.abs().max())
    assert float(d.norm()) <= l2 * eps * float(ref.norm())


@pytest.mark.cuda
def test_bsa_all_blocks_equals_the_forward_kernel(card):
    q, k, v = _inputs(1, 2, 300, 500, 128, torch.bfloat16, card, seed=22)
    o = bsa.bsa_attention(q, k, v, top_k=4, block_q=128, block_k=128)
    o_fa, _ = fa.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert float((o.float() - o_fa.float()).abs().max()) <= \
        2 * 2.0 ** -7 * float(o_fa.float().abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("S,bs,dtype", [(12480, 1024, torch.bfloat16),
                                        (1000, 384, torch.float16),
                                        (150, 32, torch.bfloat16)])
def test_block_sum_kernel_matches_plain_version(card, S, bs, dtype):
    g = torch.Generator(device=card).manual_seed(23)
    x = torch.randn((2, S, 4, 64), generator=g, device=card).to(dtype)
    bsa.reset_launches()
    s = bsa._block_sum(x, bs)
    assert bsa.bsa_block_sum_launches == 1
    ref = bsa.block_sum_reference(x, bs)
    scale = bsa.block_sum_reference(x.abs(), bs)
    assert bool(((s - ref).abs() <= 1e-5 * scale + 1e-6).all())


@pytest.mark.cuda
def test_bsa_kernel_raises_on_what_it_does_not_take(card):
    q, k, v = _inputs(1, 2, 64, 128, 64, torch.bfloat16, card, seed=24)
    idx = bsa.select_blocks(q, k, block_q=32, block_k=64, top_k=2)
    with pytest.raises(ValueError, match="multiple of 32"):
        bsa.bsa_forward(q, k, v, idx, block_q=48, block_k=64)
    with pytest.raises(ValueError, match="idx"):
        bsa.bsa_forward(q, k, v, idx.long(), block_q=32, block_k=64)
    with pytest.raises(TypeError, match="bf16 or fp16"):
        bsa.bsa_forward(q.float(), k.float(), v.float(), idx, block_q=32, block_k=64)


@pytest.mark.cuda
@pytest.mark.parametrize("M", [5, 17, 300])
def test_int8_linear_on_the_card(card, M):
    """cuBLASLt's int8 GEMM (torch._int_mm) takes the [N, K] weight
    transposed (column-major) and M > 16; int8_linear pads a small M. Its
    int32 product is exact, so the card matches the CPU up to the fp32
    rescale."""
    lin = torch.nn.Linear(64, 192)
    layer = quant.Int8Linear.from_linear(lin)
    x = torch.randn(1, M, 64)
    ref = quant.int8_linear(layer, x)
    out = quant.int8_linear(layer.to(card), x.to(card))
    torch.cuda.synchronize()
    assert out.shape == ref.shape
    assert float((out.cpu() - ref).abs().max()) <= 1e-5 * float(ref.abs().max())


# The Open-Sora v2 MMDiT's joint [txt | img] self-attention: no prefix, no
# key mask, Sq == Sk with ragged tails (8312 = 64 * 128 + 120, 11 432 = 89
# * 128 + 40), 24 heads of 128; serving runs the 3-row triple-CFG batch,
# the anchor eval 1 row of 8312, the train step 1 row of 11 432.
OPENSORA_CASES = {"serve": (3, 8312), "anchor": (1, 8312), "train": (1, 11432)}


def _chunked(fn, q, k, v, *rest, heads=4):
    """A plain version over head chunks (its fp32 S x S of 24 heads at
    these lengths would not fit beside the inputs)."""
    outs = [fn(q[:, :, h:h + heads], k[:, :, h:h + heads], v[:, :, h:h + heads],
               *(x[:, :, h:h + heads] for x in rest)) for h in range(0, q.shape[2], heads)]
    return [torch.cat(parts, dim=2) for parts in zip(*outs)]


def _check_joint(card, B, H, S, D, backward: bool):
    """Unmasked joint self-attention at S x S: the forward kernel, and with
    ``backward`` the dQ and dK/dV kernels, against the plain versions."""
    q, k, v = _inputs(B, H, S, S, D, torch.bfloat16, card, seed=41)
    do = _inputs(B, H, S, S, D, torch.bfloat16, card, seed=42)[0]
    o, lse = fa.flash_attention(q, k, v)
    o_r, lse_r = _chunked(fa.attention_reference, q, k, v)
    _assert_close(o, lse, o_r, lse_r)
    del o_r, lse_r
    if backward:
        delta = (do.float() * o.float()).sum(-1)
        got = (fa.flash_attention_bwd_dq(q, k, v, do, lse, delta),
               *fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta))
        ref = _chunked(fa.attention_backward_reference, q, k, v, o, lse, do)
        for name, d, d_r in zip(("dq", "dk", "dv"), got, ref):
            _assert_grad_close(name, d, d_r)


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(OPENSORA_CASES))
def test_opensora_joint_attention_shapes(card, case):
    B, S = OPENSORA_CASES[case]
    _check_joint(card, B, 24, S, 128, backward=case == "train")


# CogVideoX-5B's joint [text | video] self-attention: 48 heads of 64, no
# mask, ragged tails (8026 = 62 * 128 + 90, 11 146 = 87 * 128 + 10): the
# 2-row CFG serving batch (226 text + 5 latents of 1560 tokens), the anchor
# eval's row of 8026 and the train step's 226 + 7 x 1560
COGVIDEOX_CASES = {"serve": (2, 8026), "anchor": (1, 8026), "train": (1, 11146)}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(COGVIDEOX_CASES))
def test_cogvideox_joint_attention_head_dim_64(card, case):
    B, S = COGVIDEOX_CASES[case]
    _check_joint(card, B, 48, S, 64, backward=case == "train")


# (B, H, S, mlp): a small ragged case, and the serving and train shapes
# at the published widths (3 H D + mlp = 21 504); backward where the path
# runs it
STRIDED_V_CASES = {"small": (2, 2, 300, 1024), "serve": (3, 24, 8312, 12288),
                   "train": (1, 24, 11432, 12288)}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(STRIDED_V_CASES))
def test_opensora_single_block_strided_v(card, case):
    """The single block's v is a view of linear1's fused output (token
    stride 3 H D + mlp); q and k are rope's contiguous tensors: forward and
    both backward kernels take it without a copy."""
    B, H, S, mlp = STRIDED_V_CASES[case]
    D = 128
    g = torch.Generator(device=card).manual_seed(43)
    h = torch.randn((B, S, 3 * H * D + mlp), generator=g, device=card).bfloat16()
    v = h[..., :3 * H * D].reshape(B, S, 3, H, D)[:, :, 2]
    assert v.stride(1) == 3 * H * D + mlp
    q, k, do = (torch.randn((B, S, H, D), generator=g, device=card).bfloat16()
                for _ in range(3))
    o, lse = fa.flash_attention(q, k, v)
    _assert_close(o, lse, *_chunked(fa.attention_reference, q, k, v))
    if case == "serve":
        return
    delta = (do.float() * o.float()).sum(-1)
    got = (fa.flash_attention_bwd_dq(q, k, v, do, lse, delta),
           *fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta))
    ref = _chunked(fa.attention_backward_reference, q, k, v, o, lse, do)
    for name, d, d_r in zip(("dq", "dk", "dv"), got, ref):
        _assert_grad_close(name, d, d_r)


# ---------------------------------------------------------------------------
# The q/k prologue (csrc/qk_norm_rope.cu): per-head RMSNorm and RoPE
# ---------------------------------------------------------------------------
#
# Against the plain version (the same fp32 arithmetic, rounded once): an
# element differs by at most one ulp and few do, max|y - y_ref| <= eps
# max|y_ref| and ||y - y_ref|| <= eps / 4 ||y_ref|| (dx twice both); dw
# (fp32) to 1e-4 relative. Against a float64 evaluation of
# the same math the kernel errs no more than the chain it replaces, in max
# and in mean, to 0.1% (with the rotation off both round the same fp32
# values, and a last-bit difference can flip one rounding either way).

# (B, T, H, D, Tk: None for self-attention with the rotation, lanes, dtype);
# T * H is never a multiple of a CTA's 64 rows
QK_CASES = {
    "d128_rope_odd_rows": (1, 37, 3, 128, None, 0, torch.bfloat16),
    "d64_rope_odd_rows": (2, 45, 5, 64, None, 0, torch.bfloat16),
    "d128_cross": (2, 41, 4, 128, 9, 0, torch.bfloat16),
    "d64_cross_fp16": (1, 50, 3, 64, 7, 0, torch.float16),
    "d128_rope_lanes": (4, 29, 3, 128, None, 2, torch.bfloat16),
    "d64_cross_lanes": (4, 33, 2, 64, 5, 2, torch.bfloat16),
}


def _qk_inputs(card, B, T, H, D, Tk, lanes, dtype, seed):
    """q, k strided views of a fused qkv with cos/sin [T, D/2] (Tk None),
    or q [B, T, H, D] and k a view of a fused kv [B, Tk, 2, H, D]."""
    g = torch.Generator(device=card).manual_seed(seed)
    rnd = lambda *s: (3.0 * torch.randn(s, generator=g, device=card)).to(dtype)
    wshape = (lanes, D) if lanes else (D,)
    wq, wk = ((1.0 + 0.3 * torch.randn(wshape, generator=g, device=card)).to(dtype)
              for _ in range(2))
    if Tk is not None:
        return rnd(B, T, H, D), rnd(B, Tk, 2, H, D)[:, :, 0], wq, wk, None, None
    qkv = rnd(B, T, 3, H, D)
    ang = 60.0 * torch.rand((T, D // 2), generator=g, device=card)
    return qkv[:, :, 0], qkv[:, :, 1], wq, wk, torch.cos(ang), torch.sin(ang)


def _qk_chain(x, w, cos, sin):
    y = rms_norm(x, w)
    if cos is None:
        return y
    return apply_rope(y[:, None], cos[None], sin[None])[:, 0]


def _f64(t):
    return None if t is None else t.double()


def _assert_qk_close(name, got, ref, truth, chain, scale):
    eps = torch.finfo(got.dtype).eps
    d, r = got.float() - ref.float(), ref.float()
    assert float(d.abs().max()) <= scale * eps * float(r.abs().max()), name
    assert float(d.norm()) <= scale * eps / 4 * float(r.norm()), name
    e, e_chain = (got.double() - truth).abs(), (chain.double() - truth).abs()
    assert float(e.max()) <= 1.001 * float(e_chain.max()), name
    assert float(e.mean()) <= 1.001 * float(e_chain.mean()), name


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(QK_CASES))
def test_qk_norm_rope_forward_matches_plain_version(card, case):
    q, k, wq, wk, cos, sin = _qk_inputs(card, *QK_CASES[case], seed=90)
    yq, yk = qn._kernel_forward(q, k, wq, wk, cos, sin, 1e-6)
    for name, x, w, y in (("q", q, wq, yq), ("k", k, wk, yk)):
        y_ref = qn.norm_rope_reference(x, w, cos, sin, 1e-6)
        truth = qn.norm_rope_reference(x.double(), w.double(), _f64(cos), _f64(sin), 1e-6)
        _assert_qk_close(name, y, y_ref, truth, _qk_chain(x, w, cos, sin), 1.0)


@pytest.mark.cuda
@pytest.mark.parametrize("need_w", [False, True])
@pytest.mark.parametrize("case", list(QK_CASES))
def test_qk_norm_rope_backward_matches_plain_version(card, case, need_w):
    q, k, wq, wk, cos, sin = _qk_inputs(card, *QK_CASES[case], seed=91)
    g = torch.Generator(device=card).manual_seed(92)
    dyq, dyk = (torch.randn(x.shape, generator=g, device=card).to(x.dtype) for x in (q, k))
    got = qn._kernel_backward(q, k, wq, wk, cos, sin, dyq, dyk, 1e-6, (True, True),
                              (need_w, need_w))
    for i, (name, x, w, dy) in enumerate((("q", q, wq, dyq), ("k", k, wk, dyk))):
        dx_ref, dw_ref = qn.norm_rope_backward_reference(x, w, cos, sin, dy, 1e-6, need_w)
        truth = qn.norm_rope_backward_reference(x.double(), w.double(), _f64(cos), _f64(sin),
                                                dy.double(), 1e-6, False)[0]
        xl = x.detach().clone().requires_grad_(True)
        (dx_chain,) = torch.autograd.grad(_qk_chain(xl, w, cos, sin), [xl], [dy])
        _assert_qk_close("d" + name, got[i], dx_ref, truth, dx_chain, 2.0)
        if need_w:
            torch.testing.assert_close(got[2 + i], dw_ref.reshape(w.shape), rtol=1e-4,
                                       atol=1e-4 * float(dw_ref.abs().max()))
        else:
            assert got[2 + i] is None


@pytest.mark.cuda
def test_qk_norm_rope_function_uses_the_kernels(card):
    """On CUDA tensors ``qk_norm_rope`` runs one forward launch for q and k
    and one backward launch, with gradients (dq, dk, dwq, dwk) as the
    function's plain versions give them on the CPU."""
    q0, k0, wq0, wk0, cos, sin = _qk_inputs(card, 2, 45, 4, 128, None, 0, torch.bfloat16,
                                            seed=93)
    g = torch.Generator(device=card).manual_seed(94)
    dy = [torch.randn(x.shape, generator=g, device=card).bfloat16() for x in (q0, k0)]
    grads = {}
    for dev in ("cuda", "cpu"):
        ts = [t.detach().to(dev).requires_grad_(True) for t in (q0, k0, wq0, wk0)]
        fwd, bwd = qn.launches, qn.bwd_launches
        if dev == "cuda":
            yq, yk = qn.qk_norm_rope(*ts, cos, sin)
        else:
            yq, yk = qn.QKNormRopeFunction.apply(*ts, cos.cpu(), sin.cpu(), 1e-6)
        torch.autograd.backward([yq, yk], [d.to(dev) for d in dy])
        grads[dev] = [yq, yk] + [t.grad for t in ts]
        if dev == "cuda":
            assert (qn.launches - fwd, qn.bwd_launches - bwd) == (1, 1)
    for name, a, b in zip(("yq", "yk", "dq", "dk", "dwq", "dwk"), grads["cuda"], grads["cpu"]):
        eps = torch.finfo(torch.bfloat16).eps
        d, r = a.float().cpu() - b.float(), b.float()
        assert float(d.abs().max()) <= 2 * eps * float(r.abs().max()), name


@pytest.mark.cuda
def test_qk_norm_rope_without_autograd_launches_the_forward_alone(card):
    """Under no_grad (the sampler, the anchor) the entry launches the
    forward kernel straight, with the function's outputs."""
    q, k, wq, wk, cos, sin = _qk_inputs(card, 2, 45, 4, 128, None, 0, torch.bfloat16,
                                        seed=96)
    fwd, bwd = qn.launches, qn.bwd_launches
    with torch.no_grad():
        yq, yk = qn.qk_norm_rope(q, k, wq, wk, cos, sin)
    assert (qn.launches - fwd, qn.bwd_launches - bwd) == (1, 0)
    assert yq.shape == q.shape and yk.shape == k.shape and yq.is_contiguous()
    fq, fk = qn.QKNormRopeFunction.apply(q, k, wq, wk, cos, sin, 1e-6)
    assert torch.equal(yq, fq) and torch.equal(yk, fk)


@pytest.mark.cuda
def test_qk_norm_rope_raises_on_what_it_does_not_take(card):
    q, k, wq, wk, cos, sin = _qk_inputs(card, 1, 40, 2, 128, None, 0, torch.bfloat16,
                                        seed=95)
    flat = torch.zeros(q.numel() + 1, device=card, dtype=q.dtype)
    with pytest.raises(ValueError):  # rows off 16-byte alignment
        qn._kernel_forward(flat[1:].view(q.shape), k, wq, wk, cos, sin, 1e-6)
    with pytest.raises(ValueError):  # head_dim 48
        qn._kernel_forward(q[..., :48], k[..., :48], wq[:48], wk[:48], None, None, 1e-6)
    with pytest.raises(TypeError):
        qn._kernel_forward(q.float(), k.float(), wq, wk, cos, sin, 1e-6)
