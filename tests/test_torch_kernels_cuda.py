"""The port's CUDA flash-attention kernels (forward, dQ and dK/dV
backward) against their plain PyTorch versions, on the card. Every test here is marked ``cuda`` and skips
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
