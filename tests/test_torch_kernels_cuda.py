"""The port's CUDA flash-attention kernel against its plain PyTorch
version, on the card. Every test here is marked ``cuda`` and skips
without a GPU. The file imports no JAX, so it runs on the card machine,
which has none:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py

(``--noconftest``: tests/conftest.py imports JAX for the reference
tests.) Tolerance, set by the reference's own scale as in chip_smoke.py,
with eps the dtype's machine epsilon (bf16 2^-7, fp16 2^-10):
max|o - o_ref| <= 2 eps max|o_ref| (the two roundings of the 16-bit
output, plus P rounded at another running max), ||o - o_ref||_2 <=
eps ||o_ref||_2, and 1e-3 abs on the fp32 lse.
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
