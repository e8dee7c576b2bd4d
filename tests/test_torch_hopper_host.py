"""Host-side code of the Hopper attention kernels, on CPU tensors: the
tensor-map arguments the wrappers hand to csrc/hopper_common.cuh
(dims, byte strides, box, swizzle) for contiguous, fused-kv, fused-qkv
and int8 operands, the refusal of what TMA cannot take, and the int8
key scales' row layout."""

import pytest
import torch

from longcat_video_tta_tpu_torch.ops import bsa
from longcat_video_tta_tpu_torch.ops import flash_attention as fa


@pytest.mark.parametrize("D", [32, 64, 128])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_map_of_contiguous_operand(D, dtype):
    B, S, H = 2, 300, 3
    x = torch.zeros((B, S, H, D), dtype=dtype)
    m = fa.tma_map_args(x)
    row = 2 * D
    assert m["dims"] == (D, H, S, B)
    assert m["strides"] == (row, H * row, S * H * row)
    sw = min(row, 128)  # a 256-byte row (D 128) is two 64-column boxes
    assert m["swizzle"] == sw
    assert m["box"] == (sw // 2, 1, 128, 1)


def test_map_of_fused_kv_views():
    """k, v sliced out of a [B, Sk, 2, H, D] projection: token stride
    2 H D values, no copy."""
    B, Sk, H, D = 2, 512, 4, 128
    kv = torch.zeros((B, Sk, 2, H, D), dtype=torch.bfloat16)
    k, v = kv[:, :, 0], kv[:, :, 1]
    mk, mv = fa.tma_map_args(k), fa.tma_map_args(v)
    assert mk["strides"] == mv["strides"] == (2 * D, 2 * 2 * H * D, 2 * Sk * 2 * H * D)
    assert mk["dims"] == mv["dims"] == (D, H, Sk, B)
    assert v.data_ptr() - k.data_ptr() == H * D * 2


def test_map_of_fused_qkv_views():
    B, S, H, D = 3, 150, 4, 64
    qkv = torch.zeros((B, S, 3, H, D), dtype=torch.float16)
    maps = [fa.tma_map_args(qkv[:, :, i]) for i in range(3)]
    for m in maps:
        assert m["strides"] == (2 * D, 2 * 3 * H * D, 2 * S * 3 * H * D)
        assert m["box"] == (64, 1, 128, 1) and m["swizzle"] == 128


@pytest.mark.parametrize("D,sw", [(32, 32), (64, 64), (128, 128)])
def test_map_of_int8_operand(D, sw):
    """int8 q/k rows are D bytes: a 32-, 64- or 128-byte swizzle, one box."""
    x = torch.zeros((2, 200, 3, D), dtype=torch.int8)
    m = fa.tma_map_args(x)
    assert m["strides"] == (D, 3 * D, 200 * 3 * D)
    assert m["swizzle"] == sw and m["box"] == (sw, 1, 128, 1)


def test_single_batch_map_has_a_valid_batch_stride():
    """A size-1 batch's stride is never stepped; the map gets S token
    strides, whatever torch reports for it."""
    x = torch.zeros((1, 70, 2, 64), dtype=torch.bfloat16).as_strided(
        (1, 70, 2, 64), (3, 128, 64, 1))
    assert fa.tma_map_args(x)["strides"] == (128, 256, 70 * 256)


def test_refuses_what_tma_cannot_take():
    x = torch.zeros((2, 16, 2, 64), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="contiguous"):
        fa.tma_map_args(x.transpose(1, 2).contiguous().transpose(1, 2))
    # a token stride of 129 values: 258 bytes, not a multiple of 16
    odd = torch.zeros(2 * 16 * 129, dtype=torch.bfloat16).as_strided(
        (2, 16, 2, 64), (16 * 129, 129, 64, 1))
    with pytest.raises(ValueError, match="multiples of 16"):
        fa.tma_map_args(odd)
    # a base address 2 bytes past an aligned one
    flat = torch.zeros(2 * 16 * 128 + 8, dtype=torch.bfloat16)
    shifted = flat[1:1 + 2 * 16 * 128].view(2, 16, 2, 64)
    with pytest.raises(ValueError, match="multiples of 16"):
        fa.tma_map_args(shifted)


def test_flash_wrapper_states_the_alignment_tma_needs():
    flat = torch.zeros(2 * 16 * 128 + 8, dtype=torch.bfloat16)
    q = flat[1:1 + 2 * 16 * 128].view(2, 16, 2, 64)
    with pytest.raises(ValueError, match="TMA"):
        fa._check_operand("q", q, 64)


def test_key_scales_rows():
    """[B, Sk, H, 1] scales -> [B*H, ld] rows, key j of (b, h) at column
    j, ld a multiple of 4 (16-byte rows), zero padding."""
    B, Sk, H = 2, 9, 3
    ks = torch.arange(B * Sk * H, dtype=torch.float32).reshape(B, Sk, H, 1)
    rows, ld = bsa._key_scales(ks)
    assert ld == 12 and rows.shape == (B * H, ld) and rows.is_contiguous()
    for b in range(B):
        for h in range(H):
            assert torch.equal(rows[b * H + h, :Sk], ks[b, :, h, 0])
    assert float(rows[:, Sk:].abs().sum()) == 0.0


@pytest.mark.parametrize("B,Sq,H", [(1, 10, 3), (2, 12, 2), (3, 1, 1), (1, 77, 4)])
def test_backward_rows_layout(B, Sq, H):
    """[B, Sq, H] lse and delta -> [2, B*H, ld] fp32 rows: lse in log2
    units and delta of (b, h) at row b*H + h, query i at column i, ld Sq
    rounded up to 4 (16-byte rows), zero padding."""
    g = torch.Generator().manual_seed(B * 100 + Sq)
    lse = torch.randn((B, Sq, H), generator=g)
    delta = torch.randn((B, Sq, H), generator=g)
    rows, ld = fa.backward_rows(lse, delta)
    assert ld % 4 == 0 and Sq <= ld < Sq + 4 and (ld * 4) % 16 == 0
    assert rows.shape == (2, B * H, ld) and rows.dtype == torch.float32
    assert rows.is_contiguous()
    for b in range(B):
        for h in range(H):
            torch.testing.assert_close(rows[0, b * H + h, :Sq], lse[b, :, h] * fa.LOG2E,
                                       rtol=0, atol=0)
            assert torch.equal(rows[1, b * H + h, :Sq], delta[b, :, h])
    assert float(rows[:, :, Sq:].abs().sum()) == 0.0


def test_backward_rows_of_a_row_with_no_key():
    """lse = -1e30 (a row that sees no key) stays finite in log2 units."""
    lse = torch.full((1, 5, 2), fa.NEG_INF)
    rows, _ = fa.backward_rows(lse, torch.zeros_like(lse))
    assert torch.isfinite(rows).all() and float(rows[0, :, :5].max()) < -1e30


@pytest.mark.parametrize("kw", [dict(), dict(num_cond_tokens=9),
                                dict(num_cond_tokens=9, kv_valid_len=20)])
@pytest.mark.parametrize("Sq", [30, 32])
def test_delta_in_the_row_layout_gives_the_reference_gradients(kw, Sq):
    """delta = rowsum(dO * O) as FlashAttentionFunction.backward sums it
    straight into the rows (from do and o, bf16 as on the card), read
    back, is the delta attention_backward_reference computes: the same
    rows as from that delta, and the same gradients to the last bit; the
    lse row read back in natural units matches to fp32 rounding."""
    g = torch.Generator().manual_seed(7)
    q, k, v, do = (torch.randn((2, Sq, 3, 32), generator=g).to(torch.bfloat16)
                   for _ in range(4))
    o, lse = fa.attention_reference(q, k, v, **kw)
    rows, ld = fa.backward_rows(lse, do=do, o=o)
    ref_delta = (do.float() * o.float()).sum(-1)
    assert torch.equal(rows, fa.backward_rows(lse, ref_delta)[0])
    B, _, H, _ = q.shape
    back = rows.view(2, B, H, ld)[..., :Sq].permute(0, 1, 3, 2)
    delta = back[1]
    torch.testing.assert_close(back[0] / fa.LOG2E, lse, rtol=1e-6, atol=0)
    ref = fa.attention_backward_reference(q, k, v, o, lse, do, **kw)
    got = fa._backward_reference_from_delta(q, k, v, do, lse, delta, **kw)
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
