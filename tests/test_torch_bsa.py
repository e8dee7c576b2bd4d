"""The port's block-sparse attention and W8A8 ops vs the JAX package, on
the CPU (the port's plain versions; JAX's Pallas kernels in interpret
mode, as tests/test_bsa.py runs them).

Tolerances:
- block sums: 1e-5 abs on sums of ~100 N(0, 1) values (fp32 summation
  order only);
- ``select_blocks``: the indices exactly (ties broken to the lower index,
  as lax.top_k);
- ``bsa_attention`` fp32: 2e-5 abs (the JAX kernel's running maximum vs
  the plain version's row maximum, fp32 rounding); bf16: 2 bf16 ulp of the
  output scale (P is rounded to bf16 at another maximum, then the output
  to bf16); ``qk_int8``: 2e-2 abs (p is rounded to bf16 at an argument
  s - m taken at another maximum: up to |s - m| * 2^-9 relative per p);
- int8 weights and scales: bit-equal; ``int8_linear``: 1e-5 relative to
  the output scale (fp32 products of exact int32 sums).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from longcat_video_tta_tpu.ops import bsa as jbsa
from longcat_video_tta_tpu.ops import quant as jquant
from longcat_video_tta_tpu_torch.ops import bsa
from longcat_video_tta_tpu_torch.ops import quant
from longcat_video_tta_tpu_torch.ops.flash_attention import attention_reference

torch.set_num_threads(1)


def _qkv(seed, B=1, Sq=96, Sk=160, H=2, D=32):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(s).astype(np.float32)
                 for s in ((B, Sq, H, D), (B, Sk, H, D), (B, Sk, H, D)))


@pytest.mark.parametrize("S,bs", [(128, 32), (150, 32), (100, 64), (7, 8)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_block_sum_matches_jax(S, bs, dtype):
    x = np.random.default_rng(S).standard_normal((2, S, 3, 16)).astype(np.float32)
    xj = jnp.asarray(x, getattr(jnp, dtype))
    nb = -(-S // bs)
    ref = jbsa._block_sum(jnp.pad(xj, ((0, 0), (0, nb * bs - S), (0, 0), (0, 0))), bs,
                          interpret=True)
    out = bsa._block_sum(torch.from_numpy(x).to(getattr(torch, dtype)), bs)
    assert bsa.bsa_block_sum_launches == 0 and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5, rtol=0)


SELECT_CASES = {
    # Sq, Sk, block, top_k, cond tokens, kv_valid
    "cond_prefix_diagonal": (64, 192, 32, 4, 64, None),
    "no_prefix": (96, 160, 32, 3, 0, None),
    "ragged_tail": (70, 150, 32, 3, 32, None),
    "kv_valid_demotion": (64, 192, 32, 3, 32, 96),
    "kv_valid_partial_block": (96, 192, 32, 4, 32, 150),
    "wide_blocks": (100, 300, 64, 3, 64, None),
}


@pytest.mark.parametrize("case", list(SELECT_CASES))
def test_select_blocks_matches_jax(case):
    Sq, Sk, blk, top_k, nc, kvv = SELECT_CASES[case]
    q, k, _ = _qkv(1, B=2, Sq=Sq, Sk=Sk)
    kw = dict(block_q=blk, block_k=blk, top_k=top_k, num_cond_tokens=nc,
              q_token_offset=Sk - Sq)
    ref = jbsa.select_blocks(jnp.asarray(q), jnp.asarray(k), interpret=True,
                             kv_valid=None if kvv is None else jnp.int32(kvv), **kw)
    out = bsa.select_blocks(torch.from_numpy(q), torch.from_numpy(k), kv_valid=kvv, **kw)
    assert out.dtype == torch.int32
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_select_blocks_ties_take_the_lower_index():
    """Constant keys: every unforced block scores the same, and every
    forced block scores 3e38; both packages keep the lowest indices."""
    q, k, _ = _qkv(2, Sq=64, Sk=256)
    k[:] = 0.5
    kw = dict(block_q=32, block_k=32, top_k=5, num_cond_tokens=64, q_token_offset=192)
    ref = jbsa.select_blocks(jnp.asarray(q), jnp.asarray(k), interpret=True, **kw)
    out = bsa.select_blocks(torch.from_numpy(q), torch.from_numpy(k), **kw)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    assert out[0, 0].tolist() == [0, 1, 2, 3, 6]  # cond 0-1, lowest 2-3, diagonal 6


BSA_CASES = {
    # Sq, Sk, top_k, block, cond tokens, kv_valid, qk_int8
    "sparse": (96, 160, 3, 32, 32, None, False),
    "clamped_top_k": (64, 192, 2, 32, 128, None, False),
    "ragged_tail": (64, 150, 3, 32, 32, None, False),
    "kv_valid": (64, 192, 4, 32, 64, 150, False),
    "qk_int8": (96, 160, 3, 32, 32, None, True),
    "qk_int8_kv_valid": (64, 192, 3, 32, 32, 150, True),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(BSA_CASES))
def test_bsa_attention_matches_jax(case, dtype):
    Sq, Sk, top_k, blk, nc, kvv, int8 = BSA_CASES[case]
    q, k, v = _qkv(3, Sq=Sq, Sk=Sk)
    kw = dict(top_k=top_k, block_q=blk, block_k=blk, num_cond_tokens=nc, qk_int8=int8)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    ref = jbsa.bsa_attention(*(jnp.asarray(a, jd) for a in (q, k, v)), interpret=True,
                             kv_valid=None if kvv is None else jnp.int32(kvv), **kw)
    out = bsa.bsa_attention(*(torch.from_numpy(a).to(td) for a in (q, k, v)),
                            kv_valid=kvv, **kw)
    assert out.dtype == td and out.shape == q.shape
    assert bsa.bsa_launches == bsa.bsa_int8_launches == 0
    ref = np.asarray(ref.astype(jnp.float32))
    if int8:
        atol = 2e-2
    elif dtype == "bfloat16":
        atol = 2 * 2.0 ** -7 * float(np.abs(ref).max())
    else:
        atol = 2e-5
    np.testing.assert_allclose(out.float().numpy(), ref, atol=atol, rtol=0)


def test_full_top_k_equals_dense_attention():
    """Every block selected: BSA is the port's dense attention."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(4, Sq=64, Sk=150))
    out = bsa.bsa_attention(q, k, v, top_k=5, block_q=32, block_k=32)
    ref, _ = attention_reference(q, k, v)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=2e-6, rtol=0)


def test_bsa_reference_matches_jax_oracle():
    """The plain version over a given selection equals the JAX dense
    masked oracle (``bsa_reference``) on the same indices."""
    q, k, v = _qkv(5, Sq=96, Sk=160)
    idx = jbsa.select_blocks(jnp.asarray(q), jnp.asarray(k), block_q=32, block_k=32,
                             top_k=3, num_cond_tokens=32, q_token_offset=64)
    ref = jbsa.bsa_reference(*(jnp.asarray(a) for a in (q, k, v)), idx, block_q=32,
                             block_k=32)
    out = bsa.bsa_reference(*(torch.from_numpy(a) for a in (q, k, v)),
                            torch.from_numpy(np.asarray(idx)), block_q=32, block_k=32)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-6, rtol=0)


def test_quantize_tokens_bit_equal():
    q, _, _ = _qkv(6)
    q[0, 3] = 0.0  # an all-zero token takes the 1e-8 floor
    qi, qs = jbsa._quantize_tokens(jnp.asarray(q))
    ti, ts = bsa._quantize_tokens(torch.from_numpy(q))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(qi))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(qs))


def test_decode_top_k_and_clamp_follow_the_reference():
    for n_kb in (1, 5, 16, 19):
        for keep in (0.15, 0.35, 0.5, 1.0):
            ref = min(n_kb, max(4, -int(-n_kb * keep // 1)))  # models/dit.py:282-284
            assert bsa.decode_top_k(n_kb, keep, 4) == ref
    # 7 cond blocks + the diagonal at the default geometry: 7 -> 8
    assert bsa.clamp_top_k(7, 18720, 1024, 6240) == 8
    assert bsa.clamp_top_k(10, 18720, 1024, 6240) == 10
    assert bsa.clamp_top_k(6, 15600, 1024, 3120) == 6


# ---------------------------------------------------------------------------
# W8A8
# ---------------------------------------------------------------------------


def test_quantize_linear_params_bit_equal():
    rng = np.random.default_rng(7)
    w = (0.02 * rng.standard_normal((48, 80))).astype(np.float32)  # [K, N]
    w[:, 5] = 0.0  # a zero output channel takes the 1e-8 floor
    ref = jquant.quantize_linear_params({"kernel": jnp.asarray(w)})
    wi, s = quant.quantize_linear_params(torch.from_numpy(w.T.copy()))  # [N, K]
    np.testing.assert_array_equal(wi.numpy().T, np.asarray(ref["kernel_i8"]))
    np.testing.assert_array_equal(s.numpy(), np.asarray(ref["scale"]))


@pytest.mark.parametrize("bias", [True, False])
def test_int8_linear_matches_jax(bias):
    rng = np.random.default_rng(8)
    w = (0.05 * rng.standard_normal((64, 96))).astype(np.float32)
    b = rng.standard_normal(96).astype(np.float32)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32)
    p = {"kernel": jnp.asarray(w)}
    lin = torch.nn.Linear(64, 96, bias=bias)
    with torch.no_grad():
        lin.weight.copy_(torch.from_numpy(w.T.copy()))
        if bias:
            p["bias"] = jnp.asarray(b)
            lin.bias.copy_(torch.from_numpy(b))
    ref = np.asarray(jquant.int8_linear(jquant.quantize_linear_params(p), jnp.asarray(x)))
    layer = quant.Int8Linear.from_linear(lin)
    out = quant.int8_linear(layer, torch.from_numpy(x))
    assert out.shape == (2, 5, 96) and layer.weight_i8.shape == (96, 64)
    assert layer.weight_i8.is_contiguous()  # [N, K] row-major, passed transposed
    np.testing.assert_allclose(out.detach().numpy(), ref, rtol=0,
                               atol=1e-5 * float(np.abs(ref).max()))


def test_quantize_dit_blocks_shares_every_other_parameter():
    from longcat_video_tta_tpu_torch.config import longcat_tiny
    from longcat_video_tta_tpu_torch.models import weights
    from longcat_video_tta_tpu_torch.ops.layers import linear

    dit, _, _ = weights.init_random(longcat_tiny(), "cpu", torch.Generator().manual_seed(0))
    q = quant.quantize_dit_blocks_int8(dit)
    base = {id(p) for p in dit.parameters()}
    qparams = list(q.parameters())
    assert all(id(p) in base for p in qparams)  # no parameter was copied
    heavy = {id(getattr(getattr(blk, g), n).weight) for blk in dit.blocks
             for g, names in quant._BLOCK_LINEARS.items() for n in names}
    assert {id(p) for p in qparams} == base - heavy
    blk, qblk = dit.blocks[0], q.blocks[0]
    assert isinstance(qblk.attn.qkv, quant.Int8Linear) and isinstance(qblk.ffn.w2,
                                                                      quant.Int8Linear)
    assert qblk.attn.qkv.bias is blk.attn.qkv.bias and qblk.adaln is blk.adaln
    assert qblk.attn.q_norm is blk.attn.q_norm and q.final is dit.final
    assert isinstance(blk.attn.qkv, torch.nn.Linear)  # the source is untouched
    x = torch.randn(1, 4, 64)
    np.testing.assert_allclose(linear(qblk.attn.qkv, x).detach().numpy(),
                               linear(blk.attn.qkv, x).detach().numpy(), atol=2e-2)


def test_build_libraries_builds_a_repeated_source_once(tmp_path, monkeypatch):
    """One nvcc per distinct library, even when a source is listed twice
    (two builds of one library would race on its temporary file)."""
    from longcat_video_tta_tpu_torch.ops import flash_attention as fa

    calls = tmp_path / "calls"
    nvcc = tmp_path / "nvcc"
    nvcc.write_text("#!/bin/sh\n"
                    f"echo x >> {calls}\n"
                    'while [ $# -gt 0 ]; do [ "$1" = "-o" ] && out="$2"; shift; done\n'
                    'touch "$out"\n')
    nvcc.chmod(0o755)
    monkeypatch.setattr(fa, "_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(fa, "BUILD_DIR", str(tmp_path / "build"))
    got = fa.build_libraries([fa.BSA_SOURCE, fa.BSA_SOURCE])
    assert calls.read_text().count("x") == 1
    assert got[0][0] == got[1][0] and os.path.exists(got[0][0]) and got[1][2] == 0.0
    assert fa.build_libraries([fa.BSA_SOURCE])[0][2] == 0.0  # built: no nvcc
    assert calls.read_text().count("x") == 1
