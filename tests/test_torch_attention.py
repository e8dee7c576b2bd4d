"""PyTorch port attention (ops/flash_attention.py, ops/attention.py) vs
the JAX Pallas flash kernel run in interpret mode.

The port's plain version ``attention_reference`` must give the o and the
lse of the reference kernel (``flash_chunk_fwd``) and the o of
``flash_attention``. Tolerance: fp32 inputs, 2e-5 abs/rel (the two
differ only in summation order). The CUDA kernel itself is held to the
same plain version on the card (tests/test_torch_kernels_cuda.py and
chip_smoke.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from longcat_video_tta_tpu.ops.flash_attention import flash_attention as jax_flash
from longcat_video_tta_tpu.ops.flash_attention import flash_chunk_fwd
from longcat_video_tta_tpu_torch.ops import flash_attention as fa
from longcat_video_tta_tpu_torch.ops.attention import attention

torch.set_num_threads(1)

TOL = dict(atol=2e-5, rtol=2e-5)

# (B, H, Sq, Sk, D, num_cond_tokens, kv_valid_len)
CASES = {
    "d32_square": (2, 2, 64, 64, 32, 0, None),
    "d64_ragged": (1, 3, 100, 100, 64, 0, None),
    "d128_decode": (1, 2, 96, 160, 128, 0, None),
    "cond_prefix": (2, 2, 120, 120, 32, 37, None),
    "cond_prefix_d128": (1, 2, 136, 136, 128, 64, None),
    "cross_text": (2, 2, 72, 16, 64, 0, None),
    "kv_valid": (1, 2, 80, 200, 64, 0, 130),
    "kv_valid_cond": (1, 2, 144, 144, 32, 40, 100),
}


def _inputs(B, H, Sq, Sk, D, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Sq, H, D)).astype(np.float32)
    k = rng.standard_normal((B, Sk, H, D)).astype(np.float32)
    v = rng.standard_normal((B, Sk, H, D)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("case", list(CASES))
def test_reference_matches_jax_flash_chunk(case):
    B, H, Sq, Sk, D, ncond, kv_valid = CASES[case]
    q, k, v = _inputs(B, H, Sq, Sk, D)
    o_j, lse_j = flash_chunk_fwd(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), 0, 0,
        num_cond_tokens=ncond if Sq == Sk else 0, interpret=True,
        kv_valid=None if kv_valid is None else jnp.int32(kv_valid))
    o_t, lse_t = fa.attention_reference(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        num_cond_tokens=ncond, kv_valid_len=kv_valid)
    assert o_t.shape == (B, Sq, H, D) and lse_t.shape == (B, Sq, H)
    np.testing.assert_allclose(o_t.numpy(), np.asarray(o_j), **TOL)
    np.testing.assert_allclose(lse_t.numpy(), np.asarray(lse_j), **TOL)


@pytest.mark.parametrize("q_off,k_off,kv_valid", [(64, 0, None), (0, 64, None),
                                                    (32, 96, 150)])
def test_reference_global_offsets_match_jax_flash_chunk(q_off, k_off, kv_valid):
    """Global q/k offsets (ring attention): the prefix rule and kv_valid
    read global indices."""
    q, k, v = _inputs(1, 2, 96, 96, 32, seed=7)
    o_j, lse_j = flash_chunk_fwd(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), q_off, k_off,
        num_cond_tokens=100, interpret=True,
        kv_valid=None if kv_valid is None else jnp.int32(kv_valid))
    o_t, lse_t = fa.attention_reference(
        *(torch.from_numpy(a) for a in (q, k, v)), num_cond_tokens=100,
        kv_valid_len=kv_valid, q_offset=q_off, k_offset=k_off)
    np.testing.assert_allclose(o_t.numpy(), np.asarray(o_j), **TOL)
    np.testing.assert_allclose(lse_t.numpy(), np.asarray(lse_j), **TOL)


@pytest.mark.parametrize("case", ["d64_ragged", "cond_prefix", "kv_valid",
                                  "d128_decode"])
def test_attention_matches_jax_flash_attention(case):
    B, H, Sq, Sk, D, ncond, kv_valid = CASES[case]
    q, k, v = _inputs(B, H, Sq, Sk, D, seed=1)
    o_j = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                    num_cond_tokens=ncond, kv_valid_len=kv_valid, interpret=True)
    o_t = attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                    num_cond_tokens=ncond, kv_valid_len=kv_valid)
    np.testing.assert_allclose(o_t.numpy(), np.asarray(o_j), **TOL)


def test_cpu_wrapper_is_the_plain_version_and_launches_nothing():
    q, k, v = (torch.from_numpy(a) for a in _inputs(1, 2, 48, 80, 64, seed=2))
    fa.reset_launches()
    o, lse = fa.flash_attention(q, k, v, kv_valid_len=50)
    o_r, lse_r = fa.attention_reference(q, k, v, kv_valid_len=50)
    assert torch.equal(o, o_r) and torch.equal(lse, lse_r)
    assert fa.launches == 0


def test_row_with_no_visible_key_gives_zero():
    """kv_valid 0: every key masked -> o = 0 and lse = -1e30, as the
    reference kernel's l_safe rule gives."""
    q, k, v = _inputs(1, 2, 32, 48, 32, seed=3)
    o_j, lse_j = flash_chunk_fwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                 0, 0, num_cond_tokens=0, interpret=True,
                                 kv_valid=jnp.int32(0))
    o_t, lse_t = fa.attention_reference(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        kv_valid_len=0)
    assert float(o_t.abs().max()) == 0.0
    np.testing.assert_allclose(o_t.numpy(), np.asarray(o_j), atol=0)
    np.testing.assert_allclose(lse_t.numpy(), np.asarray(lse_j), rtol=1e-6)


def test_bf16_rounds_p_like_the_kernel():
    """bf16 inputs: P is rounded to bf16 before P V, as the reference
    kernel does (flash_attention.py:177-180). Held against the JAX kernel
    in interpret mode at bf16 tolerance (1e-2: one bf16 ulp near 1)."""
    q, k, v = _inputs(1, 2, 64, 96, 64, seed=4)
    to_bf = lambda a: jnp.asarray(a, jnp.bfloat16)
    o_j, lse_j = flash_chunk_fwd(to_bf(q), to_bf(k), to_bf(v), 0, 0,
                                 num_cond_tokens=0, interpret=True)
    tb = lambda a: torch.from_numpy(a).to(torch.bfloat16)
    o_t, lse_t = fa.attention_reference(tb(q), tb(k), tb(v))
    assert o_t.dtype == torch.bfloat16
    np.testing.assert_allclose(o_t.float().numpy(),
                               np.asarray(o_j.astype(jnp.float32)), atol=1e-2)
    np.testing.assert_allclose(lse_t.numpy(), np.asarray(lse_j), atol=1e-4)
