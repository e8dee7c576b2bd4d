"""PyTorch port attention backward (ops/flash_attention.py) vs the JAX
Pallas backward kernels run in interpret mode.

- ``attention_backward_reference`` (the plain version the dQ and dK/dV
  CUDA kernels are held to on the card) against ``flash_chunk_dq`` /
  ``flash_chunk_dkv`` given the lse and delta of ``flash_chunk_fwd``, and
  against ``jax.vjp`` of ``flash_attention``. fp32: 2e-5 abs/rel
  (summation order only). bf16: each output within 1/64 of its largest
  magnitude (a few bf16 ulps: P and dS are rounded to bf16 at fp32
  values that differ in the last bits, then the output is rounded).
- ``FlashAttentionFunction`` on CPU tensors: the gradients of torch
  autograd through ``attention_reference``.
- A row with no visible key gets exactly zero gradients.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from longcat_video_tta_tpu.ops.flash_attention import flash_attention as jax_flash
from longcat_video_tta_tpu.ops.flash_attention import (
    flash_chunk_dkv,
    flash_chunk_dq,
    flash_chunk_fwd,
)
from longcat_video_tta_tpu_torch.ops import flash_attention as fa
from longcat_video_tta_tpu_torch.ops.attention import attention

torch.set_num_threads(1)

TOL = dict(atol=2e-5, rtol=2e-5)

# (B, H, Sq, Sk, D, num_cond_tokens, kv_valid_len, q_offset, k_offset)
CASES = {
    "d32_prefix": (2, 2, 120, 120, 32, 37, None, 0, 0),
    "d64_kv_valid": (1, 3, 80, 200, 64, 0, 130, 0, 0),
    "d128_prefix": (1, 2, 136, 136, 128, 64, None, 0, 0),
    "d64_cross": (2, 2, 72, 16, 64, 0, None, 0, 0),
    "d32_prefix_kv_valid": (1, 2, 144, 144, 32, 40, 100, 0, 0),
    "d128_q_offset": (1, 2, 96, 96, 128, 100, None, 64, 0),
    "d64_k_offset_kv_valid": (1, 2, 96, 96, 64, 100, 150, 32, 96),
}


def _inputs(B, H, Sq, Sk, D, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Sq, H, D)).astype(np.float32)
    k = rng.standard_normal((B, Sk, H, D)).astype(np.float32)
    v = rng.standard_normal((B, Sk, H, D)).astype(np.float32)
    do = rng.standard_normal((B, Sq, H, D)).astype(np.float32)
    return q, k, v, do


def _jax_chunk_grads(q, k, v, do, ncond, kv_valid, q_off, k_off):
    """(dq, dk, dv, lse, delta) from the Pallas kernels in interpret mode."""
    kw = dict(num_cond_tokens=ncond, interpret=True,
              kv_valid=None if kv_valid is None else jnp.int32(kv_valid))
    q, k, v, do = (jnp.asarray(a) for a in (q, k, v, do))
    o, lse = flash_chunk_fwd(q, k, v, q_off, k_off, **kw)
    delta = jnp.sum(do.astype(jnp.float32) * o.astype(jnp.float32), axis=-1)
    dq = flash_chunk_dq(q, k, v, do, lse, delta, q_off, k_off, **kw)
    dk, dv = flash_chunk_dkv(q, k, v, do, lse, delta, q_off, k_off, **kw)
    return dq, dk, dv, lse, delta


@pytest.mark.parametrize("case", list(CASES))
def test_plain_backward_matches_jax_chunk_kernels(case):
    B, H, Sq, Sk, D, ncond, kv_valid, q_off, k_off = CASES[case]
    q, k, v, do = _inputs(B, H, Sq, Sk, D, seed=1)
    dq_j, dk_j, dv_j, lse_j, delta_j = _jax_chunk_grads(
        q, k, v, do, ncond if Sq == Sk else 0, kv_valid, q_off, k_off)
    t = [torch.from_numpy(a) for a in (q, k, v, do)]
    kw = dict(num_cond_tokens=ncond, kv_valid_len=kv_valid, q_offset=q_off,
              k_offset=k_off)
    o, lse = fa.attention_reference(*t[:3], **kw)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_j), **TOL)
    dq, dk, dv = fa.attention_backward_reference(*t[:3], o, lse, t[3], **kw)
    for got, ref in ((dq, dq_j), (dk, dk_j), (dv, dv_j)):
        assert got.shape == ref.shape and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    # the two wrappers' CPU path is the same plain version, from the
    # reference's own lse and delta
    lse_t, delta_t = torch.from_numpy(np.array(lse_j)), torch.from_numpy(
        np.array(delta_j))
    fa.reset_launches()
    dq_w = fa.flash_attention_bwd_dq(*t, lse_t, delta_t, **kw)
    dk_w, dv_w = fa.flash_attention_bwd_dkv(*t, lse_t, delta_t, **kw)
    assert (fa.bwd_dq_launches, fa.bwd_dkv_launches) == (0, 0)
    for got, ref in ((dq_w, dq_j), (dk_w, dk_j), (dv_w, dv_j)):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("case", ["d32_prefix", "d64_kv_valid", "d128_prefix",
                                  "d64_cross"])
def test_plain_backward_matches_jax_vjp(case):
    """Against jax.vjp of the public flash_attention (its custom VJP runs
    the same two backward kernels)."""
    B, H, Sq, Sk, D, ncond, kv_valid, _, _ = CASES[case]
    q, k, v, do = _inputs(B, H, Sq, Sk, D, seed=2)
    fn = lambda q_, k_, v_: jax_flash(q_, k_, v_, num_cond_tokens=ncond,
                                      kv_valid_len=kv_valid, interpret=True)
    _, vjp = jax.vjp(fn, *(jnp.asarray(a) for a in (q, k, v)))
    refs = vjp(jnp.asarray(do))
    t = [torch.from_numpy(a) for a in (q, k, v, do)]
    kw = dict(num_cond_tokens=ncond, kv_valid_len=kv_valid)
    o, lse = fa.attention_reference(*t[:3], **kw)
    got = fa.attention_backward_reference(*t[:3], o, lse, t[3], **kw)
    for g, r in zip(got, refs):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), **TOL)


@pytest.mark.parametrize("case", ["d64_kv_valid", "d128_prefix"])
def test_plain_backward_bf16_matches_jax_chunk_kernels(case):
    """bf16 inputs: P rounded to bf16 before P^T dO and dS before dS^T Q
    and dS K, as the Pallas kernels round them (flash_attention.py:300,
    :312, :369). Tolerance: 1/64 of each output's largest magnitude."""
    B, H, Sq, Sk, D, ncond, kv_valid, q_off, k_off = CASES[case]
    q, k, v, do = _inputs(B, H, Sq, Sk, D, seed=3)
    bf = lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))
    q, k, v, do = bf(q), bf(k), bf(v), bf(do)
    to_j = lambda a: jnp.asarray(a, jnp.bfloat16)
    kw_j = dict(num_cond_tokens=ncond, interpret=True,
                kv_valid=None if kv_valid is None else jnp.int32(kv_valid))
    o_j, lse_j = flash_chunk_fwd(to_j(q), to_j(k), to_j(v), 0, 0, **kw_j)
    delta_j = jnp.sum(to_j(do).astype(jnp.float32) * o_j.astype(jnp.float32), -1)
    args_j = (to_j(q), to_j(k), to_j(v), to_j(do), lse_j, delta_j, 0, 0)
    refs = (flash_chunk_dq(*args_j, **kw_j),) + flash_chunk_dkv(*args_j, **kw_j)

    t = [torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v, do)]
    kw = dict(num_cond_tokens=ncond, kv_valid_len=kv_valid)
    lse = torch.from_numpy(np.array(lse_j))
    delta = torch.from_numpy(np.array(delta_j))
    got = fa._backward_reference_from_delta(*t, lse, delta, **kw)
    for g, r in zip(got, refs):
        assert g.dtype == torch.bfloat16
        r = np.asarray(r.astype(jnp.float32))
        np.testing.assert_allclose(g.float().numpy(), r, rtol=0,
                                   atol=np.abs(r).max() / 64)


@pytest.mark.parametrize("kw", [dict(), dict(num_cond_tokens=13),
                                dict(num_cond_tokens=13, kv_valid_len=25)])
def test_function_cpu_gradients_equal_autograd_of_reference(kw):
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(1, 2, 40, 40, 32, seed=4))
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    o = fa.FlashAttentionFunction.apply(*leaves, kw.get("num_cond_tokens", 0),
                                        kw.get("kv_valid_len"), None, 0, 0)
    got = torch.autograd.grad(o, leaves, do)
    leaves_r = [x.clone().requires_grad_(True) for x in (q, k, v)]
    o_r, _ = fa.attention_reference(*leaves_r, **kw)
    ref = torch.autograd.grad(o_r, leaves_r, do)
    torch.testing.assert_close(o, o_r, rtol=0, atol=0)
    for g, r in zip(got, ref):
        torch.testing.assert_close(g, r, rtol=2e-5, atol=2e-5)


def test_attention_uses_the_function_only_when_recording():
    q, k, v, _ = (torch.from_numpy(a) for a in _inputs(1, 2, 24, 24, 32, seed=5))
    assert attention(q, k, v).grad_fn is None
    q.requires_grad_(True)
    o = attention(q, k, v, num_cond_tokens=8)
    assert type(o.grad_fn).__name__ == "FlashAttentionFunctionBackward"
    (dq,) = torch.autograd.grad(o.sum(), [q])
    assert dq.shape == q.shape
    with torch.no_grad():
        assert attention(q, k, v).grad_fn is None


def test_row_with_no_visible_key_gets_zero_gradients():
    """kv_valid 0: lse = -1e30 on every row; P is selected to 0 under the
    mask, so every gradient is exactly 0 (not NaN from exp(inf) * 0), as
    in the reference kernels."""
    q, k, v, do = _inputs(1, 2, 32, 48, 32, seed=6)
    dq_j, dk_j, dv_j, _, _ = _jax_chunk_grads(q, k, v, do, 0, 0, 0, 0)
    t = [torch.from_numpy(a) for a in (q, k, v, do)]
    o, lse = fa.attention_reference(*t[:3], kv_valid_len=0)
    got = fa.attention_backward_reference(*t[:3], o, lse, t[3], kv_valid_len=0)
    for g, r in zip(got, (dq_j, dk_j, dv_j)):
        assert torch.isfinite(g).all() and float(g.abs().max()) == 0.0
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
