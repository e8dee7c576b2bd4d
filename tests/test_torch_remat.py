"""The port's remat policies (ops/layers.py::remat_wrap "full", "dots",
"dots_attn"; ``lc_port::flash_fwd`` in ops/flash_attention.py) on the
plain path, against each other and against the JAX package's
``remat_wrap`` on the same weights (longcat_tiny with remat on, fp32)
and the same injected draws.

Tolerances: a policy changes only what the backward recomputes, so the
port's loss and gradients under "dots" and "dots_attn" equal "full"'s to
1e-6 rel (the same ops on the same values); against JAX, as
test_torch_tta.py: loss 1e-5 rel, gradients 1e-4 rel / 1e-6 abs.
"""

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from longcat_video_tta_tpu.config import longcat_tiny as jax_tiny
from longcat_video_tta_tpu.pipeline import ModelBundle as JaxBundle
from longcat_video_tta_tpu.tta import losses as jlosses
from longcat_video_tta_tpu_torch.config import longcat_tiny
from longcat_video_tta_tpu_torch.ops import flash_attention as fa
from longcat_video_tta_tpu_torch.ops.layers import remat_saved_ops, remat_wrap
from longcat_video_tta_tpu_torch.pipeline.pipeline import ModelBundle
from longcat_video_tta_tpu_torch.tta.losses import flow_matching_loss_conditioned

torch.set_num_threads(1)

JCFG = jax_tiny()
TCFG = longcat_tiny()
POLICIES = ("full", "dots", "dots_attn")


@pytest.fixture(scope="module")
def bundles():
    jb = JaxBundle.init_random(JCFG, seed=0)
    tonp = lambda t: jax.tree.map(np.asarray, t)
    tb = ModelBundle.from_numpy(TCFG, tonp(jb.dit_params), tonp(jb.vae_params),
                                tonp(jb.text_params), device="cpu")
    return jb, tb


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    f32 = lambda *s: rng.standard_normal(s).astype(np.float32)
    mask = np.ones((1, 16), np.int32)
    mask[:, 10:] = 0
    key = jax.random.PRNGKey(3)
    train = f32(1, 16, 2, 4, 6)
    k_sig, k_noise = jax.random.split(key)
    sigma = np.array(jax.random.uniform(k_sig, (1,), minval=0.001, maxval=1.0))
    noise = np.array(jax.random.normal(k_noise, train.shape, jnp.float32))
    return dict(cond=f32(1, 16, 2, 4, 6), train=train, text=f32(1, 16, 48), mask=mask,
                delta=0.1 * f32(TCFG.dit.adaln_tembed_dim), key=key, sigma=sigma,
                noise=noise)


def _port_step(tb, data, policy, counts=None, monkeypatch=None):
    """(loss, d loss / d delta_t) of the port DiT with remat under
    ``policy``; with ``counts``, the plain attention forwards and
    backwards are counted."""
    dit = copy.copy(tb.dit)
    dit.cfg = dataclasses.replace(tb.dit.cfg, remat=True, remat_policy=policy)
    if counts is not None:
        ref_fwd, ref_bwd = fa.attention_reference, fa.FlashAttentionFunction.backward

        def fwd(*a, **k):
            counts["flash_fwd"] += 1
            return ref_fwd(*a, **k)

        def bwd(ctx, do):
            counts["flash_bwd"] += 1
            return ref_bwd(ctx, do)

        monkeypatch.setattr(fa, "attention_reference", fwd)
        monkeypatch.setattr(fa.FlashAttentionFunction, "backward", staticmethod(bwd))
    t = lambda k: torch.from_numpy(np.asarray(data[k]))
    delta = t("delta").requires_grad_(True)
    loss = flow_matching_loss_conditioned(
        dit, t("cond"), t("train"), t("text"), t("mask"), adapters={"delta_t": delta},
        sigma=t("sigma"), noise=t("noise"))
    (grad,) = torch.autograd.grad(loss, [delta])
    return loss.detach(), grad


@pytest.mark.parametrize("policy", ["dots", "dots_attn"])
def test_policy_gives_full_remat_gradients(bundles, data, policy):
    _, tb = bundles
    loss_f, grad_f = _port_step(tb, data, "full")
    loss, grad = _port_step(tb, data, policy)
    torch.testing.assert_close(loss, loss_f, rtol=1e-6, atol=0)
    torch.testing.assert_close(grad, grad_f, rtol=1e-6, atol=1e-9)
    assert float(grad.abs().max()) > 0


@pytest.mark.parametrize("policy,fwd_per_block", [("full", 4), ("dots", 4),
                                                  ("dots_attn", 2)])
def test_dots_attn_runs_no_forward_recompute(bundles, data, monkeypatch, policy,
                                             fwd_per_block):
    """The plain version behind ``lc_port::flash_fwd`` runs twice per
    attention under "full" and "dots" (forward, then the recompute) and
    once under "dots_attn", whose recompute takes the saved o and lse;
    the backward runs once per attention under every policy (chip_smoke's
    ``train_step_launches``)."""
    _, tb = bundles
    counts = {"flash_fwd": 0, "flash_bwd": 0}
    _port_step(tb, data, policy, counts, monkeypatch)
    depth = TCFG.dit.depth
    assert counts == {"flash_fwd": fwd_per_block * depth, "flash_bwd": 2 * depth}


def test_dots_saves_mm_and_addmm_not_bmm(monkeypatch):
    """What the selective checkpoint saves, recorded from its policy
    calls on a block with linears (addmm / mm) and a batched product
    (bmm): "dots" saves the linears' products and recomputes bmm;
    "dots_attn" also saves ``lc_port::flash_fwd``."""
    aten = torch.ops.aten
    assert set(remat_saved_ops("dots")) == {aten.mm.default, aten.addmm.default}
    assert set(remat_saved_ops("dots_attn")) == {aten.mm.default, aten.addmm.default,
                                                 fa.flash_fwd_op._opoverload}
    assert remat_saved_ops("full") == ()
    with pytest.raises(ValueError, match="unknown remat policy"):
        remat_saved_ops("everything")

    decisions = []
    make = torch.utils.checkpoint.create_selective_checkpoint_contexts

    def recording(policy_fn, *a, **k):
        def rec(ctx, op, *args, **kwargs):
            out = policy_fn(ctx, op, *args, **kwargs)
            if not ctx.is_recompute:
                decisions.append((op, out))
            return out
        return make(rec, *a, **k)

    monkeypatch.setattr(torch.utils.checkpoint, "create_selective_checkpoint_contexts",
                        recording)
    g = torch.Generator().manual_seed(0)
    w1, b1 = torch.randn(8, 6, generator=g), torch.randn(8, generator=g)
    w2 = torch.randn(8, 8, generator=g)

    def body(x):
        h = F.linear(x, w1, b1)                 # addmm
        h = torch.bmm(h, h.transpose(1, 2))     # bmm
        return F.linear(h.reshape(-1, 8), w2)   # mm

    x = torch.randn(2, 8, 6, generator=g, requires_grad=True)
    remat_wrap(body, True, "dots")(x).sum().backward()
    MUST = torch.utils.checkpoint.CheckpointPolicy.MUST_SAVE
    saved = {op for op, d in decisions if d == MUST}
    seen = {op for op, _ in decisions}
    assert saved == {aten.addmm.default, aten.mm.default}
    assert aten.bmm.default in seen


@pytest.mark.parametrize("policy", POLICIES)
def test_policy_gradients_match_jax_remat(bundles, data, policy):
    """The JAX ``remat_wrap`` under the same policy, on the same weights
    and draws (its loss draws sigma and noise from the key; the port is
    handed them)."""
    jb, tb = bundles
    jcfg = dataclasses.replace(JCFG.dit, remat=True, remat_policy=policy)
    j = lambda k: jnp.asarray(data[k])

    def jloss(delta):
        return jlosses.flow_matching_loss_conditioned(
            jb.dit_params, jcfg, j("cond"), j("train"), j("text"), j("mask"),
            data["key"], adapters={"delta_t": delta})

    ref_loss, ref_grad = jax.value_and_grad(jloss)(j("delta"))
    loss, grad = _port_step(tb, data, policy)
    np.testing.assert_allclose(float(loss), float(ref_loss), rtol=1e-5)
    np.testing.assert_allclose(grad.numpy(), np.asarray(ref_grad), rtol=1e-4, atol=1e-6)
