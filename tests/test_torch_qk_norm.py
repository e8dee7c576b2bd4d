"""The q/k prologue (ops/qk_norm.py) on the CPU: ``qk_norm_rope``'s plain
path against the chain it replaces (``rms_norm`` then ``apply_rope``),
``QKNormRopeFunction`` (the plain versions of the card's forward and
backward kernels) against autograd of that chain, and the DiT's call
sites, under every remat policy. The kernels themselves are held to the
same plain versions on the card (tests/test_torch_kernels_cuda.py).

Tolerances: the plain path is the chain, so equal bit for bit. The
function computes the chain's arithmetic in fp32 with one rounding: in
fp32 it matches the chain's values and autograd's gradients to 1e-5
relative (sums taken in another order); in bf16 its error against a
float64 evaluation is no larger than the chain's, in max and in mean. A
DiT through the function matches the plain path to 1e-4 relative (fp32
tiny model; the loss's reductions amplify last-bit differences)."""

import dataclasses

import pytest
import torch

from longcat_video_tta_tpu_torch.config import longcat_tiny
from longcat_video_tta_tpu_torch.models import dit as dit_mod
from longcat_video_tta_tpu_torch.models.dit import CrossAttention, LongCatDiT, SelfAttention
from longcat_video_tta_tpu_torch.ops import qk_norm as qn
from longcat_video_tta_tpu_torch.ops.attention import attention
from longcat_video_tta_tpu_torch.ops.layers import (
    apply_rope,
    linear,
    remat_saved_ops,
    rms_norm,
    rope_3d_angles,
)
from longcat_video_tta_tpu_torch.tta.losses import flow_matching_loss_conditioned
from longcat_video_tta_tpu_torch.utils import spans

torch.set_num_threads(1)

ROPE_DIMS = {32: (8, 12, 12), 64: (16, 24, 24), 128: (32, 48, 48)}
NT, NH, NW, H, L = 2, 3, 5, 3, 7  # tokens 2 x 15, 3 heads, 7 text tokens


def _inputs(dh, layout, lanes, dtype, seed=0):
    """(q, k, wq, wk, cos, sin): ``layout`` "self" (q, k strided views of a
    fused qkv [B, nt, nhw, 3, H, dh], the rotation on), "self_norope"
    (the same views, no rotation) or "cross" (q [B, S, H, dh], k a view
    of a fused kv [B, L, 2, H, dh], no rotation); a lane weight [V, dh]
    with ``lanes``, else [dh]."""
    g = torch.Generator().manual_seed(seed)
    B = 4 if lanes else 2
    rnd = lambda *s: (3.0 * torch.randn(*s, generator=g)).to(dtype)
    wshape = (2, dh) if lanes else (dh,)
    wq = (1.0 + 0.3 * torch.randn(*wshape, generator=g)).to(dtype)
    wk = (1.0 + 0.3 * torch.randn(*wshape, generator=g)).to(dtype)
    if layout == "cross":
        q = rnd(B, NT * NH * NW, H, dh)
        k = rnd(B, L, 2, H, dh)[:, :, 0]
        return q, k, wq, wk, None, None
    qkv = rnd(B, NT, NH * NW, 3, H, dh)
    cos, sin = rope_3d_angles(NT, NH, NW, ROPE_DIMS[dh])
    if layout == "self_norope":
        cos = sin = None
    return qkv[..., 0, :, :], qkv[..., 1, :, :], wq, wk, cos, sin


def _chain(x, w, cos, sin):
    y = rms_norm(x, w)
    return y if cos is None else apply_rope(y, cos, sin)


CASES = [(dh, layout, lanes) for dh in (64, 128)
         for layout in ("self", "self_norope", "cross") for lanes in (False, True)]
IDS = [f"d{dh}-{layout}-{'lanes' if lanes else 'w'}" for dh, layout, lanes in CASES]


@pytest.mark.parametrize("dh,layout,lanes", CASES, ids=IDS)
def test_plain_path_is_the_chain_bit_for_bit(dh, layout, lanes):
    q, k, wq, wk, cos, sin = _inputs(dh, layout, lanes, torch.bfloat16)
    assert not q.is_contiguous() or not k.is_contiguous()  # strided views
    yq, yk = qn.qk_norm_rope(q, k, wq, wk, cos, sin)
    assert torch.equal(yq, _chain(q, wq, cos, sin))
    assert torch.equal(yk, _chain(k, wk, cos, sin))


@pytest.mark.parametrize("dh,layout,lanes", CASES, ids=IDS)
def test_function_matches_autograd_of_the_chain(dh, layout, lanes):
    """fp32: the function's forward equals the chain's values and its
    backward (the plain backward kernel) autograd's dq, dk, dwq, dwk."""
    q0, k0, wq0, wk0, cos, sin = _inputs(dh, layout, lanes, torch.float32, seed=1)
    leaves = lambda: [t.detach().clone().requires_grad_(True) for t in (q0, k0, wq0, wk0)]
    g = torch.Generator().manual_seed(2)
    dyq = torch.randn(q0.shape, generator=g)
    dyk = torch.randn(k0.shape, generator=g)

    q, k, wq, wk = leaves()
    yq, yk = qn.QKNormRopeFunction.apply(q, k, wq, wk, cos, sin, 1e-6)
    assert yq.shape == q.shape and yk.shape == k.shape and yq.is_contiguous()
    got = torch.autograd.grad((yq * dyq).sum() + (yk * dyk).sum(), [q, k, wq, wk])

    q, k, wq, wk = leaves()
    rq, rk = _chain(q, wq, cos, sin), _chain(k, wk, cos, sin)
    want = torch.autograd.grad((rq * dyq).sum() + (rk * dyk).sum(), [q, k, wq, wk])
    torch.testing.assert_close(yq, rq, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(yk, rk, rtol=1e-5, atol=1e-6)
    for name, a, b in zip(("dq", "dk", "dwq", "dwk"), got, want):
        assert a.shape == b.shape, name
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5 * float(b.abs().max()),
                                   msg=name)


@pytest.mark.parametrize("need", ["q", "k", "wq", "q_wk"])
def test_function_returns_only_the_gradients_asked_for(need):
    """Cross-attention's k comes from the frozen text path, and the norm
    weights train only under norm_tune: the backward leaves the rest
    None."""
    q0, k0, wq0, wk0, cos, sin = _inputs(128, "self", False, torch.float32, seed=3)
    ts = [t.detach().clone().requires_grad_(n in need.split("_"))
          for t, n in zip((q0, k0, wq0, wk0), ("q", "k", "wq", "wk"))]
    yq, yk = qn.QKNormRopeFunction.apply(*ts, cos, sin, 1e-6)
    (yq.sum() + yk.sum()).backward()
    for t, n in zip(ts, ("q", "k", "wq", "wk")):
        assert (t.grad is not None) == (n in need.split("_")), n


@pytest.mark.parametrize("dh,layout", [(64, "self"), (128, "self"), (128, "cross")])
def test_one_rounding_is_no_less_precise_than_the_chain(dh, layout):
    """bf16: the kernel's arithmetic (``norm_rope_reference``) against a
    float64 evaluation of the same math errs no more than the chain, in
    max and in mean."""
    q, _, wq, _, cos, sin = _inputs(dh, layout, False, torch.bfloat16, seed=4)
    x = qn._rows(q)
    ref = qn.norm_rope_reference(x.double(), wq.double(), None if cos is None
                                 else cos.double(), None if sin is None else sin.double(),
                                 1e-6)
    one = qn.norm_rope_reference(x, wq, cos, sin, 1e-6).double()
    chain = qn._rows(_chain(q, wq, cos, sin)).double()
    e_one, e_chain = (one - ref).abs(), (chain - ref).abs()
    assert float(e_one.max()) <= float(e_chain.max())
    assert float(e_one.mean()) <= float(e_chain.mean())


@pytest.mark.parametrize("lanes", [False, True])
def test_backward_reference_is_autograd_of_the_forward_reference(lanes):
    """fp64: the plain backward kernel (rstd recomputed from x) is the
    gradient of the plain forward kernel, dx and dw."""
    q, _, w, _, cos, sin = _inputs(64, "self", lanes, torch.float64, seed=5)
    x = qn._rows(q).detach().clone().requires_grad_(True)
    w = w.detach().clone().requires_grad_(True)
    cos, sin = cos.double(), sin.double()
    dy = torch.randn(x.shape, generator=torch.Generator().manual_seed(6), dtype=torch.float64)
    want = torch.autograd.grad(qn.norm_rope_reference(x, w, cos, sin, 1e-6), [x, w], [dy])
    dx, dw = qn.norm_rope_backward_reference(x.detach(), w.detach(), cos, sin, dy, 1e-6, True)
    torch.testing.assert_close(dx, want[0], rtol=1e-10, atol=1e-12)
    torch.testing.assert_close(dw.reshape(w.shape), want[1], rtol=1e-10, atol=1e-12)


def test_op_is_registered_and_recomputed_under_every_policy():
    """``lc_port::qk_norm_rope`` is a dispatcher op that no remat policy
    saves (PREFER_RECOMPUTE), with a fake for tracing."""
    op = torch.ops.lc_port.qk_norm_rope.default
    for policy in ("full", "dots", "dots_attn"):
        assert op not in remat_saved_ops(policy)
    q, k, wq, wk, cos, sin = _inputs(64, "self", False, torch.bfloat16, seed=6)
    q, k = qn._rows(q), qn._rows(k)
    with torch._subclasses.fake_tensor.FakeTensorMode() as mode:
        fq, fk = mode.from_tensor(q), mode.from_tensor(k)
        out = qn.qk_norm_rope_op(fq, fk, mode.from_tensor(wq), mode.from_tensor(wk),
                                 mode.from_tensor(cos), mode.from_tensor(sin), 1e-6)
    assert [tuple(t.shape) for t in out] == [tuple(fq.shape), tuple(fk.shape)]


@pytest.mark.parametrize("case", ["rows_not_contiguous", "head_dim", "dtype", "lanes",
                                  "tables", "heads"])
def test_wrapper_raises_on_what_the_kernels_do_not_take(case):
    q, k, wq, wk, cos, sin = _inputs(64, "self", False, torch.bfloat16, seed=7)
    q, k = qn._rows(q), qn._rows(k)
    if case == "rows_not_contiguous":
        q = q.transpose(2, 3).contiguous().transpose(2, 3)
    elif case == "head_dim":
        q, k = q[..., :48], k[..., :48]
    elif case == "dtype":
        q = q.float()
    elif case == "tables":
        cos = cos[:1]
    elif case == "heads":
        k = k[:, :, :2]
    with pytest.raises((ValueError, TypeError)):
        if case == "lanes":
            qn._weight(torch.ones(3, 64), q.shape[0], 64)
        qn._check_inputs(q, k, cos, sin)


def test_counters_hold_the_prologue_launches():
    got = spans._counters(False)
    assert got["qk_norm_rope"] == qn.launches
    assert got["qk_norm_rope_bwd"] == qn.bwd_launches


# ---------------------------------------------------------------------------
# The call sites
# ---------------------------------------------------------------------------


def _module(cls, cfg, seed):
    m = cls(cfg, torch.float32)
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in m.named_parameters():
            p.copy_((1.0 if "norm" in name else 0.0) + 0.2 * torch.randn(p.shape, generator=g))
    return m


def test_self_and_cross_attention_are_unchanged():
    """The modules' outputs equal the sequence they ran before, op for op."""
    cfg = longcat_tiny().dit
    g = torch.Generator().manual_seed(8)
    x = torch.randn(1, NT, NH * NW, cfg.hidden_size, generator=g)
    y = torch.randn(1, L, cfg.hidden_size, generator=g)
    cos, sin = rope_3d_angles(NT, NH, NW, cfg.rope_dims)
    sa, ca = _module(SelfAttention, cfg, 9), _module(CrossAttention, cfg, 10)
    nH, dh, S = cfg.num_heads, cfg.head_dim, NT * NH * NW

    qkv = linear(sa.qkv, x).reshape(1, NT, NH * NW, 3, nH, dh)
    q = apply_rope(rms_norm(qkv[..., 0, :, :], sa.q_norm), cos, sin).reshape(1, S, nH, dh)
    k = apply_rope(rms_norm(qkv[..., 1, :, :], sa.k_norm), cos, sin).reshape(1, S, nH, dh)
    o = attention(q, k, qkv[..., 2, :, :].reshape(1, S, nH, dh), num_cond_tokens=NH * NW)
    want = linear(sa.proj, o.reshape(1, NT, NH * NW, nH * dh))
    got, (k_out, _) = sa(x, cos, sin, NH * NW)
    assert torch.equal(got, want) and torch.equal(k_out, k)

    q = rms_norm(linear(ca.q, x).reshape(1, S, nH, dh), ca.q_norm)
    kv = linear(ca.kv, y).reshape(1, L, 2, nH, dh)
    o = attention(q, rms_norm(kv[:, :, 0], ca.k_norm), kv[:, :, 1])
    want = linear(ca.proj, o.reshape(1, NT, NH * NW, nH * dh))
    assert torch.equal(ca(x, y), want)


def _dit(remat_policy):
    cfg = longcat_tiny().dit
    cfg = dataclasses.replace(cfg, remat=remat_policy is not None,
                              remat_policy=remat_policy or "full")
    dit = LongCatDiT(cfg)
    g = torch.Generator().manual_seed(11)
    with torch.no_grad():
        for name, p in dit.named_parameters():
            base = 1.0 if name.endswith("_norm") or "norm.weight" in name else 0.0
            p.copy_(base + 0.1 * torch.randn(p.shape, generator=g))
    return dit


def _delta_a_step(dit):
    g = torch.Generator().manual_seed(12)
    f = lambda *s: torch.randn(*s, generator=g)
    mask = torch.ones(1, 16, dtype=torch.int32)
    mask[:, 10:] = 0
    delta = (0.1 * f(dit.cfg.adaln_tembed_dim)).requires_grad_(True)
    cond, train, text = f(1, 16, 2, 4, 6), f(1, 16, 2, 4, 6), f(1, 16, 48)
    sigma, noise = torch.tensor([0.4]), f(1, 16, 2, 4, 6)
    loss = flow_matching_loss_conditioned(dit, cond, train, text, mask,
                                          adapters={"delta_t": delta}, sigma=sigma,
                                          noise=noise)
    (grad,) = torch.autograd.grad(loss, [delta])
    return loss.detach(), grad


def _through_function(monkeypatch, calls):
    """Send the DiT's call sites through ``QKNormRopeFunction`` on the CPU
    (what they run on the card), counting the op's forwards."""
    ref = qn.norm_rope_reference

    def counted(*a):
        calls.append(1)
        return ref(*a)

    monkeypatch.setattr(qn, "norm_rope_reference", counted)
    monkeypatch.setattr(dit_mod, "qk_norm_rope",
                        lambda q, k, wq, wk, cos=None, sin=None, eps=1e-6:
                        qn.QKNormRopeFunction.apply(q, k, wq, wk, cos, sin, eps))


@pytest.mark.parametrize("policy", [None, "full", "dots", "dots_attn"])
def test_dit_delta_a_step_through_the_function(monkeypatch, policy):
    """A 2-block DiT's delta_a loss and gradient through the function (the
    card's path) match the plain path, under no remat and under each
    policy; the op runs once per attention forward (2 per block, two
    reference calls each: q and k) and once more in each block's
    recompute."""
    dit = _dit(policy)
    loss_p, grad_p = _delta_a_step(dit)
    calls = []
    _through_function(monkeypatch, calls)
    loss_f, grad_f = _delta_a_step(dit)
    torch.testing.assert_close(loss_f, loss_p, rtol=1e-4, atol=0)
    torch.testing.assert_close(grad_f, grad_p, rtol=1e-4, atol=1e-4 * float(grad_p.abs().max()))
    assert float(grad_f.abs().max()) > 0
    depth = dit.cfg.depth
    assert len(calls) == 2 * 2 * depth * (1 if policy is None else 2)


def test_remat_policies_give_the_same_gradients_through_the_function(monkeypatch):
    _through_function(monkeypatch, [])
    loss0, grad0 = _delta_a_step(_dit(None))
    for policy in ("full", "dots", "dots_attn"):
        loss, grad = _delta_a_step(_dit(policy))
        torch.testing.assert_close(loss, loss0, rtol=1e-6, atol=0)
        torch.testing.assert_close(grad, grad0, rtol=1e-6, atol=1e-9)


def test_dit_forward_unchanged_under_no_grad(monkeypatch):
    """The sampling forward (no autograd) through the function matches
    the plain path."""
    dit = _dit(None)
    g = torch.Generator().manual_seed(13)
    lat = torch.randn(1, 16, 2, 4, 6, generator=g)
    text = torch.randn(1, 16, 48, generator=g)
    t = torch.tensor([500.0])
    with torch.no_grad():
        plain = dit(lat, t, text, num_cond_latents=1)
        _through_function(monkeypatch, [])
        fused = dit(lat, t, text, num_cond_latents=1)
    torch.testing.assert_close(fused, plain, rtol=1e-4, atol=1e-4 * float(plain.abs().max()))
