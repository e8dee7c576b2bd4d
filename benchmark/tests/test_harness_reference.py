"""The plain references against the program at the port's tiny
geometries on the CPU (both float32): the forward, the continuation's
cached path, the TTA loss's gradient, the anchor and one CFG step."""

import pytest
import torch

from benchmark.backbones import cogvideox as cv_backbone
from benchmark.backbones import longcat as lc_backbone
from benchmark.reference import cogvideox as cv_ref
from benchmark.reference import longcat as lc_ref
from benchmark.reference.common import fp32_matmuls

from .tiny import COGVIDEOX, LONGCAT


def _close(a, b, rtol=1e-4):
    a, b = a.double(), b.double()
    assert float((a - b).norm() / b.norm()) < rtol


def test_tiny_configs_are_the_port_presets():
    import dataclasses

    from longcat_video_tta_tpu_torch.config import longcat_tiny
    from longcat_video_tta_tpu_torch.models.backbones import cogvideox_tiny

    assert lc_backbone.program_config(LONGCAT) == dataclasses.replace(
        longcat_tiny().dit, remat=True)
    assert cv_backbone.program_config(COGVIDEOX) == cogvideox_tiny().dit


def _lc(seed=0):
    m = lc_backbone.build(LONGCAT, seed, "cpu")
    g = torch.Generator().manual_seed(seed)
    # the draws' small weights barely move tiny latents: scale the matrices up
    for name, w in m.weights.items():
        if w.ndim == 2:
            w.mul_(3.0)
    text = torch.randn(1, 16, 48, generator=g)
    mask = (torch.arange(16) < 11).int()[None]
    return m, g, text, mask


def test_longcat_forward_and_delta_gradient():
    from longcat_video_tta_tpu_torch.tta.losses import flow_matching_loss_conditioned

    m, g, text, mask = _lc()
    ref = lc_ref.LongCat(LONGCAT, m.weights)
    cond = torch.randn(1, 16, 2, 8, 12, generator=g)
    tgt = torch.randn(1, 16, 2, 8, 12, generator=g)
    sigma, noise = torch.tensor([0.4]), torch.randn(1, 16, 2, 8, 12, generator=g)
    delta = torch.randn(32, generator=g) * 0.5
    d1 = delta.clone().requires_grad_(True)
    with torch.enable_grad():
        lp = flow_matching_loss_conditioned(m.dit, cond, tgt, text, mask, adapters={"delta_t": d1},
                                            sigma=sigma, noise=noise)
        (gp,) = torch.autograd.grad(lp, [d1])
    d2 = delta.clone().requires_grad_(True)
    with fp32_matmuls(), torch.enable_grad():
        lr = lc_ref.tta_loss(ref, cond, tgt, text, mask, sigma, noise, d2)
        (gr,) = torch.autograd.grad(lr, [d2])
    _close(lp.detach(), lr.detach(), 1e-5)
    _close(gp, gr)
    assert float(gr.norm()) > 0


def test_longcat_cached_continuation_step():
    from longcat_video_tta_tpu_torch.pipeline.sampler import sample_latents

    m, g, text, mask = _lc(1)
    ref = lc_ref.LongCat(LONGCAT, m.weights)
    cond = torch.randn(1, 16, 2, 8, 12, generator=g)
    noise = torch.randn(1, 16, 2, 8, 12, generator=g)
    neg = torch.randn(1, 16, 48, generator=g)
    with torch.no_grad():
        x1 = sample_latents(m.dit, m.scheduler, text, mask, neg, mask, 4.0, num_gen_latents=2,
                            num_steps=1, lat_h=8, lat_w=12, cond_latents=cond, init_noise=noise)
    sig = lc_ref.sigmas(1, LONGCAT["scheduler_shift"])
    text2, mask2 = torch.cat([neg, text]), torch.cat([mask, mask])
    with fp32_matmuls():
        cache = ref.cond_cache(torch.cat([cond, cond]), text2, mask2)
        x1r = lc_ref.denoise_step(ref, noise * sig[0], sig[0], sig[1], text2, mask2, cache, 2, 4.0)
    _close(x1 - noise * sig[0], x1r - noise * sig[0])


def test_longcat_anchor():
    m, g, text, mask = _lc(2)
    ref = lc_ref.LongCat(LONGCAT, m.weights)
    cond, val = torch.randn(1, 16, 2, 8, 12, generator=g), torch.randn(1, 16, 1, 8, 12, generator=g)
    fixed = torch.randn(2, 1, 16, 1, 8, 12, generator=g)
    with torch.no_grad():
        ap = m.arch.anchor(m.dit, cond, val, text, mask, fixed, fixed_sigmas=(0.25, 0.75))
    with fp32_matmuls():
        ar = lc_ref.anchor_loss(ref, cond, val, text, mask, fixed, (0.25, 0.75), None)
    assert abs(float(ap) - ar) / ar < 1e-5


@pytest.mark.parametrize("what", ["loss", "anchor"])
def test_cogvideox_loss_gradient_and_anchor(what):
    m = cv_backbone.build(COGVIDEOX, 3, "cpu")
    for w in m.weights.values():
        if w.ndim == 2:
            w.mul_(3.0)
    g = torch.Generator().manual_seed(3)
    ref = cv_ref.CogVideoX(COGVIDEOX, m.weights)
    text = torch.randn(1, 16, 32, generator=g)
    cond, tgt = torch.randn(1, 16, 2, 8, 12, generator=g), torch.randn(1, 16, 1, 8, 12, generator=g)
    delta = torch.randn(32, generator=g) * 0.5
    if what == "anchor":
        fixed = torch.randn(2, 1, 16, 1, 8, 12, generator=g)
        with torch.no_grad():
            ap = m.arch.anchor(m.dit, cond, tgt, text, None, fixed, fixed_sigmas=(0.5,),
                               adapters={"delta_t": delta})
        with fp32_matmuls():
            ar = cv_ref.anchor_loss(ref, cond, tgt, text, None, fixed, (0.5,), delta)
        assert abs(float(ap) - ar) / ar < 1e-5
        return
    sigma, noise = torch.tensor([0.7]), torch.randn(1, 16, 3, 8, 12, generator=g)
    d1 = delta.clone().requires_grad_(True)
    with torch.enable_grad():
        lp = m.arch.loss(m.dit, cond, tgt, text, None, adapters={"delta_t": d1}, sigma=sigma,
                         noise=noise)
        (gp,) = torch.autograd.grad(lp, [d1])
    d2 = delta.clone().requires_grad_(True)
    with fp32_matmuls(), torch.enable_grad():
        lr = cv_ref.tta_loss(ref, cond, tgt, text, None, sigma, noise, d2)
        (gr,) = torch.autograd.grad(lr, [d2])
    _close(lp.detach(), lr.detach(), 1e-5)
    _close(gp, gr)


def test_reference_attention_gradient_matches_autograd():
    """The head-grouped attention's hand-written backward against autograd
    through the plain formula, with the prefix mask."""
    from benchmark.reference import common

    g = torch.Generator().manual_seed(4)
    q, k, v = (torch.randn(2, 10, 3, 8, generator=g, dtype=torch.float64).requires_grad_(True)
               for _ in range(3))
    do = torch.randn(2, 10, 3, 8, generator=g, dtype=torch.float64)
    o = common._Attention.apply(q, k, v, 4, 8 ** -0.5)
    grads = torch.autograd.grad(o, [q, k, v], do)
    mask = common.allowed_mask(10, 10, 4, "cpu")
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * 8 ** -0.5
    o2 = torch.einsum("bhqk,bkhd->bqhd", s.masked_fill(~mask, float("-inf")).softmax(-1), v)
    grads2 = torch.autograd.grad(o2, [q, k, v], do)
    assert torch.allclose(o, o2)
    for a, b in zip(grads, grads2):
        assert torch.allclose(a, b)
