"""PyTorch port ops/layers.py and models/scheduler.py vs their JAX twins
on the same numpy inputs. fp32 throughout; tolerance 1e-6 abs / 1e-5 rel
(elementwise math, differences are last-ulp)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from longcat_video_tta_tpu.config import SchedulerConfig as JSched
from longcat_video_tta_tpu.models import scheduler as jsched
from longcat_video_tta_tpu.ops import layers as jl
from longcat_video_tta_tpu_torch.config import SchedulerConfig
from longcat_video_tta_tpu_torch.models import scheduler as tsched
from longcat_video_tta_tpu_torch.ops import layers as tl

torch.set_num_threads(1)

TOL = dict(atol=1e-6, rtol=1e-5)
RNG = np.random.default_rng(0)


def _x(*shape, scale=1.0):
    return (RNG.standard_normal(shape) * scale).astype(np.float32)


def _close(t, j, **kw):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), **(kw or TOL))


@pytest.mark.parametrize("with_weight", [True, False])
def test_rms_norm(with_weight):
    x, w = _x(2, 5, 3, 16), _x(16)
    wt = torch.from_numpy(w) if with_weight else None
    wj = jnp.asarray(w) if with_weight else None
    _close(tl.rms_norm(torch.from_numpy(x), wt), jl.rms_norm(jnp.asarray(x), wj))


@pytest.mark.parametrize("affine", [True, False])
def test_layer_norm(affine):
    x, w, b = _x(2, 7, 24, scale=3.0), _x(24), _x(24)
    args_t = (torch.from_numpy(w), torch.from_numpy(b)) if affine else ()
    args_j = (jnp.asarray(w), jnp.asarray(b)) if affine else ()
    _close(tl.layer_norm(torch.from_numpy(x), *args_t),
           jl.layer_norm(jnp.asarray(x), *args_j), atol=2e-6, rtol=1e-5)


def test_modulate():
    x, s, c = _x(2, 3, 4, 8), _x(2, 3, 1, 8), _x(2, 3, 1, 8)
    _close(tl.modulate(*map(torch.from_numpy, (x, s, c))),
           jl.modulate(*map(jnp.asarray, (x, s, c))))


@pytest.mark.parametrize("bias", [True, False])
def test_linear(bias):
    x, w, b = _x(3, 5, 12), _x(12, 7), _x(7)
    lin = torch.nn.Linear(12, 7, bias=bias)
    with torch.no_grad():
        lin.weight.copy_(torch.from_numpy(w.T))
        if bias:
            lin.bias.copy_(torch.from_numpy(b))
    p = {"kernel": jnp.asarray(w)}
    if bias:
        p["bias"] = jnp.asarray(b)
    _close(tl.linear(lin, torch.from_numpy(x)), jl.linear(p, jnp.asarray(x)),
           atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("dim", [32, 256])
def test_timestep_embedding(dim):
    """Tolerance 1e-4: the fp32 argument t * freq reaches ~1e3, where one
    ulp is 6e-5 (the two frameworks round exp(freq) differently)."""
    t = np.array([[0.0, 640.0], [999.0, 12.5]], np.float32)
    _close(tl.timestep_embedding(torch.from_numpy(t), dim),
           jl.timestep_embedding(jnp.asarray(t), dim), atol=1e-4, rtol=1e-4)


def test_mlp_embedder():
    f, w1, b1, w2, b2 = _x(2, 3, 32), _x(32, 16), _x(16), _x(16, 16), _x(16)
    l1, l2 = torch.nn.Linear(32, 16), torch.nn.Linear(16, 16)
    with torch.no_grad():
        l1.weight.copy_(torch.from_numpy(w1.T))
        l1.bias.copy_(torch.from_numpy(b1))
        l2.weight.copy_(torch.from_numpy(w2.T))
        l2.bias.copy_(torch.from_numpy(b2))
    p = {k: jnp.asarray(v) for k, v in
         dict(w1=w1, b1=b1, w2=w2, b2=b2).items()}
    _close(tl.mlp_embedder(l1, l2, torch.from_numpy(f)),
           jl.mlp_embedder(p, jnp.asarray(f)), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("dims,t_offset", [((8, 12, 12), 0), ((32, 48, 48), 3)])
def test_rope_3d_angles(dims, t_offset):
    ct, st = tl.rope_3d_angles(3, 4, 5, dims, 10000.0, t_offset=t_offset)
    cj, sj = jl.rope_3d_angles(3, 4, 5, dims, 10000.0, t_offset=t_offset)
    assert ct.shape == (3, 20, sum(dims) // 2)
    _close(ct, cj, atol=2e-6, rtol=1e-5)
    _close(st, sj, atol=2e-6, rtol=1e-5)


def test_apply_rope():
    x = _x(2, 3, 20, 2, 32)
    cj, sj = jl.rope_3d_angles(3, 4, 5, (8, 12, 12))
    ct, st = torch.from_numpy(np.array(cj)), torch.from_numpy(np.array(sj))
    _close(tl.apply_rope(torch.from_numpy(x), ct, st),
           jl.apply_rope(jnp.asarray(x), cj, sj))


@pytest.mark.parametrize("shift", [1.0, 3.0, 5.0])
def test_timestep_shift(shift):
    s = np.linspace(0.0, 1.0, 11).astype(np.float32)
    _close(tsched.timestep_shift(torch.from_numpy(s), shift),
           jsched.timestep_shift(jnp.asarray(s), shift))


@pytest.mark.parametrize("steps", [1, 2, 4, 50])
def test_build_sigmas(steps):
    st = tsched.build_sigmas(steps, SchedulerConfig())
    sj = jsched.build_sigmas(steps, JSched())
    assert st.shape == (steps + 1,) and float(st[-1]) == 0.0
    _close(st, sj)


def test_sigma_to_timestep_and_euler_step():
    sig = np.array([0.9, 0.3], np.float32)
    _close(tsched.sigma_to_timestep(torch.from_numpy(sig), SchedulerConfig()),
           jsched.sigma_to_timestep(jnp.asarray(sig), JSched()), atol=1e-4)
    x, v = _x(1, 4, 2, 3, 3), _x(1, 4, 2, 3, 3)
    sigmas = tsched.build_sigmas(4, SchedulerConfig())
    jsig = jsched.build_sigmas(4, JSched())
    _close(tsched.euler_step(torch.from_numpy(x), torch.from_numpy(v),
                             sigmas[1], sigmas[2]),
           jsched.euler_step(jnp.asarray(x), jnp.asarray(v), jsig[1], jsig[2]))
