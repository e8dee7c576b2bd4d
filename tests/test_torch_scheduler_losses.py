"""The port's scheduler helpers (``add_noise``, ``velocity_target``),
unconditioned flow-matching losses (``flow_matching_loss``,
``flow_matching_loss_fixed``) and clip-level metrics (``compute_psnr``,
``compute_ssim``) against the JAX package, on the cases of
tests/test_scheduler.py and on longcat_tiny with the reference's own
draws injected (fp32 on the CPU).

Tolerances: the scheduler helpers are one multiply-add per element,
1e-6 abs; the losses go through the tiny DiT's forward, 1e-5 relative
(the forwards agree to 1e-4 per element, test_torch_models.py, and the
MSE averages those differences down); the metrics are fp32 means, 1e-5
relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from longcat_video_tta_tpu import config as jconfig
from longcat_video_tta_tpu.models import dit as jdit
from longcat_video_tta_tpu.models import scheduler as jsched
from longcat_video_tta_tpu.tta import losses as jlosses
from longcat_video_tta_tpu_torch.config import SchedulerConfig, longcat_tiny
from longcat_video_tta_tpu_torch.models import scheduler as tsched
from longcat_video_tta_tpu_torch.models.weights import load_dit_from_numpy
from longcat_video_tta_tpu_torch.tta import losses as tlosses

torch.set_num_threads(1)

SCHED_TOL = dict(atol=1e-6, rtol=0)
LOSS_RTOL = 1e-5
JCFG = jconfig.longcat_tiny()
TCFG = longcat_tiny()


def _scheduler_case():
    """test_scheduler.py's draw: x0 and noise [2, 4, 3] from RandomState(0)."""
    rng = np.random.RandomState(0)
    return rng.randn(2, 4, 3).astype(np.float32), rng.randn(2, 4, 3).astype(np.float32)


@pytest.mark.parametrize("sigma", [0.7, 0.0, 1.0, "per_row"])
def test_add_noise_and_velocity_target_match_jax(sigma):
    x0, noise = _scheduler_case()
    if sigma == "per_row":  # broadcastable, as the losses pass it
        sigma = np.array([0.25, 0.9], np.float32).reshape(2, 1, 1)
    xt = tsched.add_noise(torch.from_numpy(x0), torch.from_numpy(noise),
                          torch.from_numpy(sigma) if isinstance(sigma, np.ndarray) else sigma)
    ref = jsched.add_noise(jnp.asarray(x0), jnp.asarray(noise), sigma)
    np.testing.assert_allclose(xt.numpy(), np.asarray(ref), **SCHED_TOL)
    v = tsched.velocity_target(torch.from_numpy(x0), torch.from_numpy(noise))
    np.testing.assert_allclose(v.numpy(), np.asarray(jsched.velocity_target(
        jnp.asarray(x0), jnp.asarray(noise))), **SCHED_TOL)


def test_euler_step_exact_for_constant_velocity():
    """test_scheduler.py's invariant on the port: one Euler step from sigma
    to 0 along v = noise - x0 recovers x0."""
    x0, noise = (torch.from_numpy(a) for a in _scheduler_case())
    xt = tsched.add_noise(x0, noise, 0.7)
    x_rec = tsched.euler_step(xt, tsched.velocity_target(x0, noise), 0.7, 0.0)
    np.testing.assert_allclose(x_rec.numpy(), x0.numpy(), atol=1e-5)


@pytest.mark.parametrize("steps", [1, 4, 50])
def test_build_sigmas_match_jax(steps):
    got = tsched.build_sigmas(steps, SchedulerConfig())
    ref = jsched.build_sigmas(steps, jconfig.SchedulerConfig())
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **SCHED_TOL)


@pytest.fixture(scope="module")
def model():
    params = jdit.init_dit(jax.random.PRNGKey(0), JCFG.dit, zero_init=False)
    dit = load_dit_from_numpy(jax.tree.map(np.asarray, params), TCFG.dit, "cpu")
    rng = np.random.default_rng(5)
    lat = rng.standard_normal((2, 16, 3, 8, 12)).astype(np.float32)
    text = rng.standard_normal((2, 16, 48)).astype(np.float32)
    mask = np.ones((2, 16), np.int32)
    mask[:, 9:] = 0
    return params, dit, lat, text, mask


@pytest.mark.parametrize("sigmas,draws", [((0.25, 0.5, 0.75), 2), ((0.6,), 1)])
def test_flow_matching_loss_fixed_matches_jax(model, sigmas, draws):
    """The reference draws its noises from PRNGKey(42 + d); the port takes
    the same arrays."""
    params, dit, lat, text, mask = model
    ref = jlosses.flow_matching_loss_fixed(params, JCFG.dit, jnp.asarray(lat),
                                           jnp.asarray(text), jnp.asarray(mask),
                                           fixed_sigmas=sigmas, noise_draws=draws)
    noises = np.stack([np.array(jax.random.normal(jax.random.PRNGKey(42 + d), lat.shape,
                                                  jnp.float32)) for d in range(draws)])
    with torch.no_grad():
        got = tlosses.flow_matching_loss_fixed(dit, torch.from_numpy(lat),
                                               torch.from_numpy(text), torch.from_numpy(mask),
                                               torch.from_numpy(noises), fixed_sigmas=sigmas)
    np.testing.assert_allclose(float(got), float(ref), rtol=LOSS_RTOL)


def test_flow_matching_loss_matches_jax(model):
    """The reference's sigma and noise, drawn as it draws them from its
    key, injected into the port."""
    params, dit, lat, text, mask = model
    key = jax.random.PRNGKey(3)
    ref = jlosses.flow_matching_loss(params, JCFG.dit, jnp.asarray(lat), jnp.asarray(text),
                                     jnp.asarray(mask), key)
    k_sig, k_noise = jax.random.split(key)
    sigma = np.array(jax.random.uniform(k_sig, (2,), minval=0.001, maxval=1.0))
    noise = np.array(jax.random.normal(k_noise, lat.shape, jnp.float32))
    with torch.no_grad():
        got = tlosses.flow_matching_loss(dit, torch.from_numpy(lat), torch.from_numpy(text),
                                         torch.from_numpy(mask), sigma=torch.from_numpy(sigma),
                                         noise=torch.from_numpy(noise))
        drawn = tlosses.flow_matching_loss(dit, torch.from_numpy(lat), torch.from_numpy(text),
                                           torch.from_numpy(mask),
                                           generator=torch.Generator().manual_seed(0))
    np.testing.assert_allclose(float(got), float(ref), rtol=LOSS_RTOL)
    assert np.isfinite(float(drawn)) and float(drawn) != float(got)


@pytest.mark.parametrize("noise", [0.05, 0.0])
def test_compute_psnr_and_ssim_match_jax(noise):
    """The clip-level means of eval/metrics.py (at noise 0: PSNR's 50 dB
    clamp, SSIM 1)."""
    from longcat_video_tta_tpu.eval import metrics as jmetrics
    from longcat_video_tta_tpu_torch.eval import metrics as tmetrics

    rng = np.random.default_rng(7)
    gt = rng.uniform(0, 1, (3, 32, 48, 3)).astype(np.float32)
    pred = np.clip(gt + noise * rng.standard_normal(gt.shape), 0, 1).astype(np.float32)
    np.testing.assert_allclose(tmetrics.compute_psnr(pred, gt),
                               jmetrics.compute_psnr(pred, gt), rtol=1e-5)
    np.testing.assert_allclose(tmetrics.compute_ssim(pred, gt),
                               jmetrics.compute_ssim(pred, gt), rtol=1e-5, atol=1e-6)
