"""path_tracer_tpu_torch core against the JAX package: RNG, spectra,
tone mapping, vMF sampling and camera rays, on inputs made with numpy."""

from types import SimpleNamespace

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from path_tracer_tpu.core import sampling as jsampling
from path_tracer_tpu.core import spectrum as jspectrum
from path_tracer_tpu.core import tonemap as jtonemap
from path_tracer_tpu.ops import camera as jcamera
from path_tracer_tpu_torch.core import sampling as tsampling
from path_tracer_tpu_torch.core import spectrum as tspectrum
from path_tracer_tpu_torch.core import tonemap as ttonemap
from path_tracer_tpu_torch.ops import camera as tcamera

# Transcendentals (exp, log, sin, cos, atan2) differ in the last bits
# between XLA's CPU kernels and PyTorch's; everything else is the same
# float32 arithmetic in the same order.
RTOL = 2e-5
ATOL = 2e-6


def _rngs(n, seed):
    lane = np.arange(n, dtype=np.uint32)
    j = jsampling.Rng.seed(jnp.asarray(lane), jnp.uint32(seed))
    t = tsampling.Rng.seed(torch.from_numpy(lane.astype(np.int64)), seed)
    return j, t


@pytest.mark.parametrize('seed', [0, 123, 0xFFFFFFFF])
def test_rng_streams_bit_exact(seed):
    """64k lanes x 8 draws: the int64-emulated uint32 stream equals the
    JAX uint32 stream bit for bit, and so do the float32 uniforms."""
    j, t = _rngs(65536, seed)
    np.testing.assert_array_equal(np.asarray(j.state).astype(np.int64),
                                  t.state.numpy())
    for _ in range(4):
        np.testing.assert_array_equal(
            np.asarray(j.next_u32()).astype(np.int64), t.next_u32().numpy())
        np.testing.assert_array_equal(np.asarray(j.uniform()),
                                      t.uniform().numpy())
    np.testing.assert_array_equal(np.asarray(j.state).astype(np.int64),
                                  t.state.numpy())


def test_spectrum_functions():
    rng = np.random.default_rng(1)
    lam = rng.uniform(360, 830, (4, 4096)).astype(np.float32)
    beta = rng.normal(0, 1e-3, (4, 4096)).astype(np.float32)
    beta[3] = np.abs(beta[3]) * 1e3
    np.testing.assert_allclose(
        tspectrum.sample_standard_observer(torch.from_numpy(lam)).numpy(),
        np.asarray(jspectrum.sample_standard_observer(lam)), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(
        tspectrum.sample_parametric_spectrum_scaled(
            torch.from_numpy(beta[:, None, :].repeat(4, 1)), torch.from_numpy(lam)).numpy(),
        np.asarray(jspectrum.sample_parametric_spectrum_scaled(
            beta[:, None, :].repeat(4, 1), lam)), rtol=RTOL, atol=ATOL)
    nl0 = rng.uniform(0, 1, 4096).astype(np.float32)
    np.testing.assert_array_equal(
        tspectrum.hero_wavelength_cluster(torch.from_numpy(nl0)).numpy(),
        np.asarray(jspectrum.hero_wavelength_cluster(nl0)))
    xyz = rng.uniform(0, 2, (3, 4096)).astype(np.float32)
    np.testing.assert_allclose(tspectrum.xyz_to_srgb(torch.from_numpy(xyz)).numpy(),
                               np.asarray(jspectrum.xyz_to_srgb(xyz)),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize('mode', [0, 1, 2, 3])
def test_tonemap(mode):
    color = np.random.default_rng(2).uniform(0, 4, (3, 64, 32)).astype(np.float32)
    np.testing.assert_allclose(
        ttonemap.tonemap(torch.from_numpy(color), mode).numpy(),
        np.asarray(jtonemap.tonemap(jnp.asarray(color), mode)),
        rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize('kappa', [0.0, 3.5, 80.0])
def test_von_mises_fisher(kappa):
    n = 4096
    rng = np.random.default_rng(3)
    mu = rng.normal(0, 1, (3, n)).astype(np.float32)
    mu /= np.linalg.norm(mu, axis=0, keepdims=True)
    j, t = _rngs(n, 9)
    jd = jsampling.random_von_mises_fisher(j, jnp.float32(kappa), jnp.asarray(mu))
    td = tsampling.random_von_mises_fisher(
        t, torch.tensor(kappa, dtype=torch.float32), torch.from_numpy(mu))
    # Near-pole samples amplify a last-bit difference of log/exp through
    # sqrt(1 - z^2); the directions stay unit vectors within 2e-4.
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=2e-4)
    np.testing.assert_allclose(
        tsampling.von_mises_fisher_pdf(torch.tensor(kappa, dtype=torch.float32),
                                       torch.from_numpy(mu), td).numpy(),
        np.asarray(jsampling.von_mises_fisher_pdf(jnp.float32(kappa), mu,
                                                  jnp.asarray(td.numpy()))),
        rtol=1e-4, atol=1e-6)


def _cameras():
    world = np.eye(4, dtype=np.float32)
    world[:3, :3] = np.array([[1, 0, 0], [0, 0, -1], [0, 1, 0]], np.float32)
    world[:3, 3] = [0.5, -4.0, 1.5]
    return dict(
        camera_sensor_size=np.array([[0.8, 0.45], [0.036, 0.024], [1, 1]], np.float32),
        camera_sensor_distance=np.array([1.0, 0.0362, 1.0], np.float32),
        camera_aperture_radius=np.array([0.004, 0.004, 0.0], np.float32),
        camera_focal_length=np.array([0.0, 0.035, 0.0], np.float32),
        camera_world_from_camera=np.stack([world] * 3),
    )


@pytest.mark.parametrize('model', [0, 1, 2])
def test_camera_rays(model):
    """Pinhole, thin-lens and 360 rays from the same sample positions and
    random streams."""
    cams = _cameras()
    n = 4096
    ndc = np.random.default_rng(4).uniform(0, 1, (2, n)).astype(np.float32)
    j, t = _rngs(n, 5)
    jo, jd = jcamera.generate_camera_rays(
        SimpleNamespace(**{k: jnp.asarray(v) for k, v in cams.items()}),
        model, model, jnp.asarray(ndc), j)
    to, td = tcamera.generate_camera_rays(
        SimpleNamespace(**{k: torch.from_numpy(v) for k, v in cams.items()}),
        model, model, torch.from_numpy(ndc), t)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(t.state.numpy(), np.asarray(j.state).astype(np.int64))
