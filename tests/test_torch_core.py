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


def _observer_float64(lam):
    """sample_standard_observer's lobes evaluated by numpy in float64."""
    lam = lam.astype(np.float64)

    def lobe(scale, center, slope_lo, slope_hi):
        t = (lam - center) * np.where(lam < center, slope_lo, slope_hi)
        return scale * np.exp(-0.5 * t * t)

    return np.stack([
        lobe(0.362, 442.0, 0.0624, 0.0374) + lobe(1.056, 599.8, 0.0264, 0.0323)
        - lobe(0.065, 501.1, 0.0490, 0.0382),
        lobe(0.821, 568.8, 0.0213, 0.0247) + lobe(0.286, 530.9, 0.0613, 0.0322),
        lobe(1.217, 437.0, 0.0845, 0.0278) + lobe(0.681, 459.0, 0.0385, 0.0725)])


def test_spectrum_functions():
    rng = np.random.default_rng(1)
    lam = rng.uniform(360, 830, (4, 4096)).astype(np.float32)
    beta = rng.normal(0, 1e-3, (4, 4096)).astype(np.float32)
    beta[3] = np.abs(beta[3]) * 1e3
    # Both packages are held to a float64 evaluation first, so that a
    # failure names the side that moved and the state of torch's CPU
    # backend in this process.
    exact = _observer_float64(lam)
    port = tspectrum.sample_standard_observer(torch.from_numpy(lam)).numpy()
    ref = np.asarray(jspectrum.sample_standard_observer(lam))
    flush = getattr(torch, 'get_flush_denormal', lambda: 'unknown')()
    np.testing.assert_allclose(
        port, exact, rtol=RTOL, atol=ATOL,
        err_msg=f'the port left float64 (torch threads '
                f'{torch.get_num_threads()}, flush denormal {flush})')
    np.testing.assert_allclose(ref, exact, rtol=RTOL, atol=ATOL,
                               err_msg='JAX left float64')
    np.testing.assert_allclose(port, ref, rtol=RTOL, atol=ATOL)
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


def test_d65_table_interpolation():
    """tests/test_spectrum.py's nodes and midpoint, and the JAX package's
    values over the whole range, bit for bit."""
    from path_tracer_tpu_torch.core.constants import CIE_LAMBDA_MAX, CIE_LAMBDA_MIN
    d65 = tspectrum.sample_illuminant_d65
    assert np.isclose(float(d65(0.0)), 46.638, atol=1e-3)
    nl_560 = (560.0 - CIE_LAMBDA_MIN) / (CIE_LAMBDA_MAX - CIE_LAMBDA_MIN)
    assert np.isclose(float(d65(nl_560)), 100.0, atol=1e-3)
    nl = (360.5 - CIE_LAMBDA_MIN) / (CIE_LAMBDA_MAX - CIE_LAMBDA_MIN)
    assert np.isclose(float(d65(nl)), (46.638 + 47.183) / 2, atol=1e-3)
    grid = np.linspace(0.0, 1.0, 4097, dtype=np.float32)
    np.testing.assert_array_equal(d65(torch.from_numpy(grid)).numpy(),
                                  np.asarray(jspectrum.sample_illuminant_d65(grid)))


def test_xyz_srgb_roundtrip():
    """srgb_to_xyz against the JAX package's, and the round trip through
    the reference's 4-decimal matrices (inexact inverses: ~1.5e-2)."""
    rgb = np.random.RandomState(0).rand(3, 100).astype(np.float32)
    xyz = tspectrum.srgb_to_xyz(torch.from_numpy(rgb))
    np.testing.assert_allclose(xyz.numpy(), np.asarray(jspectrum.srgb_to_xyz(rgb)),
                               rtol=RTOL, atol=ATOL)
    back = tspectrum.xyz_to_srgb(xyz).numpy()
    np.testing.assert_allclose(back, rgb, atol=2e-2)


@pytest.mark.parametrize('samples', [16, 471])
def test_observe_parametric_spectrum_under_d65(samples):
    """A flat unit spectrum observes to the D65 white point, and random
    spectra (with and without an intensity row) to the JAX package's XYZ."""
    white = tspectrum.observe_parametric_spectrum_under_d65(
        torch.tensor([0.0, 0.0, 1e6]), sample_count=samples).numpy()
    if samples == 471:
        assert np.isclose(white[1], 1.0, atol=0.02)
        chroma = white / white.sum()
        assert np.isclose(chroma[0], 0.3127, atol=0.01)
        assert np.isclose(chroma[1], 0.3290, atol=0.01)
    beta = np.random.default_rng(2).normal(0, 1e-3, (4, 512)).astype(np.float32)
    beta[2] *= 1e3
    beta[3] = np.abs(beta[3]) * 1e3
    for b in (beta, beta[:3]):
        np.testing.assert_allclose(
            tspectrum.observe_parametric_spectrum_under_d65(
                torch.from_numpy(b), sample_count=samples).numpy(),
            np.asarray(jspectrum.observe_parametric_spectrum_under_d65(
                b, sample_count=samples)), rtol=RTOL, atol=ATOL)


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
