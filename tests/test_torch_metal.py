"""The port's BASIC_METAL model against the JAX package: the GGX
functions, the F82-tint Fresnel, the BSDF (rough and Dirac), the
two-model dispatch, and the slice as a whole: a frame of the two-instance
diffuse + metal scene in 'flat' and in 'inst' mode.

Function inputs are made with numpy from a seed and go through both
packages. The two run the same float32 operations in the same order;
sqrt, cos, sin and pow differ in the last bit between XLA's CPU kernels
and PyTorch's, so functions agree to rtol 1e-5 / atol 1e-6 (see `_close`
for the few ill-conditioned lanes), and frames, in which such a bit can
send a path elsewhere, within bench.py's Monte-Carlo bands at their
floor (2% mean absolute error, 2% bias).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import path_tracer_tpu as jpkg
import path_tracer_tpu.scene.model as jmodel
import path_tracer_tpu.scene.procedural as jproc
import path_tracer_tpu_torch as tpkg
import path_tracer_tpu_torch.scene.compile as tcompile
import path_tracer_tpu_torch.scene.model as tmodel
import path_tracer_tpu_torch.scene.procedural as tproc
from path_tracer_tpu.core import optics as joptics
from path_tracer_tpu.core import sampling as jsampling
from path_tracer_tpu.core.constants import (
    MATERIAL_TYPE_BASIC_DIFFUSE, MATERIAL_TYPE_BASIC_METAL)
from path_tracer_tpu.models import basic_metal as jmetal
from path_tracer_tpu.models import dispatch as jdispatch
from path_tracer_tpu_torch.core import optics as toptics
from path_tracer_tpu_torch.core import sampling as tsampling
from path_tracer_tpu_torch.models import basic_metal as tmetal
from path_tracer_tpu_torch.models import dispatch as tdispatch

from test_torch_cuda import flat_mode, two_instance_scene

RTOL, ATOL = 1e-5, 1e-6
N = 4096
BOTH = (MATERIAL_TYPE_BASIC_DIFFUSE, MATERIAL_TYPE_BASIC_METAL)


def _close(port, ref):
    """Within RTOL/ATOL on at least 99.9% of the elements and within
    rtol 2e-3 on all: sqrt(1 - x^2) near x = 1 (a grazing visible normal,
    a half vector at the lobe's edge) multiplies a last-bit difference of
    cos or sqrt many times over on a few lanes in a thousand."""
    port = port.numpy() if torch.is_tensor(port) else np.asarray(port)
    ref = np.asarray(ref)
    within = np.abs(port - ref) <= ATOL + RTOL * np.abs(ref)
    assert within.mean() >= 0.999, within.mean()
    np.testing.assert_allclose(port, ref, rtol=2e-3, atol=1e-4)


def _hemisphere(rng, n):
    """Unit directions with z in (0.02, 1]: the side the BSDF accepts."""
    v = rng.normal(0, 1, (3, n)).astype(np.float32)
    v[2] = np.abs(v[2]) + 0.02
    return (v / np.linalg.norm(v, axis=0, keepdims=True)).astype(np.float32)


def _ctx(rng, n, roughness):
    """Material context columns as numpy: metal lanes of the given
    roughness (a scalar, or None for a mix of rough and Dirac lanes)."""
    if roughness is None:
        rough = np.where(rng.uniform(0, 1, n) < 0.5, 5e-4,
                         rng.uniform(0.05, 1.0, n)).astype(np.float32)
    else:
        rough = np.full(n, roughness, np.float32)
    return dict(
        type=rng.integers(1, 3, n).astype(np.int32),
        roughness=rough,
        roughness_anisotropy=rng.uniform(0, 0.8, n).astype(np.float32),
        base_reflectance=rng.uniform(0.05, 0.95, (4, n)).astype(np.float32),
        specular_reflectance=rng.uniform(0.05, 1.0, (4, n)).astype(np.float32),
    )


def _both(ctx):
    return ({k: jnp.asarray(v) for k, v in ctx.items()},
            {k: torch.from_numpy(v) for k, v in ctx.items()})


def test_ggx_functions():
    rng = np.random.default_rng(21)
    rough = rng.uniform(0.02, 1.0, N).astype(np.float32)
    aniso = rng.uniform(0, 0.9, N).astype(np.float32)
    view, other = _hemisphere(rng, N), _hemisphere(rng, N)
    u1, u2 = (rng.uniform(0, 1, N).astype(np.float32) for _ in range(2))
    ja = jsampling.ggx_roughness_alpha(rough, aniso)
    ta = tsampling.ggx_roughness_alpha(torch.from_numpy(rough),
                                       torch.from_numpy(aniso))
    _close(ta, ja)
    tv, to = torch.from_numpy(view), torch.from_numpy(other)
    _close(tsampling.ggx_smith_g1(tv, ta), jsampling.ggx_smith_g1(view, ja))
    _close(tsampling.ggx_distribution(to, ta),
           jsampling.ggx_distribution(other, ja))
    _close(tsampling.ggx_visible_normal(tv, ta, torch.from_numpy(u1),
                                        torch.from_numpy(u2)),
           jsampling.ggx_visible_normal(view, ja, u1, u2))
    grazing = np.array([[1.0, 0.0], [0.0, 0.6], [0.0, 0.8]], np.float32)
    assert tsampling.ggx_smith_g1(torch.from_numpy(grazing), ta[:, :2])[0] == 0.0


def test_schlick_fresnel_metal():
    rng = np.random.default_rng(22)
    base = rng.uniform(0, 1, (4, N)).astype(np.float32)
    spec = rng.uniform(0, 1, (4, N)).astype(np.float32)
    cos = rng.uniform(-0.1, 1.0, N).astype(np.float32)
    _close(toptics.schlick_fresnel_metal(*(torch.from_numpy(x)
                                           for x in (base, spec, cos))),
           joptics.schlick_fresnel_metal(base, spec, cos))


@pytest.mark.parametrize('roughness', [0.3, 0.7, 5e-4],
                         ids=['rough', 'very_rough', 'dirac'])
def test_basic_metal_bsdf(roughness):
    """evaluate_bsdf and sample_bsdf of the metal, rough and Dirac
    (roughness < 1e-3: probability 1, still a valid reflection)."""
    rng = np.random.default_rng(23)
    jctx, tctx = _both(_ctx(rng, N, roughness))
    view, light = _hemisphere(rng, N), _hemisphere(rng, N)
    u = [rng.uniform(0, 1, N).astype(np.float32) for _ in range(3)]

    jd, jthr, jpdf, jok = jmetal.sample_bsdf(jctx, jnp.asarray(view), *u)
    td, tthr, tpdf, tok = tmetal.sample_bsdf(
        tctx, torch.from_numpy(view), *(torch.from_numpy(x) for x in u))
    ok = np.asarray(jok)
    # The mask flips only where scattered.z is a rounding away from 0.
    assert (tok.numpy() == ok).mean() > 0.999 and ok.mean() > 0.5
    _close(td, jd)
    _close(tpdf, jpdf)
    _close(tthr, jthr)
    dirac = roughness < 1e-3
    assert bool(tmetal.has_dirac_bsdf(tctx).all()) == dirac
    assert bool((tpdf == 1.0).all()) == dirac

    jthr, jpdf, jok = jmetal.evaluate_bsdf(jctx, jnp.asarray(view), jnp.asarray(light))
    tthr, tpdf, tok = tmetal.evaluate_bsdf(tctx, torch.from_numpy(view),
                                           torch.from_numpy(light))
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
    assert bool(tok.any()) != dirac
    _close(tpdf, jpdf)
    _close(tthr, jthr)


def test_dispatch_selects_by_material_type():
    """Diffuse and metal lanes mixed, rough and Dirac: has_dirac_bsdf,
    evaluate_bsdf and sample_bsdf of the dispatch against the JAX
    dispatch with the same static type set, and the same RNG draws."""
    rng = np.random.default_rng(24)
    jctx, tctx = _both(_ctx(rng, N, None))
    view, light = _hemisphere(rng, N), _hemisphere(rng, N)
    np.testing.assert_array_equal(
        tdispatch.has_dirac_bsdf(tctx, BOTH).numpy(),
        np.asarray(jdispatch.has_dirac_bsdf(jctx, BOTH)))
    assert 0.1 < tdispatch.has_dirac_bsdf(tctx, BOTH).float().mean() < 0.4
    tout = tdispatch.evaluate_bsdf(tctx, torch.from_numpy(view),
                                   torch.from_numpy(light), BOTH)
    jout = jdispatch.evaluate_bsdf(jctx, jnp.asarray(view), jnp.asarray(light),
                                   BOTH)
    _close(tout[0], jout[0])
    _close(tout[1], jout[1])
    np.testing.assert_array_equal(tout[2].numpy(), np.asarray(jout[2]))
    lane = np.arange(N, dtype=np.uint32)
    jrng = jsampling.Rng.seed(jnp.asarray(lane), jnp.uint32(3))
    trng = tsampling.Rng.seed(torch.from_numpy(lane.astype(np.int64)), 3)
    jout = jdispatch.sample_bsdf(jctx, jnp.asarray(view), jrng, BOTH)
    tout = tdispatch.sample_bsdf(tctx, torch.from_numpy(view), trng, BOTH)
    np.testing.assert_array_equal(trng.state.numpy(),
                                  np.asarray(jrng.state).astype(np.int64))
    _close(tout[0], jout[0])
    for a, b in zip(tout[1:3], jout[1:3]):
        _close(a, b)
    assert (tout[3].numpy() == np.asarray(jout[3])).mean() > 0.999


@pytest.fixture(scope='module')
def jax_frame():
    return np.asarray(jpkg.render_scene(two_instance_scene(jmodel, jproc),
                                        64, 32, spp_rounds=4, seed=3))


@pytest.mark.parametrize('mode', ['flat', 'inst'])
def test_render_scene_matches_jax_in_mc_bands(jax_frame, mode):
    """The slice as a whole: render_scene of the two-instance diffuse +
    metal scene, 64x32, 4 rounds, seed 3, on the CPU through the flat
    tables (wide_trace5) and through the instanced tables (inst_trace),
    each against the JAX package's frame. The packages draw the same
    random numbers."""
    scene = two_instance_scene(tmodel, tproc)
    if mode == 'flat':
        with flat_mode(tcompile):
            img = tpkg.render_scene(scene, 64, 32, spp_rounds=4, seed=3,
                                    device='cpu').numpy()
    else:
        img = tpkg.render_scene(scene, 64, 32, spp_rounds=4, seed=3,
                                device='cpu').numpy()
    assert scene.packet_mode == mode
    assert img.shape == jax_frame.shape == (32, 64, 3)
    assert np.isfinite(img).all() and img.mean() > 0.01
    rel = np.abs(img - jax_frame).mean() / (jax_frame.mean() + 1e-3)
    bias = abs(img.mean() - jax_frame.mean()) / (jax_frame.mean() + 1e-3)
    assert rel < 0.02 and bias < 0.02, (rel, bias)
