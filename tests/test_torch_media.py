"""The port's dielectrics and media against the JAX package: the three
dielectric optics functions, Henyey-Greenstein phase sampling, the
BASIC_TRANSLUCENT model (rough and smooth, entering and leaving), the
static specialization flags of the scatter stage, and frames of the
sphere array (thin lens) and of the glass-ball mesh scene in both packet
modes. The scatter step with media is in tests/test_torch_openpbr.py,
which renders the scene it starts from.

Inputs are made with numpy from a seed and go through both packages;
functions are held with `_close` of tests/test_torch_metal.py and masks
on >= 99.9% of the lanes (the uniforms the models take are given, so
no call here draws from a stream).
"""

import contextlib
import dataclasses

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
from path_tracer_tpu.core.constants import MATERIAL_TYPE_BASIC_TRANSLUCENT
from path_tracer_tpu.models import basic_translucent as jtrans
from path_tracer_tpu_torch.core import optics as toptics
from path_tracer_tpu_torch.core import sampling as tsampling
from path_tracer_tpu_torch.integrator import wavefront as twavefront
from path_tracer_tpu_torch.models import basic_translucent as ttrans

from test_torch_cuda import flat_mode, glass_ball_scene
from test_torch_cuda import spectrum_beta as _beta
from test_torch_cuda import unit_directions as _unit
from test_torch_metal import _close

N = 4096


def translucent_ctx(rng, n, roughness):
    """BASIC_TRANSLUCENT context columns as numpy; roughness 'rough' or
    'smooth' (under the Dirac threshold); an exterior IOR of air or
    water; a quarter of the lanes without a transmission depth. The
    interior IORs (1.5 to 1.9) keep the interface away from an index
    match, where a refracted half vector out + eta * view nearly vanishes
    and its Jacobian turns a last-bit difference into 1e-4; the rough
    lanes (roughness 0.2 to 0.8) keep away from sharp lobes, whose GGX
    density divides a last-bit difference of a half vector by alpha."""
    rough = (rng.uniform(0.2, 0.8, n) if roughness == 'rough'
             else np.full(n, 5e-4)).astype(np.float32)
    return dict(
        type=np.full(n, MATERIAL_TYPE_BASIC_TRANSLUCENT, np.int32),
        lam=rng.uniform(380, 720, (4, n)).astype(np.float32),
        exterior_ior=np.where(rng.uniform(0, 1, n) < 0.5, 1.0, 1.33)
        .astype(np.float32) * np.ones((4, 1), np.float32),
        ior=rng.uniform(1.5, 1.9, n).astype(np.float32),
        abbe_number=rng.uniform(20, 60, n).astype(np.float32),
        roughness=rough,
        roughness_anisotropy=rng.uniform(0, 0.8, n).astype(np.float32),
        transmission_spectrum=_beta(rng, n),
        transmission_depth=np.where(rng.uniform(0, 1, n) < 0.25, 0.0,
                                    rng.uniform(0.2, 2.0, n)).astype(np.float32),
        scattering_spectrum=_beta(rng, n),
        scattering_anisotropy=rng.uniform(-0.9, 0.9, n).astype(np.float32),
    )


def both(ctx):
    return ({k: jnp.asarray(v) for k, v in ctx.items()},
            {k: torch.from_numpy(v) for k, v in ctx.items()})


def test_dielectric_optics():
    """Cauchy dispersion, the refracted cosine and the dielectric Fresnel,
    with relative IORs on both sides of 1 so that some lanes are totally
    internally reflected (refracted cosine 0, reflectance 1)."""
    rng = np.random.default_rng(31)
    ior = rng.uniform(1.3, 1.9, N).astype(np.float32)
    abbe = rng.uniform(15, 70, N).astype(np.float32)
    lam = rng.uniform(380, 720, (4, N)).astype(np.float32)
    _close(toptics.cauchy_empirical_ior(*map(torch.from_numpy, (ior, abbe, lam))),
           joptics.cauchy_empirical_ior(ior, abbe, lam))

    eta = rng.uniform(0.5, 2.0, N).astype(np.float32)
    cos1 = rng.uniform(-1, 1, N).astype(np.float32)
    cos2 = joptics.cos_theta_refracted(eta, cos1)
    tcos2 = toptics.cos_theta_refracted(torch.from_numpy(eta), torch.from_numpy(cos1))
    _close(tcos2, cos2)
    tir = np.asarray(cos2) == 0.0
    assert 0.05 < tir.mean() < 0.5
    np.testing.assert_array_equal(tcos2.numpy() == 0.0, tir)
    f = joptics.fresnel_dielectric(eta, cos1)
    tf = toptics.fresnel_dielectric(torch.from_numpy(eta), torch.from_numpy(cos1))
    _close(tf, f)
    np.testing.assert_allclose(tf.numpy()[tir], 1.0, rtol=1e-6)
    # Per-wavelength etas against one cosine pair, as the models call it.
    eta4 = rng.uniform(0.6, 1.6, (4, N)).astype(np.float32)
    c2 = rng.uniform(-1, 1, N).astype(np.float32)
    _close(toptics.fresnel_dielectric(*map(torch.from_numpy, (eta4, cos1, c2))),
           joptics.fresnel_dielectric(eta4, cos1, c2))


@pytest.mark.parametrize('g', [-0.9, 0.0, 0.9])
def test_sample_direction_hg(g):
    """Henyey-Greenstein samples for forward, isotropic and backward
    scattering: the directions, and the reference's sign convention (mean
    cosine -g about +Z)."""
    rng = np.random.default_rng(32)
    u1, u2 = (rng.uniform(0, 1, N).astype(np.float32) for _ in range(2))
    aniso = np.full(N, g, np.float32)
    ref = jsampling.sample_direction_hg(aniso, u1, u2)
    out = tsampling.sample_direction_hg(*map(torch.from_numpy, (aniso, u1, u2)))
    _close(out, ref)
    np.testing.assert_allclose(np.linalg.norm(out.numpy(), axis=0), 1.0, atol=1e-5)
    assert abs(out[2].mean().item() + g) < 0.05


def test_translucent_load_medium():
    rng = np.random.default_rng(33)
    jctx, tctx = both(translucent_ctx(rng, N, 'rough'))
    ref = jtrans.load_medium(jctx)
    out = ttrans.load_medium(tctx)
    assert out.keys() == ref.keys()
    for key in ('ior', 'absorption', 'scattering', 'anisotropy'):
        _close(out[key], ref[key])
    assert bool(out['has_medium'].all())
    none = tctx['transmission_depth'] == 0.0
    assert bool((out['scattering'][:, none] == 0).all()) and bool(none.any())


@pytest.mark.parametrize('side', ['entering', 'leaving'])
@pytest.mark.parametrize('roughness', ['rough', 'smooth'])
def test_translucent_bsdf(roughness, side):
    """evaluate_bsdf and sample_bsdf of the dispersive dielectric, rough
    and smooth (Dirac: the smooth refraction collapses to the primary
    wavelength), with the view above the surface (entering) or below it
    (leaving). Light directions for evaluate_bsdf lie on both sides, so
    the reflection and the per-wavelength refraction branches run."""
    rng = np.random.default_rng(34 + (roughness == 'smooth') + 2 * (side == 'leaving'))
    jctx, tctx = both(translucent_ctx(rng, N, roughness))
    view = _unit(rng, N, 1 if side == 'entering' else -1)
    light = _unit(rng, N)
    u = [rng.uniform(0, 1, N).astype(np.float32) for _ in range(3)]

    jout = jtrans.sample_bsdf(jctx, jnp.asarray(view), *u)
    tout = ttrans.sample_bsdf(tctx, torch.from_numpy(view), *map(torch.from_numpy, u))
    ok = np.asarray(jout[3])
    assert (tout[3].numpy() == ok).mean() >= 0.999 and 0.3 < ok.mean()
    for a, b in zip(tout[:3], jout[:3]):
        _close(a, b)
    smooth = roughness == 'smooth'
    assert bool(ttrans.has_dirac_bsdf(tctx).all()) == smooth
    refracted = tout[0][2].numpy() * view[2] < 0
    assert 0.05 < refracted.mean() < 0.98
    if smooth:
        # The collapse: refracted lanes carry the primary wavelength only.
        assert (tout[2].numpy()[1:, refracted] == 0).all()

    jout = jtrans.evaluate_bsdf(jctx, jnp.asarray(view), jnp.asarray(light))
    tout = ttrans.evaluate_bsdf(tctx, torch.from_numpy(view), torch.from_numpy(light))
    np.testing.assert_array_equal(tout[2].numpy(), np.asarray(jout[2]))
    _close(tout[0], jout[0])
    _close(tout[1], jout[1])
    assert bool((tout[1] == 0).all()) == smooth


def test_specialization_flags_are_bitwise_noops():
    """The port's counterpart of tests/test_integrator.py::
    test_static_specialization_flags_are_bitwise_noops: on a scene with
    no medium, no sky sampling and nothing that refracts, forcing each
    flag on (the general path) gives a bit-identical frame, because the
    dropped branches' draws are consumed all the same."""
    packed = tpkg.compile_scene(tproc.make_cornell_scene(), aspect_ratio=2.0,
                                device='cpu')
    layout = tpkg.SceneLayout.from_packed(packed)
    assert not (layout.scene_has_medium or layout.has_skybox_sampling
                or layout.has_transmissive)
    config = tpkg.RenderConfig(width=48, height=24)

    def run(lay):
        state = twavefront.render(packed, config, 6, seed=3, layout=lay)
        return state['accum']['xyz'], state['accum']['count']

    flags = ('scene_has_medium', 'has_skybox_sampling', 'has_transmissive')
    base = run(dataclasses.replace(layout, **{f: True for f in flags}))
    assert float(base[1].sum()) > 0
    for flag in flags:
        specialized = run(dataclasses.replace(
            layout, **{f: f != flag for f in flags}))
        for a, b in zip(base, specialized):
            assert torch.equal(a, b), flag
    for a, b in zip(base, run(layout)):
        assert torch.equal(a, b)


def _bands(img, ref):
    assert img.shape == ref.shape == (32, 64, 3)
    assert np.isfinite(img).all() and img.mean() > 0.01
    rel = np.abs(img - ref).mean() / (ref.mean() + 1e-3)
    bias = abs(img.mean() - ref.mean()) / (ref.mean() + 1e-3)
    assert rel < 0.02 and bias < 0.02, (rel, bias)


def test_sphere_array_thin_lens_matches_jax():
    """Bench config 2's scene (metal and dispersive glass spheres on a
    plane, thin-lens camera) through render_scene, 64x32, 4 rounds,
    seed 3, against the JAX package's frame within bench.py's bands at
    their floor (2% mean absolute error, 2% bias)."""
    ref = np.asarray(jpkg.render_scene(jproc.make_sphere_array_scene(), 64, 32,
                                       spp_rounds=4, seed=3))
    img = tpkg.render_scene(tproc.make_sphere_array_scene(), 64, 32,
                            spp_rounds=4, seed=3, device='cpu').numpy()
    _bands(img, ref)


@pytest.fixture(scope='module')
def glass_frame():
    return np.asarray(jpkg.render_scene(glass_ball_scene(jmodel, jproc), 64, 32,
                                        spp_rounds=4, seed=3))


@pytest.mark.parametrize('mode', ['inst', 'flat'])
def test_glass_ball_scene_matches_jax(glass_frame, mode):
    """Config 5 cut to size (a glass mesh ball, a metal cube and a floor
    mesh) through inst_trace's and wide_trace5's plain versions, each
    against the JAX package's frame."""
    scene = glass_ball_scene(tmodel, tproc)
    with flat_mode(tcompile) if mode == 'flat' else contextlib.nullcontext():
        img = tpkg.render_scene(scene, 64, 32, spp_rounds=4, seed=3,
                                device='cpu').numpy()
    assert scene.packet_mode == mode
    _bands(img, glass_frame)
