"""The port's OpenPBR model, four-model dispatch, material fetch and the
scatter stage with media against the JAX package: OpenPBR's emission,
medium and layer walk (coat present or absent, metal and translucent
bases, bounce limits 1, 4 and 16), the dispatch over all four models
with surface emission and media, fetch_ctx / fetch_medium_ctx for each
set of material types, one scatter step from a mid-render JAX state with
nested dielectrics in fog, and a frame of the shared OpenPBR scene.

Inputs are made with numpy from a seed and go through both packages;
functions are held with `_close` of tests/test_torch_metal.py and masks
on >= 99.9% of the lanes, and the RNG state is bit-exact after every
call that draws.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import path_tracer_tpu.scene.compile as jcompile
import path_tracer_tpu.scene.model as jmodel
import path_tracer_tpu.scene.procedural as jproc
import path_tracer_tpu_torch as tpkg
import path_tracer_tpu_torch.scene.compile as tcompile
import path_tracer_tpu_torch.scene.model as tmodel
import path_tracer_tpu_torch.scene.procedural as tproc
from path_tracer_tpu.core import sampling as jsampling
from path_tracer_tpu.core.constants import (
    MATERIAL_TYPE_BASIC_DIFFUSE, MATERIAL_TYPE_BASIC_METAL,
    MATERIAL_TYPE_BASIC_TRANSLUCENT, MATERIAL_TYPE_OPENPBR, SHAPE_INDEX_NONE,
    TEXTURE_TYPE_REFLECTANCE_WITH_ALPHA)
from path_tracer_tpu.integrator import scatter as jscatter
from path_tracer_tpu.integrator import wavefront as jwavefront
from path_tracer_tpu.integrator.resolve import resolve as jresolve
from path_tracer_tpu.models import common as jcommon
from path_tracer_tpu.models import dispatch as jdispatch
from path_tracer_tpu.models import openpbr as jpbr
from path_tracer_tpu.ops import intersect as jintersect
from path_tracer_tpu_torch.core import sampling as tsampling
from path_tracer_tpu_torch.integrator import scatter as tscatter
from path_tracer_tpu_torch.models import common as tcommon
from path_tracer_tpu_torch.models import dispatch as tdispatch
from path_tracer_tpu_torch.models import openpbr as tpbr
from path_tracer_tpu_torch.utils import profiling

from test_torch_compile import jax_fields, layout_fields
from test_torch_cuda import openpbr_ctx, openpbr_scene
from test_torch_media import _unit, both, translucent_ctx
from test_torch_metal import _close
from test_torch_scatter import _t

N = 8192
ALL = (MATERIAL_TYPE_BASIC_DIFFUSE, MATERIAL_TYPE_BASIC_METAL,
       MATERIAL_TYPE_BASIC_TRANSLUCENT, MATERIAL_TYPE_OPENPBR)


def _rngs(seed):
    lane = np.arange(N, dtype=np.uint32)
    return (jsampling.Rng.seed(jnp.asarray(lane), jnp.uint32(seed)),
            tsampling.Rng.seed(torch.from_numpy(lane.astype(np.int64)), seed))


def _same_state(trng, jrng):
    np.testing.assert_array_equal(trng.state.numpy(),
                                  np.asarray(jrng.state).astype(np.int64))


def test_openpbr_emission_and_medium():
    rng = np.random.default_rng(41)
    jctx, tctx = both(openpbr_ctx(rng, N))
    _close(tpbr.emission(tctx), jpbr.emission(jctx))
    ref = jpbr.load_medium(jctx)
    out = tpbr.load_medium(tctx)
    assert out.keys() == ref.keys()
    for key in ('ior', 'absorption', 'scattering', 'anisotropy'):
        _close(out[key], ref[key])
    assert bool(out['has_medium'].all())
    assert bool(tpbr.has_dirac_bsdf(tctx).all())


@pytest.mark.parametrize('limit', [1, 4, 16])
@pytest.mark.parametrize('case', ['coat', 'no_coat', 'metal', 'translucent'])
def test_openpbr_sample_bsdf(case, limit):
    """The layer walk: 24 draws from the stream on every lane whatever
    its limit, then the sampled direction, throughput, density and
    validity. Views come from outside the surface, and for the
    translucent base from both sides (only a translucent base is hit
    from inside)."""
    rng = np.random.default_rng(42 + limit)
    jctx, tctx = both(openpbr_ctx(rng, N, case, limit))
    view = _unit(rng, N, 1)
    if case == 'translucent':
        view = view * np.where(rng.uniform(0, 1, N) < 0.5, 1, -1).astype(np.float32)
    u = [rng.uniform(0, 1, N).astype(np.float32) for _ in range(3)]
    jrng, trng = _rngs(limit)
    jout = jpbr.sample_bsdf(jctx, jnp.asarray(view), *u, jrng)
    tout = tpbr.sample_bsdf(tctx, torch.from_numpy(view),
                            *map(torch.from_numpy, u), trng)
    _same_state(trng, jrng)
    ok = np.asarray(jout[3])
    assert (tout[3].numpy() == ok).mean() >= 0.999
    assert 0.05 < ok.mean() < 0.999
    for a, b in zip(tout[:3], jout[:3]):
        _close(a, b)
    zeros = tpbr.evaluate_bsdf(tctx, torch.from_numpy(view), torch.from_numpy(view))
    assert not any(bool(x.any()) for x in zeros)


@pytest.mark.parametrize('case', ['coat', 'metal', 'translucent'])
def test_openpbr_sample_bsdf_on_cpu_is_the_plain_walk(case):
    """On CPU tensors `sample_bsdf` is `sample_bsdf_plain` to the bit, with
    the same stream after it, launches no kernel and counts every lane as
    walked (its counters' meaning on the CPU)."""
    rng = np.random.default_rng(44)
    ctx = {k: torch.from_numpy(v)
           for k, v in openpbr_ctx(rng, N, case, 8).items()}
    view = torch.from_numpy(_unit(rng, N, 1))
    u = [torch.from_numpy(rng.uniform(0, 1, N).astype(np.float32))
         for _ in range(3)]
    walked = tsampling.Rng.seed(torch.arange(N), 9)
    plain = tsampling.Rng.seed(torch.arange(N), 9)
    profiling.reset()
    out = tpbr.sample_bsdf(ctx, view, *u, walked)
    ref = tpbr.sample_bsdf_plain(ctx, view, *u, plain)
    assert torch.equal(walked.state, plain.state)
    for a, b in zip(out, ref):
        torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)
    counted = profiling.counters()
    assert counted.get('kernel.openpbr_walk', 0) == 0
    assert counted['pt.model.openpbr.lanes'] == N
    assert counted['pt.model.openpbr.walk_warps'] == N // 32
    assert counted['pt.model.openpbr.warps'] == N // 32


def test_openpbr_walk_kernel_wrapper_takes_only_cuda_tensors():
    """The kernel's wrapper raises on CPU tensors: the plain walk is
    `sample_bsdf`'s own route there, never a fallback of the wrapper."""
    rng = np.random.default_rng(45)
    ctx = {k: torch.from_numpy(v) for k, v in openpbr_ctx(rng, 64).items()}
    view = torch.from_numpy(_unit(rng, 64, 1))
    u = torch.zeros(64)
    with pytest.raises(ValueError, match='CUDA'):
        tpbr.openpbr_walk(ctx, view, u, u, u, torch.zeros(64, dtype=torch.int64))
    assert 'kernel.openpbr_walk' not in profiling.counters()


def mixed_ctx(rng, n):
    """Lanes of all four material types with every column the models
    read."""
    ctx = openpbr_ctx(rng, n)
    trans = translucent_ctx(rng, n, 'rough')
    for key in ('ior', 'abbe_number', 'scattering_spectrum',
                'scattering_anisotropy'):
        ctx[key] = trans[key]
    ctx['type'] = rng.integers(0, 4, n).astype(np.int32)
    return ctx


@pytest.mark.parametrize('types', [ALL, ()], ids=['all', 'empty'])
def test_dispatch_four_models(types):
    """has_dirac_bsdf, evaluate_bsdf, sample_bsdf (with OpenPBR's walk on
    every lane), surface_emission and load_medium over lanes of all four
    types; an empty type set means all four models."""
    rng = np.random.default_rng(43)
    jctx, tctx = both(mixed_ctx(rng, N))
    view = _unit(rng, N, 1)
    light = _unit(rng, N)
    np.testing.assert_array_equal(tdispatch.has_dirac_bsdf(tctx, types).numpy(),
                                  np.asarray(jdispatch.has_dirac_bsdf(jctx, types)))
    tout = tdispatch.evaluate_bsdf(tctx, torch.from_numpy(view),
                                   torch.from_numpy(light), types)
    jout = jdispatch.evaluate_bsdf(jctx, jnp.asarray(view), jnp.asarray(light), types)
    _close(tout[0], jout[0])
    _close(tout[1], jout[1])
    np.testing.assert_array_equal(tout[2].numpy(), np.asarray(jout[2]))
    jrng, trng = _rngs(5)
    jout = jdispatch.sample_bsdf(jctx, jnp.asarray(view), jrng, types)
    tout = tdispatch.sample_bsdf(tctx, torch.from_numpy(view), trng, types)
    _same_state(trng, jrng)
    for a, b in zip(tout[:3], jout[:3]):
        _close(a, b)
    assert (tout[3].numpy() == np.asarray(jout[3])).mean() >= 0.999
    emission = tdispatch.surface_emission(tctx, types)
    _close(emission, jdispatch.surface_emission(jctx, types))
    assert bool((emission[:, tctx['type'] != MATERIAL_TYPE_OPENPBR] == 0).all())
    ref = jdispatch.load_medium(jctx, types)
    out = tdispatch.load_medium(tctx, types)
    for key in ('ior', 'absorption', 'scattering', 'anisotropy'):
        _close(out[key], ref[key])
    np.testing.assert_array_equal(out['has_medium'].numpy(),
                                  np.asarray(ref['has_medium']))
    assert tdispatch.has_any_medium(types) == jdispatch.has_any_medium(types)


def _material_scene(m, p):
    """A mesh with one material of each type, textures on the OpenPBR
    base and emission colors and on the metal's roughness."""
    scene = m.Scene()
    pos, nrm, uv, faces = p.uv_sphere(8, 4)
    mesh = scene.create_mesh(name='s', positions=pos, normals=nrm, uvs=uv,
                             faces=faces)
    grain = scene.create_texture(name='grain',
                                 type=TEXTURE_TYPE_REFLECTANCE_WITH_ALPHA,
                                 pixels=p.wood_grain_texture(32))
    mats = [
        scene.create_material(MATERIAL_TYPE_BASIC_DIFFUSE,
                              base_color=np.asarray([0.7, 0.5, 0.3])),
        scene.create_material(MATERIAL_TYPE_BASIC_METAL, roughness=0.3,
                              roughness_texture=grain),
        scene.create_material(MATERIAL_TYPE_BASIC_TRANSLUCENT, ior=1.6,
                              transmission_depth=0.7),
        scene.create_material(MATERIAL_TYPE_OPENPBR, base_color_texture=grain,
                              emission_color=np.asarray([1.0, 0.5, 0.2]),
                              emission_color_texture=grain,
                              emission_luminance=2.0, coat_weight=0.5),
    ]
    for mat in mats:
        scene.create_entity(m.ENTITY_TYPE_MESH_INSTANCE, mesh=mesh, material=mat)
    scene.create_entity(m.ENTITY_TYPE_CAMERA)
    return scene


@pytest.fixture(scope='module')
def material_tables():
    jp = jcompile.compile_scene(_material_scene(jmodel, jproc))
    jl = jintersect.SceneLayout.from_packed(jp)
    tp = tcompile.packed_from_numpy(jax_fields(jp), layout_fields(jl), device='cpu')
    return jp, jl, tp


@pytest.mark.parametrize('types', [
    (MATERIAL_TYPE_BASIC_DIFFUSE,),
    (MATERIAL_TYPE_BASIC_DIFFUSE, MATERIAL_TYPE_BASIC_METAL),
    (MATERIAL_TYPE_BASIC_DIFFUSE, MATERIAL_TYPE_BASIC_TRANSLUCENT),
    (MATERIAL_TYPE_OPENPBR,),
    ALL,
    (),
], ids=['diffuse', 'metal', 'translucent', 'openpbr', 'all', 'empty'])
def test_fetch_ctx_matches_jax(material_tables, types):
    """fetch_ctx and fetch_medium_ctx gather the same columns as the JAX
    package under its presence rules, texture taps included (the OpenPBR
    emission color among them)."""
    jp, jl, tp = material_tables
    assert set(jl.textured_attrs) >= {'base', 'emission', 'roughness'}
    rng = np.random.default_rng(44)
    n = 2048
    mat = rng.integers(0, int(jp.materials.type.shape[0]), n).astype(np.int32)
    lam = rng.uniform(380, 720, (4, n)).astype(np.float32)
    uv = rng.uniform(-1, 2, (2, n)).astype(np.float32)
    ext = np.ones((4, n), np.float32)
    args = (jl.materials_textured, jl.atlas_size, types, jl.texture_filter_modes,
            jl.textured_attrs, jl.atlas_quad_fit)
    ref = jcommon.fetch_ctx(jp, *map(jnp.asarray, (mat, lam, uv, ext)), *args)
    out = tcommon.fetch_ctx(tp, *map(torch.from_numpy, (mat, lam, uv, ext)), *args)
    assert out.keys() == ref.keys()
    for key in out:
        if out[key].is_floating_point():
            _close(out[key], ref[key])
        else:
            np.testing.assert_array_equal(out[key].numpy(), np.asarray(ref[key]))
    ref = jcommon.fetch_medium_ctx(jp, jnp.asarray(mat), jnp.asarray(lam), types)
    out = tcommon.fetch_medium_ctx(tp, torch.from_numpy(mat), torch.from_numpy(lam),
                                   types)
    assert out.keys() == ref.keys()
    for key in out:
        np.testing.assert_array_equal(out[key].numpy(), np.asarray(ref[key]))


@pytest.fixture(scope='module')
def jax_render():
    """The shared OpenPBR scene through the JAX package: its compile, the
    port's copy of its tables, and the render state after 4 rounds at
    64x32, seed 3 (render_scene's frame, and a mid-render state)."""
    jp = jcompile.compile_scene(openpbr_scene(jmodel, jproc), aspect_ratio=2.0)
    jl = jintersect.SceneLayout.from_packed(jp)
    tp = tcompile.packed_from_numpy(jax_fields(jp), layout_fields(jl), device='cpu')
    state = jwavefront.render(jp, jwavefront.RenderConfig(width=64, height=32), 4,
                              seed=3, layout=jl)
    return jp, jl, tp, state


def test_openpbr_scene_matches_jax(jax_render):
    """render_scene of the OpenPBR scene (coat, metal and translucent
    bases, an emitter, the fallback material, glass, fog), 64x32, 4
    rounds, seed 3, against the JAX package's frame within bench.py's
    bands at their floor (2% mean absolute error, 2% bias)."""
    _, _, _, state = jax_render
    ref = np.asarray(jresolve(state['accum'], 64, 32, lane=state['lane']))
    img = tpkg.render_scene(openpbr_scene(tmodel, tproc), 64, 32, spp_rounds=4,
                            seed=3, device='cpu').numpy()
    assert img.shape == ref.shape == (32, 64, 3)
    assert np.isfinite(img).all() and img.mean() > 0.01
    rel = np.abs(img - ref).mean() / (ref.mean() + 1e-3)
    bias = abs(img.mean() - ref.mean()) / (ref.mean() + 1e-3)
    assert rel < 0.02 and bias < 0.02, (rel, bias)


def test_scatter_step_with_media_matches_jax(jax_render):
    """One scatter step from the mid-render JAX state of the OpenPBR
    scene (a rough glass sphere overlapping a glass mesh ball whose
    medium scatters, OpenPBR emitters, fog) and its JAX hit record:
    fetch_medium, the absorption, the volumetric branch, the exterior
    IOR, surface emission and the active-shape lists. The RNG state is
    bit-exact; the lists and the alive mask agree on >= 99.9% of the
    lanes."""
    jp, jl, tp, state = jax_render
    assert jl.scene_has_medium and jl.has_transmissive
    before = np.asarray(state['path']['active_shapes'])
    assert (before.min(0) != SHAPE_INDEX_NONE).mean() > 0.02
    hit = jintersect.trace(jp, jl, state['origin'], state['direction'])
    jrng = jsampling.Rng(state['rng_state'])
    j_path, j_o, j_d, j_alive = jscatter.scatter(
        jp, state['path'], state['origin'], state['direction'], hit, jrng,
        jnp.float32(0.05), jl)

    trng = tsampling.Rng(_t(state['rng_state']))
    t_hit = {k: _t(v) for k, v in hit.items() if k != 'complexity'}
    t_path, t_o, t_d, t_alive = tscatter.scatter(
        tp, {k: _t(v) for k, v in state['path'].items()}, _t(state['origin']),
        _t(state['direction']), t_hit, trng, 0.05, tp.host_layout)

    _same_state(trng, jrng)
    j_active = np.asarray(j_path['active_shapes'])
    same_list = (t_path['active_shapes'].numpy() == j_active).all(0)
    assert same_list.mean() >= 0.999, same_list.mean()
    assert (j_active != before).any(0).mean() > 0.005   # lists changed
    same = t_alive.numpy() == np.asarray(j_alive)
    assert same.mean() >= 0.999, same.mean()
    np.testing.assert_allclose(t_path['sample'].numpy(), np.asarray(j_path['sample']),
                               rtol=1e-4, atol=1e-5)
    for key in ('throughput', 'probability'):
        np.testing.assert_allclose(t_path[key].numpy()[:, same],
                                   np.asarray(j_path[key])[:, same],
                                   rtol=1e-3, atol=1e-5)
    np.testing.assert_allclose(t_o.numpy()[:, same], np.asarray(j_o)[:, same],
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(t_d.numpy()[:, same], np.asarray(j_d)[:, same],
                               atol=1e-4)

    # fetch_medium on both sides of an interface: the innermost shape of
    # each list (the ambient fog where it is empty) and the outermost.
    lam = jnp.asarray(np.random.default_rng(45).uniform(
        380, 720, (4, before.shape[1])).astype(np.float32))
    for shapes in (before.min(0), before.max(0)):
        ref = jscatter.fetch_medium(jp, jnp.asarray(shapes), lam, jl.material_types)
        out = tscatter.fetch_medium(tp, torch.from_numpy(shapes), _t(lam),
                                    jl.material_types)
        np.testing.assert_array_equal(out['priority'].numpy(),
                                      np.asarray(ref['priority']))
        for key in ('ior', 'absorption', 'scattering', 'anisotropy'):
            _close(out[key], ref[key])
