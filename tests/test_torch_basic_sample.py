"""The BSDF sample of the basic models on the CPU: `dispatch.sample_bsdf`
takes the plain version (models/dispatch.py::sample_bsdf_plain) on CPU
tensors, launches nothing, counts every lane of each model it runs, and
equals the JAX package's dispatch on the glass ball scene's diffuse,
metal and glass materials. The card's kernel, csrc/basic_sample.cu, is
held to the plain version bit for bit in tests/test_torch_cuda.py; its
wrapper checks every tensor before it launches, and launches on a card
only."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import path_tracer_tpu.scene.compile as jcompile
import path_tracer_tpu.scene.model as jmodel
import path_tracer_tpu.scene.procedural as jproc
import path_tracer_tpu_torch.scene.compile as tcompile
from path_tracer_tpu.core import sampling as jsampling
from path_tracer_tpu.models import dispatch as jdispatch
from path_tracer_tpu.ops import intersect as jintersect
from path_tracer_tpu_torch.core import sampling as tsampling
from path_tracer_tpu_torch.core.constants import (
    MATERIAL_TYPE_BASIC_DIFFUSE, MATERIAL_TYPE_BASIC_METAL,
    MATERIAL_TYPE_BASIC_TRANSLUCENT, MATERIAL_TYPE_OPENPBR)
from path_tracer_tpu_torch.models import common as tcommon
from path_tracer_tpu_torch.models import dispatch as tdispatch
from path_tracer_tpu_torch.ops import basic_sample
from path_tracer_tpu_torch.utils import profiling

from test_torch_compile import jax_fields, layout_fields
from test_torch_cuda import glass_ball_scene
from test_torch_metal import _close

N = 4096
BASIC = (MATERIAL_TYPE_BASIC_DIFFUSE, MATERIAL_TYPE_BASIC_METAL,
         MATERIAL_TYPE_BASIC_TRANSLUCENT)


@pytest.fixture(scope='module')
def glass_ball():
    """The glass ball scene compiled by the JAX package, and the port's
    tables built from the same arrays on the CPU."""
    jp = jcompile.compile_scene(glass_ball_scene(jmodel, jproc),
                                aspect_ratio=2.0)
    jl = jintersect.SceneLayout.from_packed(jp)
    tp = tcompile.packed_from_numpy(jax_fields(jp), layout_fields(jl),
                                    device='cpu')
    return jp, jl, tp


def glass_ball_lanes(glass_ball, n=N, seed=61):
    """The port's fetch_ctx over n lanes of the glass ball's material slots
    (wood, glass and metal), with views from outside the surface, and from
    both sides on the glass (entering and leaving it: only glass is hit
    from inside), and an exterior IOR of 1 or of water; returns (ctx,
    view) as CPU tensors."""
    jp, jl, tp = glass_ball
    rng = np.random.default_rng(seed)
    mat = rng.integers(0, int(jp.materials.type.shape[0]), n).astype(np.int32)
    lam = rng.uniform(380, 720, (4, n)).astype(np.float32)
    uv = rng.uniform(0, 1, (2, n)).astype(np.float32)
    ext = np.where(rng.random(n) < 0.8, 1.0, 1.33).astype(np.float32)
    ext = np.repeat(ext[None], 4, 0)
    view = rng.normal(size=(3, n)).astype(np.float32)
    view /= np.linalg.norm(view, axis=0)
    ctx = tcommon.fetch_ctx(
        tp, *map(torch.from_numpy, (mat, lam, uv, ext)), jl.materials_textured,
        jl.atlas_size, jl.material_types, jl.texture_filter_modes,
        jl.textured_attrs, jl.atlas_quad_fit)
    glass = ctx['type'].numpy() == MATERIAL_TYPE_BASIC_TRANSLUCENT
    view[2] = np.where(glass, view[2], np.abs(view[2]))
    return ctx, torch.from_numpy(view)


def _cpu_lanes(n=64, seed=62):
    """Valid CPU inputs of the wrapper for n lanes of all three models."""
    rng = np.random.default_rng(seed)

    def f(*shape, lo=0.0, hi=1.0):
        return torch.from_numpy(rng.uniform(lo, hi, shape + (n,)).astype(
            np.float32))

    ctx = dict(type=torch.from_numpy(rng.integers(0, 3, n).astype(np.int32)),
               lam=f(4, lo=380, hi=720), exterior_ior=torch.ones(4, n),
               base_reflectance=f(4), specular_reflectance=f(4),
               roughness=f(), roughness_anisotropy=f(), ior=f(lo=1.2, hi=2),
               abbe_number=f(lo=15, hi=80))
    view = f(3, lo=-1, hi=1)
    return ctx, view, [f() for _ in range(3)]


def _out(n):
    return [torch.empty(3, n), torch.empty(4, n), torch.empty(4, n),
            torch.empty(n, dtype=torch.bool)]


BAD_INPUTS = {
    'device': lambda c, v, u, k: (dict(c, roughness=torch.empty(
        c['roughness'].shape, device='meta')), v, u, k),
    'dtype': lambda c, v, u, k: (dict(c, ior=c['ior'].double()), v, u, k),
    'type_dtype': lambda c, v, u, k: (dict(c, type=c['type'].long()), v, u, k),
    'shape': lambda c, v, u, k: (c, v[:2], u, k),
    'lanes': lambda c, v, u, k: (dict(
        c, lam=c['lam'][:, :-1].contiguous()), v, u, k),
    'contiguous': lambda c, v, u, k: (c, v.T.contiguous().T, u, k),
    'uniform': lambda c, v, u, k: (c, v, [u[0], u[1][:-1], u[2]], k),
    'missing': lambda c, v, u, k: (
        {key: x for key, x in c.items() if key != 'abbe_number'}, v, u, k),
    'where': lambda c, v, u, k: (c, v, u, dict(
        k, where=torch.ones(v.shape[1], dtype=torch.int32))),
    'out': lambda c, v, u, k: (c, v, u, dict(k, out=_out(v.shape[1])[1:])),
    'out_shape': lambda c, v, u, k: (c, v, u, dict(
        k, out=[torch.empty(4, v.shape[1])] + _out(v.shape[1])[1:])),
    'stats': lambda c, v, u, k: (c, v, u, dict(
        k, stats=torch.zeros(2, dtype=torch.int64))),
    'no_basic_model': lambda c, v, u, k: (c, v, u, dict(
        k, types=(MATERIAL_TYPE_OPENPBR,))),
}


@pytest.mark.parametrize('bad', sorted(BAD_INPUTS))
def test_basic_sample_wrapper_refuses_bad_input(bad):
    """Each input of the wrong device, dtype, shape, lane count or layout,
    a missing column, a bad mask, bad outputs or counters, and a type set
    without a basic model raise before any launch; CPU tensors that pass
    every check raise because the kernel runs on a card only."""
    ctx, view, u = _cpu_lanes()
    kw = dict(types=BASIC, where=None, out=None, stats=None)

    def call(ctx, view, u, kw):
        basic_sample.basic_sample(ctx, view, *u, kw['types'], where=kw['where'],
                                  out=kw['out'], stats=kw['stats'])

    profiling.reset()
    with pytest.raises(ValueError, match='CUDA'):
        call(ctx, view, u, kw)
    with pytest.raises(ValueError, match='CUDA'):
        call(ctx, view, u, dict(kw, where=torch.ones(64, dtype=torch.bool),
                                out=_out(64),
                                stats=torch.zeros(3, dtype=torch.int64)))
    with pytest.raises(ValueError) as raised:
        call(*BAD_INPUTS[bad](ctx, view, u, kw))
    assert 'CUDA' not in str(raised.value)
    assert 'kernel.basic_sample' not in profiling.counters()


@pytest.mark.parametrize('where', ['every_lane', 'surface_lanes'])
def test_cpu_dispatch_is_the_plain_version_and_matches_jax(glass_ball, where,
                                                           monkeypatch):
    """On CPU tensors `dispatch.sample_bsdf` draws the three uniforms and
    runs `sample_bsdf_plain` on them, to the bit, with the stream after
    them equal; it launches no kernel. Against the JAX package's dispatch
    on the glass ball's wood, glass and metal lanes (views from outside,
    and from both sides on the glass): the stream bit-exact, the samples within float32 rounding of
    the transcendentals, the validity on >= 99.9% of the lanes."""
    jp, jl, _ = glass_ball
    types = jl.material_types
    assert set(types) == set(BASIC)
    ctx, view = glass_ball_lanes(glass_ball)
    for t in BASIC:
        assert int((ctx['type'] == t).sum()) > N // 8
    mask = (None if where == 'every_lane'
            else torch.from_numpy(np.random.default_rng(63).random(N) < 0.6))
    lane = np.arange(N, dtype=np.uint32)
    trng = tsampling.Rng.seed(torch.from_numpy(lane.astype(np.int64)), 7)
    start = trng.state.clone()
    seen = []
    plain = tdispatch.sample_bsdf_plain

    def capture(*args):
        seen.append(plain(*args))
        return seen[-1]

    monkeypatch.setattr(tdispatch, 'sample_bsdf_plain', capture)
    profiling.reset()
    out = tdispatch.sample_bsdf(ctx, view, trng, types, mask)
    assert len(seen) == 1
    assert profiling.counters().get('kernel.basic_sample', 0) == 0
    # The plain version from the same three draws, on its own.
    ref_rng = tsampling.Rng(start.clone())
    u = [ref_rng.uniform() for _ in range(3)]
    ref = plain(ctx, view, *u, ref_rng, types, mask)
    assert torch.equal(trng.state, ref_rng.state)
    for a, b in zip(out, ref):
        torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)

    jrng = jsampling.Rng.seed(jnp.asarray(lane), jnp.uint32(7))
    jctx = {k: jnp.asarray(v.numpy()) for k, v in ctx.items()}
    jout = jdispatch.sample_bsdf(jctx, jnp.asarray(view.numpy()), jrng, types)
    np.testing.assert_array_equal(trng.state.numpy(),
                                  np.asarray(jrng.state).astype(np.int64))
    for a, b in zip(out[:3], jout[:3]):
        _close(a, b)
    ok = np.asarray(jout[3])
    assert (out[3].numpy() == ok).mean() >= 0.999
    assert 0.3 < ok.mean() < 1.0


def test_cpu_counters_count_every_lane(glass_ball):
    """While tracing, a CPU sample keeps a span and a lane count a model:
    `pt.model.<name>.sample` and `pt.model.<name>.lanes` = every lane, for
    each basic model of the set, and opens no `pt.model.basic.sample`
    (the card's one span)."""
    _, jl, _ = glass_ball
    ctx, view = glass_ball_lanes(glass_ball, n=512)
    rng = tsampling.Rng.seed(torch.arange(512), 3)
    profiling.reset()
    with profiling.tracing():
        tdispatch.sample_bsdf(ctx, view, rng, jl.material_types,
                              torch.rand(512) < 0.5)
        counted = profiling.counters()
        spans = {r[0] for r in profiling.records()}
    for name in ('basic_diffuse', 'basic_metal', 'basic_translucent'):
        assert counted[f'pt.model.{name}.lanes'] == 512
        assert f'pt.model.{name}.sample' in spans
    assert tdispatch.BASIC_SPAN not in spans
    assert 'kernel.basic_sample' not in counted
