"""The medium event of `scatter` on the CPU: a CPU round takes the plain
version (integrator/scatter.py::medium_event_plain) and launches nothing,
counts its lanes in `pt.scatter.medium.lanes` while tracing, and a scatter
step through it equals the JAX package's on a scene with glass and fog.
The card's kernel, csrc/medium_event.cu, is held to the plain version bit
for bit in tests/test_torch_cuda.py; its wrapper checks every tensor
before it launches, and launches on a card only."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import path_tracer_tpu.scene.compile as jcompile
import path_tracer_tpu.scene.model as jmodel
import path_tracer_tpu.scene.procedural as jproc
import path_tracer_tpu_torch.scene.compile as tcompile
import path_tracer_tpu_torch.scene.model as tmodel
import path_tracer_tpu_torch.scene.procedural as tproc
from path_tracer_tpu.core.sampling import Rng as JRng
from path_tracer_tpu.integrator import scatter as jscatter
from path_tracer_tpu.ops import intersect as jintersect
from path_tracer_tpu_torch.core.constants import (
    ACTIVE_SHAPE_LIMIT, SHAPE_INDEX_NONE)
from path_tracer_tpu_torch.core.sampling import Rng as TRng
from path_tracer_tpu_torch.integrator import scatter as tscatter
from path_tracer_tpu_torch.integrator import wavefront
from path_tracer_tpu_torch.ops import medium_event
from path_tracer_tpu_torch.ops.intersect import SceneLayout
from path_tracer_tpu_torch.utils import profiling

from test_torch_compile import jax_fields, layout_fields
from test_torch_cuda import blob_scene, glass_ball_scene, medium_lanes


def foggy_glass_ball(m, p):
    """The glass ball scene with the ambient medium scattering: glass,
    metal and diffuse, and fog."""
    scene = glass_ball_scene(m, p)
    scene.root.scatter_rate = 0.05
    return scene


@pytest.fixture(scope='module')
def foggy_packed():
    packed = tcompile.compile_scene(foggy_glass_ball(tmodel, tproc),
                                    aspect_ratio=2.0, device='cpu')
    return packed, SceneLayout.from_packed(packed)


BAD_INPUTS = {
    'device': lambda lanes, packed: dict(
        lanes, time=torch.empty(lanes['time'].shape, device='meta')),
    'dtype': lambda lanes, packed: dict(
        lanes, throughput=lanes['throughput'].double()),
    'shape': lambda lanes, packed: dict(lanes, normal=lanes['normal'][:2]),
    'lanes': lambda lanes, packed: dict(
        lanes, shape=lanes['shape'][:-1].contiguous()),
    'contiguous': lambda lanes, packed: dict(
        lanes, origin=lanes['origin'].T.contiguous().T),
    'rng_dtype': lambda lanes, packed: dict(
        lanes, rng_state=lanes['rng_state'].to(torch.int32)),
}


@pytest.mark.parametrize('bad', sorted(BAD_INPUTS))
def test_medium_event_wrapper_refuses_bad_input(foggy_packed, bad):
    """Each lane input of the wrong device, dtype, shape or layout raises
    before any launch, as do bad counters; CPU tensors that pass every
    check raise because the kernel runs on a card only."""
    packed, layout = foggy_packed
    lanes = medium_lanes(64)
    with pytest.raises(ValueError, match='CUDA'):
        medium_event.medium_event(packed, layout.material_types, lanes)
    with pytest.raises(ValueError, match='stats'):
        medium_event.medium_event(packed, layout.material_types, lanes,
                                  stats=torch.zeros(2, dtype=torch.int64))
    bad_lanes = BAD_INPUTS[bad](lanes, packed)
    with pytest.raises(ValueError) as raised:
        medium_event.medium_event(packed, layout.material_types, bad_lanes)
    assert 'CUDA' not in str(raised.value)


def test_cpu_round_takes_the_plain_version_and_counts_its_lanes(
        foggy_packed, monkeypatch):
    """A CPU round runs medium_event_plain once and launches nothing;
    while tracing, `pt.scatter.medium.lanes` bins every lane of it
    (ambient, inside a shape's medium, scattering in a volume), the bins
    sum to the lanes, and a round with tracing off adds nothing."""
    packed, layout = foggy_packed
    config = wavefront.RenderConfig(width=48, height=24)
    state = wavefront.reset(packed, config, seed=11)
    for _ in range(3):
        wavefront.render_round(packed, layout, config, state, 0.05)
    seen = []
    plain = tscatter.medium_event_plain

    def capture(*args):
        seen.append(plain(*args))
        return seen[-1]

    monkeypatch.setattr(tscatter, 'medium_event_plain', capture)
    profiling.reset()
    with profiling.tracing():
        wavefront.render_round(packed, layout, config, state, 0.05)
        counted = profiling.counters()
    assert len(seen) == 1 and 'kernel.medium_event' not in counted
    bins = counted[tscatter.MEDIUM_LANES]
    want = torch.bincount(tscatter.medium_bins(seen[0]), minlength=3)
    assert bins == dict(zip(tscatter.MEDIUM_BINS, want.tolist()))
    assert sum(bins.values()) == 48 * 24
    assert bins['ambient'] > 0 and bins['volume'] > 0
    # Off, a round adds nothing.
    wavefront.render_round(packed, layout, config, state, 0.05)
    assert profiling.counters()[tscatter.MEDIUM_LANES] == bins


def _t(x):
    a = np.asarray(x)
    return torch.from_numpy(a.astype(np.int64) if a.dtype == np.uint32 else a.copy())


def test_scatter_with_medium_matches_jax(monkeypatch):
    """One scatter step through medium_event_plain against the JAX
    package's scatter on the glass ball in fog, from lanes inside and
    outside the glass (the JAX package's trace of random rays): the RNG
    state is bit-exact, the active-shape lists and the alive mask agree
    on >= 99.9% of the lanes, the new samples, rays and weights within
    float32 rounding of the transcendentals; some lanes scatter in a
    volume, some are inside the glass."""
    jp = jcompile.compile_scene(foggy_glass_ball(jmodel, jproc), aspect_ratio=2.0)
    jl = jintersect.SceneLayout.from_packed(jp)
    tp = tcompile.packed_from_numpy(jax_fields(jp), layout_fields(jl), device='cpu')
    assert jl.scene_has_medium and jl.has_transmissive
    n = 4096
    lanes = medium_lanes(n, seed=9)
    rng = np.random.default_rng(9)
    # Rays from around the ball (its centre (0.2, -1.5, 0.6)), and the
    # ball's shape index in the lists of half of them.
    origin = (np.array([0.2, -1.5, 0.6], np.float32)[:, None]
              + rng.uniform(-1.2, 1.2, (3, n)).astype(np.float32))
    direction = lanes['direction'].numpy()
    shapes = np.full((ACTIVE_SHAPE_LIMIT, n), SHAPE_INDEX_NONE, np.int32)
    shapes[0] = np.where(rng.random(n) < 0.5, 1, SHAPE_INDEX_NONE)
    path = dict(lambda0=rng.uniform(0, 1, n).astype(np.float32),
                throughput=lanes['throughput'].numpy(),
                probability=lanes['probability'].numpy(),
                sample=np.zeros((3, n), np.float32), active_shapes=shapes)
    seeds = lanes['rng_state'].numpy().astype(np.uint32)
    hit = jintersect.trace(jp, jl, jnp.asarray(origin), jnp.asarray(direction))
    jrng = JRng(jnp.asarray(seeds))
    j_path, j_o, j_d, j_alive = jscatter.scatter(
        jp, {k: jnp.asarray(v) for k, v in path.items()}, jnp.asarray(origin),
        jnp.asarray(direction), hit, jrng, jnp.float32(0.05), jl)

    seen = []
    trng = TRng(torch.from_numpy(seeds.astype(np.int64)))
    t_hit = {k: _t(v) for k, v in hit.items() if k != 'complexity'}
    plain = tscatter.medium_event_plain

    def capture(*args):
        seen.append(plain(*args))
        return seen[-1]

    monkeypatch.setattr(tscatter, 'medium_event_plain', capture)
    t_path, t_o, t_d, t_alive = tscatter.scatter(
        tp, {k: torch.from_numpy(v) for k, v in path.items()},
        torch.from_numpy(origin), torch.from_numpy(direction), t_hit, trng,
        0.05, tp.host_layout)
    (event,) = seen
    assert int(event['vol_scatter'].sum()) > 0
    assert int((event['priority'] != SHAPE_INDEX_NONE).sum()) > n // 4

    np.testing.assert_array_equal(trng.state.numpy(),
                                  np.asarray(jrng.state).astype(np.int64))
    same_list = (t_path['active_shapes'].numpy()
                 == np.asarray(j_path['active_shapes'])).all(0)
    assert same_list.mean() >= 0.999, same_list.mean()
    same = t_alive.numpy() == np.asarray(j_alive)
    assert same.mean() >= 0.999, same.mean()
    assert 0.05 < np.asarray(j_alive).mean()
    np.testing.assert_allclose(t_path['sample'].numpy(),
                               np.asarray(j_path['sample']), rtol=1e-4, atol=1e-5)
    for key in ('throughput', 'probability'):
        np.testing.assert_allclose(t_path[key].numpy()[:, same],
                                   np.asarray(j_path[key])[:, same],
                                   rtol=1e-3, atol=1e-5)
    np.testing.assert_allclose(t_o.numpy()[:, same], np.asarray(j_o)[:, same],
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(t_d.numpy()[:, same], np.asarray(j_d)[:, same],
                               atol=1e-4)


def test_medium_free_scene_skips_the_event(monkeypatch):
    """A scene with no medium-bearing material and no scatter rate never
    reaches the medium event, on either device's path."""
    packed = tcompile.compile_scene(blob_scene(tmodel)[0], device='cpu')
    layout = SceneLayout.from_packed(packed)
    assert not layout.scene_has_medium

    def refuse(*args):
        raise AssertionError('the medium event ran')

    monkeypatch.setattr(tscatter, 'medium_event', refuse)
    config = wavefront.RenderConfig(width=32, height=16)
    state = wavefront.reset(packed, config, seed=3)
    wavefront.render_round(packed, layout, config, state, 0.05)
