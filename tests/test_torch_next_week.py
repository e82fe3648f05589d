"""The benchmark's next_week_final configuration (the closing scene of Ray
Tracing: The Next Week): its frozen draws against the book's rule, its
counts, the baked marble texture against a plain transcription of the
book's noise_texture, and the port against the plain reference on the
CPU through the cell's comparison, with the bfloat16 control failing: on
a tiny film, and on lanes started inside the medium sphere, aimed down at
the ground boxes, up at the light and at the marble sphere."""

import copy
import math
import types

import numpy as np
import pytest
import torch

from benchmark.harness import cell as cell_mod
from benchmark.harness import check, runner
from path_tracer_tpu_torch.core import constants
from path_tracer_tpu_torch.core.constants import (
    RENDER_FLAG_ACCUMULATE,
    RENDER_FLAG_SAMPLE_JITTER,
    SHAPE_INDEX_NONE,
)
from path_tracer_tpu_torch.integrator import scatter, wavefront
from path_tracer_tpu_torch.models.common import TEXTURE_SPAN
from path_tracer_tpu_torch.ops.intersect import SceneLayout
from path_tracer_tpu_torch.scene import model
from path_tracer_tpu_torch.scene.compile import compile_scene
from path_tracer_tpu_torch.utils import profiling

WORKLOAD = 'next_week_final.offline_800x800_w10'


@pytest.fixture(scope='module')
def cell():
    return cell_mod.load_cell(WORKLOAD)


@pytest.fixture
def small_cell():
    """The cell with a 256x128 marble texture in place of the 2048x1024
    one: the renders below compile the scene five times, and the bake and
    the atlas's spectral uplift are most of a compile's time on the CPU."""
    cell = cell_mod.load_cell(WORKLOAD)
    cell.config = copy.deepcopy(cell.config)
    cell.config['marble_sphere']['texture'] = [256, 128]
    return cell


def program_api():
    return types.SimpleNamespace(**{k: v for m in (constants, model)
                                    for k, v in vars(m).items()
                                    if not k.startswith('_')})


def test_the_draws_follow_the_books_rule(cell):
    cfg, maker = cell.config, cell.maker
    fresh = maker.draw(cfg['draw_seed'])
    assert cfg['ground']['heights'] == fresh['heights']
    assert cfg['perlin'] == fresh['perlin']
    assert cfg['cluster']['centres'] == fresh['centres']
    heights = np.asarray(fresh['heights'])
    assert heights.shape == (400,) and 1.0 <= heights.min() and heights.max() <= 101.0
    vectors = np.asarray(fresh['perlin']['vectors'])
    assert vectors.shape == (256, 3)
    np.testing.assert_allclose(np.linalg.norm(vectors, axis=1), 1.0, atol=2e-6)
    for key in ('perm_x', 'perm_y', 'perm_z'):
        assert sorted(fresh['perlin'][key]) == list(range(256))
    centres = np.asarray(fresh['centres'])
    assert centres.shape == (1000, 3)
    assert 0.0 <= centres.min() and centres.max() <= 165.0
    # The book's rotate_y then the translation, on one centre.
    t = math.radians(15.0)
    x, y, z = centres[7]
    want = [math.cos(t) * x + math.sin(t) * z - 100.0, y + 270.0,
            -math.sin(t) * x + math.cos(t) * z + 395.0]
    np.testing.assert_allclose(maker.cluster_centres(cfg)[7], want, rtol=1e-12)


@pytest.mark.parametrize('api', ['program', 'reference'])
def test_the_counts(cell, api):
    cfg = cell.config
    a = program_api() if api == 'program' else check.reference_api()
    scene = cell.maker.make_scene(a, cfg)
    kinds = [e.type for e in scene.walk_entities()]
    assert kinds.count(a.ENTITY_TYPE_CUBE) == cfg['cubes'] == 400
    assert kinds.count(a.ENTITY_TYPE_SPHERE) == cfg['spheres'] == 1006
    assert kinds.count(a.ENTITY_TYPE_MESH_INSTANCE) == 1
    assert sum(len(m.faces) for m in scene.meshes) == cfg['triangles'] == 2
    textured = [m for m in scene.materials if any(t is not None for t in m.textures())]
    assert len(textured) == 1 and textured[0].base_texture.pixels.shape == (1024, 2048, 4)
    assert cfg['reduced'] == []
    for key in ('mist', 'earth', 'moving_sphere', 'marble', 'depth', 'light'):
        assert key in cfg['assumed']


def book_noise_texture(p, cfg):
    """The book's noise_texture(0.2).value at the point p, transcribed
    scalar by scalar in float64 (perlin::noise, perlin_interp, turb)."""
    perlin = cfg['perlin']
    vectors, px, py, pz = (perlin[k] for k in ('vectors', 'perm_x', 'perm_y', 'perm_z'))

    def noise(q):
        u, v, w = (c - math.floor(c) for c in q)
        i, j, k = (int(math.floor(c)) for c in q)
        uu, vv, ww = (f * f * (3 - 2 * f) for f in (u, v, w))
        accum = 0.0
        for di in range(2):
            for dj in range(2):
                for dk in range(2):
                    g = vectors[px[(i + di) & 255] ^ py[(j + dj) & 255]
                                ^ pz[(k + dk) & 255]]
                    dot = g[0] * (u - di) + g[1] * (v - dj) + g[2] * (w - dk)
                    accum += ((di * uu + (1 - di) * (1 - uu))
                              * (dj * vv + (1 - dj) * (1 - vv))
                              * (dk * ww + (1 - dk) * (1 - ww)) * dot)
        return accum

    m = cfg['marble_sphere']
    accum, weight, q = 0.0, 1.0, list(p)
    for _ in range(m['turbulence_depth']):
        accum += weight * noise(q)
        weight *= 0.5
        q = [2 * c for c in q]
    return 0.5 * (1 + math.sin(m['noise_scale'] * p[2] + 10 * abs(accum)))


def test_the_marble_texels_are_the_books_noise(cell):
    cfg, maker = cell.config, cell.maker
    pixels = maker.marble_pixels(cfg)
    m = cfg['marble_sphere']
    w, h = m['texture']
    rows = [0, 1, 200, 511, 512, 900, 1023]
    cols = [0, 2047, 1000, 17, 1024, 1500, 333]
    for r, c in zip(rows, cols):
        # The texel's uv, by the atlas placement; its point on the sphere,
        # by the inverse of the sphere's uv.
        u, v = c / (w - 1), 1.0 - r / (h - 1)
        phi, z = 2 * math.pi * u - math.pi, 2 * v - 1
        s = math.sqrt(max(0.0, 1 - z * z))
        p = [m['centre'][0] + m['radius'] * s * math.cos(phi),
             m['centre'][1] + m['radius'] * s * math.sin(phi),
             m['centre'][2] + m['radius'] * z]
        # The program's sphere uv of that point gives the texel's uv back
        # (u is not defined at the poles).
        local = [(p[k] - m['centre'][k]) / m['radius'] for k in range(3)]
        if s > 1e-6:
            assert (math.atan2(local[1], local[0]) + math.pi) / (2 * math.pi) \
                == pytest.approx(u, abs=1e-9)
        assert (local[2] + 1) / 2 == pytest.approx(v, abs=1e-12)
        want = book_noise_texture(p, cfg)
        assert pixels[r, c, :3] == pytest.approx([want] * 3, rel=1e-6, abs=1e-7)
        assert pixels[r, c, 3] == 1.0
    assert 0.0 <= pixels[..., :3].min() and pixels[..., :3].max() <= 1.0


def test_program_agrees_and_the_control_does_not(small_cell):
    cell = small_cell
    cell.traffic.update(width=32, height=32, waves=1, chunk_rounds=2,
                        warmup_rounds=3, trace_rounds=2)
    values, _ = runner.run(cell, 2 ** 32 + 29, 0.2, False, device='cpu',
                           control=True)
    program, control = values['program'], values['control']
    assert set(program) == set(cell.limits)
    assert values['program_correct'], program
    assert not values['control_correct'], control


def lanes_of_interest(scene, state, seed):
    """Put the lanes of a reset state where the scene's rarer paths are:
    a quarter inside the medium sphere (its shape in the active-shape
    list), a quarter above the ground aimed down at the boxes, a quarter
    under the light aimed up at it, and a quarter aimed at the marble
    sphere. Returns the shape indices of (medium sphere, light, marble)."""
    def of(pred):
        return next(e for e in scene.walk_entities() if pred(e))

    medium = of(lambda e: getattr(e.material, 'transmission_depth', 0) > 0)
    light = of(lambda e: e.type == model.ENTITY_TYPE_MESH_INSTANCE)
    marble = of(lambda e: getattr(e.material, 'base_texture', None) is not None)
    n = state['lane'].shape[0]
    gen = torch.Generator().manual_seed(seed)
    q = n // 4

    def unit(k):
        d = torch.randn(3, k, generator=gen)
        return d / d.norm(dim=0)

    def uniform(k, lo, hi):
        return lo + (hi - lo) * torch.rand(k, generator=gen)

    origin = state['origin'].clone()
    direction = state['direction'].clone()
    centre = torch.as_tensor(medium.transform.position)[:, None]
    radius = float(medium.transform.scale[0])
    origin[:, :q] = centre + 0.9 * radius * uniform(q, 0, 1) ** (1 / 3) * unit(q)
    direction[:, :q] = unit(q)
    origin[:, q:2 * q] = torch.stack([uniform(q, -1000, 1000),
                                      torch.full((q,), 300.0),
                                      uniform(q, -1000, 1000)])
    down = torch.stack([uniform(q, -0.3, 0.3), -torch.ones(q), uniform(q, -0.3, 0.3)])
    direction[:, q:2 * q] = down / down.norm(dim=0)
    origin[:, 2 * q:3 * q] = torch.stack([uniform(q, 130, 410),
                                          torch.full((q,), 450.0),
                                          uniform(q, 150, 400)])
    up = torch.stack([uniform(q, -0.1, 0.1), torch.ones(q), uniform(q, -0.1, 0.1)])
    direction[:, 2 * q:3 * q] = up / up.norm(dim=0)
    k = n - 3 * q
    mc = torch.as_tensor(marble.transform.position)[:, None]
    start = mc + 300.0 * unit(k)
    aim = mc + 60.0 * unit(k) - start
    origin[:, 3 * q:] = start
    direction[:, 3 * q:] = aim / aim.norm(dim=0)
    state['origin'].copy_(origin)
    state['direction'].copy_(direction)
    state['path']['active_shapes'][0, :q] = medium.packed_shape_index
    return medium.packed_shape_index, light.packed_shape_index, marble.packed_shape_index


def test_volume_lanes_boxes_light_and_marble_agree_with_the_reference(small_cell):
    """One round of the port on lanes placed where the scene's rarer paths
    are, against the reference's round from the same state through the
    cell's comparison; the bfloat16 control fails it. The round has
    volume scattering events, cube, mesh and textured hits, and the
    texture span opens under the material fetch while tracing, and not
    otherwise."""
    cell = small_cell
    width = height = 32
    flags = RENDER_FLAG_ACCUMULATE | RENDER_FLAG_SAMPLE_JITTER
    scene = cell.maker.make_scene(program_api(), cell.config)
    packed = compile_scene(scene, aspect_ratio=1.0, device='cpu')
    layout = SceneLayout.from_packed(packed)
    assert layout.packet_mode == 'inst'
    config = wavefront.RenderConfig(width=width, height=height, flags=flags,
                                    camera_model=packed.host_camera_models[0])
    seed = 2 ** 31 + 77
    state = wavefront.reset(packed, config, seed)
    medium, light, marble = lanes_of_interest(scene, state, seed)
    n = width * height
    idx = torch.arange(n)
    p = dict(width=width, height=height, flags=flags, seed=seed,
             termination_probability=0.05, brightness=1.0, tonemap=3)
    cap = dict(params=p, slots=idx, before=check.snapshot(state, idx))

    with profiling.tracing(), check.capture_hits(wavefront, idx) as hits:
        wavefront.render(packed, config, 1, state=state, layout=layout,
                         termination_probability=0.05)
        counted = profiling.counters()
        records = profiling.records()
    cap['hit'] = hits['hit']
    cap['after'] = check.snapshot(state, idx)

    ref = check.reference_outputs(cell, cap, torch.float32)
    program = check.numbers(cap, ref)
    limits = {k: cell.limits[k] for k in program}
    assert check.judge(program, limits)[0], program
    low = check.reference_outputs(cell, cap, torch.bfloat16)
    control = check.numbers(check.control_capture(cap, low), ref)
    assert not check.judge(control, limits)[0], control

    shape = cap['hit']['shape']
    cubes = {e.packed_shape_index for e in scene.walk_entities()
             if e.type == model.ENTITY_TYPE_CUBE}
    found = dict(
        volume=counted[scatter.MEDIUM_LANES]['volume'],
        cube=int(sum((shape == s).sum() for s in cubes)),
        mesh=int((shape == light).sum()),
        textured=int((shape == marble).sum()),
        inside_medium=int((cap['before']['path']['active_shapes'][0] == medium).sum()))
    assert all(v > 0 for v in found.values()), found
    assert found['volume'] > n // 8, found
    attribute_lanes = counted['pt.trace.attributes.lanes']
    assert attribute_lanes['cube'] == found['cube']
    assert attribute_lanes['mesh'] == found['mesh']
    assert int((shape != SHAPE_INDEX_NONE).sum()) == n - attribute_lanes['miss']
    parents = {r[0]: records[r[1]][0] for r in records if r[1] >= 0}
    assert parents[TEXTURE_SPAN] == 'pt.scatter.material'
    profiling.reset()
    wavefront.render(packed, config, 1, state=state, layout=layout,
                     termination_probability=0.05)
    assert profiling.records() == []
