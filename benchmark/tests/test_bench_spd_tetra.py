"""The spd_tetra configuration (SPD's Sierpinski tetrahedron): the same
document through the program's scene API and the reference's, the
geometry at the configuration's depth, its entries in BENCHMARK.json and
its files, and, on the card, a short run and a traced run of its cell.
Its CPU comparison with the reference, cut to depths 2 and 3, is
tests/test_torch_spd_tetra.py, which the repository's test run collects."""

import json
import os
import subprocess
import sys
import types

import numpy as np
import pytest

from benchmark.harness import cell as cell_mod
from benchmark.harness import check

WORKLOAD = 'spd_tetra.offline_1440x1440_w4'
ROOT = os.path.dirname(cell_mod.BENCH_DIR)


def spec():
    with open(os.path.join(ROOT, 'BENCHMARK.json')) as f:
        return json.load(f)


def program_api():
    from path_tracer_tpu_torch.core import constants
    from path_tracer_tpu_torch.scene import model
    return types.SimpleNamespace(**{k: v for m in (constants, model)
                                    for k, v in vars(m).items()
                                    if not k.startswith('_')})


def document(scene):
    """What the scene holds, as plain values: meshes, materials, the
    entities with their transforms and pinholes, the sky."""
    meshes = {id(m): i for i, m in enumerate(scene.meshes)}
    materials = {id(m): i for i, m in enumerate(scene.materials)}
    return dict(
        meshes=[{k: np.asarray(getattr(m, k)) for k in
                 ('positions', 'normals', 'uvs', 'faces')} for m in scene.meshes],
        materials=[(type(m).__name__, np.asarray(m.base_color))
                   for m in scene.materials],
        entities=[(e.type, meshes.get(id(getattr(e, 'mesh', None))),
                   materials.get(id(getattr(e, 'material', None))),
                   np.asarray(e.transform.position), np.asarray(e.transform.rotation),
                   np.asarray(e.transform.scale),
                   getattr(getattr(e, 'pinhole', None), 'field_of_view_in_degrees', None))
                  for e in scene.walk_entities()],
        sky=(np.asarray(scene.root.skybox_texture.pixels),
             scene.root.skybox_texture.type, scene.root.skybox_brightness,
             scene.root.skybox_sampling_probability))


def assert_same(a, b, where='scene'):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), where
        for k in a:
            assert_same(a[k], b[k], f'{where}.{k}')
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for k, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f'{where}[{k}]')
    elif isinstance(a, np.ndarray):
        np.testing.assert_array_equal(a, b, err_msg=where)
        assert a.dtype == b.dtype, where
    else:
        assert a == b, where


def test_both_apis_give_the_same_document():
    cell = cell_mod.load_cell(WORKLOAD)
    cfg = dict(cell.config, depth=4, tetrahedra=4 ** 4, triangles=4 ** 5)
    program = document(cell.maker.make_scene(program_api(), cfg))
    reference = document(cell.maker.make_scene(check.reference_api(), cfg))
    assert_same(program, reference)
    assert len(program['meshes']) == 1 and len(program['materials']) == 1
    assert program['materials'][0][0] == 'BasicDiffuseMaterial'
    np.testing.assert_array_equal(program['materials'][0][1],
                                  np.float32([0.8, 0.8, 0.8]))
    pixels, *rest = program['sky']
    assert pixels.shape == (512, 1024, 4) and bool((pixels == 1.0).all())
    assert rest[1:] == [1.0, 0.0]


def test_the_geometry_at_the_configurations_depth():
    """4^(d+1) triangles of 4^d tetrahedra in [-1, 1]^3, every vertex on
    the lattice of step 2^(1-d) through the base corners, every normal of
    unit length, flat, and pointing away from its tetrahedron's
    centroid."""
    cell = cell_mod.load_cell(WORKLOAD)
    cfg, maker = cell.config, cell.maker
    d = cfg['depth']
    assert d == 9 and cfg['reduced'] == []
    assert cfg['tetrahedra'] == 4 ** d == 262144
    assert cfg['triangles'] == 4 ** (d + 1) == 1048576
    tets = maker.tetrahedra(d, cfg['vertices'])
    positions, normals, uvs, faces = maker.tetra_mesh(tets)
    assert tets.shape == (4 ** d, 4, 3)
    assert faces.shape == (4 ** (d + 1), 3)
    np.testing.assert_array_equal(faces.ravel(), np.arange(len(positions)))
    assert positions.min(axis=0).tolist() == [-1.0, -1.0, -1.0]
    assert positions.max(axis=0).tolist() == [1.0, 1.0, 1.0]
    steps = (positions.astype(np.float64) + 1.0) / 2.0 ** (1 - d)
    np.testing.assert_array_equal(steps, np.round(steps))
    assert not uvs.any()
    tri = positions.reshape(-1, 3, 3).astype(np.float64)
    n = normals.reshape(-1, 3, 3)
    np.testing.assert_array_equal(n[:, 0], n[:, 1])
    np.testing.assert_array_equal(n[:, 0], n[:, 2])
    np.testing.assert_allclose(np.linalg.norm(n[:, 0], axis=1), 1.0, atol=1e-6)
    centroid = np.repeat(tets.mean(axis=1), 4, axis=0)
    assert bool((np.einsum('fc,fc->f', n[:, 0], tri.mean(axis=1) - centroid) > 0).all())
    # The winding agrees with the normal.
    cross = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    assert bool((np.einsum('fc,fc->f', cross, n[:, 0]) > 0).all())
    # Each level halves the edge: a leaf's edge is 2 sqrt(2) / 2^d.
    edge = np.linalg.norm(tets[:, 1] - tets[:, 0], axis=1)
    np.testing.assert_allclose(edge, 2.0 * np.sqrt(2.0) / 2 ** d, rtol=1e-12)


def test_the_entries_are_well_formed():
    s = spec()
    config = {c['name']: c for c in s['configs']}['spd_tetra']
    assert config['file'] == 'benchmark/configs/spd_tetra.json'
    assert config['reduced'] == []
    assert config['source'] == 'https://github.com/erich666/StandardProceduralDatabases'
    cell = cell_mod.load_cell(WORKLOAD)
    cfg = cell.config
    assert cfg['name'] == 'spd_tetra' and cfg['source'] == config['source']
    assert 'tetra.c' in cfg['databases']
    for key in ('vertices', 'size_factor', 'view', 'material', 'sky', 'depth'):
        assert key in cfg['assumed'], key
    w = {w['name']: w for w in s['workloads']}[WORKLOAD]
    assert (w['config'], w['traffic'], w['chips']) == (
        'spd_tetra', 'offline_1440x1440_w4', 1)
    t = cell.traffic
    assert t['generator'] == 'offline' and t['packet_mode'] == 'inst'
    # The lanes of cornell_box.offline_2880x2880.
    assert t['width'] * t['height'] * t['waves'] == 2880 * 2880
    assert (t['width'], t['height']) == (cfg['image']['width'], cfg['image']['height'])
    assert (t['chunk_rounds'], t['trace_rounds'], t['termination_probability']) == (4, 2, 0.05)
    assert t['warmup_rounds'] >= 48
    # The other cells' limits, but trace_rays_off: most rays miss the
    # fractal, and a miss is the same record in any precision, so the
    # bfloat16 control's share (0.205-0.207 on three seeds) fails 0.03 by
    # 7x alone; 0.005 keeps 16x.
    others = cell_mod.load_cell('next_week_final.offline_800x800_w10')
    assert cell.limits == dict(others.limits, trace_rays_off=0.005)
    assert {m['name'] for m in cell.end_to_end} == {'setup_s', 'mrays_per_s'}
    reads = {m['name'] for m in cell.per_layer}
    assert reads == {'scene_compile_s', 'device_idle_pct.offline',
                     'kernels_per_round', 'trace_ms_per_round',
                     'scatter_ms_per_round', 'inst_trace_ms',
                     'inst_trace_roofline', 'hit_attributes_ms',
                     'hit_attributes_roofline', 'basic_sample_ms'}


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')


def run(trace):
    out = subprocess.run(
        [sys.executable, 'benchmark/run.py', '--workload', WORKLOAD,
         '--seed', str(2 ** 31 + 24680), '--seconds', '3', '--trace', str(trace)],
        cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.cuda
def test_a_short_run_is_correct(card):
    result = run(0)
    assert result['correct'], result['checks']
    assert set(result['metrics']) == {'setup_s', 'mrays_per_s'}


@pytest.mark.cuda
def test_a_traced_run_reads_its_layers(card):
    result = run(1)
    assert result['correct'], result['checks']
    metrics = result['metrics']
    for name in ('scene_compile_s', 'inst_trace_ms', 'hit_attributes_ms',
                 'basic_sample_ms', 'scatter_ms_per_round',
                 'trace_ms_per_round', 'kernels_per_round'):
        assert metrics[name]['value'] > 0, name
    for name in ('inst_trace_roofline', 'hit_attributes_roofline'):
        assert 0 < metrics[name]['value'] <= 100, name
    assert 'device_idle_pct.offline' in metrics
