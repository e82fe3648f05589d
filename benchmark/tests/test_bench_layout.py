"""BENCHMARK.json against the files of the benchmark, and a new
configuration, mix, metric and cell added as files alone."""

import json
import os
import shutil

import pytest

from benchmark.harness import cell as cell_mod
from benchmark.harness import runner

ROOT = os.path.dirname(cell_mod.BENCH_DIR)


def spec():
    with open(os.path.join(ROOT, 'BENCHMARK.json')) as f:
        return json.load(f)


@pytest.mark.parametrize('workload', [w['name'] for w in spec()['workloads']])
def test_every_cell_is_found_from_its_files(workload):
    cell = cell_mod.load_cell(workload)
    assert callable(cell.maker.make_scene)
    assert callable(cell.generator.run)
    names = {m['name'] for m in cell.end_to_end}
    assert 'setup_s' in names and len(names) >= 2
    assert cell.per_layer
    for m in cell.per_layer:
        assert callable(cell.metric_reader(m['name']).read)
        assert m['moves'] in names, (m['name'], m['moves'])
    assert cell.limits


def test_files_and_names_keep_to_the_contract():
    s = spec()
    assert s['paths'] == ['benchmark']
    layers = {}
    for m in s['per_layer']:
        layers.setdefault(m['name'], m['layer'])
    for c in s['configs']:
        assert c['file'].startswith('benchmark/configs/')
        with open(os.path.join(ROOT, c['file'])) as f:
            cfg = json.load(f)
        assert cfg['name'] == c['name']
        assert cfg['reduced'] == c['reduced']
    e2e = {m['name']: m for m in s['end_to_end']}
    assert e2e['setup_s']['bound'] <= 0.25
    for m in s['end_to_end']:
        assert 0.01 <= m['bound'] <= 0.25
    for w in s['workloads']:
        assert len(w['why']) <= 200 and w['chips'] == 1


DUMMY_CONFIG = {
    "name": "dummy", "source": "https://example.org/dummy", "reduced": [],
    "radius": 0.5,
}

DUMMY_MAKER = '''
import numpy as np


def make_scene(api, cfg):
    scene = api.Scene()
    n = 12
    phi = np.linspace(0, 2 * np.pi, n, endpoint=False)
    ring = np.stack([np.cos(phi), np.sin(phi), np.zeros(n)], 1) * cfg['radius']
    p = np.concatenate([ring, [[0, 0, 1.0]]]).astype(np.float32)
    f = np.asarray([[i, (i + 1) % n, n] for i in range(n)], np.int32)
    nrm = np.tile(np.asarray([[0, 0, 1.0]], np.float32), (n + 1, 1))
    uv = np.zeros((n + 1, 2), np.float32)
    mesh = scene.create_mesh(name='cone', positions=p, normals=nrm, uvs=uv,
                             faces=f)
    mat = scene.create_material(api.MATERIAL_TYPE_BASIC_DIFFUSE, name='m',
                                base_color=np.asarray([0.5, 0.5, 0.5]))
    scene.create_entity(api.ENTITY_TYPE_MESH_INSTANCE, mesh=mesh, material=mat)
    cam = scene.create_entity(api.ENTITY_TYPE_CAMERA, transform=api.Transform(
        position=[0.0, -3.0, 0.5], rotation=[np.pi / 2, 0, 0]))
    cam.pinhole.field_of_view_in_degrees = 60.0
    return scene
'''

DUMMY_METRIC = '''
"""Rounds in the profiled sub-window."""


def read(data):
    return float(data.rounds) if data.generator == 'offline' else None
'''


def _tree(root):
    out = {}
    for base, _dirs, files in os.walk(root):
        if '__pycache__' in base:
            continue
        for f in files:
            path = os.path.join(base, f)
            with open(path, 'rb') as fh:
                out[os.path.relpath(path, root)] = fh.read()
    return out


def test_a_configuration_mix_metric_and_cell_are_added_as_files(tmp_path):
    """A copy of the benchmark gains a configuration, a traffic mix, a
    per-layer metric and a cell as new files and new BENCHMARK.json
    entries; the cell runs (on the CPU, at a tiny size) and reports the
    new metric, and no file that was there changed."""
    bench = tmp_path / 'benchmark'
    shutil.copytree(cell_mod.BENCH_DIR, bench,
                    ignore=shutil.ignore_patterns('__pycache__'))
    before = _tree(bench)
    (bench / 'configs' / 'dummy.json').write_text(json.dumps(DUMMY_CONFIG))
    (bench / 'configs' / 'dummy.py').write_text(DUMMY_MAKER)
    mix = json.load(open(bench / 'traffic' / 'offline_1440x1440.json'))
    mix.update(width=32, height=16, chunk_rounds=2, warmup_rounds=2,
               trace_rounds=3)
    (bench / 'traffic' / 'dummy_mix.json').write_text(json.dumps(mix))
    (bench / 'metrics' / 'dummy_metric.py').write_text(DUMMY_METRIC)
    (bench / 'cells' / 'dummy.dummy_mix.json').write_text(json.dumps(
        {'limits': {'trace_rays_off': 0.01, 'round_lanes_off': 0.01}}))
    s = spec()
    s['configs'].append(dict(name='dummy', source=DUMMY_CONFIG['source'],
                             file='benchmark/configs/dummy.json', reduced=[],
                             why='a cone'))
    s['workloads'].append(dict(name='dummy.dummy_mix', config='dummy',
                               traffic='dummy_mix', chips=1, why='test'))
    s['end_to_end'][1]['workloads'].append('dummy.dummy_mix')
    s['per_layer'].append(dict(name='dummy_metric', unit='rounds',
                               better='higher', source='program_counter',
                               layer='integrator.wavefront',
                               moves='mrays_per_s',
                               workloads=['dummy.dummy_mix']))
    (tmp_path / 'BENCHMARK.json').write_text(json.dumps(s))
    after = _tree(bench)
    assert all(after[k] == v for k, v in before.items())

    cell = cell_mod.load_cell('dummy.dummy_mix', root=str(tmp_path),
                              bench_dir=str(bench))
    result, lines = runner.run(cell, 2 ** 33 + 7, 0.2, True, device='cpu')
    assert result['correct'], lines
    assert result['metrics']['dummy_metric']['value'] == 3.0
    result, lines = runner.run(cell, 2 ** 33 + 7, 0.2, False, device='cpu')
    assert result['correct'], lines
    assert set(result['metrics']) == {'setup_s', 'mrays_per_s'}
    assert list(result)[-1] == 'checks'
