"""The one_weekend_final configuration: its frozen sphere list against
the book's rule, the program against the plain reference at a tiny film
on the CPU with the bfloat16 control failing, and, on the card, a short
run and a traced run of its cell."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from benchmark.harness import cell as cell_mod
from benchmark.harness import check, runner

WORKLOAD = 'one_weekend_final.offline_1200x675_w8'
ROOT = os.path.dirname(cell_mod.BENCH_DIR)


def test_the_sphere_list_follows_the_books_rule():
    cell = cell_mod.load_cell(WORKLOAD)
    cfg, maker = cell.config, cell.maker
    small = cfg['small_spheres']
    # The frozen list is the draw of the seed the file states.
    assert small == maker.draw_small_spheres(cfg['draw_seed'])
    assert cfg['spheres'] == 1 + len(small) + 3
    # 22 x 22 candidates, less those within 0.9 of (4, 0.2, 0).
    assert 22 * 22 - 10 <= len(small) <= 22 * 22
    centres = np.asarray([s['centre'] for s in small])
    assert all(s['radius'] == 0.2 for s in small)
    np.testing.assert_array_equal(centres[:, 1], 0.2)
    assert (np.linalg.norm(centres - [4.0, 0.2, 0.0], axis=1) > 0.9).all()
    cells = np.floor(centres[:, [0, 2]])
    assert cells.min() >= -11 and cells.max() <= 10
    assert len({tuple(c) for c in cells}) == len(small)
    kinds = [s['material'] for s in small]
    assert set(kinds) == {'lambertian', 'metal', 'dielectric'}
    assert kinds.count('lambertian') > kinds.count('metal') > kinds.count('dielectric')
    for s in small:
        if s['material'] == 'lambertian':
            assert all(0.0 <= a <= 1.0 for a in s['albedo'])
        elif s['material'] == 'metal':
            assert all(0.5 <= a <= 1.0 for a in s['albedo'])
            assert 0.0 <= s['fuzz'] <= 0.5
        else:
            assert s['ior'] == 1.5
    assert cfg['ground'] == dict(centre=[0.0, -1000.0, 0.0], radius=1000.0,
                                 material='lambertian', albedo=[0.5, 0.5, 0.5])
    api = check.reference_api()
    scene = maker.make_scene(api, cfg)
    spheres = [e for e in scene.walk_entities()
               if e.type == api.ENTITY_TYPE_SPHERE]
    assert len(spheres) == cfg['spheres']


def test_program_agrees_and_the_control_does_not():
    cell = cell_mod.load_cell(WORKLOAD)
    cell.traffic.update(width=48, height=27, waves=2, chunk_rounds=2,
                        warmup_rounds=3, trace_rounds=2)
    values, _ = runner.run(cell, 2 ** 32 + 13, 0.3, False, device='cpu',
                           control=True)
    program, control = values['program'], values['control']
    assert set(program) == set(cell.limits)
    # Both are judged by the harness's own rule (check.judge).
    assert values['program_correct'], program
    assert not values['control_correct'], control
    assert control['round_lanes_off'] > 0.5


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')


def run(trace):
    out = subprocess.run(
        [sys.executable, 'benchmark/run.py', '--workload', WORKLOAD,
         '--seed', str(2 ** 31 + 54321), '--seconds', '3', '--trace', str(trace)],
        cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.cuda
def test_a_short_run_is_correct(card):
    result = run(0)
    assert result['correct'], result['checks']
    assert set(result['metrics']) == {'setup_s', 'mrays_per_s'}


@pytest.mark.cuda
def test_a_traced_run_reads_the_shape_kernel(card):
    result = run(1)
    assert result['correct'], result['checks']
    assert result['metrics']['shape_trace_ms']['value'] > 0
    assert 0 < result['metrics']['shape_trace_roofline']['value'] <= 100
