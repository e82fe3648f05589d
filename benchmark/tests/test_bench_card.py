"""On the card: one short run of each cell through the command, correct,
with its metrics, and one traced run. Skips without a card."""

import json
import os
import subprocess
import sys

import pytest

from benchmark.harness import cell as cell_mod

ROOT = os.path.dirname(cell_mod.BENCH_DIR)
WORKLOADS = ['cornell_box.offline_1440x1440', 'cornell_box.offline_2880x2880']


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')


def run(workload, trace):
    out = subprocess.run(
        [sys.executable, 'benchmark/run.py', '--workload', workload,
         '--seed', str(2 ** 31 + 12345), '--seconds', '3', '--trace', str(trace)],
        cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.cuda
@pytest.mark.parametrize('workload', WORKLOADS)
def test_a_short_run_is_correct(card, workload):
    result = run(workload, 0)
    assert result['correct'], result['checks']
    assert result['device']['platform'] == 'gpu'
    assert 'setup_s' in result['metrics'] and len(result['metrics']) >= 2


@pytest.mark.cuda
@pytest.mark.parametrize('workload', WORKLOADS)
def test_a_traced_run_reads_the_layers(card, workload):
    result = run(workload, 1)
    assert result['correct'], result['checks']
    for m in cell_mod.load_cell(workload).per_layer:
        assert m['name'] in result['metrics'], m['name']
    for name, metric in result['metrics'].items():
        if name.startswith('inst_trace_roofline'):
            assert 0 < metric['value'] < 100
    assert 0 < result['device']['busy_s'] <= result['device']['window_s']
