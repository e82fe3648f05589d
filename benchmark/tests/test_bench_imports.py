"""No run imports JAX or the JAX package, and the plain reference
imports nothing of the program."""

import ast
import os
import subprocess
import sys

from benchmark.harness import cell as cell_mod
from benchmark.harness import runner

REFERENCE = os.path.join(cell_mod.BENCH_DIR, 'reference')


def test_forbidden_modules_compare_whole_top_level_names():
    assert runner.forbidden_modules(['path_tracer_tpu_torch',
                                     'path_tracer_tpu_torch.ops.build',
                                     'jaxtyping', 'flaxen', 'numpy']) == []
    assert runner.forbidden_modules(['jax.numpy', 'numpy']) == ['jax']
    assert runner.forbidden_modules(['path_tracer_tpu.scene.model',
                                     'jaxlib', 'flax.linen']) == [
        'flax', 'jaxlib', 'path_tracer_tpu']


def test_reference_sources_import_nothing_of_the_program():
    for base, _dirs, files in os.walk(REFERENCE):
        for f in files:
            if not f.endswith('.py'):
                continue
            tree = ast.parse(open(os.path.join(base, f)).read())
            for node in ast.walk(tree):
                names = []
                if isinstance(node, ast.Import):
                    names = [a.name for a in node.names]
                elif isinstance(node, ast.ImportFrom) and node.level == 0:
                    names = [node.module]
                for name in names:
                    top = name.split('.')[0]
                    assert top not in ('path_tracer_tpu', 'path_tracer_tpu_torch',
                                       'jax', 'jaxlib', 'flax', 'benchmark'), (f, name)


def test_reference_loads_neither_the_program_nor_jax():
    code = (
        'import sys; sys.path.insert(0, sys.argv[1]);'
        'import benchmark.reference.follow;'
        'import benchmark.reference.plain.scene.compile;'
        'bad = sorted({m.split(".")[0] for m in sys.modules}'
        ' & {"jax", "jaxlib", "flax", "path_tracer_tpu", "path_tracer_tpu_torch"});'
        'print(",".join(bad))')
    root = os.path.dirname(cell_mod.BENCH_DIR)
    out = subprocess.run([sys.executable, '-c', code, root], capture_output=True,
                         text=True, check=True, env=dict(os.environ, PYTHONPATH=''))
    assert out.stdout.strip() == ''


def test_a_run_loads_no_jax():
    """A whole run of a cell (CPU, tiny) in a fresh process: the program,
    the harness and the reference leave no forbidden module loaded."""
    root = os.path.dirname(cell_mod.BENCH_DIR)
    code = '''
import sys
sys.path.insert(0, sys.argv[1])
from benchmark.harness import runner
from benchmark.harness.cell import load_cell
cell = load_cell('cornell_box.offline_1440x1440')
cell.traffic.update(width=32, height=16, chunk_rounds=1, warmup_rounds=1)
result, _ = runner.run(cell, 99, 0.1, False, device='cpu')
print(result['correct'], ','.join(runner.forbidden_modules()))
'''
    out = subprocess.run([sys.executable, '-c', code, root], capture_output=True,
                         text=True, timeout=600, env=dict(os.environ, PYTHONPATH=''))
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.split('\n')[-2].strip() == 'True'
