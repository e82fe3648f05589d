"""Find a cell's pieces by the names in BENCHMARK.json.

- configuration `<c>`: the file its entry names (`configs/<c>.json`, the
  sizes as run) and the maker beside it (`configs/<c>.py`,
  `make_scene(api, cfg)`);
- traffic `<t>`: `traffic/<t>.json`, parameters that the generator
  `generators/<generator>.py` named in it reads;
- per-layer metric `<m>`: `metrics/<m>.py`, whose `read(data)` returns a
  number or None;
- limits of the comparison: `cells/<workload>.json`.

A new configuration, mix, metric or cell is new files and new entries:
no file here names one.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import sys

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load_module(path, name):
    """Import the Python file `path` as module `name`."""
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module


@dataclasses.dataclass
class Cell:
    name: str
    config: dict
    maker: object
    traffic: dict
    generator: object
    chips: int
    end_to_end: list
    per_layer: list
    limits: dict
    bench_dir: str

    def metric_reader(self, name):
        return load_module(os.path.join(self.bench_dir, 'metrics', name + '.py'),
                           'benchmark_metric_' + name.replace('.', '_'))


def _applies(metric, workload):
    return 'workloads' not in metric or workload in metric['workloads']


def load_cell(workload, root=None, bench_dir=BENCH_DIR):
    """The cell `workload` of the BENCHMARK.json in `root` (default: the
    directory above the benchmark's)."""
    root = root or os.path.dirname(bench_dir)
    with open(os.path.join(root, 'BENCHMARK.json')) as f:
        spec = json.load(f)
    cells = {w['name']: w for w in spec['workloads']}
    if workload not in cells:
        raise KeyError(f'no workload {workload!r} in BENCHMARK.json '
                       f'(have {sorted(cells)})')
    w = cells[workload]
    config = {c['name']: c for c in spec['configs']}[w['config']]
    with open(os.path.join(root, config['file'])) as f:
        cfg = json.load(f)
    maker_path = os.path.splitext(os.path.join(root, config['file']))[0] + '.py'
    maker = load_module(maker_path, 'benchmark.configs.' + w['config'])
    with open(os.path.join(bench_dir, 'traffic', w['traffic'] + '.json')) as f:
        traffic = json.load(f)
    generator = load_module(
        os.path.join(bench_dir, 'generators', traffic['generator'] + '.py'),
        'benchmark_generator_' + traffic['generator'])
    with open(os.path.join(bench_dir, 'cells', workload + '.json')) as f:
        limits = json.load(f)['limits']
    return Cell(
        name=workload, config=cfg, maker=maker, traffic=traffic,
        generator=generator,
        chips=int(w['chips']),
        end_to_end=[m for m in spec['end_to_end'] if _applies(m, workload)],
        per_layer=[m for m in spec['per_layer'] if _applies(m, workload)],
        limits=limits, bench_dir=bench_dir)
