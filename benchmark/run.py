"""Run one cell of the benchmark and print its result line.

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Runs on the machine it is started on, with one CUDA card. The last line
of standard output is the result (JSON); the last lines of standard
error are the compared numbers beside their limits. Exits non-zero,
with no result, without a card, with fewer cards than the cell asks
for, or if JAX or the JAX package was loaded.
"""

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# Build and kernel caches stay at fixed paths inside the checkout.
os.environ['TORCH_EXTENSIONS_DIR'] = os.path.join(ROOT, 'build', 'torch_extensions')
os.environ['TRITON_CACHE_DIR'] = os.path.join(ROOT, 'build', 'triton')
sys.path.insert(0, ROOT)

from benchmark.harness import runner  # noqa: E402
from benchmark.harness.cell import load_cell  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seed', type=int, required=True)
    ap.add_argument('--seconds', type=float, required=True)
    ap.add_argument('--trace', type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    cell = load_cell(args.workload, root=ROOT)
    if not torch.cuda.is_available():
        print('benchmark: no CUDA device', file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f'benchmark: {cell.name} needs {cell.chips} cards, '
              f'{torch.cuda.device_count()} present', file=sys.stderr)
        return 2
    result, lines = runner.run(cell, args.seed, args.seconds, args.trace)
    found = runner.forbidden_modules()
    if found:
        print(f'benchmark: forbidden modules loaded: {", ".join(found)}',
              file=sys.stderr)
        return 3
    for line in lines:
        print(line, file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
