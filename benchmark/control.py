"""Readings that the comparison's limits are set from: for each seed, one
run of the cell (a window of --seconds, then the check), giving the
numbers of the program against the reference and of the control, the
reference in bfloat16 put in the program's place. One process serves
all seeds. The benchmark's own runs never run the control.

    python benchmark/control.py --workload <cell> --seeds 1,2,3 --seconds 3

Prints one JSON line a seed: {"seed", "program": {...}, "control": {...}}.
"""

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
os.environ['TORCH_EXTENSIONS_DIR'] = os.path.join(ROOT, 'build', 'torch_extensions')
os.environ['TRITON_CACHE_DIR'] = os.path.join(ROOT, 'build', 'triton')
sys.path.insert(0, ROOT)

from benchmark.harness import runner  # noqa: E402
from benchmark.harness.cell import load_cell  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seeds', required=True)
    ap.add_argument('--seconds', type=float, default=3.0)
    ap.add_argument('--no-control', action='store_true',
                    help='the program\'s numbers only')
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print('control: no CUDA device', file=sys.stderr)
        return 2
    cell = load_cell(args.workload, root=ROOT)
    for seed in (int(s) for s in args.seeds.split(',')):
        if args.no_control:
            result, _ = runner.run(cell, seed, args.seconds, False)
            values = dict(program={k: c['value'] for k, c in result['checks'].items()})
        else:
            values, _ = runner.run(cell, seed, args.seconds, False, control=True)
        print(json.dumps(dict(seed=seed, **values)), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
