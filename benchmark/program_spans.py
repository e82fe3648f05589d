"""Run one cell as run.py does, and read the program's own spans and
counters.

    python3 benchmark/program_spans.py --workload <cell> --seed <n> --seconds <s> [--tracing-on] [--out FILE]

By default this is run.py's traced run (--trace 1), and after its
profiled sub-window, which runs with the program's tracing off, a second
sub-window of the same rounds runs with the program's tracing on
(`profiling.tracing()`), read by harness/program_spans.py. Prints the
run's result line, then one JSON line: the device ms and kernels a round
inside each program span (children included, and each span's own), the
idle gaps by program span, the counters, and the readings of the
scatter side's parts.

With --tracing-on it is run.py's untraced run (--trace 0) with the
program's tracing on from the start of set-up to the end, and prints its
result line alone: its end-to-end metrics, beside run.py's on the same
seed, are what tracing costs.
"""

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
os.environ['TORCH_EXTENSIONS_DIR'] = os.path.join(ROOT, 'build', 'torch_extensions')
os.environ['TRITON_CACHE_DIR'] = os.path.join(ROOT, 'build', 'triton')
sys.path.insert(0, ROOT)

from benchmark.harness import program_spans, runner  # noqa: E402
from benchmark.harness.cell import load_cell  # noqa: E402


def split(trace):
    """The JSON-ready reading of a ProgramTrace (None: nothing read)."""
    if trace is None:
        return None
    per_round = {name: ms / trace.rounds
                 for name, ms in sorted(trace.span_device_ms.items())}
    own = dict(per_round)
    for name, parent in trace.parents.items():
        if parent in own and name in per_round:
            own[parent] -= per_round[name]
    return dict(
        rounds=trace.rounds,
        kernels_per_round=len(trace.kernels) / trace.rounds,
        span_ms_per_round=per_round,
        span_own_ms_per_round=own,
        span_kernels_per_round={name: n / trace.rounds
                                for name, n in sorted(trace.span_kernels.items())},
        parents=trace.parents,
        idle_gaps=trace.idle_gaps,
        counters=trace.counters,
        readings=program_spans.readings(trace))


def run(cell, seed, seconds, tracing_on=False, device='cuda'):
    """(result, the check's lines, the program's split or None)."""
    from path_tracer_tpu_torch.utils import profiling

    found = {}

    class TwoWindows(runner.Context):
        def profile(self, run, spans, rounds):
            super().profile(run, spans, rounds)
            names = {n for *_, n in spans.intervals} | {'bench.window'}
            found['trace'] = program_spans.profile_traced(
                run, rounds, self.device, names)

    if tracing_on:
        if not hasattr(profiling, 'tracing'):
            raise RuntimeError('the program has no tracing to turn on')
        profiling.reset()
        profiling.enable()
    original = runner.Context
    runner.Context = TwoWindows
    try:
        result, lines = runner.run(cell, seed, seconds, int(not tracing_on),
                                   device=device)
    finally:
        runner.Context = original
        if tracing_on:
            profiling.disable()
    return result, lines, split(found.get('trace'))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seed', type=int, required=True)
    ap.add_argument('--seconds', type=float, required=True)
    ap.add_argument('--tracing-on', action='store_true')
    ap.add_argument('--out', help='also append the lines to this file')
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print('program_spans: no CUDA device', file=sys.stderr)
        return 2
    cell = load_cell(args.workload, root=ROOT)
    result, lines, program = run(cell, args.seed, args.seconds, args.tracing_on)
    for line in lines:
        print(line, file=sys.stderr)
    out = [json.dumps(dict(result, workload=cell.name, seed=args.seed,
                           tracing_on=args.tracing_on))]
    if not args.tracing_on:
        out.append(json.dumps(dict(program_spans=program, workload=cell.name,
                                   seed=args.seed)))
    if args.out:
        with open(args.out, 'a') as f:
            f.write('\n'.join(out) + '\n')
    print('\n'.join(out), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
