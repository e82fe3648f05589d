"""One run of one cell: set-up, window, optional profiled sub-window,
the check, and the result line."""

from __future__ import annotations

import gc
import os
import subprocess
import sys
import time
import types

from . import check, profile

FORBIDDEN = ('jax', 'jaxlib', 'flax', 'path_tracer_tpu')

_T_IMPORT = time.time()


def process_age():
    """Seconds since this process started (from /proc; else since this
    module was imported)."""
    try:
        with open('/proc/self/stat') as f:
            fields = f.read().rsplit(')', 1)[1].split()
        with open('/proc/uptime') as f:
            uptime = float(f.read().split()[0])
        return uptime - int(fields[19]) / os.sysconf('SC_CLK_TCK')
    except (OSError, ValueError, IndexError):
        return time.time() - _T_IMPORT


def forbidden_modules(modules=None):
    """Loaded modules whose top-level name is one of FORBIDDEN, compared
    whole (path_tracer_tpu_torch is not path_tracer_tpu)."""
    names = sys.modules if modules is None else modules
    return sorted({m.split('.', 1)[0] for m in names} & set(FORBIDDEN))


def power_limit():
    try:
        out = subprocess.run(
            ['nvidia-smi', '--query-gpu=power.limit', '--format=csv,noheader'],
            capture_output=True, text=True, timeout=30)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else None
    except (OSError, subprocess.SubprocessError, IndexError):
        return None


class Context:
    """What a traffic generator sees of the harness."""

    def __init__(self, cell, seed, seconds, trace, device):
        import torch

        self.cell = cell
        self.params = {k: v for k, v in cell.traffic.items() if k != 'generator'}
        self.seed = int(seed)
        self.seconds = float(seconds)
        self.trace = bool(trace)
        self.device = torch.device(device)
        self.end_to_end = {}
        self.attempted = 0
        self.failed = 0
        self.compile_s = 0.0
        self.lanes = self.triangles = self.mesh_instances = 0
        self.window_s_per_unit = 0.0
        self.setup_s = None
        # (stage, seconds since process start) as set-up goes on.
        self.setup_marks = [('torch and the harness imported', process_age())]
        self.memory_peak = 0
        self.trace_data = None
        if self.device.type == 'cuda':
            torch.cuda.reset_peak_memory_stats(self.device)

    def program_scene(self):
        from path_tracer_tpu_torch.core import constants
        from path_tracer_tpu_torch.scene import model
        api = types.SimpleNamespace(**{
            k: v for m in (constants, model) for k, v in vars(m).items()
            if not k.startswith('_')})
        return self.cell.maker.make_scene(api, self.cell.config)

    def sync(self):
        import torch
        if self.device.type == 'cuda':
            torch.cuda.synchronize(self.device)

    def mark(self, stage):
        self.setup_marks.append((stage, process_age()))

    def setup_done(self):
        self.setup_s = process_age()
        self.setup_marks.append(('set-up done', self.setup_s))

    def read_memory_peak(self):
        import torch
        if self.device.type == 'cuda':
            self.memory_peak = int(torch.cuda.max_memory_allocated(self.device))

    def profile(self, run, spans, rounds):
        import torch
        if self.device.type == 'cuda':
            window_s, kernels, span_ms, idle = profile.profile_window(run, spans)
            kind = torch.cuda.get_device_name(self.device)
        else:
            # CPU rehearsal: the host clock only, no device reading.
            t0 = time.perf_counter()
            run()
            window_s, kernels, span_ms, idle = time.perf_counter() - t0, [], {}, []
            kind = 'cpu'
        self.trace_data = profile.TraceData(
            cell=self.cell.name, generator=self.cell.traffic['generator'],
            device_kind=kind, window_s=window_s, kernels=kernels,
            span_device_ms=span_ms,
            rounds=rounds)
        self.idle_gaps = idle


def run(cell, seed, seconds, trace, device='cuda', control=False):
    """Run the cell; returns (result dict, the check's lines). With
    `control`, the low-precision reference is also put in the program's
    place, and the numbers of both, each judged against the cell's
    limits, are returned."""
    import torch

    ctx = Context(cell, seed, seconds, trace, device)
    cap = cell.generator.run(ctx)
    gc.collect()
    if ctx.device.type == 'cuda':
        torch.cuda.synchronize(ctx.device)
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    ref = check.reference_outputs(cell, cap, torch.float32)
    values = check.numbers(cap, ref)
    check_s = time.perf_counter() - t_check
    if control:
        low = check.reference_outputs(cell, cap, torch.bfloat16)
        low_values = check.numbers(check.control_capture(cap, low), ref)
        return dict(program=values,
                    program_correct=check.judge(values, cell.limits)[0],
                    control=low_values,
                    control_correct=check.judge(low_values, cell.limits)[0]), []
    values['failed_requests'] = ctx.failed
    correct, checks = check.judge(values, dict(cell.limits, failed_requests=0))
    correct &= ctx.attempted > 0

    kind = (torch.cuda.get_device_name(ctx.device)
            if ctx.device.type == 'cuda' else 'cpu')
    device_info = dict(platform='gpu' if ctx.device.type == 'cuda' else 'cpu',
                       kind=kind, count=1, memory_peak_bytes=ctx.memory_peak,
                       power_limit=power_limit() if ctx.device.type == 'cuda' else None)
    metrics, result = {}, dict(correct=bool(correct), attempted=ctx.attempted,
                               failed=ctx.failed)
    if not trace:
        # A metric `<reading>.<regime>` reports the generator's <reading>
        # under a bound of its own (mrays_per_s.launch_bound).
        values_e2e = dict(ctx.end_to_end, setup_s=ctx.setup_s)
        for m in cell.end_to_end:
            reading = m['name'] if m['name'] in values_e2e else m['name'].split('.')[0]
            if reading not in values_e2e:
                raise RuntimeError(f'{cell.name}: no reading of {m["name"]}')
            metrics[m['name']] = dict(value=values_e2e[reading], unit=m['unit'])
    else:
        data = ctx.trace_data
        data.lanes, data.compile_s = ctx.lanes, ctx.compile_s
        data.triangles, data.mesh_instances = ctx.triangles, ctx.mesh_instances
        data.window_s_per_unit = ctx.window_s_per_unit
        for m in cell.per_layer:
            value = cell.metric_reader(m['name']).read(data)
            if value is not None:
                metrics[m['name']] = dict(value=value, unit=m['unit'])
        device_info.update(busy_s=data.busy_s, window_s=data.window_s)
        result['breakdown'] = dict(device_ops=data.top_ops(10),
                                   idle_gaps=ctx.idle_gaps)
    result.update(metrics=metrics, device=device_info, checks=checks)
    lines = [f'setup: {stage} at {t:.2f} s' for stage, t in ctx.setup_marks]
    lines += [f'reference: {check_s:.2f} s after the window']
    lines += [f'check {name}: {c["value"]!r} (limit {c["limit"]!r})'
              for name, c in checks.items()]
    return result, lines
