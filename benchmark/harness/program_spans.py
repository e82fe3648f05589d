"""The program's own spans in a profiled window.

With tracing on, the program (`utils/profiling.py` of the port) opens a
`torch.profiler.record_function` for each span it records: named
`pt.<layer>...`, or after a log event's kind (`render.dispatch`). On the
profiler's timeline each is a CPU event on the host and a GPU user
annotation, on one clock. The profiler draws a span's GPU range from the
first to the last kernel launched in it and in no span inside it, so a
span whose own kernels all come before its children's has a range that
holds none of theirs. So each kernel belongs to the innermost GPU range
around it, and counts for that span and for each span the program
opened it in (the span records' parents). Read here:

- the device ms of the kernels of each `pt.*` span, its children's
  included, and how many kernels they are;
- each idle gap of the device, by the innermost `pt.*` CPU event open at
  its midpoint;
- the program's counters, `profiling.counters()` at the window's end.

The annotations are not kernels. A program without the facility gives
nothing to read: `profile_traced` returns None.
"""

from __future__ import annotations

import collections
import dataclasses

from . import stats
from .profile import Kernel, _short

PREFIX = 'pt.'
OUTSIDE = 'host, outside the spans'


@dataclasses.dataclass
class ProgramTrace:
    rounds: int
    kernels: list         # the window's device kernels, annotations left out
    span_device_ms: dict  # pt.* span -> device ms inside its ranges
    span_kernels: dict    # pt.* span -> kernels inside its ranges
    idle_gaps: list       # [[innermost pt.* span or OUTSIDE, seconds], ...]
    counters: dict
    parents: dict         # span -> the span it opened in, where it has one

    def ms_per_round(self, span):
        ms = self.span_device_ms.get(span)
        return ms / self.rounds if ms and self.rounds else None

    def kernels_per_round(self, span):
        n = self.span_kernels.get(span)
        return n / self.rounds if n and self.rounds else None

    def lane_use_pct(self, model):
        """100 x surface-event lanes of `model`'s material type / lanes
        the model ran on."""
        ran = self.counters.get(f'pt.model.{model}.lanes')
        by_type = self.counters.get('pt.scatter.surface_lanes_by_type', {})
        used = by_type.get(model)
        if not ran or used is None:
            return None
        return 100.0 * used / ran


# The readings of the scatter side's parts, under the names their
# per-layer metrics take.
_MS = {
    'trace_attributes_ms_per_round': 'pt.trace.attributes',
    'medium_ms_per_round': 'pt.scatter.medium',
    'material_fetch_ms_per_round': 'pt.scatter.material',
    'bsdf_sample_ms_per_round': 'pt.scatter.bsdf_sample',
    'openpbr_sample_ms_per_round': 'pt.model.openpbr.sample',
    'respawn_ms_per_round': 'pt.respawn',
}


def readings(trace):
    """{metric name: value or None} of a ProgramTrace."""
    out = {name: trace.ms_per_round(span) for name, span in _MS.items()}
    out['openpbr_lane_use_pct'] = trace.lane_use_pct('openpbr')
    out['openpbr_sample_kernels_per_round'] = trace.kernels_per_round(
        'pt.model.openpbr.sample')
    return out


def _innermost(spans, points):
    """For each of `points`, the name of the innermost of the nested or
    disjoint (start, end, name) `spans` open there, or None."""
    spans = sorted(spans, key=lambda s: (s[0], -s[1]))
    out, stack, i = [None] * len(points), [], 0
    for j in sorted(range(len(points)), key=points.__getitem__):
        t = points[j]
        while i < len(spans) and spans[i][0] <= t:
            while stack and stack[-1][1] < spans[i][0]:
                stack.pop()
            stack.append(spans[i])
            i += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        out[j] = stack[-1][2] if stack else None
    return out


def read(events, records, counters, rounds, annotations=()):
    """A ProgramTrace of a finished profile's `events`, with the
    program's span `records` (utils/profiling.py's `records()`) and
    `counters`. No span is a kernel: neither the program's, nor those
    named in `annotations` (the benchmark's own)."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    annotations = {r[0] for r in records} | set(annotations)
    parents = {}
    for name, parent, *_ in records:
        if parent >= 0:
            parents.setdefault(name, records[parent][0])
    kernels = sorted(
        (Kernel(_short(e.name), e.time_range.start, e.time_range.end)
         for e in events if e.device_type == cuda and e.name not in annotations),
        key=lambda k: k.start_us)
    ranges = [(e.time_range.start, e.time_range.end, e.name) for e in events
              if e.device_type == cuda and e.name.startswith(PREFIX)]
    owners = _innermost(ranges, [(k.start_us + k.end_us) / 2 for k in kernels])
    lineage = {}
    span_ms, span_n = collections.Counter(), collections.Counter()
    for k, owner in zip(kernels, owners):
        if owner not in lineage:
            chain, name = [], owner
            while name is not None and name not in chain:
                chain.append(name)
                name = parents.get(name)
            lineage[owner] = [n for n in chain if n.startswith(PREFIX)]
        for name in lineage[owner]:
            span_ms[name] += (k.end_us - k.start_us) / 1e3
            span_n[name] += 1
    host = [(e.time_range.start, e.time_range.end, e.name) for e in events
            if e.device_type != cuda and e.name.startswith(PREFIX)]
    gaps = stats.gaps([(k.start_us, k.end_us) for k in kernels])
    idle = collections.Counter()
    middles = [(a + b) / 2 for a, b in gaps]
    for (start, end), name in zip(gaps, _innermost(host, middles)):
        idle[name or OUTSIDE] += (end - start) / 1e6
    return ProgramTrace(rounds=rounds, kernels=kernels,
                        span_device_ms=dict(span_ms), span_kernels=dict(span_n),
                        idle_gaps=[[n, s] for n, s in idle.most_common(10)],
                        counters=counters, parents=parents)


def profile_traced(run, rounds, device, annotations=()):
    """Profile `run()` with the program's tracing on, between two
    synchronisations; its ProgramTrace, or None for a program without
    the facility. `annotations`: the names of the benchmark's own spans
    open in the window."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from path_tracer_tpu_torch.utils import profiling
    if not hasattr(profiling, 'tracing'):
        return None
    cuda = torch.device(device).type == 'cuda'
    activities = [ProfilerActivity.CPU]
    if cuda:
        activities.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize()
    with profile(activities=activities) as prof:
        with profiling.tracing():
            run()
            if cuda:
                torch.cuda.synchronize()
    return read(prof.events(), profiling.records(), profiling.counters(),
                rounds, annotations)
