"""Spans around the program's calls, and the reading of a profiled
sub-window.

The benchmark's own code provides the spans: `Spans.wrap` replaces a
module or class attribute of the program by a wrapper that opens a
`torch.profiler.record_function` span of the given name and keeps the
host interval of each call, and `restore` puts the originals back. A
device kernel belongs to a span when it runs inside the span's range on
the device timeline (the profiler's GPU user annotation of the span);
an idle gap on the device belongs to the span open on the host in its
middle.
"""

from __future__ import annotations

import bisect
import collections
import dataclasses
import functools
import time
import warnings

from . import stats


class Spans:
    def __init__(self):
        self.intervals = []   # (start, end, name) on the host's perf_counter
        self._patches = []

    def wrap(self, owner, attr, name):
        import torch

        original = getattr(owner, attr)

        @functools.wraps(original)
        def wrapper(*args, **kwargs):
            with torch.profiler.record_function(name):
                t0 = time.perf_counter()
                try:
                    return original(*args, **kwargs)
                finally:
                    self.intervals.append((t0, time.perf_counter(), name))

        setattr(owner, attr, wrapper)
        self._patches.append((owner, attr, original))

    def restore(self):
        while self._patches:
            owner, attr, original = self._patches.pop()
            setattr(owner, attr, original)


@dataclasses.dataclass
class Kernel:
    name: str
    start_us: float
    end_us: float


@dataclasses.dataclass
class TraceData:
    """What a per-layer metric reads: the cell, the profiled sub-window
    (its kernels, the device time of the kernels inside each span, its
    length and its work), and the set-up's readings."""

    cell: str
    generator: str
    device_kind: str
    window_s: float
    kernels: list
    span_device_ms: dict
    rounds: int = 0
    lanes: int = 0
    triangles: int = 0
    mesh_instances: int = 0
    compile_s: float = 0.0
    # Host seconds a round in the same run's measured window, which the
    # profiler did not slow.
    window_s_per_unit: float = 0.0

    def idle_pct(self, units):
        """Share of a round's unprofiled wall time in which
        the device ran nothing: 1 - device busy time a unit in the trace /
        host time a unit in the measured window, in %."""
        if not self.kernels or not units or not self.window_s_per_unit:
            return None
        return 100.0 * (1.0 - self.busy_s / units / self.window_s_per_unit)

    @property
    def busy_s(self):
        return stats.union_length([(k.start_us, k.end_us) for k in self.kernels]) / 1e6

    def kernel_ms(self, pattern):
        """Device ms of the kernels whose name contains `pattern`."""
        return sum(k.end_us - k.start_us for k in self.kernels
                   if pattern in k.name) / 1e3

    def top_ops(self, count=10):
        by_name = collections.Counter()
        for k in self.kernels:
            by_name[k.name] += (k.end_us - k.start_us) / 1e6
        return [[n, s] for n, s in by_name.most_common(count)]


def _short(name):
    return name.replace('(anonymous namespace)::', '').split('(')[0][:120]


def read_profile(prof, spans, origin):
    """(kernels, device ms a span, idle seconds by the span open on the
    host in the middle of each gap) of a finished torch.profiler.profile.

    `spans` holds the host intervals of the span wrappers (of any
    thread), `origin` the host time at which the 'bench.window' range
    opened; the range's start on the profiler's timeline maps the one
    clock onto the other."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    names = {n for _, _, n in spans.intervals} | {'bench.window'}
    events = prof.events()
    window = [e for e in events
              if e.device_type != cuda and e.name == 'bench.window']
    shift = window[0].time_range.start - origin * 1e6 if window else 0.0
    intervals = sorted((a * 1e6 + shift, b * 1e6 + shift, n)
                       for a, b, n in spans.intervals)
    starts = [i[0] for i in intervals]

    def span_at(t):
        """The innermost span open at time t (the latest that started
        before t and had not ended)."""
        i = bisect.bisect_right(starts, t) - 1
        while i >= 0:
            if intervals[i][1] >= t:
                return intervals[i][2]
            i -= 1
        return None

    # The spans' own ranges on the device timeline (the profiler's GPU
    # user annotations, from the first to the last kernel launched inside
    # a span) are no device work; a kernel belongs to the span whose range
    # holds it. (The profiler's correlation of kernels to CPU ops is not
    # used: on the card it counted some kernels twice.)
    kernels = [Kernel(_short(e.name), e.time_range.start, e.time_range.end)
               for e in events
               if e.device_type == cuda and e.name not in names]
    ranges = [(e.time_range.start, e.time_range.end, e.name) for e in events
              if e.device_type == cuda and e.name in names
              and e.name != 'bench.window']
    span_ms = collections.Counter()
    for start, end, name in ranges:
        for k in kernels:
            overlap = min(end, k.end_us) - max(start, k.start_us)
            if overlap > 0:
                span_ms[name] += overlap / 1e3
    idle = collections.Counter()
    for start, end in stats.gaps([(k.start_us, k.end_us) for k in kernels]):
        idle[span_at((start + end) / 2) or 'host, outside the spans'] += (end - start) / 1e6
    return kernels, dict(span_ms), [[n, s] for n, s in idle.most_common(10)]


def profile_window(run, spans):
    """Profile `run()` between two synchronisations. Returns (the window
    in seconds by the host clock, kernels, device ms a span, idle gaps)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    torch.cuda.synchronize()
    warnings.filterwarnings('ignore', message='.*Profiler clears events')
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function('bench.window'):
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            window_s = time.perf_counter() - t0
    kernels, span_ms, idle = read_profile(prof, spans, t0)
    if not kernels:
        raise RuntimeError('the profiler recorded no device activity')
    return window_s, kernels, span_ms, idle
