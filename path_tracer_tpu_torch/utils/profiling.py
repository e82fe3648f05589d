"""The program's spans and counters, and device traces.

One facility for what the program records of itself:

- `span(name)`: a context manager at a layer boundary. Off (the default)
  it checks one module flag and returns a shared object that does
  nothing: no `record_function`, no allocation, no device work, no
  synchronise. On (`enable()` / `disable()`, or `with tracing():`) it
  opens `torch.profiler.record_function(name)`, so that under a profiler
  the span is a CPU event on the profiler's own timeline and its GPU
  user annotation covers the kernels launched inside it, and it keeps
  (name, parent index, t0_ns, t1_ns, thread id) from
  `time.perf_counter_ns()` in memory for `records()`.
- `count(name, value=1)`: a counter at the same boundaries. Host counts
  (Python ints) always add into one dict. Device counts (tensors) add
  only while tracing is on, into persistent device tensors, with no
  `.item()` and no synchronise; `counters()` reads both.
  `kernel_counts(names, device[, bins])` hands a hand-written kernel
  such tensors to add into itself, so that counting takes no launch.

The program's spans and counters are named `pt.<layer>...`, one per
launch of a hand-written kernel `kernel.<name>`; `utils/log.py`'s
`timer` opens a span named after its event kind. PyTorch returns from a
CUDA call before the card has run it, so a span's host interval is the
time its launches were enqueued; its device time is what a profiler
reads inside its GPU range.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time

import torch

_on = False
_lock = threading.Lock()
_local = threading.local()
_records = []          # one (name, parent, t0_ns, t1_ns, tid) a span
_host = {}             # name -> int
_device = {}           # name -> (int64 tensor, bin labels or None)
_kernel_counts = {}    # (names, bins, device) -> int64 tensor a kernel adds to
_generation = 0        # bumped by reset(): a span open across it records nothing
_OFF = contextlib.nullcontext()


def enabled():
    return _on


def enable():
    global _on
    _on = True


def disable():
    global _on
    _on = False


def reset():
    """Forget every span record and every count."""
    global _generation
    with _lock:
        _generation += 1
        _records.clear()
        _host.clear()
        _device.clear()
        _kernel_counts.clear()


@contextlib.contextmanager
def tracing():
    """Tracing on for the region, from no records and no counts; the
    previous state after it."""
    was = _on
    reset()
    enable()
    try:
        yield
    finally:
        if not was:
            disable()


class _Span:
    __slots__ = ('name', 'generation', 'index', 'parent', 't0', 'function')

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        self.function = torch.profiler.record_function(self.name)
        self.function.__enter__()
        stack = getattr(_local, 'stack', None)
        if stack is None:
            stack = _local.stack = []
        with _lock:
            generation, parent = stack[-1] if stack else (None, -1)
            self.generation = _generation
            self.parent = parent if generation == _generation else -1
            self.index = len(_records)
            self.t0 = time.perf_counter_ns()
            _records.append((self.name, self.parent, self.t0, None,
                             threading.get_ident()))
        stack.append((self.generation, self.index))
        return self

    def __exit__(self, exc_type, exc, tb):
        t1 = time.perf_counter_ns()
        _local.stack.pop()
        with _lock:
            if self.generation == _generation:
                _records[self.index] = (self.name, self.parent, self.t0, t1,
                                        threading.get_ident())
        self.function.__exit__(exc_type, exc, tb)
        return False


def span(name):
    """A span named `name` around a `with` block while tracing is on;
    a shared do-nothing context while it is off."""
    return _Span(name) if _on else _OFF


def records():
    """The spans recorded since the last reset, in the order they opened:
    (name, index of the parent span or -1, t0_ns, t1_ns, thread id);
    t1_ns is None while a span is open."""
    with _lock:
        return list(_records)


def count(name, value=1, bins=None, where=None):
    """Add `value` to the counter `name`.

    An int is a host count, kept whether tracing is on or off. A tensor
    is a device count, kept only while tracing is on: its sum (a bool
    mask counts its true lanes), or with `bins` (the labels of bins 0,
    1, ...) a histogram of its integer entries, entries outside the bins
    not counted. `where` (a bool tensor) counts only those lanes. The sum
    stays on the device until `counters()`.
    """
    if not isinstance(value, torch.Tensor):
        with _lock:
            _host[name] = _host.get(name, 0) + value
        return
    if not _on:
        return
    if bins is None:
        add = (value if where is None else torch.where(where, value, 0)).sum()
    else:
        # One row a bin, summed: a scatter of atomic adds into a few bins
        # would serialise on them.
        labels = torch.arange(len(bins), device=value.device)[:, None]
        hits = value[None, :] == labels
        add = (hits if where is None else hits & where).sum(dim=1)
    with _lock:
        acc = _device.get(name)
        if acc is None:
            acc = _device[name] = (torch.zeros(add.shape, dtype=torch.int64,
                                               device=value.device), bins)
    acc[0].add_(add)


def kernel_counts(names, device, bins=None):
    """Device counts that a kernel adds to itself while tracing is on: one
    int64 tensor on `device` with an element for each of `names`, kept
    and read as `count`'s device counts are (the same tensor until the
    next reset); with `bins`, `names` is one name and the tensor its
    histogram, an element for each label of `bins`. None while tracing
    is off: the kernel then counts nothing."""
    if not _on:
        return None
    bins = None if bins is None else tuple(bins)
    names = names if bins else tuple(names)
    key = (names, bins, str(device))
    with _lock:
        acc = _kernel_counts.get(key)
        if acc is None:
            acc = _kernel_counts[key] = torch.zeros(
                len(bins or names), dtype=torch.int64, device=device)
            if bins:
                _device[names] = (acc, bins)
            else:
                for k, name in enumerate(names):
                    _device[name] = (acc[k], None)
    return acc


def counters():
    """Every count: host counts as ints, device counts read from the
    device (this synchronises) as ints, or as {label: int} for a
    histogram."""
    with _lock:
        out = dict(_host)
        device = dict(_device)
    for name, (acc, bins) in device.items():
        if bins is None:
            out[name] = int(acc)
        else:
            out[name] = dict(zip(bins, acc.tolist()))
    return out


@contextlib.contextmanager
def device_trace(log_dir='pt_trace'):
    """A torch.profiler trace of the CPU and, where there is one, the
    card around a region, with the program's tracing on: the Chrome trace
    in `<log_dir>/trace.json` holds the program's spans beside the
    kernels they launched."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof, tracing():
        yield log_dir
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    os.makedirs(log_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(log_dir, 'trace.json'))
