# From path_tracer_tpu/utils/log.py; here the clock is time.perf_counter and
# `timer` opens a span of utils/profiling.py.
"""Structured (JSON-lines) event logging.

The reference has no logging subsystem at all -- progress is visible
only through the ImGui overlay. A production renderer needs machine-
readable telemetry: this module emits one JSON object per event to a
sink chosen at process start, and is a strict no-op (one dict lookup)
when disabled, so hot paths can log unconditionally.

Enable with the environment variable ``PT_LOG``:

  PT_LOG=stderr      events to stderr
  PT_LOG=/path/x.jsonl  events appended to a file

or programmatically via `enable(sink)`. Events carry a monotonic
timestamp (`ts`, seconds of `time.perf_counter()` since this module was
imported, the clock of the program's spans in utils/profiling.py), the
event `kind`, and arbitrary fields::

  {"ts": 12.081, "kind": "render.dispatch", "rounds": 64, "s": 24.9}

`timer` also opens a span named after its kind (utils/profiling.py), so
its region shows on a traced timeline beside the program's spans. A
timer's `s` is host time: `render.dispatch`'s is the time the rounds
took to enqueue, not to render, since nothing in it synchronises.

Emitters in the framework: scene compile stages (`compile.pack`),
render driver calls (`render.dispatch`), session restarts
(`session.restart`), checkpoint IO, benchmark phases, and device
failure/recovery (`utils/resilience.py`).
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time

from . import profiling

_T0 = time.perf_counter()
_state = {'fh': None}
_lock = threading.Lock()


def _coerce(v):
    # numpy / jax scalars -> python scalars; arrays summarized by shape.
    if hasattr(v, 'item') and getattr(v, 'ndim', 1) == 0:
        return v.item()
    if hasattr(v, 'shape') and hasattr(v, 'dtype'):
        return f'<{v.dtype}{tuple(v.shape)}>'
    return v


def enable(sink='stderr'):
    """Route events to `sink`: 'stderr', 'stdout', or a file path."""
    if sink in ('stderr', 'stdout'):
        _state['fh'] = getattr(sys, sink)
    else:
        _state['fh'] = open(sink, 'a', buffering=1)


def disable():
    fh = _state['fh']
    _state['fh'] = None
    if fh not in (None, sys.stderr, sys.stdout):
        fh.close()


def enabled():
    return _state['fh'] is not None


def event(kind, **fields):
    """Emit one structured event; no-op unless logging is enabled."""
    fh = _state['fh']
    if fh is None:
        return
    rec = {'ts': round(time.perf_counter() - _T0, 3), 'kind': kind}
    for k, v in fields.items():
        rec[k] = _coerce(v)
    line = json.dumps(rec, default=str)
    with _lock:
        fh.write(line + '\n')


class timer:
    """Context manager that logs `kind` with the region's host time, in
    a span of the same name.

    Extra fields pass through; set more via `.fields` inside the body::

        with log.timer('compile.pack', sections=n) as t:
            ...
            t.fields['rows'] = rows
    """

    def __init__(self, kind, **fields):
        self.kind = kind
        self.fields = fields

    def __enter__(self):
        self._span = profiling.span(self.kind)
        self._span.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        self.fields['s'] = round(time.perf_counter() - self._t0, 4)
        self._span.__exit__(exc_type, exc, tb)
        if exc_type is not None:
            self.fields['error'] = exc_type.__name__
        event(self.kind, **self.fields)
        return False


_env = os.environ.get('PT_LOG')
if _env:
    enable(_env)
