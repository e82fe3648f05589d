"""Profiling utilities: ray-throughput counters and device traces.

Port of path_tracer_tpu/utils/profiling.py. PyTorch returns from a CUDA
call before the card has run it, so a measured region ends in
`torch.cuda.synchronize()` on the device of `sync_tensor`; without one
the host clock would time the enqueue only. `device_trace` wraps
torch.profiler where the JAX package uses jax.profiler.
"""

from __future__ import annotations

import contextlib
import time

import torch


class RayThroughputTimer:
    """Times wavefront rounds and reports Mrays/s.

    Every wavefront round traces exactly one ray per lane (terminated
    paths respawn in place), so rays = lanes * rounds.
    """

    def __init__(self, lanes):
        self.lanes = lanes
        self.rounds = 0
        self.elapsed = 0.0

    @contextlib.contextmanager
    def measure(self, rounds, sync_tensor=None):
        if sync_tensor is not None and sync_tensor.is_cuda:
            torch.cuda.synchronize(sync_tensor.device)
        t0 = time.perf_counter()
        yield
        if sync_tensor is not None and sync_tensor.is_cuda:
            torch.cuda.synchronize(sync_tensor.device)
        self.elapsed += time.perf_counter() - t0
        self.rounds += rounds

    @property
    def mrays_per_second(self):
        if self.elapsed == 0:
            return 0.0
        return self.lanes * self.rounds / self.elapsed / 1e6


@contextlib.contextmanager
def device_trace(log_dir='pt_trace'):
    """torch.profiler trace of the CPU and, where there is one, the card
    around a region; the Chrome trace goes to `<log_dir>/trace.json`."""
    import os

    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield log_dir
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    os.makedirs(log_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(log_dir, 'trace.json'))
