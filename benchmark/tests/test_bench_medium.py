"""The medium-event kernel's two readers on made-up traces."""

import pytest

from benchmark.harness.profile import Kernel

from test_bench_arith import read, trace_data


def test_medium_readers():
    """Device ms a round of the kernel by name, and the least time of 144
    bytes a lane at 3.35 TB/s over it: 0.3565 ms for the 2880 cell's
    8,294,400 lanes."""
    lanes = 2880 * 2880
    d = trace_data(lanes=lanes, kernels=[
        Kernel('a', 0, 2000),
        Kernel('medium_event_kernel<false>', 3000, 3800),
        Kernel('medium_event_kernel<false>', 5000, 5800)])
    assert read('medium_ms', d) == pytest.approx(0.8)
    least_s = lanes * 144 / 3.35e12
    assert least_s == pytest.approx(0.3565e-3, rel=1e-3)
    assert read('medium_roofline', d) == pytest.approx(100 * least_s / 0.8e-3)


def test_medium_readers_say_nothing_without_the_kernel():
    """A program without the kernel (the parent's) gives neither metric,
    nor does another generator or an unknown card."""
    for d in (trace_data(), trace_data(generator='other'),
              trace_data(device_kind='cpu', kernels=[
                  Kernel('medium_event_kernel<true>', 0, 10)])):
        assert read('medium_roofline', d) is None
    assert read('medium_ms', trace_data()) is None
    assert read('medium_ms', trace_data(generator='other', kernels=[
        Kernel('medium_event_kernel<false>', 0, 10)])) is None
