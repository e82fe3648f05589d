"""The scatter-tail kernel's two readers on made-up traces."""

import pytest

from benchmark.harness.profile import Kernel

from test_bench_arith import read, trace_data


def test_scatter_tail_readers():
    """Device ms a round of the kernel by name, and the least time of 92
    bytes a lane at 3.35 TB/s over it: 0.2278 ms for the 2880 cell's
    8,294,400 lanes."""
    lanes = 2880 * 2880
    d = trace_data(lanes=lanes, kernels=[
        Kernel('a', 0, 2000),
        Kernel('scatter_tail_kernel<false>', 3000, 4100),
        Kernel('scatter_tail_kernel<false>', 5000, 6100)])
    assert read('scatter_tail_ms', d) == pytest.approx(1.1)
    least_s = lanes * 92 / 3.35e12
    assert least_s == pytest.approx(0.2278e-3, rel=1e-3)
    assert read('scatter_tail_roofline', d) == pytest.approx(
        100 * least_s / 1.1e-3)


def test_scatter_tail_readers_say_nothing_without_the_kernel():
    """A program without the kernel (the parent's) gives neither metric,
    nor does another generator or an unknown card."""
    for d in (trace_data(), trace_data(generator='other'),
              trace_data(device_kind='cpu', kernels=[
                  Kernel('scatter_tail_kernel<true>', 0, 10)])):
        assert read('scatter_tail_roofline', d) is None
    assert read('scatter_tail_ms', trace_data()) is None
    assert read('scatter_tail_ms', trace_data(generator='other', kernels=[
        Kernel('scatter_tail_kernel<false>', 0, 10)])) is None
