"""The basic BSDF-sample kernel's reader on made-up traces."""

import pytest

from benchmark.harness.profile import Kernel

from test_bench_arith import read, trace_data


def test_basic_sample_reader():
    """Device ms a round of the kernel by name, in either instantiation:
    two rounds of 0.5 ms, one of them counting."""
    d = trace_data(kernels=[
        Kernel('a', 0, 2000),
        Kernel('(anonymous namespace)::basic_sample_kernel<false>('
               '(anonymous namespace)::BasicSampleArgs)', 3000, 3500),
        Kernel('basic_sample_kernel<true>', 5000, 5500)])
    assert read('basic_sample_ms', d) == pytest.approx(0.5)


def test_basic_sample_reader_says_nothing_without_the_kernel():
    """A program without the kernel (the parent's) gives nothing, nor does
    another generator or a trace whose kernels are all others."""
    assert read('basic_sample_ms', trace_data()) is None
    assert read('basic_sample_ms', trace_data(kernels=[
        Kernel('medium_event_kernel<false>', 0, 10)])) is None
    assert read('basic_sample_ms', trace_data(generator='other', kernels=[
        Kernel('basic_sample_kernel<false>', 0, 10)])) is None
