"""The benchmark's arithmetic and the per-layer readers on made-up
traces."""

import pytest

from benchmark.harness import cell as cell_mod
from benchmark.harness import roofline, stats
from benchmark.harness.profile import Kernel, TraceData


def test_union_of_intervals_and_gaps():
    spans = [(0, 10), (5, 12), (20, 25), (24, 30), (40, 41)]
    assert stats.union_length(spans) == 12 + 10 + 1
    assert stats.gaps(spans) == [(12, 20), (30, 40)]
    assert stats.union_length([]) == 0


def test_rays_are_lanes_times_rounds():
    assert stats.mrays_per_s(2_073_600, 420, 10.0) == pytest.approx(87.0912)


def test_roofline_bytes_of_the_two_cells():
    small = roofline.trace_bytes(1440 * 1440, 32, 4)
    assert small == 2_073_600 * 48 + 32 * 36 + 4 * 48 == 99_534_144
    assert roofline.least_seconds('NVIDIA H100 80GB HBM3', 1440 * 1440,
                                  32, 4) == pytest.approx(29.712e-6, rel=1e-4)
    large = roofline.trace_bytes(2880 * 2880, 32, 4)
    assert large == 8_294_400 * 48 + 32 * 36 + 4 * 48 == 398_132_544
    assert roofline.least_seconds('NVIDIA H100 80GB HBM3', 2880 * 2880,
                                  32, 4) == pytest.approx(118.846e-6, rel=1e-4)
    assert roofline.least_seconds('some other card', 1, 1, 1) is None


def trace_data(**kw):
    base = dict(
        cell='c', generator='offline', device_kind='NVIDIA H100 80GB HBM3',
        window_s=0.010,
        kernels=[Kernel('a', 0, 2000), Kernel('inst_trace_kernel<1, false>', 1000, 3000),
                 Kernel('b', 5000, 9000)],
        span_device_ms={'bench.trace': 4.0, 'bench.scatter': 10.0},
        rounds=2, lanes=1920 * 1080, triangles=41_346,
        mesh_instances=1, compile_s=3.5, window_s_per_unit=0.005)
    base.update(kw)
    return TraceData(**base)


def read(name, data):
    path = cell_mod.os.path.join(cell_mod.BENCH_DIR, 'metrics', name + '.py')
    return cell_mod.load_module(path, 'm_' + name.replace('.', '_')).read(data)


def test_offline_readers():
    d = trace_data()
    assert d.busy_s == pytest.approx(0.007)
    # 7 ms busy over 2 rounds of 5 ms each: 30% idle.
    assert read('device_idle_pct.offline', d) == pytest.approx(30.0)
    assert read('kernels_per_round', d) == 1.5
    assert read('trace_ms_per_round', d) == 2.0
    assert read('scatter_ms_per_round', d) == 5.0
    assert read('inst_trace_ms', d) == pytest.approx(1.0)
    assert read('inst_trace_roofline', d) == pytest.approx(100 * 30.156e-6 / 1e-3, rel=1e-4)
    assert read('scene_compile_s', d) == 3.5
    assert read('device_idle_pct.launch_bound', d) == pytest.approx(30.0)
    assert read('kernels_per_round.launch_bound', d) == 1.5


def test_readers_say_nothing_where_nothing_was_recorded():
    d = trace_data(kernels=[Kernel('a', 0, 10)], span_device_ms={})
    assert read('inst_trace_ms', d) is None
    assert read('inst_trace_roofline', d) is None
    assert read('trace_ms_per_round', d) is None
    assert read('inst_trace_roofline', trace_data(device_kind='cpu')) is None


def test_offline_readers_say_nothing_of_another_generator():
    d = trace_data(generator='other')
    for name in ('device_idle_pct.offline', 'kernels_per_round',
                 'trace_ms_per_round', 'scatter_ms_per_round',
                 'inst_trace_ms', 'inst_trace_roofline',
                 'device_idle_pct.launch_bound', 'kernels_per_round.launch_bound'):
        assert read(name, d) is None, name


def test_spread_is_the_interquartile_range_over_the_median():
    assert stats.spread([1, 2, 3, 4, 5, 6]) == pytest.approx(1.0)
    assert stats.spread([10.0] * 6) == 0.0


class _Range:
    def __init__(self, start, end):
        self.start, self.end = start, end


class _Event:
    def __init__(self, name, start, end, device, kernels=()):
        import torch
        self.name = name
        self.time_range = _Range(start, end)
        self.device_type = (torch.autograd.DeviceType.CUDA if device
                            else torch.autograd.DeviceType.CPU)
        self.kernels = list(kernels)


class _Kernel:
    def __init__(self, duration):
        self.duration = duration


class _Prof:
    def __init__(self, events):
        self._events = events

    def events(self):
        return self._events


def test_profile_reading_attributes_kernels_and_gaps_to_spans():
    from benchmark.harness.profile import Spans, read_profile
    spans = Spans()
    # Host clock: the window opens at 100.0 s; profiler time is in us
    # from 5,000 (so host t maps to (t - 100) * 1e6 + 5000).
    spans.intervals = [(100.000010, 100.000050, 'bench.trace'),
                       (100.000050, 100.000090, 'bench.scatter')]
    events = [
        _Event('bench.window', 5000, 5100, False),
        _Event('bench.window', 5001, 5099, True),
        # The spans on the host, with kernels that must not count twice.
        _Event('bench.trace', 5010, 5050, False, [_Kernel(40.0)]),
        _Event('aten::add', 5012, 5013, False, [_Kernel(4.0)]),
        # The spans' ranges on the device timeline.
        _Event('bench.trace', 5020, 5024, True),
        _Event('bench.scatter', 5070, 5099, True),
        _Event('add_kernel', 5020, 5024, True),
        _Event('mul_kernel', 5070, 5076, True),
        _Event('mul_kernel2', 5076, 5077, True),
        _Event('copy_kernel', 5097, 5099, True),
    ]
    kernels, span_ms, idle = read_profile(_Prof(events), spans, 100.0)
    assert [k.name for k in kernels] == ['add_kernel', 'mul_kernel',
                                        'mul_kernel2', 'copy_kernel']
    assert span_ms == {'bench.trace': pytest.approx(0.004),
                       'bench.scatter': pytest.approx(0.009)}
    # Gaps 5024-5070 (middle 5047: trace) and 5077-5097 (middle 5087: scatter).
    assert dict(idle) == {'bench.trace': pytest.approx(46e-6),
                          'bench.scatter': pytest.approx(20e-6)}
