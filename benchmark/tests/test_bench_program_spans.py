"""The reading of the program's own spans (harness/program_spans.py) on a
synthetic event list, its readings, and program_spans.py's second
sub-window driven at a tiny size on the CPU."""

import pytest

from benchmark import program_spans as script
from benchmark.harness import program_spans
from benchmark.tests.test_bench_arith import _Event
from benchmark.tests.test_bench_reference import tiny_cell


def _records(*spans):
    """utils/profiling.records() of (name, parent name) pairs, in order."""
    names = [n for n, _ in spans]
    return [(n, names.index(p) if p else -1, 0, 1, 7) for n, p in spans]


def test_program_spans_are_not_kernels_and_gaps_go_to_the_innermost_span():
    records = _records(('render.dispatch', None), ('pt.round', 'render.dispatch'),
                       ('pt.trace', 'pt.round'), ('pt.trace.kernel', 'pt.trace'),
                       ('pt.scatter', 'pt.round'),
                       ('pt.scatter.material', 'pt.scatter'),
                       ('pt.respawn', 'pt.round'))
    events = [
        # The host's spans (CPU events, profiler clock in us).
        _Event('render.dispatch', 990, 1300, False),
        _Event('pt.round', 1000, 1200, False),
        _Event('pt.trace', 1001, 1008, False),
        _Event('pt.trace.kernel', 1003, 1006, False),
        _Event('pt.scatter', 1010, 1100, False),
        _Event('pt.scatter.material', 1020, 1040, False),
        _Event('pt.respawn', 1100, 1190, False),
        _Event('bench.scatter', 1005, 1105, False),
        # Their ranges on the device, as the profiler draws them: from the
        # first to the last kernel launched in the span and in no span
        # inside it (the round and the trace launch one kernel each before
        # their children's), and the benchmark's.
        _Event('pt.round', 1009, 1010, True),
        _Event('pt.trace', 1010, 1012, True),
        _Event('pt.trace.kernel', 1013, 1020, True),
        _Event('pt.scatter', 1030, 1110, True),
        _Event('pt.scatter.material', 1030, 1050, True),
        _Event('pt.respawn', 1200, 1290, True),
        _Event('bench.scatter', 1030, 1110, True),
        # The kernels.
        _Event('invert_kernel', 1009, 1010, True),
        _Event('make_hit_kernel', 1010, 1012, True),
        _Event('inst_trace_kernel', 1013, 1020, True),
        _Event('fetch_kernel', 1030, 1050, True),
        _Event('walk_kernel', 1060, 1110, True),
        _Event('respawn_kernel', 1200, 1290, True),
    ]
    counters = {'pt.model.openpbr.lanes': 400,
                'pt.scatter.surface_lanes_by_type': {'basic_diffuse': 350,
                                                     'openpbr': 12}}
    trace = program_spans.read(events, records, counters, rounds=2,
                               annotations={'bench.scatter'})
    assert [k.name for k in trace.kernels] == [
        'invert_kernel', 'make_hit_kernel', 'inst_trace_kernel', 'fetch_kernel',
        'walk_kernel', 'respawn_kernel']
    assert trace.span_device_ms == {
        'pt.round': pytest.approx(0.170), 'pt.trace': pytest.approx(0.009),
        'pt.trace.kernel': pytest.approx(0.007),
        'pt.scatter': pytest.approx(0.070),
        'pt.scatter.material': pytest.approx(0.020),
        'pt.respawn': pytest.approx(0.090)}
    assert trace.span_kernels == {'pt.round': 6, 'pt.trace': 2,
                                  'pt.trace.kernel': 1, 'pt.scatter': 2,
                                  'pt.scatter.material': 1, 'pt.respawn': 1}
    # Gaps 1012-1013 (middle 1012.5: scatter's host span was open, the
    # trace's had closed), 1020-1030 (the material fetch's), 1050-1060
    # (scatter's: the fetch's had closed at 1040) and 1110-1200 (respawn,
    # inside the round).
    assert dict(trace.idle_gaps) == {'pt.scatter': pytest.approx(11e-6),
                                     'pt.scatter.material': pytest.approx(10e-6),
                                     'pt.respawn': pytest.approx(90e-6)}
    assert trace.parents == {'pt.round': 'render.dispatch',
                             'pt.trace': 'pt.round',
                             'pt.trace.kernel': 'pt.trace',
                             'pt.scatter': 'pt.round',
                             'pt.scatter.material': 'pt.scatter',
                             'pt.respawn': 'pt.round'}
    got = program_spans.readings(trace)
    assert got['material_fetch_ms_per_round'] == pytest.approx(0.010)
    assert got['openpbr_sample_kernels_per_round'] is None
    assert got['respawn_ms_per_round'] == pytest.approx(0.045)
    assert got['openpbr_lane_use_pct'] == pytest.approx(3.0)
    # No span of these in the window: nothing to read.
    for name in ('trace_attributes_ms_per_round', 'medium_ms_per_round',
                 'bsdf_sample_ms_per_round', 'openpbr_sample_ms_per_round'):
        assert got[name] is None, name


def test_readings_say_nothing_without_spans_or_counters():
    trace = program_spans.read([], [], {}, rounds=4)
    assert set(program_spans.readings(trace).values()) == {None}
    assert trace.idle_gaps == [] and trace.kernels == []


def test_second_window_with_the_program_traced_at_a_tiny_size():
    from path_tracer_tpu_torch.utils import profiling

    cell = tiny_cell('cornell_box.offline_1440x1440')
    result, _, split = script.run(cell, 2 ** 31 + 77, 0.3, device='cpu')
    assert result['correct'], result['checks']
    assert not profiling.enabled()
    rounds = cell.traffic['trace_rounds']
    assert split['rounds'] == rounds
    counted = split['counters']
    assert counted['pt.rounds'] == rounds
    lanes = 40 * 40 * rounds
    assert counted['pt.model.openpbr.lanes'] == lanes
    assert counted['pt.model.basic_diffuse.lanes'] == lanes
    by_type = counted['pt.scatter.surface_lanes_by_type']
    # The light is the only OpenPBR material: a few of the surface lanes.
    assert 0 <= by_type['openpbr'] < by_type['basic_diffuse'] <= lanes
    assert split['parents']['pt.model.openpbr.sample'] == 'pt.scatter.bsdf_sample'
    assert split['parents']['pt.scatter'] == 'pt.round'
    # The CPU has no device timeline: no kernel, no device reading.
    assert split['span_ms_per_round'] == {} and split['idle_gaps'] == []
    assert split['readings']['openpbr_lane_use_pct'] == pytest.approx(
        100.0 * by_type['openpbr'] / lanes)


def test_an_untraced_run_with_tracing_on_throughout():
    from path_tracer_tpu_torch.utils import profiling

    cell = tiny_cell('cornell_box.offline_2880x2880')
    result, _, split = script.run(cell, 2 ** 31 + 78, 0.3, tracing_on=True,
                                  device='cpu')
    assert result['correct'], result['checks']
    assert split is None and not profiling.enabled()
    assert {'setup_s', 'mrays_per_s'} <= set(result['metrics'])
    # Every round since set-up began ran traced: warm-up, window, check.
    rounds = [r for r in profiling.records() if r[0] == 'pt.round']
    assert len(rounds) >= cell.traffic['warmup_rounds'] + result['attempted']


def test_a_program_without_the_facility_gives_nothing(monkeypatch):
    """As the parent commit's program: no `tracing`, `enable`, `disable`
    or `reset` in utils/profiling.py. The traced run goes on and reads
    nothing of the program; tracing it throughout is refused."""
    from path_tracer_tpu_torch.utils import profiling

    for name in ('tracing', 'enable', 'disable', 'reset'):
        monkeypatch.delattr(profiling, name)
    ran = []
    assert program_spans.profile_traced(lambda: ran.append(1), 2, 'cpu') is None
    assert ran == []
    cell = tiny_cell('cornell_box.offline_1440x1440')
    result, _, split = script.run(cell, 2 ** 31 + 79, 0.3, device='cpu')
    assert result['correct'] and split is None
    with pytest.raises(RuntimeError, match='no tracing'):
        script.run(cell, 2 ** 31 + 79, 0.3, tracing_on=True, device='cpu')
