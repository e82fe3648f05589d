"""utils/profiling.py: the program's spans and counters, off and on, and
the span tree of a render round on the CPU."""

import json

import numpy as np
import pytest
import torch

import path_tracer_tpu_torch.scene.model as tmodel
import path_tracer_tpu_torch.scene.procedural as tproc
from path_tracer_tpu_torch.integrator import wavefront
from path_tracer_tpu_torch.ops.intersect import SceneLayout
from path_tracer_tpu_torch.scene.compile import compile_scene
from path_tracer_tpu_torch.utils import log, profiling

from test_torch_cuda import openpbr_scene

W, H = 16, 8


@pytest.fixture(autouse=True)
def fresh_profiling():
    profiling.disable()
    profiling.reset()
    yield
    profiling.disable()
    profiling.reset()


@pytest.fixture(scope='module')
def openpbr_round():
    """The OpenPBR test scene (media, nested dielectrics, four OpenPBR
    materials and a translucent one, mesh instances) on the CPU, its
    layout, a configuration and a fresh state's maker."""
    packed = compile_scene(openpbr_scene(tmodel, tproc), aspect_ratio=W / H,
                           device='cpu')
    layout = SceneLayout.from_packed(packed)
    config = wavefront.RenderConfig(width=W, height=H)
    return packed, layout, config, lambda: wavefront.reset(packed, config, 11)


def _aten_ops(run):
    """The aten operators `run()` calls, as the profiler records them."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        run()
    return [e.name for e in prof.events() if e.name.startswith('aten::')]


def test_off_span_opens_nothing_and_device_counts_launch_nothing(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError('record_function opened while tracing is off')

    monkeypatch.setattr(torch.profiler, 'record_function', refuse)
    assert not profiling.enabled()
    first = profiling.span('pt.a')
    assert profiling.span('pt.b') is first      # one shared object
    with first:
        with profiling.span('pt.c'):
            pass
    assert profiling.records() == []

    types = torch.tensor([0, 3, 3, 1, 9])
    mask = torch.tensor([True, True, False, True, True])

    def counts():
        profiling.count('dead', mask)
        profiling.count('by_type', types, bins=('a', 'b', 'c', 'd'), where=mask)

    assert _aten_ops(counts) == []
    profiling.count('kernel.x')
    profiling.count('kernel.x', 2)
    assert profiling.counters() == {'kernel.x': 3}


def test_on_spans_keep_parents_and_device_counts_add_without_sync(monkeypatch):
    types = torch.tensor([0, 3, 3, 1, 9, -1])
    mask = torch.tensor([True, True, False, True, True, True])
    with profiling.tracing():
        with profiling.span('pt.a'):
            with profiling.span('pt.b'):
                with profiling.span('pt.c'):
                    pass
            with profiling.span('pt.d'):
                pass
        with profiling.span('pt.e'):
            pass

        def refuse(*args, **kwargs):
            raise AssertionError('a device count read its value on the host')

        with monkeypatch.context() as m:
            for name in ('item', 'tolist', '__bool__', '__int__', '__float__'):
                m.setattr(torch.Tensor, name, refuse)
            for _ in range(2):
                profiling.count('dead', mask)
                profiling.count('by_type', types, bins=('a', 'b', 'c', 'd'),
                                where=mask)
            profiling.count('pt.rounds')
    assert not profiling.enabled()
    recs = profiling.records()
    names = [r[0] for r in recs]
    assert names == ['pt.a', 'pt.b', 'pt.c', 'pt.d', 'pt.e']
    parent = {r[0]: (names[r[1]] if r[1] >= 0 else None) for r in recs}
    assert parent == {'pt.a': None, 'pt.b': 'pt.a', 'pt.c': 'pt.b',
                      'pt.d': 'pt.a', 'pt.e': None}
    for name, _, t0, t1, tid in recs:
        assert t0 <= t1 and isinstance(tid, int), name
    a, b, c = recs[0], recs[1], recs[2]
    assert a[2] <= b[2] <= c[2] <= c[3] <= b[3] <= a[3]
    # Lanes 0, 1 and 3, twice: types 9 and -1 lie outside the bins, lane 2
    # is masked.
    assert profiling.counters() == {
        'dead': 10, 'pt.rounds': 1,
        'by_type': {'a': 2, 'b': 2, 'c': 0, 'd': 2}}
    # A new traced region starts from nothing.
    with profiling.tracing():
        pass
    assert profiling.records() == [] and profiling.counters() == {}


def test_kernel_counts_are_device_counts_a_kernel_adds_into():
    """`kernel_counts` is None while tracing is off; on, it hands out one
    zeroed int64 tensor for the names, the same one until a reset, whose
    elements `counters()` reads under those names."""
    assert profiling.kernel_counts(('pt.k.a', 'pt.k.b'), 'cpu') is None
    with profiling.tracing():
        acc = profiling.kernel_counts(('pt.k.a', 'pt.k.b'), 'cpu')
        assert acc.dtype == torch.int64 and acc.tolist() == [0, 0]
        assert profiling.kernel_counts(('pt.k.a', 'pt.k.b'), 'cpu') is acc
        acc += torch.tensor([5, 2])      # what the kernel does on the card
        acc[0] += 1
        assert profiling.counters() == {'pt.k.a': 6, 'pt.k.b': 2}
    with profiling.tracing():
        fresh = profiling.kernel_counts(('pt.k.a', 'pt.k.b'), 'cpu')
        assert fresh is not acc and fresh.tolist() == [0, 0]
    assert profiling.counters() == {'pt.k.a': 0, 'pt.k.b': 0}



def test_kernel_counts_with_bins_are_a_histogram_a_kernel_adds_into():
    """With `bins`, `kernel_counts` hands out one zeroed int64 tensor for
    one name, an element a bin, the same one until a reset, which
    `counters()` reads as that name's histogram; None while tracing is
    off."""
    bins = ('miss', 'hit')
    assert profiling.kernel_counts('pt.k.h', 'cpu', bins=bins) is None
    with profiling.tracing():
        acc = profiling.kernel_counts('pt.k.h', 'cpu', bins=bins)
        assert acc.dtype == torch.int64 and acc.tolist() == [0, 0]
        assert profiling.kernel_counts('pt.k.h', 'cpu', bins=list(bins)) is acc
        acc += torch.tensor([3, 4])      # what the kernel does on the card
        assert profiling.counters() == {'pt.k.h': {'miss': 3, 'hit': 4}}
    with profiling.tracing():
        fresh = profiling.kernel_counts('pt.k.h', 'cpu', bins=bins)
        assert fresh is not acc and fresh.tolist() == [0, 0]


def test_log_timer_opens_a_span_on_the_span_clock(tmp_path):
    sink = tmp_path / 'events.jsonl'
    log.enable(str(sink))
    try:
        with profiling.tracing():
            with profiling.span('pt.outer'):
                with log.timer('checkpoint.save', path='x') as t:
                    t.fields['rows'] = 3
        log.event('after')
    finally:
        log.disable()
    (name, parent, t0, t1, _), = [r for r in profiling.records()
                                  if r[0] == 'checkpoint.save']
    assert profiling.records()[parent][0] == 'pt.outer'
    saved, after = [json.loads(line) for line in sink.read_text().splitlines()]
    assert saved['kind'] == 'checkpoint.save' and saved['rows'] == 3
    assert saved['path'] == 'x' and 0.0 <= saved['s'] <= (t1 - t0) / 1e9 + 1e-3
    assert after['ts'] >= saved['ts']


def _tree(recs):
    children = {}
    for name, parent, *_ in recs:
        children.setdefault(recs[parent][0] if parent >= 0 else None,
                            set()).add(name)
    return children


def test_render_round_span_tree_and_counts(openpbr_round):
    packed, layout, config, fresh = openpbr_round
    state = fresh()
    with profiling.tracing():
        wavefront.render_round(packed, layout, config, state, 0.05)
    recs = profiling.records()
    tree = _tree(recs)
    assert tree[None] == {'pt.round'}
    assert tree['pt.round'] == {'pt.trace', 'pt.scatter', 'pt.accumulate',
                                'pt.respawn'}
    assert tree['pt.trace'] == {'pt.trace.analytic', 'pt.trace.kernel',
                                'pt.trace.attributes'}
    assert layout.scene_has_medium
    assert {'pt.scatter.medium', 'pt.scatter.material',
            'pt.scatter.bsdf_sample', 'pt.scatter.tail'} <= tree['pt.scatter']
    assert tree['pt.scatter'] <= {'pt.scatter.medium', 'pt.scatter.material',
                                  'pt.scatter.bsdf_sample',
                                  'pt.scatter.bsdf_eval', 'pt.scatter.tail'}
    assert {'pt.model.openpbr.sample',
            'pt.model.basic_translucent.sample'} <= tree['pt.scatter.bsdf_sample']
    assert sum(r[0] == 'pt.round' for r in recs) == 1

    n = W * H
    counted = profiling.counters()
    assert counted['pt.rounds'] == 1
    assert counted['pt.model.openpbr.lanes'] == n
    by_type = counted['pt.scatter.surface_lanes_by_type']
    assert set(by_type) == {'basic_diffuse', 'basic_metal',
                            'basic_translucent', 'openpbr'}
    assert 0 < by_type['openpbr'] and sum(by_type.values()) <= n
    assert 0 <= counted['pt.respawn.lanes'] <= n
    assert sum(counted['pt.scatter.tail.lanes'].values()) == n


def test_round_state_is_bit_identical_with_tracing_on_and_off(openpbr_round):
    packed, layout, config, fresh = openpbr_round
    off, on = fresh(), fresh()
    for _ in range(2):
        wavefront.render_round(packed, layout, config, off, 0.05)
    with profiling.tracing():
        for _ in range(2):
            wavefront.render_round(packed, layout, config, on, 0.05)

    def leaves(tree, prefix=''):
        if isinstance(tree, dict):
            for k in sorted(tree):
                yield from leaves(tree[k], prefix + '/' + k)
        else:
            yield prefix, tree

    a, b = dict(leaves(off)), dict(leaves(on))
    assert a.keys() == b.keys()
    for key in a:
        assert np.array_equal(a[key].numpy(), b[key].numpy()), key


@pytest.mark.parametrize('use_packet', [None, False], ids=['packet', 'portable'])
def test_trace_counts_attribute_lanes_by_what_they_hit(use_packet):
    """`pt.trace.attributes.lanes` bins every lane of a trace by what it
    hit (the plain chain counts on the CPU): misses, mesh, plane, sphere
    and cube hits, summing to the lanes; nothing while tracing is off."""
    from path_tracer_tpu_torch.ops import intersect
    from test_torch_cuda import attribute_bins, attribute_case

    packed = attribute_case('mixed', 'cpu')
    layout = SceneLayout.from_packed(packed)
    rng = np.random.default_rng(4)
    n = 3000
    o = torch.from_numpy(rng.uniform(-7, 7, (3, n)).astype(np.float32))
    d = rng.normal(size=(3, n)).astype(np.float32)
    d = torch.from_numpy(d / np.linalg.norm(d, axis=0))
    with profiling.tracing():
        hit = intersect.trace(packed, layout, o, d, use_packet=use_packet)
        bins = profiling.counters()[intersect.ATTRIBUTE_LANES]
    assert bins == attribute_bins(hit) and sum(bins.values()) == n
    assert all(v > 0 for v in bins.values()), bins
    profiling.reset()
    intersect.trace(packed, layout, o, d, use_packet=use_packet)
    assert intersect.ATTRIBUTE_LANES not in profiling.counters()
