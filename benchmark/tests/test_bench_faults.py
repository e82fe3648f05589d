"""A run with the timed path broken underneath comes out not correct:
the harness's look for a card is skipped (CPU, tiny size) and the rest
of the run is driven as on the card, once for each fault a cell can
have. (One card: there is no exchange between cards to leave out.)"""

import contextlib

import pytest
import torch

from benchmark.harness import runner
from benchmark.tests.test_bench_reference import tiny_cell


@contextlib.contextmanager
def patched(owner, attr, make):
    original = getattr(owner, attr)
    setattr(owner, attr, make(original))
    try:
        yield
    finally:
        setattr(owner, attr, original)


def state_unchanged(original):
    def render_round(packed, layout, config, rs, *args, **kwargs):
        return rs
    return render_round


def half_the_lanes_left_out(original):
    """Scatter advances the first half of the lanes; the rest keep their
    path and ray, and stay alive."""
    def scatter(packed, state, origin, direction, hit, rng, *args, **kwargs):
        new_state, new_origin, new_direction, alive = original(
            packed, state, origin, direction, hit, rng, *args, **kwargs)
        half = origin.shape[1] // 2
        keep = torch.arange(origin.shape[1], device=origin.device) >= half
        new_state = {k: torch.where(keep, state[k], v) for k, v in new_state.items()}
        return (new_state, torch.where(keep, origin, new_origin),
                torch.where(keep, direction, new_direction), alive | keep)
    return scatter


def hits_altered(original):
    """Every 16th ray's hit comes back 1% farther."""
    def trace(*args, **kwargs):
        hit = dict(original(*args, **kwargs))
        n = hit['time'].shape[0]
        every = torch.arange(n, device=hit['time'].device) % 16 == 0
        hit['time'] = torch.where(every, hit['time'] * 1.01, hit['time'])
        return hit
    return trace


def image_altered(original):
    """The resolved image comes back with one channel 1% brighter."""
    def resolve(*args, **kwargs):
        image = original(*args, **kwargs).clone()
        image[..., 1] = torch.clamp(image[..., 1] * 1.01 + 0.004, 0.0, 1.0)
        return image
    return resolve


def faults():
    from path_tracer_tpu_torch.integrator import resolve, wavefront
    return {
        'state_unchanged': (wavefront, 'render_round', state_unchanged),
        'half_the_lanes_left_out': (wavefront, 'scatter', half_the_lanes_left_out),
        'hits_altered': (wavefront, 'trace', hits_altered),
        'image_altered': (resolve, 'resolve', image_altered),
    }


CELLS = ['cornell_box.offline_1440x1440', 'cornell_box.offline_2880x2880']
CASES = [(w, f) for w in CELLS for f in
         ('state_unchanged', 'half_the_lanes_left_out', 'hits_altered',
          'image_altered')]


@pytest.mark.parametrize('workload', CELLS)
def test_an_unbroken_run_is_correct(workload):
    cell = tiny_cell(workload)
    result, lines = runner.run(cell, 77, 0.2, False, device='cpu')
    assert result['correct'], lines
    assert set(result['metrics']) == {m['name'] for m in cell.end_to_end}


@pytest.mark.parametrize('workload,fault', CASES)
def test_a_broken_run_is_not_correct(workload, fault):
    owner, attr, make = faults()[fault]
    with patched(owner, attr, make):
        result, lines = runner.run(tiny_cell(workload), 77, 0.2, False,
                                   device='cpu')
    assert not result['correct'], lines
