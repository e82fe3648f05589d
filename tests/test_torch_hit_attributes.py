"""The hit attributes of `trace` on the CPU: a CPU trace resolves them
with the plain chain (ops/intersect.py::resolve_attributes_plain: the
mesh kernel's winners merged into the hit record, then
resolve_hit_attributes) and launches nothing; the card's kernel,
csrc/hit_attributes.cu, is held to that chain bit for bit in
tests/test_torch_cuda.py, and its wrapper refuses CPU tensors."""

import numpy as np
import pytest
import torch

from path_tracer_tpu_torch.core.constants import HIT_TIME_LIMIT
from path_tracer_tpu_torch.ops import hit_attributes, intersect
from path_tracer_tpu_torch.utils import profiling

from test_torch_cuda import (
    ATTRIBUTE_CASES,
    attribute_case,
    attribute_trace_options,
    same_bits,
)


def random_rays(seed, n):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-7, 7, (3, n)).astype(np.float32)
    d = rng.normal(size=(3, n)).astype(np.float32)
    d /= np.linalg.norm(d, axis=0)
    return torch.from_numpy(o), torch.from_numpy(d)


@pytest.mark.parametrize('case', ATTRIBUTE_CASES)
def test_cpu_trace_takes_the_plain_chain(case, monkeypatch):
    packed = attribute_case(case, 'cpu')
    layout = intersect.SceneLayout.from_packed(packed)
    o, d = random_rays(len(case), 2048)
    captured = []
    plain = intersect.resolve_attributes_plain

    def capture(*args):
        captured.append(args)
        return plain(*args)

    monkeypatch.setattr(intersect, 'resolve_attributes_plain', capture)
    options, no_winners = attribute_trace_options(case)
    profiling.reset()
    got = intersect.trace(packed, layout, o, d, **options)
    assert 'kernel.hit_attributes' not in profiling.counters()
    (_, _, _, _, hit, winners), = captured
    assert (winners is None) == no_winners
    want = plain(packed, layout, o, d, hit, winners)
    assert list(got) == list(want)
    for key in want:
        assert same_bits(got[key], want[key]), key
    assert bool((got['shape'] != hit['shape']).any()) or winners is None


def test_hit_attributes_wrapper_refuses_cpu_tensors():
    packed = attribute_case('inst_one', 'cpu')
    layout = intersect.SceneLayout.from_packed(packed)
    o, d = random_rays(0, 64)
    hit = intersect.make_hit(64, HIT_TIME_LIMIT, 'cpu')
    with pytest.raises(ValueError, match='CUDA'):
        hit_attributes.hit_attributes(packed, layout, o, d, hit)
