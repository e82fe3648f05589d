"""The next_week_final cell on the card: a short run and a traced run of
it, and the medium-event kernel against its plain version on the scene's
volume lanes. Its CPU tests are tests/test_torch_next_week.py, which the
repository's test run collects."""

import contextlib
import json
import os
import subprocess
import sys

import pytest

from benchmark.harness import cell as cell_mod

WORKLOAD = 'next_week_final.offline_800x800_w10'
ROOT = os.path.dirname(cell_mod.BENCH_DIR)


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    return torch.device('cuda')


def run(trace):
    out = subprocess.run(
        [sys.executable, 'benchmark/run.py', '--workload', WORKLOAD,
         '--seed', str(2 ** 31 + 65432), '--seconds', '3', '--trace', str(trace)],
        cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.cuda
def test_a_short_run_is_correct(card):
    result = run(0)
    assert result['correct'], result['checks']
    assert set(result['metrics']) == {'setup_s', 'mrays_per_s'}


@pytest.mark.cuda
def test_a_traced_run_reads_its_layers(card):
    result = run(1)
    assert result['correct'], result['checks']
    metrics = result['metrics']
    for name in ('shape_trace_ms', 'hit_attributes_ms', 'medium_ms',
                 'scatter_ms_per_round', 'trace_ms_per_round',
                 'kernels_per_round'):
        assert metrics[name]['value'] > 0, name
    for name in ('shape_trace_roofline', 'hit_attributes_roofline',
                 'medium_roofline'):
        assert 0 < metrics[name]['value'] <= 100, name


def same_bits(a, b):
    """Equal to the bit: float32 compared as int32 words."""
    import torch
    if a.dtype == torch.float32:
        return torch.equal(a.view(torch.int32), b.view(torch.int32))
    return torch.equal(a, b)


@pytest.mark.cuda
def test_medium_event_kernel_matches_plain_version_on_volume_lanes(card, monkeypatch):
    """csrc/medium_event.cu, as `scatter` launches it in a round of this
    scene with a quarter of the lanes started inside the medium sphere,
    against medium_event_plain on the same inputs, bit for bit in every
    output and the random state it leaves, with tracing off and on; the
    round has volume scattering events."""
    import torch

    sys.path.insert(0, os.path.join(ROOT, 'tests'))
    from test_torch_next_week import lanes_of_interest, program_api

    from path_tracer_tpu_torch.core.sampling import Rng
    from path_tracer_tpu_torch.integrator import scatter, wavefront
    from path_tracer_tpu_torch.ops import medium_event
    from path_tracer_tpu_torch.ops.intersect import SceneLayout
    from path_tracer_tpu_torch.scene.compile import compile_scene
    from path_tracer_tpu_torch.utils import profiling

    cell = cell_mod.load_cell(WORKLOAD)
    scene = cell.maker.make_scene(program_api(), cell.config)
    packed = compile_scene(scene, aspect_ratio=1.0, device=card)
    layout = SceneLayout.from_packed(packed)
    config = wavefront.RenderConfig(width=256, height=256,
                                    camera_model=packed.host_camera_models[0])
    captured = []
    launch = medium_event.medium_event

    def capture(packed, types, lanes, stats=None):
        inputs = {k: v.clone() for k, v in lanes.items()}
        out = launch(packed, types, lanes, stats=stats)
        captured.append((types, inputs, dict(out)))
        return out

    monkeypatch.setattr(medium_event, 'medium_event', capture)
    for traced in (False, True):
        state = wavefront.reset(packed, config, seed=11 + traced)
        lanes_of_interest(scene, state, seed=5 + traced)
        profiling.reset()
        with profiling.tracing() if traced else contextlib.nullcontext():
            wavefront.render_round(packed, layout, config, state, 0.05)
            counted = profiling.counters()
        assert counted['kernel.medium_event'] == 1
        types, lanes, got = captured.pop()
        rng = Rng(lanes['rng_state'].clone())
        want = scatter.medium_event_plain(
            packed, types, lanes['active_shapes'], lanes['lam'],
            lanes['throughput'], lanes['probability'],
            {k: lanes[k] for k in ('time', 'shape', 'normal')},
            lanes['origin'], lanes['direction'], rng)
        want['rng_state'] = rng.state
        assert set(got) == set(want)
        for key in want:
            assert same_bits(got[key], want[key]), (
                key, traced, int((got[key] != want[key]).sum()))
        volume = int(want['vol_scatter'].sum())
        assert volume > 256 * 256 // 8, volume
        if traced:
            assert counted[scatter.MEDIUM_LANES]['volume'] == volume
