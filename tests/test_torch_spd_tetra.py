"""The benchmark's spd_tetra configuration (SPD's Sierpinski tetrahedron)
on the CPU, cut to depths 2 and 3 (64 and 256 triangles): the port
against the plain reference through the cell's comparison (the reset
state, one round's hits and the image at their pixels), with the
bfloat16 control failing it; the mesh traversal's counters and the
compile's `compile.bvh` spans while tracing."""

import copy
import types

import pytest
import torch

from benchmark.harness import cell as cell_mod
from benchmark.harness import runner
from path_tracer_tpu_torch.core import constants
from path_tracer_tpu_torch.core.constants import SHAPE_INDEX_NONE
from path_tracer_tpu_torch.integrator import wavefront
from path_tracer_tpu_torch.ops import trace_inst
from path_tracer_tpu_torch.ops.intersect import KERNEL_COUNTERS, SceneLayout, trace
from path_tracer_tpu_torch.scene import model
from path_tracer_tpu_torch.scene.compile import compile_scene
from path_tracer_tpu_torch.utils import profiling

WORKLOAD = 'spd_tetra.offline_1440x1440_w4'


def cut_cell(depth):
    """The cell with its configuration cut to `depth` and a 32x32 film."""
    cell = cell_mod.load_cell(WORKLOAD)
    cell.config = copy.deepcopy(cell.config)
    cell.config.update(depth=depth, tetrahedra=4 ** depth,
                       triangles=4 ** (depth + 1))
    cell.traffic = dict(cell.traffic, width=32, height=32, waves=1,
                        chunk_rounds=2, warmup_rounds=3, trace_rounds=2)
    return cell


def program_scene(cell):
    api = types.SimpleNamespace(**{k: v for m in (constants, model)
                                   for k, v in vars(m).items()
                                   if not k.startswith('_')})
    return cell.maker.make_scene(api, cell.config)


@pytest.mark.parametrize('depth', [2, 3])
def test_program_agrees_and_the_control_does_not(depth):
    cell = cut_cell(depth)
    values, _ = runner.run(cell, 2 ** 32 + 20 + depth, 0.2, False,
                           device='cpu', control=True)
    program, control = values['program'], values['control']
    assert set(program) == set(cell.limits)
    assert values['program_correct'], program
    assert not values['control_correct'], control


def test_traversal_counters_and_compile_spans():
    """With tracing on: compile_scene opens a `compile.bvh` span under
    `compile.pack` for each table set built (the portable BVH2, the
    'inst' BLAS); a trace adds the traversal's counters, equal to the sums
    of an inst_trace(stats=True) call on the same rays, and at least one
    triangle test a mesh hit. With tracing off a trace counts nothing."""
    cell = cut_cell(3)
    scene = program_scene(cell)
    with profiling.tracing():
        packed = compile_scene(scene, aspect_ratio=1.0, device='cpu')
        records = profiling.records()
    spans = [r for r in records if r[0] == 'compile.bvh']
    assert len(spans) == 2
    assert all(records[r[1]][0] == 'compile.pack' for r in spans)

    layout = SceneLayout.from_packed(packed)
    assert layout.packet_mode == 'inst' and layout.instance_slots == 1
    config = wavefront.RenderConfig(width=32, height=32,
                                    camera_model=packed.host_camera_models[0])
    state = wavefront.reset(packed, config, seed=2 ** 31 + 5)
    wavefront.render(packed, config, 2, state=state, layout=layout,
                     termination_probability=0.05)
    origin, direction = state['origin'], state['direction']
    with profiling.tracing():
        hit = trace(packed, layout, origin, direction)
        counted = profiling.counters()
    *_, per_ray = trace_inst.inst_trace(
        packed.inst_nodes, packed.inst_tris, packed.inst_rows, origin,
        direction, torch.full_like(hit['time'], constants.HIT_TIME_LIMIT),
        tlas_rows=layout.tlas_rows, stats=True)
    assert {name: counted[name] for name in KERNEL_COUNTERS} == {
        name: int(per_ray[row].sum()) for name, row in KERNEL_COUNTERS.items()}
    rows, tests, instances = (counted[name] for name in KERNEL_COUNTERS)
    hits = int((hit['shape'] != SHAPE_INDEX_NONE).sum())
    n = origin.shape[1]
    assert 0 < hits < n
    assert tests >= hits
    assert hits <= instances <= n
    assert rows >= n

    profiling.reset()
    trace(packed, layout, origin, direction)
    assert not any(name in profiling.counters() for name in KERNEL_COUNTERS)
