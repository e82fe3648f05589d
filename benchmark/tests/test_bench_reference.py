"""The plain reference against the program at a tiny size on the CPU,
and the bfloat16 control failing the same comparison."""

import numpy as np
import pytest

from benchmark.harness import runner
from benchmark.harness.cell import load_cell

TINY = {
    'cornell_box.offline_1440x1440': dict(width=40, height=40),
    'cornell_box.offline_2880x2880': dict(width=48, height=48),
}


def tiny_cell(workload):
    cell = load_cell(workload)
    cell.traffic.update(TINY[workload], chunk_rounds=2, warmup_rounds=3,
                        trace_rounds=2)
    return cell


@pytest.mark.parametrize('workload', sorted(TINY))
def test_program_agrees_and_the_control_does_not(workload):
    cell = tiny_cell(workload)
    values, _ = runner.run(cell, 2 ** 32 + 11, 0.3, False, device='cpu',
                           control=True)
    program, control = values['program'], values['control']
    assert set(program) == set(cell.limits)
    for name, limit in cell.limits.items():
        assert program[name] <= limit, (name, program[name])
    # Both are judged by the harness's own rule (check.judge).
    assert values['program_correct'], program
    assert not values['control_correct'], control
    # Each number the control fails, it fails by a wide margin.
    assert control['round_lanes_off'] > 0.5
