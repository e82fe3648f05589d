"""The analytic-shape kernel's share of its roofline, in %: the least
time of one pass of the cell's rays over its shapes (compulsory bytes
over the card's memory rate) over the kernel's device time a round.

The bytes are counted from the cell's inputs, not from the program's
tables, so that the least time stays the same whatever implements the
kernel: per ray 7 float32 read (origin, direction, t_in) and 6 words
written (t, shape, shape type, the 3 hit coordinates); per shape its
48-byte transform, read once, the count from the cell's configuration.
"""

from benchmark.harness import roofline
from benchmark.harness.cell import load_cell

KERNEL = 'shape_trace_kernel'
RAY_BYTES = 7 * 4 + 6 * 4
SHAPE_BYTES = 48


def shape_trace_bytes(rays, shapes):
    return rays * RAY_BYTES + shapes * SHAPE_BYTES


def read(data):
    ms = data.kernel_ms(KERNEL)
    if data.generator != 'offline' or not ms or not data.rounds:
        return None
    peak = roofline.PEAKS.get(data.device_kind)
    shapes = load_cell(data.cell).config.get('spheres')
    if peak is None or not shapes:
        return None
    least = shape_trace_bytes(data.lanes, shapes) / peak['hbm_bytes_per_s']
    return 100.0 * least / (ms / data.rounds / 1e3)
