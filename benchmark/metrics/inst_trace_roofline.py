"""The traversal kernel's share of its roofline, in %: the least time of
one traversal of the cell's rays (compulsory bytes of the cell's rays,
triangles and instances over the card's memory rate; harness/roofline.py)
over the kernel's device time a round."""

from benchmark.harness import roofline

KERNEL = 'inst_trace_kernel'


def read(data):
    ms = data.kernel_ms(KERNEL)
    if data.generator != 'offline' or not ms or not data.rounds:
        return None
    least = roofline.least_seconds(data.device_kind, data.lanes,
                                   data.triangles, data.mesh_instances)
    if least is None:
        return None
    return 100.0 * least / (ms / data.rounds / 1e3)
