"""Device ms a round of the kernels launched inside the `trace` call
(ops.intersect: analytic shapes, the traversal kernel, hit attributes)."""


def read(data):
    ms = data.span_device_ms.get('bench.trace')
    if data.generator != 'offline' or not ms or not data.rounds:
        return None
    return ms / data.rounds
