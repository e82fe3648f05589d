"""Device ms a round of the kernels launched inside the `scatter` call
(integrator.scatter and the material models)."""


def read(data):
    ms = data.span_device_ms.get('bench.scatter')
    if data.generator != 'offline' or not ms or not data.rounds:
        return None
    return ms / data.rounds
