"""Device kernels the profiler recorded a round, in a cell whose rounds
the host's launches bind."""


def read(data):
    if data.generator != 'offline' or not data.kernels or not data.rounds:
        return None
    return len(data.kernels) / data.rounds
