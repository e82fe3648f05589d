"""Device kernels the profiler recorded, a round."""


def read(data):
    if data.generator != 'offline' or not data.kernels or not data.rounds:
        return None
    return len(data.kernels) / data.rounds
