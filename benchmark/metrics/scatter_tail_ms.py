"""Device ms a round of the scatter-tail kernel, found by name."""

KERNEL = 'scatter_tail_kernel'


def read(data):
    ms = data.kernel_ms(KERNEL)
    if data.generator != 'offline' or not ms or not data.rounds:
        return None
    return ms / data.rounds
