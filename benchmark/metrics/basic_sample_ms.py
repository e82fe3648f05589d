"""Device ms a round of the basic models' BSDF-sample kernel, found by
name."""

KERNEL = 'basic_sample_kernel'


def read(data):
    ms = data.kernel_ms(KERNEL)
    if data.generator != 'offline' or not ms or not data.rounds:
        return None
    return ms / data.rounds
