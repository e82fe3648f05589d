"""Device ms a round of the medium-event kernel, found by name."""

KERNEL = 'medium_event_kernel'


def read(data):
    ms = data.kernel_ms(KERNEL)
    if data.generator != 'offline' or not ms or not data.rounds:
        return None
    return ms / data.rounds
