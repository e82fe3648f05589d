"""Share of a round's wall time in which no device operation ran, in %,
in a cell whose rounds the host's launches bind: 1 - (union of the
device-op intervals of the profiled rounds / rounds) / (seconds a round
in the same run's measured window)."""


def read(data):
    if data.generator != 'offline':
        return None
    return data.idle_pct(data.rounds)
