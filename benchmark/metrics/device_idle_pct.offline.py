"""Share of a round's wall time in which no device operation ran, in %:
1 - (union of the device-op intervals of the profiled rounds / rounds) /
(seconds a round in the same run's measured window). The profiler slows
the host's launches, so the wall time is taken where it did not run."""


def read(data):
    if data.generator != 'offline':
        return None
    return data.idle_pct(data.rounds)
