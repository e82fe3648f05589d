"""The benchmark's arithmetic: the union of device intervals, rays
traced, the spread of a set of runs."""

from __future__ import annotations


def union_length(intervals):
    """Total length covered by (start, end) intervals, overlaps counted
    once."""
    total, reach = 0.0, None
    for start, end in sorted(intervals):
        if reach is None or start > reach:
            total += end - start
            reach = end
        elif end > reach:
            total += end - reach
            reach = end
    return total


def gaps(intervals):
    """(start, end) of the idle gaps between the union of `intervals`."""
    out, reach = [], None
    for start, end in sorted(intervals):
        if reach is not None and start > reach:
            out.append((reach, start))
        reach = end if reach is None else max(reach, end)
    return out


def mrays_per_s(lanes, rounds, seconds):
    """Every round traces one ray a lane (a terminated path respawns in
    place), so rays = lanes x rounds."""
    return lanes * rounds / seconds / 1e6


def spread(values):
    """Distance between the first and third quartile (Python's
    statistics.quantiles, n=4) as a share of the median."""
    import statistics
    q1, median, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / median
