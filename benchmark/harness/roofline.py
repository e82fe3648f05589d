"""Peaks of the cards and the compulsory bytes of the traversal kernel.

The bytes are counted from the cell's inputs, not from the program's
tables, so that the least time stays the same whatever implements the
kernel: per ray 7 float32 read (origin, direction, t_in) and 5 words
written (t, face, u, v, instance); per triangle its 3 vertices of 12
bytes, read once; per mesh instance a 48-byte transform.
"""

from __future__ import annotations

# Published rates of the SXM part at its 700 W limit (NVIDIA's data
# sheet): HBM3 bandwidth in bytes/s.
PEAKS = {
    'NVIDIA H100 80GB HBM3': dict(hbm_bytes_per_s=3.35e12),
}

RAY_BYTES = 7 * 4 + 5 * 4
TRIANGLE_BYTES = 3 * 12
INSTANCE_BYTES = 48


def trace_bytes(rays, triangles, instances):
    return rays * RAY_BYTES + triangles * TRIANGLE_BYTES + instances * INSTANCE_BYTES


def least_seconds(kind, rays, triangles, instances):
    """The least time one traversal of `rays` could take on a card of
    `kind`, bound by its memory; None for a card not in the table."""
    peak = PEAKS.get(kind)
    if peak is None:
        return None
    return trace_bytes(rays, triangles, instances) / peak['hbm_bytes_per_s']
