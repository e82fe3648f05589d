# Frozen copy of path_tracer_tpu_torch/core/vec.py, part of the benchmark's
# plain reference: not kept in step with the program.
"""Channels-first vector/spectrum math on torch tensors.

Port of path_tracer_tpu/core/vec.py. The layout is kept: per-lane
quantities put the lane axis LAST --

    scalars:   (N,)
    vectors:   (3, N)
    spectra:   (4, N)   (hero-wavelength clusters)

so the port's public functions take and return the same shapes as the
JAX package's, and tests compare like with like. On the GPU the
channels-first rows are also what keeps each elementwise kernel
coalesced: one (N,) row per component.
"""

from __future__ import annotations

import torch


def vec3(x, y, z):
    """Stack components into a (3, N) vector (scalars broadcast)."""
    ref = next(a for a in (x, y, z) if torch.is_tensor(a))
    parts = [a if torch.is_tensor(a) else torch.full_like(ref, float(a))
             for a in (x, y, z)]
    return torch.stack(torch.broadcast_tensors(*parts), dim=0)


def dot(a, b):
    """(3, N) x (3, N) -> (N,)."""
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def cross(a, b):
    return torch.stack([
        a[1] * b[2] - a[2] * b[1],
        a[2] * b[0] - a[0] * b[2],
        a[0] * b[1] - a[1] * b[0],
    ], dim=0)


def length(a):
    return torch.sqrt(dot(a, a))


def normalize(a):
    return a * (1.0 / length(a))


def safe_normalize(a):
    """Normalize, returning +Z for degenerate vectors (common.glsl.inc:93-100)."""
    lsq = dot(a, a)
    bad = lsq < 1e-12
    inv = 1.0 / torch.sqrt(torch.where(bad, torch.ones_like(lsq), lsq))
    unit_z = torch.zeros_like(a)
    unit_z[2] = 1.0
    return torch.where(bad, unit_z, a * inv)


def max4(s):
    """(4, N) -> (N,) max over the spectral axis."""
    return torch.amax(s, dim=0)


def sum4(s):
    return torch.sum(s, dim=0)


def transform_point(m, p):
    """Apply a matrix (m[i][j]: scalars or (N,) rows) to (3, N) points."""
    return torch.stack([
        m[i][0] * p[0] + m[i][1] * p[1] + m[i][2] * p[2] + m[i][3]
        for i in range(3)
    ], dim=0)


def transform_vector(m, v):
    """Apply the rotation/scale part of m (m[i][j]: scalars or (N,)
    rows) to (3, N) vectors."""
    return torch.stack([
        m[i][0] * v[0] + m[i][1] * v[1] + m[i][2] * v[2]
        for i in range(3)
    ], dim=0)


def transform_normal(n, m_inverse):
    """normalize(N^T * M_inv): rows index the *columns* of the inverse
    (common.glsl.inc:50-53)."""
    return safe_normalize(torch.stack([
        m_inverse[0][i] * n[0] + m_inverse[1][i] * n[1] + m_inverse[2][i] * n[2]
        for i in range(3)
    ], dim=0))


def take_matrix(table, idx):
    """Gather lanes from a (4, 4, S) matrix table -> nested [i][j] lists
    of (N,) components (consumed by the transform_* helpers)."""
    rows = table[:, :, idx]
    return [[rows[i, j] for j in range(4)] for i in range(4)]
