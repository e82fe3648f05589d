"""The reference's trace: analytic shapes as the program's plain path
tests them, then every ray against every face of every mesh instance
(Moller-Trumbore in the instance's object space), the nearest hit
winning, and the hit attributes resolved from the faces' vertices."""

from __future__ import annotations

import torch

from .plain.core.constants import HIT_TIME_LIMIT, SHAPE_TYPE_MESH_INSTANCE
from .plain.core.vec import take_matrix, transform_point, transform_vector
from .plain.ops.intersect import (
    intersect_analytic,
    make_hit,
    moller_trumbore,
    resolve_hit_attributes,
)

# Rays x faces tested in one step; about 20 float temporaries of this
# many elements are alive at once.
BLOCK_ELEMENTS = 1 << 22


def trace(packed, layout, instances, origin, direction, dtype=torch.float32):
    """Hit records of the (3, N) rays. `instances`: (shape index, (first
    face, end face)) of each mesh instance. `dtype` is the precision of
    the triangle tests (bfloat16 for the control)."""
    n = origin.shape[1]
    dev = origin.device
    hit = make_hit(n, HIT_TIME_LIMIT, dev)
    hit = intersect_analytic(packed, layout, origin, direction, hit)
    # Fresh tensors of this call, updated in place block by block.
    time, shape, shape_type, primitive, coords = (
        hit[k] for k in ('time', 'shape', 'shape_type', 'primitive', 'coords'))
    for shape_index, (f0, f1) in instances:
        idx = torch.full((1,), int(shape_index), dtype=torch.long, device=dev)
        m = [[c[0] for c in row]
             for row in take_matrix(packed.shape_object_from_world, idx)]
        o = transform_point(m, origin).to(dtype)
        d = transform_vector(m, direction).to(dtype)
        tri = packed.face_positions[:, :, f0:f1].to(dtype)     # (3, 3, F)
        p0, p1, p2 = (tri[k][:, None, :] for k in range(3))
        step = max(1, BLOCK_ELEMENTS // max(f1 - f0, 1))
        for r0 in range(0, n, step):
            r1 = min(n, r0 + step)
            t_max = time[r0:r1, None].to(dtype)
            t, u, v, valid = moller_trumbore(
                o[:, r0:r1, None], d[:, r0:r1, None], p0, p1, p2, t_max)
            t = torch.where(valid, t, torch.full_like(t, float('inf')))
            best, face = torch.min(t, dim=1)
            rows = torch.arange(r1 - r0, device=dev)
            take = best.float() < time[r0:r1]
            bu = u[rows, face].float()
            bv = v[rows, face].float()
            time[r0:r1] = torch.where(take, best.float(), time[r0:r1])
            shape[r0:r1] = torch.where(take, torch.full_like(shape[r0:r1], int(shape_index)),
                                       shape[r0:r1])
            shape_type[r0:r1] = torch.where(
                take, torch.full_like(shape_type[r0:r1], SHAPE_TYPE_MESH_INSTANCE),
                shape_type[r0:r1])
            primitive[r0:r1] = torch.where(take, (face + f0).to(primitive.dtype),
                                           primitive[r0:r1])
            coords[:, r0:r1] = torch.where(
                take, torch.stack([1.0 - bu - bv, bu, bv], 0), coords[:, r0:r1])
    hit = dict(time=time, shape=shape, shape_type=shape_type,
               primitive=primitive, coords=coords,
               complexity=hit['complexity'])
    return resolve_hit_attributes(packed, layout, origin, direction, hit)
