"""Closest hit among the analytic shapes on the card: csrc/shape_trace.cu.

`shape_trace` traces world rays against the analytic shapes' tables that
scene/compile.py's `pack_shape_tables` builds:

  plane_rows   (P, 16) f32   the valid plane slots, tested in order
  shape_rows   (B, 16) f32   the valid sphere and cube slots
  shape_nodes  (W, 128) f32  BVH8 rows over the shape rows' padded world
                             boxes, leaf metas INST_BASE + shape row

(a shape row: object_from_world 3x4 row-major, type, shape index, tie
rank). It merges the closest hit into a hit record and returns the new
record, as ops/intersect.py::intersect_analytic does, bit for bit in
`time`, `shape`, `shape_type`, `primitive` and `coords`; `complexity`
grows by the BVH nodes and shapes each ray visited. It runs on CUDA
tensors only: intersect_analytic routes the card's traces here, and on
the CPU keeps its dense path; ops/intersect.py::traverse_shape_bvh is
the same walk in plain PyTorch.
"""

from __future__ import annotations

import torch

from ..utils import profiling
from .trace_inst import check_tensor


def shape_trace(plane_rows, shape_rows, shape_nodes, origin, direction, hit,
                stats=None):
    """Merge the closest analytic hit of each ray into `hit` (a record of
    ops/intersect.py::make_hit's fields; hit['time'] is each ray's
    reach). origin/direction: (3, N) float32 on one card. `stats`, when
    given, is a (2,) int64 tensor to which the kernel adds the nodes and
    the shapes tested, summed over rays. Counted as `kernel.shape_trace`."""
    dev = origin.device
    if dev.type != 'cuda':
        raise ValueError(f'shape_trace runs on a CUDA device, not {dev}')
    n = origin.shape[-1]
    check_tensor('plane_rows', plane_rows, dev, (None, 16))
    check_tensor('shape_rows', shape_rows, dev, (None, 16))
    check_tensor('shape_nodes', shape_nodes, dev, (None, 128))
    check_tensor('origin', origin, dev, (3, n))
    check_tensor('direction', direction, dev, (3, n))
    ins = {k: hit[k].contiguous() for k in
           ('time', 'shape', 'shape_type', 'primitive', 'coords', 'complexity')}
    check_tensor('time', ins['time'], dev, (n,))
    for name in ('shape', 'shape_type', 'primitive', 'complexity'):
        check_tensor(name, ins[name], dev, (n,), torch.int32)
    check_tensor('coords', ins['coords'], dev, (3, n))
    if stats is None:
        stats = torch.empty((0,), dtype=torch.int64, device=dev)
    else:
        check_tensor('stats', stats, dev, (2,), torch.int64)
    out = {k: torch.empty_like(v) for k, v in ins.items()}
    from .build import load
    err = load().shape_trace(
        shape_nodes, shape_rows, plane_rows, origin, direction, ins['time'],
        ins['shape'], ins['shape_type'], ins['primitive'], ins['coords'],
        ins['complexity'], out['time'], out['shape'], out['shape_type'],
        out['primitive'], out['coords'], out['complexity'], stats,
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f'shape_trace kernel launch failed: cudaError {err}')
    profiling.count('kernel.shape_trace')
    return out
