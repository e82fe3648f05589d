"""World-flattened BVH8 traversal with attributes in the leaf rows (v3):
CUDA kernel and plain version.

Port of path_tracer_tpu/ops/trace_wide.py. `wide_trace` traces world
rays against the attribute-carrying flat tables of scene/compile.py:

  wide_nodes (W, 128) f32  the node rows of ops/trace_packet.py
  wide_tris  (R, 128) f32  leaf rows of 4 triangles at a 32-lane stride:
                           p0 p1 p2 (9), n0 n1 n2 (9), uv0 uv1 uv2 (6),
                           shape index (1) -- scene/bvh8.py

The triangle test is Moller-Trumbore on edges formed in the kernel
(e1 = p1 - p0), and the winner's normal and uv are lerped in the kernel
from the same row, so no side table is gathered afterwards. Returns
(t, face, normal (3, N) unnormalized, uv (2, N), shape (N,) int32) with
face = (tri_row + r) * 4 + k; on a miss face is -1 and normal, uv and
shape are 0 (shape is NOT -1: callers mask by face >= 0).

On a CUDA tensor `wide_trace` launches the hand-written kernel
csrc/trace_wide.cu; on a CPU tensor it runs `wide_trace_plain`. There is
no fallback from one to the other. Push order, the pop cull and the
per-ray counters are those of ops/trace_packet.py: kernel and plain
version cull alike.
"""

from __future__ import annotations

import torch

from ..scene import bvh8
from ..utils import profiling
from .trace_inst import anatomy_record, stats_buffers
from .trace_packet import STACK_DEPTH, check_rays, traverse_plain

LEAF_ROWS = bvh8.LEAF_MAX // bvh8.TRIS_PER_ROW

def wide_trace_plain(wide_nodes, wide_tris, origin, direction, t_in,
                     stats=False, cull=True, stack_depth=STACK_DEPTH):
    """The kernel's traversal in plain PyTorch (`traverse_plain` with the
    4-triangle attribute rows), with the kernel's arithmetic in the
    kernel's order: the leaf's slots one after another, a slot taken only
    where its ft is below the t the slots before it left. Arguments and
    results as `wide_trace`; `cull` and `stack_depth` as
    `trace_packet.traverse_plain`."""
    dev = origin.device
    n = origin.shape[1]
    t = t_in.clone()
    face = torch.full((n,), -1, dtype=torch.int32, device=dev)
    normal = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    uv = torch.zeros((n, 2), dtype=torch.float32, device=dev)
    shape = torch.zeros(n, dtype=torch.int32, device=dev)
    per_row = bvh8.TRIS_PER_ROW

    def leaf(ridx, row_id, count, rr, o, d):
        g = wide_tris[row_id].reshape(-1, per_row, bvh8.TRI_STRIDE)
        ox, oy, oz = o[:, 0], o[:, 1], o[:, 2]
        dx, dy, dz = d[:, 0], d[:, 1], d[:, 2]
        p0x, p0y, p0z = g[..., 0], g[..., 1], g[..., 2]
        e1x, e1y, e1z = g[..., 3] - p0x, g[..., 4] - p0y, g[..., 5] - p0z
        e2x, e2y, e2z = g[..., 6] - p0x, g[..., 7] - p0y, g[..., 8] - p0z
        pvx = dy * e2z - dz * e2y
        pvy = dz * e2x - dx * e2z
        pvz = dx * e2y - dy * e2x
        det = e1x * pvx + e1y * pvy + e1z * pvz
        ok = torch.abs(det) >= 1e-9
        inv_det = 1.0 / torch.where(ok, det, torch.ones_like(det))
        sx, sy, sz = ox - p0x, oy - p0y, oz - p0z
        hu = inv_det * (sx * pvx + sy * pvy + sz * pvz)
        qx = sy * e1z - sz * e1y
        qy = sz * e1x - sx * e1z
        qz = sx * e1y - sy * e1x
        hv = inv_det * (dx * qx + dy * qy + dz * qz)
        ft = inv_det * (e2x * qx + e2y * qy + e2z * qz)
        slot = torch.arange(per_row, device=dev)
        geo_ok = (ok & (hu >= 0.0) & (hu <= 1.0) & (hv >= 0.0)
                  & (hu + hv <= 1.0) & (ft >= 0.0)
                  & (count[:, None] > per_row * rr + slot))
        hw = (1.0 - hu - hv)[..., None]
        hu3, hv3 = hu[..., None], hv[..., None]
        nrm = hw * g[..., 9:12] + hu3 * g[..., 12:15] + hv3 * g[..., 15:18]
        tuv = hw * g[..., 18:20] + hu3 * g[..., 20:22] + hv3 * g[..., 22:24]
        shp = g[..., 24].round().to(torch.int32)

        tb, fb = t[ridx], face[ridx]
        nb, ub, sb = normal[ridx], uv[ridx], shape[ridx]
        base = (row_id * per_row).to(torch.int32)
        for k in range(per_row):
            win = geo_ok[:, k] & (ft[:, k] < tb)
            tb = torch.where(win, ft[:, k], tb)
            fb = torch.where(win, base + k, fb)
            nb = torch.where(win[:, None], nrm[:, k], nb)
            ub = torch.where(win[:, None], tuv[:, k], ub)
            sb = torch.where(win, shp[:, k], sb)
        t[ridx], face[ridx] = tb, fb
        normal[ridx], uv[ridx], shape[ridx] = nb, ub, sb

    counts = traverse_plain(wide_nodes, origin, direction, t, leaf, LEAF_ROWS,
                            per_row, cull, stack_depth)
    out = (t, face, normal.T.contiguous(), uv.T.contiguous(), shape)
    return out + (counts,) if stats else out


def _wide_trace_cuda(wide_nodes, wide_tris, origin, direction, t_in, stats,
                     anatomy):
    dev, n = check_rays(wide_nodes, wide_tris, origin, direction, t_in)
    t = torch.empty(n, dtype=torch.float32, device=dev)
    face = torch.empty(n, dtype=torch.int32, device=dev)
    normal = torch.empty((3, n), dtype=torch.float32, device=dev)
    uv = torch.empty((2, n), dtype=torch.float32, device=dev)
    shape = torch.empty(n, dtype=torch.int32, device=dev)
    per_ray, warps = stats_buffers(stats or anatomy, 6, n, dev)
    from .build import load
    err = load().wide_trace(wide_nodes, wide_tris, origin, direction, t_in, t,
                            face, normal, uv, shape, per_ray, warps,
                            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f'wide_trace kernel launch failed: cudaError {err}')
    profiling.count('kernel.wide_trace')
    out = (t, face, normal, uv, shape)
    if stats:
        out += (per_ray[:4],)
    if anatomy:
        out += (anatomy_record(per_ray, warps, 4),)
    return out


def wide_trace(wide_nodes, wide_tris, origin, direction, t_in, stats=False,
               anatomy=False):
    """Trace world rays (origin/direction (3, N), t_in (N,) reach)
    against the flattened world-space BVH8 with in-row attributes.

    Returns (t, face, normal, uv, shape) as the module docstring says.
    With `stats` also a (4, N) int32 tensor of per-ray interior pops,
    leaf pops, leaf rows tested and triangles in those rows; these are
    each ray's own counts, not the JAX kernel's per-grid-step packet
    counts.
    CUDA tensors launch the CUDA kernel csrc/trace_wide.cu (counted in
    utils/profiling.py as `kernel.wide_trace`). `anatomy` appends the
    dict of `trace_inst.anatomy_record`. CPU tensors run
    `wide_trace_plain` with the pop cull.
    """
    if origin.device.type == 'cuda':
        return _wide_trace_cuda(wide_nodes, wide_tris, origin, direction,
                                t_in, stats, anatomy)
    if origin.device.type == 'cpu':
        if anatomy:
            raise ValueError('only the CUDA kernels measure their anatomy')
        return wide_trace_plain(wide_nodes, wide_tris, origin, direction,
                                t_in, stats)
    raise ValueError(f'wide_trace: unsupported device {origin.device}')
