"""World-flattened BVH8 traversal with geometry-only leaves (v5): CUDA
kernel, plain version, attribute resolve.

Port of path_tracer_tpu/ops/trace_packet.py. `wide_trace5` traces world
rays against the tables that scene/compile.py builds in 'flat' mode:

  nodes   (W, 128) f32  one world-space BVH8 over every mesh instance's
                        triangles (row layout in scene/bvh8.py: child
                        boxes in lanes 0..47, metas 48..55, the axis the
                        children are sorted along in lane 64)
  tris_g  (R, 128) f32  leaf rows of 8 triangles at a 16-lane stride in
                        the bvh8.LEAF_FMT format ('bary', 'mt' or 'woop')

and returns (t, face, fu, fv), face = (leaf_row + r) * 8 + k, or -1
where nothing closer than t_in was hit. `resolve_wide_attributes` lerps
normals and uvs of the winners from the (slots, 16) side table. On a
CUDA tensor `wide_trace5` launches the hand-written kernel
csrc/trace_packet.cu; on a CPU tensor it runs `wide_trace5_plain`, the
same per-ray traversal written in PyTorch. There is no fallback from one
to the other.

A stack entry carries the distance at which the ray enters the node's
box, and a pop whose entry lies beyond the ray's t by more than the slab
test's rounding (trace_inst.CULL_SLACK) is dropped without fetching its
row (the pop cull). Kernel and plain version cull
alike (so do `wide_trace` and its plain version); the plain version with
cull=False is the cull-free reference the tests hold the cull to.

Where the JAX kernel flips a node's push order by the sign of a 1024-ray
packet's summed direction along the node's axis, kernel and plain
version here use each ray's own direction: children are sorted
ascending along the axis, so a ray flying forward pushes them last to
first and pops the near child first. The closest hit is the same; a ray
on an edge shared by two triangles may report either.
"""

from __future__ import annotations

import torch

from ..scene import bvh8
from ..utils import profiling
from .trace_inst import (
    CULL_SLACK, LEAF_FMTS, anatomy_record, check_tensor, leaf_tests,
    safe_inv, stats_buffers)

STACK_DEPTH = 96
PASS_LIMIT = 0.5 * bvh8.BIG
LEAF_ROWS = bvh8.LEAF_MAX // 8

def traverse_plain(nodes, origin, direction, t, leaf, leaf_rows,
                   tris_per_row, cull, stack_depth=STACK_DEPTH):
    """The stack walk both flat kernels share, vectorized over rays.

    Every ray owns a stack of `stack_depth` (node, entry distance) pairs
    that starts at the root; each loop iteration pops one entry from
    every ray whose stack is not empty, and drops it when `cull` and its
    entry distance is not before the ray's current `t` * CULL_SLACK. An
    interior pop slab-tests the eight child boxes against `t` and pushes
    the entered, non-empty children in the order the ray's direction along
    the node's axis gives; pushes past the depth are dropped. A leaf pop
    calls `leaf(ridx, row_id, count, rr, o, d)` once for each of its
    rows (later rows only where count > tris_per_row * rr) with the rays
    `ridx` that test table row `row_id`; `leaf` updates `t` and its own
    outputs in place. Returns the (4, N) int32 per-ray counts of
    interior pops, leaf pops, leaf rows and the triangles those rows hold
    (of the pops not dropped).
    """
    dev = origin.device
    n = origin.shape[1]
    o = origin.T.contiguous()
    d = direction.T.contiguous()
    inv = safe_inv(d)
    p = o * inv
    counts = torch.zeros((4, n), dtype=torch.int32, device=dev)
    stack = torch.zeros((n, stack_depth), dtype=torch.int64, device=dev)
    entered = torch.zeros((n, stack_depth), dtype=torch.float32, device=dev)
    sp = torch.ones(n, dtype=torch.int64, device=dev)

    while True:
        act = torch.nonzero(sp > 0).squeeze(1)
        if act.numel() == 0:
            break
        sp[act] -= 1
        v = stack[act, sp[act]]
        if cull:
            keep = entered[act, sp[act]] < t[act] * CULL_SLACK
            act, v = act[keep], v[keep]

        sel = v >= 0
        if bool(sel.any()):
            idx = act[sel]
            counts[0, idx] += 1
            row = nodes[v[sel]]
            r_inv = inv[idx][:, :, None]
            r_p = p[idx][:, :, None]
            lo = row[:, 0:24].reshape(-1, 3, 8) * r_inv - r_p
            hi = row[:, 24:48].reshape(-1, 3, 8) * r_inv - r_p
            t_lo, t_hi = torch.minimum(lo, hi), torch.maximum(lo, hi)
            entry = torch.maximum(torch.maximum(t_lo[:, 0], t_lo[:, 1]), t_lo[:, 2])
            exit_ = torch.minimum(torch.minimum(t_hi[:, 0], t_hi[:, 1]), t_hi[:, 2])
            hit = ((exit_ >= entry) & (exit_ > 0.0) & (entry < t[idx][:, None])
                   & (entry < PASS_LIMIT))
            metas = row[:, bvh8.META_LANE:bvh8.META_LANE + 8].round().to(torch.int64)
            axis = row[:, bvh8.AXIS_LANE].round().to(torch.int64)
            r_d = d[idx]
            flip = torch.where(axis == 0, r_d[:, 0], torch.where(
                axis == 1, r_d[:, 1], r_d[:, 2])) >= 0
            for i in range(8):
                ch = torch.where(flip, torch.full_like(axis, 7 - i),
                                 torch.full_like(axis, i))[:, None]
                m = metas.gather(1, ch)[:, 0]
                ok = hit.gather(1, ch)[:, 0] & (m != 0) & (sp[idx] < stack_depth)
                rows = idx[ok]
                stack[rows, sp[rows]] = m[ok]
                entered[rows, sp[rows]] = entry.gather(1, ch)[:, 0][ok]
                sp[rows] += 1

        sel = v < 0
        if bool(sel.any()):
            idx = act[sel]
            u = -v[sel]
            counts[1, idx] += 1
            count = u // bvh8.LEAF_ROW_LIMIT
            leaf_row = u % bvh8.LEAF_ROW_LIMIT
            for rr in range(leaf_rows):
                keep = (count > tris_per_row * rr if rr
                        else torch.ones_like(count, dtype=torch.bool))
                ridx = idx[keep]
                counts[2, ridx] += 1
                counts[3, ridx] += torch.clamp(
                    count[keep] - tris_per_row * rr, max=tris_per_row
                ).to(torch.int32)
                leaf(ridx, leaf_row[keep] + rr, count[keep], rr,
                     o[ridx][:, :, None], d[ridx][:, :, None])
    return counts


def wide_trace5_plain(nodes, tris_g, origin, direction, t_in, leaf_fmt=None,
                      stats=False, cull=True, stack_depth=STACK_DEPTH):
    """The kernel's traversal in plain PyTorch (`traverse_plain` with the
    8-triangle geometry rows), with the kernel's arithmetic in the
    kernel's order. Arguments and results as `wide_trace5`."""
    leaf_fmt = bvh8.LEAF_FMT if leaf_fmt is None else leaf_fmt
    dev = origin.device
    n = origin.shape[1]
    t = t_in.clone()
    face = torch.full((n,), -1, dtype=torch.int32, device=dev)
    fu = torch.zeros(n, dtype=torch.float32, device=dev)
    fv = torch.zeros(n, dtype=torch.float32, device=dev)

    def leaf(ridx, row_id, count, rr, o, d):
        g = tris_g[row_id].reshape(-1, 8, 16)
        ft, hu, hv, geo_ok = leaf_tests(g, o, d, leaf_fmt, count, rr)
        tb, fb, ub, vb = t[ridx], face[ridx], fu[ridx], fv[ridx]
        base = (row_id * 8).to(torch.int32)
        for k in range(8):
            ok = geo_ok[:, k] & (ft[:, k] < tb)
            tb = torch.where(ok, ft[:, k], tb)
            fb = torch.where(ok, base + k, fb)
            ub = torch.where(ok, hu[:, k], ub)
            vb = torch.where(ok, hv[:, k], vb)
        t[ridx], face[ridx], fu[ridx], fv[ridx] = tb, fb, ub, vb

    counts = traverse_plain(nodes, origin, direction, t, leaf, LEAF_ROWS, 8,
                            cull, stack_depth)
    if stats:
        return t, face, fu, fv, counts
    return t, face, fu, fv


def check_rays(nodes, tris, origin, direction, t_in):
    """Raise unless the tables and rays are what the flat kernels take:
    contiguous float32 on the rays' CUDA device, (., 128) tables, (3, N)
    rays and (N,) reach."""
    dev = origin.device
    n = origin.shape[-1]
    check_tensor('nodes', nodes, dev, (None, 128))
    check_tensor('tris', tris, dev, (None, 128))
    check_tensor('origin', origin, dev, (3, n))
    check_tensor('direction', direction, dev, (3, n))
    check_tensor('t_in', t_in, dev, (n,))
    return dev, n


def _wide_trace5_cuda(nodes, tris_g, origin, direction, t_in, leaf_fmt, stats,
                      anatomy):
    dev, n = check_rays(nodes, tris_g, origin, direction, t_in)
    if leaf_fmt not in LEAF_FMTS:
        raise NotImplementedError(f'leaf format {leaf_fmt!r}')
    t = torch.empty(n, dtype=torch.float32, device=dev)
    face = torch.empty(n, dtype=torch.int32, device=dev)
    fu = torch.empty(n, dtype=torch.float32, device=dev)
    fv = torch.empty(n, dtype=torch.float32, device=dev)
    per_ray, warps = stats_buffers(stats or anatomy, 6, n, dev)
    from .build import load
    err = load().wide_trace5(nodes, tris_g, origin, direction, t_in,
                             LEAF_FMTS[leaf_fmt], t, face, fu, fv, per_ray,
                             warps, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f'wide_trace5 kernel launch failed: cudaError {err}')
    profiling.count('kernel.wide_trace5')
    out = (t, face, fu, fv)
    if stats:
        out += (per_ray[:4],)
    if anatomy:
        out += (anatomy_record(per_ray, warps, 4),)
    return out


def wide_trace5(nodes, tris_g, origin, direction, t_in, leaf_fmt=None,
                stats=False, anatomy=False):
    """Trace world rays (origin/direction (3, N), t_in (N,) reach)
    against the flattened world-space BVH8.

    Returns (t, face, fu, fv): face is the slot into the attribute side
    table (-1 where nothing closer was hit), (fu, fv) the winning
    barycentrics. With `stats` also a (4, N) int32 tensor of per-ray
    interior pops, leaf pops, leaf rows tested and triangles in those
    rows; these are each ray's own counts, not the JAX kernel's
    per-grid-step packet counts.
    CUDA tensors launch the CUDA kernel csrc/trace_packet.cu (counted in
    utils/profiling.py as `kernel.wide_trace5`). `anatomy` appends the
    dict of `trace_inst.anatomy_record`. CPU tensors run
    `wide_trace5_plain` with the pop cull.
    """
    leaf_fmt = bvh8.LEAF_FMT if leaf_fmt is None else leaf_fmt
    if origin.device.type == 'cuda':
        return _wide_trace5_cuda(nodes, tris_g, origin, direction, t_in,
                                 leaf_fmt, stats, anatomy)
    if origin.device.type == 'cpu':
        if anatomy:
            raise ValueError('only the CUDA kernels measure their anatomy')
        return wide_trace5_plain(nodes, tris_g, origin, direction, t_in,
                                 leaf_fmt, stats)
    raise ValueError(f'wide_trace5: unsupported device {origin.device}')


def resolve_wide_attributes(attrs, face, fu, fv):
    """Barycentric lerp of normals and uvs, and the shape index, of the
    winning faces: one row gather from the (slots, 16) side table
    [n0 n1 n2 (9) | uv0 uv1 uv2 (6) | shape]. Returns (normal (3, N)
    unnormalized, uv (2, N), shape (N,) int32); zeros / -1 where
    face < 0."""
    ok = face >= 0
    rows = attrs[torch.where(ok, face, torch.zeros_like(face))].T  # (16, N)
    fw = 1.0 - fu - fv
    normal = fw * rows[0:3] + fu * rows[3:6] + fv * rows[6:9]
    uv = fw * rows[9:11] + fu * rows[11:13] + fv * rows[13:15]
    shape = torch.where(ok, rows[15].to(torch.int32),
                        torch.full_like(face, -1))
    return (torch.where(ok, normal, torch.zeros_like(normal)),
            torch.where(ok, uv, torch.zeros_like(uv)), shape)
