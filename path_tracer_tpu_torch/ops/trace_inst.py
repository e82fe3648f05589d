"""Two-level instanced BVH8 traversal: CUDA kernel, plain version, resolve.

Port of path_tracer_tpu/ops/trace_inst.py. `inst_trace` traces world
rays against the tables that scene/compile.py builds in 'inst' mode:

  nodes      (W, 128) f32  [TLAS rows | rebased per-mesh BVH8 rows]
                           (row layout in scene/bvh8.py)
  tris       (R, 128) f32  object-space leaf rows, 8 triangles each in
                           the bvh8.LEAF_FMT format ('bary' or 'mt')
  inst_rows  (I, 128) f32  object_from_world 3x4 in lanes 0..11, mesh
                           root row in lane 12

and returns (t, face, fu, fv, inst), face = (leaf_row + r) * 8 + k and
inst = -1 on a miss. On a CUDA tensor it launches the hand-written
kernel csrc/trace_inst.cu; on a CPU tensor it runs `inst_trace_plain`,
the same per-ray traversal written in PyTorch. There is no fallback
from one to the other.
"""

from __future__ import annotations

import torch

from ..scene import bvh8

STACK_DEPTH = 128
INST_BASE = 1 << 22      # stack entries >= INST_BASE are instance tags
PASS_LIMIT = 0.5 * bvh8.BIG
LEAF_ROWS = bvh8.LEAF_MAX // 8
_LEAF_FMTS = {'mt': 0, 'bary': 1}

# Kernel launches made through inst_trace (CUDA tensors only).
launches = 0


def reset_launches():
    global launches
    launches = 0


def _safe_inv(d):
    tiny = torch.where(d >= 0, torch.full_like(d, 1e-8), torch.full_like(d, -1e-8))
    return 1.0 / torch.where(torch.abs(d) < 1e-8, tiny, d)


def _octant(d):
    """(G, 3) directions -> (G,) octant, bit set <=> component negative."""
    neg = (d < 0).to(torch.int64)
    return (neg[:, 0] << 2) | (neg[:, 1] << 1) | neg[:, 2]


def inst_trace_plain(nodes, tris, inst_rows, origin, direction, t_in,
                     tlas_rows, leaf_fmt=None, stats=False):
    """The kernel's traversal, vectorized over rays in plain PyTorch.

    Every ray owns a (STACK_DEPTH,) stack; each loop iteration pops one
    entry from every ray whose stack is not empty and handles it as an
    instance tag, an interior node or a leaf, with the kernel's
    arithmetic in the kernel's order, until every stack is empty.
    Arguments and results as `inst_trace`.
    """
    leaf_fmt = bvh8.LEAF_FMT if leaf_fmt is None else leaf_fmt
    dev = origin.device
    n = origin.shape[1]
    w_o = origin.T.contiguous()
    w_d = direction.T.contiguous()
    w_inv = _safe_inv(w_d)
    w_p = w_o * w_inv
    w_oct = _octant(w_d)
    r_o, r_d, r_inv, r_p, r_oct = (w_o.clone(), w_d.clone(), w_inv.clone(),
                                   w_p.clone(), w_oct.clone())

    t = t_in.clone()
    face = torch.full((n,), -1, dtype=torch.int32, device=dev)
    fu = torch.zeros(n, dtype=torch.float32, device=dev)
    fv = torch.zeros(n, dtype=torch.float32, device=dev)
    inst = torch.full((n,), -1, dtype=torch.int32, device=dev)
    cur = torch.zeros(n, dtype=torch.int32, device=dev)
    counts = torch.zeros((4, n), dtype=torch.int32, device=dev)
    stack = torch.zeros((n, STACK_DEPTH), dtype=torch.int64, device=dev)
    sp = torch.ones(n, dtype=torch.int64, device=dev)

    def push(idx, value, ok):
        ok = ok & (sp[idx] < STACK_DEPTH)
        rows = idx[ok]
        stack[rows, sp[rows]] = value[ok]
        sp[rows] += 1

    while True:
        act = torch.nonzero(sp > 0).squeeze(1)
        if act.numel() == 0:
            break
        sp[act] -= 1
        v = stack[act, sp[act]]

        # Instance tags: object-space ray registers, push the mesh root.
        sel = v >= INST_BASE
        if bool(sel.any()):
            idx = act[sel]
            k = v[sel] - INST_BASE
            m = inst_rows[k]
            counts[3, idx] += 1
            o, d = w_o[idx], w_d[idx]
            ro = torch.stack([m[:, 4 * j] * o[:, 0] + m[:, 4 * j + 1] * o[:, 1]
                              + m[:, 4 * j + 2] * o[:, 2] + m[:, 4 * j + 3]
                              for j in range(3)], 1)
            rd = torch.stack([m[:, 4 * j] * d[:, 0] + m[:, 4 * j + 1] * d[:, 1]
                              + m[:, 4 * j + 2] * d[:, 2] for j in range(3)], 1)
            inv = _safe_inv(rd)
            r_o[idx], r_d[idx], r_inv[idx] = ro, rd, inv
            r_p[idx] = ro * inv
            r_oct[idx] = _octant(rd)
            cur[idx] = k.to(torch.int32)
            push(idx, m[:, 12].round().to(torch.int64),
                 torch.ones_like(idx, dtype=torch.bool))

        # Interior nodes: world ray on TLAS rows, object ray below them.
        sel = (v >= 0) & (v < INST_BASE)
        if bool(sel.any()):
            idx = act[sel]
            vv = v[sel]
            counts[0, idx] += 1
            row = nodes[vv]
            world = (vv < tlas_rows)[:, None]
            inv = torch.where(world, w_inv[idx], r_inv[idx])[:, :, None]
            p = torch.where(world, w_p[idx], r_p[idx])[:, :, None]
            oct_ = torch.where(world[:, 0], w_oct[idx], r_oct[idx])
            lo = row[:, 0:24].reshape(-1, 3, 8) * inv - p
            hi = row[:, 24:48].reshape(-1, 3, 8) * inv - p
            t_lo, t_hi = torch.minimum(lo, hi), torch.maximum(lo, hi)
            entry = torch.maximum(torch.maximum(t_lo[:, 0], t_lo[:, 1]), t_lo[:, 2])
            exit_ = torch.minimum(torch.minimum(t_hi[:, 0], t_hi[:, 1]), t_hi[:, 2])
            hit = ((exit_ >= entry) & (exit_ > 0.0) & (entry < t[idx][:, None])
                   & (entry < PASS_LIMIT))
            metas = row[:, bvh8.META_LANE:bvh8.META_LANE + 8].round().to(torch.int64)
            perm = row.gather(1, (bvh8.PERM_LANE + oct_)[:, None])[:, 0]
            perm = perm.round().to(torch.int64)
            for k in range(8):
                ch = ((perm >> (3 * k)) & 7)[:, None]
                m = metas.gather(1, ch)[:, 0]
                push(idx, m, hit.gather(1, ch)[:, 0] & (m != 0))

        # Leaves: up to LEAF_ROWS rows of 8 triangles.
        sel = v < 0
        if bool(sel.any()):
            idx = act[sel]
            u = -v[sel]
            counts[1, idx] += 1
            count = u // bvh8.LEAF_ROW_LIMIT
            leaf_row = u % bvh8.LEAF_ROW_LIMIT
            for rr in range(LEAF_ROWS):
                keep = count > 8 * rr if rr else torch.ones_like(count, dtype=torch.bool)
                ridx, rcount = idx[keep], count[keep]
                counts[2, ridx] += 1
                row_id = leaf_row[keep] + rr
                g = tris[row_id].reshape(-1, 8, 16)
                o = r_o[ridx][:, :, None]
                d = r_d[ridx][:, :, None]
                ft, hu, hv, geo_ok = _leaf_tests(g, o, d, leaf_fmt, rcount, rr)
                tb, fb = t[ridx], face[ridx]
                ub, vb, ib = fu[ridx], fv[ridx], inst[ridx]
                base = (row_id * 8).to(torch.int32)
                for k in range(8):
                    ok = geo_ok[:, k] & (ft[:, k] < tb)
                    tb = torch.where(ok, ft[:, k], tb)
                    fb = torch.where(ok, base + k, fb)
                    ub = torch.where(ok, hu[:, k], ub)
                    vb = torch.where(ok, hv[:, k], vb)
                    ib = torch.where(ok, cur[ridx], ib)
                t[ridx], face[ridx], fu[ridx], fv[ridx], inst[ridx] = tb, fb, ub, vb, ib

    if stats:
        return t, face, fu, fv, inst, counts
    return t, face, fu, fv, inst


def _leaf_tests(g, o, d, leaf_fmt, count, rr):
    """Triangle tests of one leaf row: g (G, 8, 16) slots, o/d (G, 3, 1)
    object-space rays. Returns (ft, fu, fv, ok) of shape (G, 8); `ok`
    holds every condition except ft < t, which depends on the earlier
    slots of the row."""
    ox, oy, oz = o[:, 0], o[:, 1], o[:, 2]
    dx, dy, dz = d[:, 0], d[:, 1], d[:, 2]
    if leaf_fmt == 'bary':
        nd = g[..., 0] * dx + g[..., 1] * dy + g[..., 2] * dz
        no = g[..., 0] * ox + g[..., 1] * oy + g[..., 2] * oz
        ft = (g[..., 3] - no) / nd
        hx, hy, hz = ox + ft * dx, oy + ft * dy, oz + ft * dz
        fu = g[..., 4] * hx + g[..., 5] * hy + g[..., 6] * hz + g[..., 7]
        fv = g[..., 8] * hx + g[..., 9] * hy + g[..., 10] * hz + g[..., 11]
        ok = (fu >= 0.0) & (fv >= 0.0) & (fu + fv <= 1.0) & (ft >= 0.0)
        return ft, fu, fv, ok
    if leaf_fmt != 'mt':
        raise NotImplementedError(f'leaf format {leaf_fmt!r}')
    p0x, p0y, p0z = g[..., 0], g[..., 1], g[..., 2]
    e1x, e1y, e1z = g[..., 3], g[..., 4], g[..., 5]
    e2x, e2y, e2z = g[..., 6], g[..., 7], g[..., 8]
    pvx = dy * e2z - dz * e2y
    pvy = dz * e2x - dx * e2z
    pvz = dx * e2y - dy * e2x
    det = e1x * pvx + e1y * pvy + e1z * pvz
    ok = torch.abs(det) >= 1e-9
    inv_det = 1.0 / torch.where(ok, det, torch.ones_like(det))
    sx, sy, sz = ox - p0x, oy - p0y, oz - p0z
    fu = inv_det * (sx * pvx + sy * pvy + sz * pvz)
    qx = sy * e1z - sz * e1y
    qy = sz * e1x - sx * e1z
    qz = sx * e1y - sy * e1x
    fv = inv_det * (dx * qx + dy * qy + dz * qz)
    ft = inv_det * (e2x * qx + e2y * qy + e2z * qz)
    slot = torch.arange(8, device=g.device)
    ok = (ok & (fu >= 0.0) & (fu <= 1.0) & (fv >= 0.0) & (fu + fv <= 1.0)
          & (ft >= 0.0) & (count[:, None] > 8 * rr + slot))
    return ft, fu, fv, ok


def _check(name, x, device, shape):
    """Raise unless x is a contiguous float32 tensor of `shape` (None
    matches any length) on the CUDA `device`."""
    if x.device != device:
        raise ValueError(f'{name} must lie on {device}, got {x.device}')
    if x.dtype != torch.float32:
        raise ValueError(f'{name} must be float32, got {x.dtype}')
    if not x.is_contiguous():
        raise ValueError(f'{name} must be contiguous')
    if x.dim() != len(shape) or any(
            want is not None and got != want for got, want in zip(x.shape, shape)):
        raise ValueError(f'{name} has shape {tuple(x.shape)}, expected {shape}')


def _inst_trace_cuda(nodes, tris, inst_rows, origin, direction, t_in,
                     tlas_rows, leaf_fmt, stats):
    global launches
    dev = origin.device
    n = origin.shape[-1]
    for name, x in (('nodes', nodes), ('tris', tris), ('inst_rows', inst_rows)):
        _check(name, x, dev, (None, 128))
    _check('origin', origin, dev, (3, n))
    _check('direction', direction, dev, (3, n))
    _check('t_in', t_in, dev, (n,))
    if leaf_fmt not in _LEAF_FMTS:
        raise NotImplementedError(f'leaf format {leaf_fmt!r}')
    t = torch.empty(n, dtype=torch.float32, device=dev)
    face = torch.empty(n, dtype=torch.int32, device=dev)
    fu = torch.empty(n, dtype=torch.float32, device=dev)
    fv = torch.empty(n, dtype=torch.float32, device=dev)
    inst = torch.empty(n, dtype=torch.int32, device=dev)
    counts = torch.empty((4, n) if stats else (0,), dtype=torch.int32,
                         device=dev)
    from .build import load
    err = load().inst_trace(nodes, tris, inst_rows, origin, direction, t_in,
                            int(tlas_rows), _LEAF_FMTS[leaf_fmt], t, face, fu,
                            fv, inst, counts,
                            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f'inst_trace kernel launch failed: cudaError {err}')
    launches += 1
    if stats:
        return t, face, fu, fv, inst, counts
    return t, face, fu, fv, inst


def inst_trace(nodes, tris, inst_rows, origin, direction, t_in, tlas_rows,
               leaf_fmt=None, stats=False):
    """Trace world rays (origin/direction (3, N), t_in (N,)) against the
    two-level tables; tlas_rows is the count of TLAS rows at the head
    of `nodes`.

    Returns (t, face, fu, fv, inst), plus a (4, N) int32 tensor of
    per-ray interior pops, leaf pops, leaf rows tested and instance
    entries when `stats`.
    CUDA tensors launch the CUDA kernel (and count one launch in
    `launches`); CPU tensors run `inst_trace_plain`.
    """
    leaf_fmt = bvh8.LEAF_FMT if leaf_fmt is None else leaf_fmt
    if origin.device.type == 'cuda':
        return _inst_trace_cuda(nodes, tris, inst_rows, origin, direction,
                                t_in, tlas_rows, leaf_fmt, stats)
    if origin.device.type == 'cpu':
        return inst_trace_plain(nodes, tris, inst_rows, origin, direction,
                                t_in, tlas_rows, leaf_fmt, stats)
    raise ValueError(f'inst_trace: unsupported device {origin.device}')


def resolve_inst_attributes(attrs, inst_aux, face, fu, fv, inst,
                            n_instances=None):
    """Object-space attribute lerp + world rotation for the winners.

    attrs: (slots, 16) side table; inst_aux: (I, 16) rows [inverse-world
    3x3 row-major (9), shape index (1), pad]. Normals rotate to world by
    the row-vector inverse-world product (n_w = n_o @ W^-1[:3, :3]).
    Returns (normal (3, N) unnormalized, uv (2, N), shape (N,) int32).
    With n_instances == 1 the single aux row is broadcast.
    """
    ok = face >= 0
    rows = attrs[torch.where(ok, face, torch.zeros_like(face))].T  # (16, N)
    fw = 1.0 - fu - fv
    n_obj = fw * rows[0:3] + fu * rows[3:6] + fv * rows[6:9]
    uv = fw * rows[9:11] + fu * rows[11:13] + fv * rows[13:15]
    if n_instances == 1:
        irows = inst_aux[0][:, None]
    else:
        irows = inst_aux[torch.where(ok, inst, torch.zeros_like(inst))].T
    normal = torch.stack([
        n_obj[0] * irows[0] + n_obj[1] * irows[3] + n_obj[2] * irows[6],
        n_obj[0] * irows[1] + n_obj[1] * irows[4] + n_obj[2] * irows[7],
        n_obj[0] * irows[2] + n_obj[1] * irows[5] + n_obj[2] * irows[8],
    ])
    shape = torch.where(ok, irows[9].to(torch.int32) * torch.ones_like(face),
                        torch.full_like(face, -1))
    return (torch.where(ok, normal, torch.zeros_like(normal)),
            torch.where(ok, uv, torch.zeros_like(uv)), shape)
