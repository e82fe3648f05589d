# Copied from path_tracer_tpu/scene/bvh8.py (numpy-only host code shared with the JAX package).
"""Wide (8-ary) BVH over world-space triangles for the packet kernel.

The reference traverses a binary mesh BVH per SIMT thread
(reference src/scene/scene.glsl.inc:336-399) under a TLAS of
instances (:468-520). The TPU packet kernel pays a fixed scalar/fetch
cost per node *pop*, so the tree is reshaped for pop economy instead:

  * Instancing is flattened at compile time: every mesh instance's
    triangles are pre-transformed to world space and one BVH covers the
    whole scene (the TLAS's culling role is subsumed by the top of this
    tree, and per-instance ray transforms disappear from the kernel).
  * The binary SAH tree (native/bvh_builder.cpp) is collapsed into
    8-wide nodes: ~3x fewer pops, and one 128-lane node row holds all
    eight child boxes so a single fetch feeds the whole pop.
  * Leaves hold up to LEAF_MAX faces in 128-lane rows of 8 (v5
    layout) or 4 (v3 layout) triangles; rows past the first are
    predicated on the leaf's count, so a leaf pop costs one fetch +
    Moller-Trumbore per OCCUPIED row without a fresh pop's scalar
    overhead (the binary builder's ~1.1-face leaves are far too fine
    for packet traversal, where all 1024 lanes test every triangle
    anyway).

Node row layout (one float32 row of 128 lanes per wide node):
  lanes  0..47  child AABBs, coordinate-major: lo_x[0..7], lo_y[0..7],
                lo_z[0..7], hi_x[0..7], hi_y[0..7], hi_z[0..7]
                (empty child slots get an inverted box +BIG/-BIG)
  lanes 48..55  per-child meta, stored as exact-integer float32:
                >= 0: wide index of an interior child
                <  0: -(face_count * LEAF_ROW_LIMIT + tri_row), leaf
                child of up to LEAF_MAX faces starting at row tri_row
  lane  64      traversal-order axis (0/1/2): children are pre-sorted
                by centroid along this axis at build time; the flip
                fallback picks push direction from the packet's mean
                direction sign (near-first without per-ray sorting).
  lanes 65..72  per-octant far-first push orders (write_octant_perms):
                lane 65+o packs a full child permutation 3 bits per
                push position for direction octant o, giving the
                production kernel true 3-axis front-to-back pops
                (ops/trace_inst.py oct_order; bounce pops -8.3%).

Triangle row layout (one float32 row per 4-triangle block; triangle k
at lane base 32*k):
  +0..8   p0 p1 p2 (world-space positions)
  +9..17  n0 n1 n2 (world-space unit vertex normals)
  +18..23 uv0 uv1 uv2
  +24     shape index (exact-integer float32)
Padding slots are degenerate (all zeros -> Moller-Trumbore det == 0).
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass

import numpy as np

BIG = 1.0e9            # box-miss sentinel; finite so slab math never NaNs
WIDE_WIDTH = 8
# Lane layout per node width: AABBs occupy 6*width lanes (coordinate-
# major), metas the next `width`, then the traversal axis. A 16-wide
# node still fits ONE 128-lane row (96 + 16 + 1 = 113 lanes): the
# packet kernel's per-pop cost is dominated by fixed overheads (loop
# skeleton, vector->scalar mask crossing, row fetch), so doubling the
# arity amortizes them over 2x the children per pop.
NODE_LAYOUT = {8: dict(meta=48, axis=64), 16: dict(meta=96, axis=112)}
# Per-octant far-first child push order (width 8 only): lanes
# PERM_LANE+o, o = (dx<0)<<2 | (dy<0)<<1 | (dz<0), each an
# exact-integer float packing child slots 3 bits per push position
# (child pushed first in bits 0..2; max value 2^24-1 so f32-exact).
# Full 3-axis front-to-back ordering for the packet's dominant ray
# octant, replacing the single split-axis flip (ops/trace_inst.py
# oct_order).
PERM_LANE = 65
TRI_STRIDE = 32
TRIS_PER_ROW = 4
LEAF_MAX = 16          # triangles per leaf (LEAF_MAX/8 v5 rows)
# Leaf meta = -(count * LEAF_ROW_LIMIT + tri_row): a 5-bit count field
# (count <= LEAF_MAX) above a 19-bit row field, max 16*2^19+2^19-1 =
# 8.9M < 2^24, so the value is EXACT in the float32 meta lane. The old
# -(row * 64 + count) layout silently rounded the low bits once
# tri_row exceeded 262143 (f32 mantissa), corrupting ~1.4% of leaves
# on a 1.6M-triangle scene; row-in-the-low-bits keeps every in-range
# value exact and the builders assert the range loudly.
LEAF_ROW_LIMIT = 1 << 19
META_LANE = 48
AXIS_LANE = 64
# Relative cost of a leaf's 2nd..Nth row vs a full pop, for the DP
# collapse's expected-pops objective (tools/exp_collapse.py).
LEAF_ROW_COST = 0.5


@dataclass
class WideBvh:
    nodes: np.ndarray      # (W, 128) float32
    tris: np.ndarray       # (R, 128) float32
    face_map: np.ndarray   # (R*4,) int32 -> input face index, -1 = padding
    num_nodes: int
    num_leaves: int
    width: int = WIDE_WIDTH


# --- Geometry-only leaf layout for the v5 kernel ------------------------
#
# Measured on-chip (tools/exp_pop_cost.py): the dominant per-pop cost is
# the lane->broadcast redistribution, so the v5 kernel (a) redistributes
# with static single-lane splats instead of the K=1 contraction and
# (b) keeps only what Moller-Trumbore needs in the hot table -- one
# 128-lane row holds 8 leaf triangles (16-lane stride per tri: p0.xyz
# e1.xyz e2.xyz pad), one fetch per leaf ROW; leaves span up to
# LEAF_MAX/8 consecutive rows, rows past the first predicated on the
# leaf count. Vertex attributes (normals, uvs, shape index) move to a
# cold (slots, 16) side table in HBM, gathered ONCE per trace for the
# winning faces instead of being redistributed on every leaf pop:
#   [n0.xyz n1.xyz n2.xyz uv0.uv uv1.uv uv2.uv pad shape] per slot.
GEOM5_STRIDE = 16
ATTR5_WIDTH = 16
# Leaf geometry row format consumed by the packet kernels:
#   'mt'    p0 / e1 / e2 at lanes b..b+8 -- Moller-Trumbore in-kernel.
#   'woop'  unit-triangle transform (Woop): lanes b..b+8 hold
#           M = [e1 e2 n]^-1 row-major (n = e1 x e2), lanes b+9..b+11
#           hold c = -M @ p0. The kernel computes o' = M o + c,
#           d' = M d, t = -o'_z / d'_z, u = o'_x + t d'_x,
#           v = o'_y + t d'_y; padded/degenerate slots auto-miss
#           through the 0/0 = NaN ordered-comparison path, so the
#           per-triangle count test disappears. u/v are the SAME
#           barycentrics (e1/e2 coefficients) Moller-Trumbore yields.
#
#   'bary'  plane + barycentric gradients: lanes b..b+2 hold
#           n = e1 x e2, b+3 d0 = n.p0, b+4..b+6 gu = (e2 x n)/|n|^2,
#           b+7 cu = -gu.p0, b+8..b+10 gv = (n x e1)/|n|^2, b+11
#           cv = -gv.p0. The kernel computes ft = (d0 - n.o)/(n.d),
#           the hit point h = o + ft d, then fu = gu.h + cu,
#           fv = gv.h + cv -- the same e1/e2 barycentrics as 'mt'.
#           ~22% fewer vector issues than Moller-Trumbore with only
#           ~5 simultaneously-live column broadcasts (vs woop's 12);
#           padded/degenerate slots auto-miss via 0/0 = NaN.
#
# Measured on-chip (tools/exp_woop.py, viking hall, REAL sorted
# mid-flight rays, v6 kernel): despite ~15% fewer vector issues on
# paper, woop is 7% SLOWER on bounce packets (124.6 vs 116.2 ms;
# winners agree 1.0000) -- the 12 simultaneously-live column broadcasts
# per triangle raise register pressure in exactly the way the v5->v6
# scratch-register finding showed this kernel cannot afford.
#
# 'bary' wins where woop lost (tools/exp_leafbary.py, same harness):
# bounce 149.2 -> 132.7 ms (13.9 -> 15.6 Mrays/s kernel-only, +12%),
# coherent primaries 209.1 -> 179.1 ms (+17%), hits agree 1.00000 and
# t within 2e-4 on 99.995% of shared hits -- the short dependency
# chain keeps register pressure at 'mt' levels while saving the
# cross-product arithmetic. Production default since round 3.
LEAF_FMT = 'bary'


def _cross_cols(a, b):
    """Row-wise cross product of (F, 3) arrays WITHOUT np.cross: the
    generic np.cross spends most of its time in moveaxis/axis
    normalization (profiled at 58 s for 1.2M calls in the old per-face
    path); three fused column expressions are ~100x faster."""
    return np.stack([a[:, 1] * b[:, 2] - a[:, 2] * b[:, 1],
                     a[:, 2] * b[:, 0] - a[:, 0] * b[:, 2],
                     a[:, 0] * b[:, 1] - a[:, 1] * b[:, 0]], axis=1)


def _woop_rows_batch(p):
    """(F, 3, 3) vertex positions -> (F, 12) [M row-major | c] rows.

    Vectorized over all faces (f64 inverses via the closed-form adjugate
    of [e1 | e2 | n]); degenerate faces yield all-zero rows (auto-miss
    through the kernel's 0/0 = NaN ordered comparisons)."""
    p0 = p[:, 0].astype(np.float64)
    e1 = p[:, 1].astype(np.float64) - p0
    e2 = p[:, 2].astype(np.float64) - p0
    n = _cross_cols(e1, e2)
    a = np.stack([e1, e2, n], axis=2)            # (F, 3, 3) columns
    det = (a[:, 0, 0] * (a[:, 1, 1] * a[:, 2, 2] - a[:, 1, 2] * a[:, 2, 1])
           - a[:, 0, 1] * (a[:, 1, 0] * a[:, 2, 2] - a[:, 1, 2] * a[:, 2, 0])
           + a[:, 0, 2] * (a[:, 1, 0] * a[:, 2, 1] - a[:, 1, 1] * a[:, 2, 0]))
    ok = np.abs(det) >= 1e-30
    safe = np.where(ok, det, 1.0)[:, None, None]
    adj = np.empty_like(a)
    for i in range(3):
        for j in range(3):
            r0, r1 = [r for r in range(3) if r != j]
            c0, c1 = [c for c in range(3) if c != i]
            sign = 1.0 if (i + j) % 2 == 0 else -1.0
            adj[:, i, j] = sign * (a[:, r0, c0] * a[:, r1, c1]
                                   - a[:, r0, c1] * a[:, r1, c0])
    m = adj / safe                                # (F, 3, 3) inverse
    c = -np.einsum('fij,fj->fi', m, p0)
    out = np.concatenate([m.reshape(-1, 9), c], axis=1)
    out[~ok] = 0.0
    return out.astype(np.float32)


def _bary_rows_batch(p):
    """(F, 3, 3) vertex positions -> (F, 12) [n d0 gu cu gv cv] rows.

    Vectorized over all faces; degenerate faces yield all-zero rows.
    The old per-face _bary_rows dominated big-scene compiles (69 of
    86 s at 405k faces) purely through np.cross call overhead."""
    p0 = p[:, 0].astype(np.float64)
    e1 = p[:, 1].astype(np.float64) - p0
    e2 = p[:, 2].astype(np.float64) - p0
    n = _cross_cols(e1, e2)
    nn = (n * n).sum(axis=1)
    ok = nn >= 1e-30
    safe = np.where(ok, nn, 1.0)[:, None]
    gu = _cross_cols(e2, n) / safe
    gv = _cross_cols(n, e1) / safe
    out = np.concatenate([
        n, (n * p0).sum(axis=1, keepdims=True),
        gu, -(gu * p0).sum(axis=1, keepdims=True),
        gv, -(gv * p0).sum(axis=1, keepdims=True)], axis=1)
    out[~ok] = 0.0
    return out.astype(np.float32)


def _woop_rows(p0, p1, p2):
    """(12,) single-face wrapper over _woop_rows_batch (tests/tools)."""
    return _woop_rows_batch(np.stack([p0, p1, p2])[None])[0]


def _bary_rows(p0, p1, p2):
    """(12,) single-face wrapper over _bary_rows_batch (tests/tools)."""
    return _bary_rows_batch(np.stack([p0, p1, p2])[None])[0]


def pack_wide_geom(wide: 'WideBvh',
                   tri_positions, tri_normals, tri_uvs, tri_shape,
                   leaf_fmt=None):
    """Derive the v5 tables from a packed WideBvh.

    tri_* are in the CALLER's face order (wide.face_map indexes it).
    Returns (nodes_g, tris_g, attrs, face_map_g):
      nodes_g  (W, 128)  wide.nodes with leaf metas re-encoded as
                         -(count * LEAF_ROW_LIMIT + first_row)
      tris_g   (R, 128)  8-triangle geometry rows (LEAF_FMT layout); a
                         leaf of count faces spans ceil(count/8) rows
      attrs    (R*8, 16) per-face-slot attribute rows (HBM side table;
                         slot 15 carries the face's shape index)
      face_map_g (R*8,)  face slot -> caller face index (-1 padding)
    """
    if leaf_fmt is None:
        leaf_fmt = LEAF_FMT
    tri_positions = np.asarray(tri_positions, np.float32)
    tri_normals = np.asarray(tri_normals, np.float32)
    tri_uvs = np.asarray(tri_uvs, np.float32)
    tri_shape = np.asarray(tri_shape, np.float32)

    meta_lane = NODE_LAYOUT[wide.width]['meta']
    nodes_g = wide.nodes.copy()
    metas = nodes_g[:, meta_lane:meta_lane + wide.width]
    leaf_mask = metas < 0.0
    u = -metas[leaf_mask]
    old_rows = (u % LEAF_ROW_LIMIT).astype(np.int64)
    counts = (u // LEAF_ROW_LIMIT).astype(np.int64)

    # Fully vectorized re-blocking (the old per-face Python loop with
    # per-face _bary_rows calls dominated big-scene compiles: 74 of
    # 86 s at 405k faces; the bench's 1.84M-tri terrain paid ~150 s
    # here alone). Leaf k-th faces map to geometry slots
    # row_start[leaf] * 8 + k; everything below is index arithmetic.
    counts = counts.astype(np.int64)
    leaf_rows = -(-counts // 8)
    row_start = np.concatenate([[0], np.cumsum(leaf_rows)[:-1]])
    total_rows = int(leaf_rows.sum())
    row0 = total_rows
    tris_g = np.zeros((max(total_rows, 1), 128), np.float32)
    attrs = np.zeros((max(total_rows, 1) * 8, ATTR5_WIDTH), np.float32)
    face_map_g = np.full(max(total_rows, 1) * 8, -1, np.int64)
    new_metas = (-(counts * LEAF_ROW_LIMIT + row_start)).astype(np.float32)

    # One entry per (leaf, k < count): source face + destination slot.
    leaf_of = np.repeat(np.arange(len(counts)), counts)
    k = np.arange(len(leaf_of)) - np.repeat(
        np.concatenate([[0], np.cumsum(counts)[:-1]]), counts)
    src = wide.face_map[old_rows[leaf_of] * TRIS_PER_ROW + k]
    keep = src >= 0
    leaf_of, k, src = leaf_of[keep], k[keep], src[keep]
    slot = row_start[leaf_of] * 8 + k
    r = slot // 8
    b = GEOM5_STRIDE * (slot % 8)

    p = tri_positions[src]                       # (E, 3, 3)
    if leaf_fmt == 'woop':
        rows12 = _woop_rows_batch(p)
    elif leaf_fmt == 'bary':
        rows12 = _bary_rows_batch(p)
    else:
        rows12 = np.concatenate(
            [p[:, 0], p[:, 1] - p[:, 0], p[:, 2] - p[:, 0],
             np.zeros((len(src), 3), np.float32)], axis=1)
    width_g = 12 if leaf_fmt in ('woop', 'bary') else 9
    for j in range(width_g):
        tris_g[r, b + j] = rows12[:, j]
    attrs[slot, 0:9] = tri_normals[src].reshape(-1, 9)
    attrs[slot, 9:15] = tri_uvs[src].reshape(-1, 6)
    attrs[slot, 15] = tri_shape[src]
    face_map_g[slot] = src
    if row0 > LEAF_ROW_LIMIT:
        raise ValueError(
            f'{row0} geometry rows exceed the {LEAF_ROW_LIMIT}-row leaf '
            f'encoding (~{LEAF_ROW_LIMIT * 8 / 1e6:.0f}M triangles)')

    metas[leaf_mask] = new_metas
    nodes_g[:, meta_lane:meta_lane + wide.width] = metas
    return nodes_g, tris_g, attrs, face_map_g.astype(np.int32)


def _subtree_face_ranges(a, b):
    """Per-node (face_lo, face_hi) of the contiguous face range each
    subtree spans. Children are allocated after their parent by both
    builders, so one reverse sweep suffices."""
    n = len(a)
    is_leaf = b > 0
    lo = np.zeros(n, np.int64)
    hi = np.zeros(n, np.int64)
    for i in range(n - 1, -1, -1):
        if is_leaf[i]:
            lo[i], hi[i] = a[i], b[i]
        else:
            lo[i] = min(lo[a[i]], lo[a[i] + 1])
            hi[i] = max(hi[a[i]], hi[a[i] + 1])
    return lo, hi


def collapse_bvh2_sah(node_min, node_max, a, b, leaf_max=LEAF_MAX,
                      width=WIDE_WIDTH):
    """DP-optimal 8-wide collapse of a binary BVH (Ylitie et al. 2017,
    "Efficient Incoherent Ray Traversal on GPUs through Compressed Wide
    BVHs", adapted to this kernel's cost model).

    The packet kernel pays a roughly CONSTANT ~455 cycles per node pop
    (interior or leaf, tools/exp_pop_cost.py), and a child of a wide
    node is popped iff the packet's slab test hits its box -- i.e. with
    probability proportional to the child's own surface area.  Expected
    pops per random ray are therefore

        sum over all chosen wide-subtree roots r of area(r) / area(root)

    where a root is either a wide interior node or a leaf.  The DP
    minimizes exactly that sum: cost[n][r] = minimal cost of
    representing binary subtree n as a forest of at most r roots,

        cost[n][1] = min(leaf(n),                   # count <= leaf_max
                         area(n) + min_{i} cost[l][i] + cost[r][8-i])
        leaf(n)    = area(n) * (1 + LEAF_ROW_COST * (ceil(count/8)-1))
        cost[n][r] = min(cost[n][r-1],
                         min_{i} cost[l][i] + cost[r][r-i])

    evaluated leaves-up, vectorized per tree level.  Reconstruction
    walks the recorded argmins.  Versus the greedy largest-area
    expansion (collapse_bvh2 below) this cuts wide-node count and
    expected pops 10-30% on real meshes.

    Returns (children, axes) in the same format as collapse_bvh2.
    """
    node_min = np.asarray(node_min, np.float32)
    node_max = np.asarray(node_max, np.float32)
    a = np.asarray(a)
    b = np.asarray(b)
    n = len(a)
    is_leaf = b > 0
    flo, fhi = _subtree_face_ranges(a, b)
    count = fhi - flo

    size = np.maximum(node_max - node_min, 0.0).astype(np.float64)
    area = (size[:, 0] * size[:, 1] + size[:, 1] * size[:, 2]
            + size[:, 2] * size[:, 0])
    # A leaf pop's rows past the first are predicated fetch+tests
    # without a fresh pop's fixed scalar overhead -- charge them a
    # fraction of a pop.
    leaf_rows_cost = 1.0 + LEAF_ROW_COST * (np.ceil(count / 8.0) - 1.0)

    if count[0] <= leaf_max:
        children = [[('leaf', int(flo[0]), int(count[0]), 0)]
                    if count[0] > 0 else []]
        return children, [0]

    # Tree levels (children are allocated after their parents).
    depth = np.zeros(n, np.int32)
    ai = a  # local alias
    for i in range(n):
        if not is_leaf[i]:
            depth[ai[i]] = depth[i] + 1
            depth[ai[i] + 1] = depth[i] + 1

    INF = np.inf
    cost = np.full((n, width + 1), INF)
    split_l = np.zeros((n, width + 1), np.int8)  # 0 = single root here
    j8 = np.zeros(n, np.int8)          # left budget of the width-way dist
    leaf1 = is_leaf.copy()                # C(n,1) chose leaf
    cost[is_leaf, 1:] = (area[is_leaf] * leaf_rows_cost[is_leaf])[:, None]

    order = np.argsort(depth[~is_leaf], kind='stable')
    interior_idx = np.nonzero(~is_leaf)[0][order]
    # Deepest levels first.
    for d in range(int(depth.max()), -1, -1):
        idx = interior_idx[depth[interior_idx] == d]
        if idx.size == 0:
            continue
        L = cost[a[idx]]          # (k, width+1)
        R = cost[a[idx] + 1]
        k = idx.size
        merge_cost = np.full((k, width + 1), INF)
        merge_arg = np.zeros((k, width + 1), np.int8)
        for m in range(2, width + 1):
            cands = np.stack([L[:, rl] + R[:, m - rl]
                              for rl in range(1, m)], axis=1)
            arg = cands.argmin(axis=1)
            merge_cost[:, m] = cands[np.arange(k), arg]
            merge_arg[:, m] = (arg + 1).astype(np.int8)

        node_cost = area[idx] + merge_cost[:, width]
        leaf_ok = count[idx] <= leaf_max
        leaf_cost = np.where(leaf_ok, area[idx] * leaf_rows_cost[idx], INF)
        c1 = np.minimum(leaf_cost, node_cost)
        leaf1[idx] = leaf_cost <= node_cost
        j8[idx] = merge_arg[:, width]
        cost[idx, 1] = c1
        for m in range(2, width + 1):
            prev = cost[idx, m - 1]
            better = merge_cost[:, m] < prev
            cost[idx, m] = np.where(better, merge_cost[:, m], prev)
            split_l[idx, m] = np.where(better, merge_arg[:, m],
                                       split_l[idx, m - 1])

    def roots_of(node, budget):
        out = []
        stack = [(node, budget)]
        while stack:
            m, r = stack.pop()
            s = int(split_l[m, r])
            if s == 0:
                out.append(m)
            else:
                stack.append((int(a[m]), s))
                stack.append((int(a[m]) + 1, r - s))
        return out

    children, axes = [], []
    queue = deque()

    def alloc(node):
        idx = len(children)
        children.append(None)
        axes.append(0)
        queue.append((idx, node))
        return idx

    alloc(0)
    while queue:
        w, nd = queue.popleft()
        jl = int(j8[nd])
        members = (roots_of(int(a[nd]), jl)
                   + roots_of(int(a[nd]) + 1, width - jl))
        cent = 0.5 * (node_min[members] + node_max[members])
        axis = int(np.argmax(cent.max(axis=0) - cent.min(axis=0)))
        members.sort(key=lambda m: 0.5 * (node_min[m][axis]
                                          + node_max[m][axis]))
        entries = []
        for m in members:
            if leaf1[m]:
                entries.append(('leaf', int(flo[m]), int(count[m]), m))
            else:
                entries.append(('node', alloc(m), 0, m))
        children[w] = entries
        axes[w] = axis
    return children, axes


def collapse_bvh2(node_min, node_max, a, b, leaf_max=LEAF_MAX,
                  width=WIDE_WIDTH):
    """Collapse a binary BVH into wide-node records.

    Greedy top-down: each wide node starts from one binary subtree root
    and repeatedly expands its largest-surface-area member until it has
    8 members or none are expandable. Members whose subtree spans
    <= leaf_max contiguous faces become leaf children; the rest become
    interior children (recursively collapsed).

    Returns (children, axes) where children[w] is a list of
    ('leaf', face_lo, count) / ('node', wide_index) entries sorted by
    centroid along axes[w].
    """
    node_min = np.asarray(node_min, np.float32)
    node_max = np.asarray(node_max, np.float32)
    a = np.asarray(a)
    b = np.asarray(b)
    flo, fhi = _subtree_face_ranges(a, b)
    count = fhi - flo

    size = np.maximum(node_max - node_min, 0.0)
    area = (size[:, 0] * size[:, 1] + size[:, 1] * size[:, 2]
            + size[:, 2] * size[:, 0])

    def leafable(n):
        return count[n] <= leaf_max

    children, axes = [], []
    queue = deque()

    def alloc(n):
        idx = len(children)
        children.append(None)
        axes.append(0)
        queue.append((idx, n))
        return idx

    if leafable(0):
        children.append([('leaf', int(flo[0]), int(count[0]), 0)]
                        if count[0] > 0 else [])
        axes.append(0)
        return children, axes

    alloc(0)
    while queue:
        w, root = queue.popleft()
        members = [root]
        while len(members) < width:
            cands = [m for m in members if not leafable(m)]
            if not cands:
                break
            pick = max(cands, key=lambda m: area[m])
            members.remove(pick)
            members.extend((int(a[pick]), int(a[pick]) + 1))

        cent = 0.5 * (node_min[members] + node_max[members])
        axis = int(np.argmax(cent.max(axis=0) - cent.min(axis=0)))
        members.sort(key=lambda m: 0.5 * (node_min[m][axis] + node_max[m][axis]))
        entries = []
        for m in members:
            if leafable(m):
                entries.append(('leaf', int(flo[m]), int(count[m]), m))
            else:
                entries.append(('node', alloc(m), 0, m))
        children[w] = entries
        axes[w] = axis
    return children, axes


def write_octant_perms(nodes, width=WIDE_WIDTH):
    """Stamp per-octant far-first child push orders into PERM_LANE+o.

    For each of the 8 ray-direction octants, children are ordered by
    descending centroid distance along the octant's sign vector, so a
    LIFO stack pops them front-to-back. Centroids come from the packed
    bounds lanes; empty slots (lo=BIG, hi=-BIG, centroid 0) land
    anywhere -- the kernel skips them on meta == 0. Width-16 rows have
    no free lane block for 8 packed orders; they keep the axis flip.
    """
    if width != 8 or len(nodes) == 0:
        return nodes
    w = width
    cx = 0.5 * (nodes[:, 0 * w:1 * w] + nodes[:, 3 * w:4 * w])
    cy = 0.5 * (nodes[:, 1 * w:2 * w] + nodes[:, 4 * w:5 * w])
    cz = 0.5 * (nodes[:, 2 * w:3 * w] + nodes[:, 5 * w:6 * w])
    for o in range(8):
        sx = -1.0 if (o & 4) else 1.0
        sy = -1.0 if (o & 2) else 1.0
        sz = -1.0 if (o & 1) else 1.0
        d = sx * cx + sy * cy + sz * cz          # (W, 8) signed distance
        order = np.argsort(-d, axis=1, kind='stable')  # far first
        packed = np.zeros(len(nodes), np.int64)
        for i in range(w):
            packed |= order[:, i].astype(np.int64) << (3 * i)
        nodes[:, PERM_LANE + o] = packed.astype(np.float32)
    return nodes


def pack_wide(children, axes, node_min, node_max,
              tri_positions, tri_normals, tri_uvs, tri_shape,
              width=WIDE_WIDTH):
    """Pack collapsed wide nodes + re-blocked triangles into kernel rows.

    tri_* are in the binary BVH's permuted face order (the order the
    leaf face ranges index). Leaf faces are copied into fresh 4-aligned
    blocks so a leaf is always one row fetch.
    """
    node_min = np.asarray(node_min, np.float32)
    node_max = np.asarray(node_max, np.float32)
    meta_lane = NODE_LAYOUT[width]['meta']
    axis_lane = NODE_LAYOUT[width]['axis']
    w = len(children)
    nodes = np.zeros((w, 128), np.float32)
    nodes[:, 0:3 * width] = BIG          # lo of empty slots
    nodes[:, 3 * width:6 * width] = -BIG  # hi of empty slots
    nodes[:, axis_lane] = np.asarray(axes, np.float32)

    face_map = []
    num_leaves = 0
    for widx, entries in enumerate(children):
        for c, entry in enumerate(entries):
            kind, p0, p1, m = entry
            if kind == 'leaf':
                num_leaves += 1
                tri_row = len(face_map) // TRIS_PER_ROW
                if tri_row >= LEAF_ROW_LIMIT:
                    raise ValueError(
                        f'mesh exceeds the {LEAF_ROW_LIMIT}-row leaf '
                        f'encoding ({TRIS_PER_ROW * LEAF_ROW_LIMIT / 1e6:.1f}'
                        f'M faces at this stage)')
                face_map.extend(range(p0, p0 + p1))
                face_map.extend([-1] * (-len(face_map) % TRIS_PER_ROW))
                meta = -(p1 * LEAF_ROW_LIMIT + tri_row)
            else:
                meta = p0
            lo, hi = node_min[m], node_max[m]
            for ax in range(3):
                nodes[widx, width * ax + c] = lo[ax]
                nodes[widx, 3 * width + width * ax + c] = hi[ax]
            nodes[widx, meta_lane + c] = np.float32(meta)

    if not face_map:
        face_map = [-1] * TRIS_PER_ROW
    face_map = np.asarray(face_map, np.int32)
    rows = len(face_map) // TRIS_PER_ROW
    tris = np.zeros((rows, 128), np.float32)

    tri_positions = np.asarray(tri_positions, np.float32)  # (F, 3, 3)
    tri_normals = np.asarray(tri_normals, np.float32)      # (F, 3, 3)
    tri_uvs = np.asarray(tri_uvs, np.float32)              # (F, 3, 2)
    tri_shape = np.asarray(tri_shape, np.float32)          # (F,)

    valid = face_map >= 0
    src = face_map[valid]
    slot = np.nonzero(valid)[0]
    r = slot // TRIS_PER_ROW
    base = (slot % TRIS_PER_ROW) * TRI_STRIDE
    for v in range(3):
        for c in range(3):
            tris[r, base + 3 * v + c] = tri_positions[src, v, c]
            tris[r, base + 9 + 3 * v + c] = tri_normals[src, v, c]
    for v in range(3):
        for c in range(2):
            tris[r, base + 18 + 2 * v + c] = tri_uvs[src, v, c]
    tris[r, base + 24] = tri_shape[src]

    write_octant_perms(nodes, width=width)
    return WideBvh(nodes=nodes, tris=tris, face_map=face_map,
                   num_nodes=w, num_leaves=num_leaves, width=width)


def build_wide_bvh(tri_positions, tri_normals, tri_uvs, tri_shape,
                   leaf_max=LEAF_MAX, collapse='sah', spatial=True,
                   width=WIDE_WIDTH):
    """World-space triangles -> packed wide BVH tables.

    tri_positions/tri_normals: (F, 3 verts, 3); tri_uvs: (F, 3, 2);
    tri_shape: (F,) shape index per face. collapse: 'sah' (DP-optimal,
    default) or 'greedy' (kept for A/B measurement). spatial requests
    SBVH spatial splits in the binary build (duplicated fragment
    references; face_map then repeats source faces).
    """
    from .bvh import build_bvh_cached

    tri_positions = np.asarray(tri_positions, np.float32)
    bvh = build_bvh_cached(tri_positions, spatial=spatial)
    order = bvh.face_order
    collapse_fn = collapse_bvh2_sah if collapse == 'sah' else collapse_bvh2
    children, axes = collapse_fn(bvh.node_min, bvh.node_max, bvh.a, bvh.b,
                                 leaf_max=leaf_max, width=width)
    wide = pack_wide(children, axes, bvh.node_min, bvh.node_max,
                     tri_positions[order],
                     np.asarray(tri_normals, np.float32)[order],
                     np.asarray(tri_uvs, np.float32)[order],
                     np.asarray(tri_shape, np.float32)[order],
                     width=width)
    # Remap face_map back to the caller's face order for testability.
    valid = wide.face_map >= 0
    remapped = wide.face_map.copy()
    remapped[valid] = np.asarray(order, np.int64)[wide.face_map[valid]]
    wide.face_map = remapped
    return wide
