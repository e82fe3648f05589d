"""Ray-scene intersection: analytic primitives, the mesh traversals,
hit attribute resolution.

Port of path_tracer_tpu/ops/intersect.py (behavioral reference:
reference src/scene/scene.glsl.inc:304-611). Analytic shapes are
intersected as dense (S, N) batches per shape type on the CPU, and on
the card by the shape BVH kernel of ops/trace_shapes.py, whose plain
twin is `traverse_shape_bvh`. Mesh instances go
through one kernel call for all instances: the two-level BVH8 traversal
of ops/trace_inst.py in 'inst' packet mode (the mode compile.py picks
for every scene with a mesh) or the world-flattened BVH8 traversal of
ops/trace_packet.py in 'flat' mode; or, on request, through the
portable per-instance BVH2 traversal `traverse_mesh_bvh`, which is
plain PyTorch on either device. The hit attributes that follow
(`resolve_attributes`) take one launch of the kernel of
ops/hit_attributes.py on the card, and their plain version,
`resolve_attributes_plain`, on the CPU.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch

from ..core.constants import (
    EPSILON,
    HIT_TIME_LIMIT,
    INFINITY,
    MATERIAL_TYPE_BASIC_DIFFUSE,
    MATERIAL_TYPE_BASIC_METAL,
    MATERIAL_TYPE_BASIC_TRANSLUCENT,
    MATERIAL_TYPE_OPENPBR,
    PI,
    SHAPE_INDEX_NONE,
    SHAPE_TYPE_CUBE,
    SHAPE_TYPE_MESH_INSTANCE,
    SHAPE_TYPE_PLANE,
    SHAPE_TYPE_SPHERE,
    TAU,
)
from ..core.sampling import compute_tangent_vector
from ..core.vec import (
    cross,
    dot,
    safe_normalize,
    take_matrix,
    transform_normal,
    transform_point,
    transform_vector,
    vec3,
)
from ..scene import bvh8
from ..scene.compile import (
    SHAPE_LANE_INDEX,
    SHAPE_LANE_RANK,
    SHAPE_LANE_TYPE,
    SHAPE_STACK_DEPTH,
)
from ..utils import profiling
from . import hit_attributes, trace_inst, trace_packet, trace_shapes

MAX_LEAF_FACES = 4   # faces per BVH2 leaf (scene/bvh.py)
SHAPE_BASE = trace_inst.INST_BASE   # shape BVH leaf metas: base + shape row
CULL_SLACK = trace_inst.CULL_SLACK
STACK_DEPTH = 48     # per-ray stack of the portable BVH2 traversal


@dataclass(frozen=True)
class SceneLayout:
    """Static scene structure, built on the host from the scene document
    (compile_scene attaches it as packed.host_layout). Fields as in the
    JAX package's SceneLayout, minus its TPU-budget gates (wide_fit,
    inst_fit): the card has no table budget to fit."""

    analytic_buckets: Tuple[Tuple[int, int], ...]  # (shape_type, padded K)
    instance_slots: int
    num_shapes: int
    has_skybox_texture: bool = False
    materials_textured: bool = False
    textured_attrs: Tuple[str, ...] = ('base', 'emission', 'specular',
                                       'roughness', 'roughness_anisotropy')
    atlas_size: int = 8
    texture_filter_modes: Tuple[bool, bool] = (True, True)
    # Bilinear tap strategy: 'quad', 'pair' or False (4 corner taps).
    atlas_quad_fit: object = False
    # Triangle slots of the trace tables in use (leaf rows x 8, padding
    # included).
    wide_face_slots: int = 0
    has_opacity: bool = False
    packet_mode: str = 'flat'
    tlas_rows: int = 0
    material_types: Tuple[int, ...] = ()
    scene_has_medium: bool = True
    has_skybox_sampling: bool = True
    has_transmissive: bool = True

    @staticmethod
    def from_packed(packed):
        """The layout compile_scene (or packed_from_numpy with
        layout_fields) attached to `packed`."""
        layout = getattr(packed, 'host_layout', None)
        if layout is None:
            raise ValueError('packed has no host_layout: build it with '
                             'compile_scene, or packed_from_numpy with '
                             'layout_fields')
        return layout


def _types_have_medium(mat_types):
    return (MATERIAL_TYPE_BASIC_TRANSLUCENT in mat_types
            or MATERIAL_TYPE_OPENPBR in mat_types)


def _filter_modes(nearest_flags):
    """(has_bilinear, has_nearest); bilinear-only without textures."""
    if not nearest_flags:
        return (True, False)
    return (any(not f for f in nearest_flags), any(nearest_flags))


def build_layout_host(scene, packed):
    """SceneLayout from the host-side scene document (mirrors the JAX
    package's build_layout_host).

    scene.compile_generic (set by app.Session) gives the JAX package's
    generic programs: every analytic type with a bucket-padded group,
    all four material models, every texturable attribute and both
    filters, and the conservative scatter flags. The JAX package keeps
    its program structure fixed under edits that way; here it only
    selects which branches run, and the specialization test of
    tests/test_torch_media.py shows such flags change no result."""
    from ..scene.atlas import choose_atlas_size
    from ..scene.compile import _ENTITY_TO_SHAPE_TYPE, _bucket, entity_packs_shape

    by_type = {}
    i_real = 0
    mat_types = set()
    index = 0
    for entity, _ in scene.walk_entities_with_transform():
        if not entity_packs_shape(entity):
            continue
        stype = _ENTITY_TO_SHAPE_TYPE[entity.type]
        if stype == SHAPE_TYPE_MESH_INSTANCE:
            i_real += 1
        else:
            by_type.setdefault(int(stype), []).append(index)
        # Material slot 0 is the fallback OpenPBR surface.
        mat_types.add(int(entity.material.type) if entity.material is not None
                      else MATERIAL_TYPE_OPENPBR)
        index += 1
    generic = bool(getattr(scene, 'compile_generic', False))
    if generic:
        for t in (SHAPE_TYPE_PLANE, SHAPE_TYPE_SPHERE, SHAPE_TYPE_CUBE):
            by_type.setdefault(int(t), [])
        mat_types |= {MATERIAL_TYPE_BASIC_DIFFUSE, MATERIAL_TYPE_BASIC_METAL,
                      MATERIAL_TYPE_BASIC_TRANSLUCENT, MATERIAL_TYPE_OPENPBR}
    # The group sizes of compile.py's analytic tables.
    analytic = tuple(sorted(
        (t, _bucket(len(idxs)) if generic else max(len(idxs), 1))
        for t, idxs in by_type.items()))
    slots = 0 if i_real == 0 else 1 if i_real == 1 else _bucket(i_real)

    attr_fields = dict(
        base=('base_texture', 'base_color_texture'),
        specular=('specular_texture',),
        roughness=('roughness_texture', 'specular_roughness_texture'),
        roughness_anisotropy=('roughness_anisotropy_texture',),
        emission=('emission_color_texture',),
    )
    textured_set = set()
    for material in scene.materials:
        for attr, fields in attr_fields.items():
            if any(getattr(material, f, None) is not None for f in fields):
                textured_set.add(attr)
    if generic:
        textured_set = set(attr_fields)
    packet_mode = getattr(scene, 'packet_mode', 'flat')
    leaf_table = (packed.inst_tris if packet_mode == 'inst'
                  else packed.wide_tris_g)
    return SceneLayout(
        analytic, slots, _bucket(index),
        packet_mode=packet_mode,
        tlas_rows=getattr(scene, 'packet_tlas_rows', 0),
        wide_face_slots=int(leaf_table.shape[0]) * 8,
        has_skybox_texture=scene.root.skybox_texture is not None,
        materials_textured=bool(textured_set) or generic,
        textured_attrs=tuple(sorted(textured_set)),
        atlas_size=choose_atlas_size([t for t in scene.textures
                                      if t.pixels is not None]),
        texture_filter_modes=(True, True) if generic else _filter_modes(
            [t.enable_nearest_filtering for t in scene.textures
             if t.pixels is not None]),
        atlas_quad_fit=('quad' if packed.atlas_quad.shape[0] > 1 else
                        'pair' if packed.atlas_pair.shape[0] > 1 else False),
        has_opacity=generic or any(getattr(m, 'opacity', 1.0) < 1.0
                                   for m in scene.materials),
        material_types=tuple(sorted(mat_types)),
        scene_has_medium=generic or _types_have_medium(mat_types)
        or float(scene.root.scatter_rate) > 0.0,
        has_skybox_sampling=generic or float(
            scene.root.skybox_sampling_probability) > 0.0,
        has_transmissive=generic or _types_have_medium(mat_types),
    )


def make_hit(n, duration, device):
    """Fresh hit record SoA (scene.glsl.inc:522-528)."""
    return dict(
        time=torch.full((n,), float(duration), dtype=torch.float32, device=device),
        shape=torch.full((n,), SHAPE_INDEX_NONE, dtype=torch.int32, device=device),
        shape_type=torch.zeros((n,), dtype=torch.int32, device=device),
        primitive=torch.zeros((n,), dtype=torch.int32, device=device),
        # Shape-dependent primitive coordinates (local position).
        coords=torch.zeros((3, n), dtype=torch.float32, device=device),
        # Traversal-cost counter for the preview heatmaps (the reference's
        # SceneComplexity/MeshComplexity, scene.glsl.inc:115-118).
        complexity=torch.zeros((n,), dtype=torch.int32, device=device),
    )


# --- Analytic primitives (object space, scene.glsl.inc:401-466) ----------


def _where_small(x, eps):
    return torch.where(torch.abs(x) < eps, torch.full_like(x, eps), x)


def _intersect_plane(o, d, reach):
    t = -o[2] / _where_small(d[2], 1e-12)
    hit = (t >= 0.0) & (t <= reach)
    return torch.where(hit, t, torch.full_like(t, INFINITY))


def _intersect_sphere(o, d, reach):
    v = d[0] * d[0] + d[1] * d[1] + d[2] * d[2]
    p = o[0] * d[0] + o[1] * d[1] + o[2] * d[2]
    q = o[0] * o[0] + o[1] * o[1] + o[2] * o[2] - 1.0
    d2 = p * p - q * v
    ok = d2 >= 0.0
    # The correctly rounded float32 root, as sqrtf gives it on the card.
    # torch's float32 sqrt on the CPU misses the last bit on ~0.6% of
    # values, and on which ones depends on how a call splits its work
    # over threads: a ray could get another root from one call to the
    # next. The float64 root rounded to float32 is the exact one.
    sq = torch.sqrt(torch.clamp(d2, min=0.0).double()).float()
    ok &= sq >= p
    s0 = -p - sq
    s1 = -p + sq
    s = torch.where(s0 < 0.0, s1, s0)
    ok &= (s >= 0.0) & (s <= v * reach)
    return torch.where(ok, s / torch.clamp(v, min=1e-20),
                       torch.full_like(s, INFINITY))


def _intersect_cube(o, d, reach):
    entry = exit_ = None
    for c in range(3):
        inv = 1.0 / _where_small(d[c], 1e-12)
        t0 = (-1.0 - o[c]) * inv
        t1 = (+1.0 - o[c]) * inv
        lo, hi = torch.minimum(t0, t1), torch.maximum(t0, t1)
        entry = lo if entry is None else torch.maximum(entry, lo)
        exit_ = hi if exit_ is None else torch.minimum(exit_, hi)
    t = torch.where(entry < 0.0, exit_, entry)
    ok = (exit_ >= entry) & (exit_ > 0.0) & (t < reach)
    return torch.where(ok, t, torch.full_like(t, INFINITY))


_INTERSECTORS = {
    SHAPE_TYPE_PLANE: _intersect_plane,
    SHAPE_TYPE_SPHERE: _intersect_sphere,
    SHAPE_TYPE_CUBE: _intersect_cube,
}


# Counters of the analytic intersection (utils/profiling.py), kept while
# tracing is on: BVH nodes and shapes tested, summed over rays. On the
# card csrc/shape_trace.cu adds them itself; the dense path on the CPU
# tests every slot a ray and visits no node.
ANALYTIC_NODES = 'pt.trace.analytic.nodes'
ANALYTIC_TESTS = 'pt.trace.analytic.tests'


# Counters of the mesh traversal in 'inst' mode (utils/profiling.py),
# kept while tracing is on: BVH8 node rows popped, triangles tested and
# instances entered, summed over rays on the device. Each is a row of
# inst_trace's per-ray counters: while tracing, `trace` asks for them,
# which on the card launches the counting instantiation of
# csrc/trace_inst.cu; with tracing off it launches the timed one.
KERNEL_COUNTERS = {'pt.trace.kernel.rows': 0, 'pt.trace.kernel.tests': 4,
                   'pt.trace.kernel.instances': 3}


# Lanes of the attribute resolve by what they hit (utils/profiling.py),
# kept while tracing is on: on the card csrc/hit_attributes.cu adds them
# itself, and the plain version counts them on the host's side.
ATTRIBUTE_LANES = 'pt.trace.attributes.lanes'
ATTRIBUTE_BINS = ('miss', 'mesh', 'plane', 'sphere', 'cube')


def intersect_analytic(packed, layout: SceneLayout, origin, direction, hit):
    """Intersect all analytic shapes; the lowest slot of the first group
    wins ties, as in the JAX package.

    On a CUDA device, a layout with sphere or cube groups goes through
    csrc/shape_trace.cu (ops/trace_shapes.py): the planes one by one,
    then a BVH over the shapes' boxes, with this function's results to
    the bit except `complexity`, which counts the nodes and shapes the
    walk visited. Otherwise the shapes are tested as type-grouped dense
    (S, N) batches, every ray against every slot."""
    if not layout.analytic_buckets:
        return hit
    if origin.device.type == 'cuda' and any(
            t in (SHAPE_TYPE_SPHERE, SHAPE_TYPE_CUBE)
            for t, _ in layout.analytic_buckets):
        return trace_shapes.shape_trace(
            packed.plane_rows, packed.shape_rows, packed.shape_nodes,
            origin, direction, hit,
            stats=profiling.kernel_counts((ANALYTIC_NODES, ANALYTIC_TESTS),
                                          origin.device))
    if profiling.enabled():
        profiling.count(ANALYTIC_NODES, 0)
        profiling.count(ANALYTIC_TESTS, origin.shape[1] * sum(
            k for _, k in layout.analytic_buckets))
    return intersect_analytic_dense(packed, layout, origin, direction, hit)


def intersect_analytic_dense(packed, layout: SceneLayout, origin, direction,
                             hit):
    """The dense path of `intersect_analytic` on any device: each shape
    type's slots as one (S, N) batch, then the lowest slot of the first
    group among the rays' nearest."""
    if not layout.analytic_buckets:
        return hit
    reach = hit['time'][None, :]
    groups = []  # (stype, idx (S,), o (3,S,N), d (3,S,N), t (S,N))
    for stype, _k_pad in layout.analytic_buckets:
        idx = packed.analytic_idx[stype]
        valid = packed.analytic_valid[stype] > 0.0
        m = packed.shape_object_from_world[:, :, idx][..., None]  # (4, 4, S, 1)
        o = torch.stack([m[i, 0] * origin[0] + m[i, 1] * origin[1]
                         + m[i, 2] * origin[2] + m[i, 3] for i in range(3)], 0)
        d = torch.stack([m[i, 0] * direction[0] + m[i, 1] * direction[1]
                         + m[i, 2] * direction[2] for i in range(3)], 0)
        t = _INTERSECTORS[stype](o, d, reach)
        t = torch.where(valid[:, None], t, torch.full_like(t, INFINITY))
        groups.append((stype, idx, o, d, t))

    best_t = torch.amin(torch.cat([g[4] for g in groups], dim=0), dim=0)
    improved = best_t < hit['time']
    shape_idx = hit['shape']
    shape_type = hit['shape_type']
    local = hit['coords']
    for stype, idx, o, d, t in reversed(groups):
        for s in range(t.shape[0] - 1, -1, -1):
            win = improved & (t[s] == best_t)
            shape_idx = torch.where(win, idx[s].to(torch.int32), shape_idx)
            shape_type = torch.where(win, torch.full_like(shape_type, stype),
                                     shape_type)
            local = torch.where(win, o[:, s] + d[:, s] * best_t, local)
    return dict(
        time=torch.where(improved, best_t, hit['time']),
        shape=shape_idx,
        shape_type=shape_type,
        primitive=torch.where(improved, torch.zeros_like(hit['primitive']),
                              hit['primitive']),
        coords=local,
        # Every ray tests every (padded) slot of every group.
        complexity=hit['complexity'] + sum(k for _, k in layout.analytic_buckets),
    )


def _shape_row_tests(rows, origin, direction, reach):
    """Shape rows (G, 16) of scene/compile.py's pack_shape_tables against
    G world rays (3, G): (t, object-space o, d), with the dense path's
    per-type tests in its order of operations."""
    m = rows[:, :12].T.reshape(3, 4, -1)
    o = torch.stack([m[i, 0] * origin[0] + m[i, 1] * origin[1]
                     + m[i, 2] * origin[2] + m[i, 3] for i in range(3)], 0)
    d = torch.stack([m[i, 0] * direction[0] + m[i, 1] * direction[1]
                     + m[i, 2] * direction[2] for i in range(3)], 0)
    stype = rows[:, SHAPE_LANE_TYPE].round().to(torch.int32)
    t = torch.where(stype == SHAPE_TYPE_PLANE, _intersect_plane(o, d, reach),
                    torch.where(stype == SHAPE_TYPE_SPHERE,
                                _intersect_sphere(o, d, reach),
                                _intersect_cube(o, d, reach)))
    return t, o, d


def traverse_shape_bvh(packed, origin, direction, hit, stats=False):
    """The walk of csrc/shape_trace.cu in plain PyTorch, over all rays.

    Each ray tests the plane rows in order, then walks the BVH of
    `packed.shape_nodes` from its root row: one pop a ray an iteration,
    a pop dropped when the ray enters its box beyond min(best t, t_in) x
    CULL_SLACK; a node row pushes the children the ray enters at or
    before that distance (slab test (b - o) * inv), far first in its
    octant's order, and a leaf tests its shape row. The winner is the
    lexicographic minimum of (t, tie rank), kept where its t is below
    hit['time']. Returns the hit record as `intersect_analytic` does,
    with `complexity` grown by the nodes and shapes each ray visited;
    with `stats`, also the (2, N) per-ray node and test counts.
    """
    dev = origin.device
    n = origin.shape[1]
    planes, rows, nodes = packed.plane_rows, packed.shape_rows, packed.shape_nodes
    table = torch.cat([planes, rows], 0)
    n_planes = planes.shape[0]
    reach = hit['time']
    best = torch.full((n,), INFINITY, dtype=torch.float32, device=dev)
    best_rank = torch.full((n,), 2 ** 31 - 1, dtype=torch.int64, device=dev)
    best_row = torch.zeros(n, dtype=torch.int64, device=dev)
    counts = torch.zeros((2, n), dtype=torch.int64, device=dev)

    def consider(idx, row_ids):
        r = table[row_ids]
        t, _, _ = _shape_row_tests(r, origin[:, idx], direction[:, idx],
                                   reach[idx])
        rank = r[:, SHAPE_LANE_RANK].round().to(torch.int64)
        bt, br = best[idx], best_rank[idx]
        take = (t < bt) | ((t == bt) & (rank < br))
        best[idx] = torch.where(take, t, bt)
        best_rank[idx] = torch.where(take, rank, br)
        best_row[idx] = torch.where(take, row_ids, best_row[idx])
        counts[1, idx] += 1

    every = torch.arange(n, device=dev)
    for k in range(n_planes):
        consider(every, torch.full((n,), k, dtype=torch.int64, device=dev))

    inv = trace_inst.safe_inv(direction)
    neg = (direction < 0).to(torch.int64)
    octant = (neg[0] << 2) | (neg[1] << 1) | neg[2]
    stack = torch.zeros((n, SHAPE_STACK_DEPTH), dtype=torch.int64, device=dev)
    entered = torch.zeros((n, SHAPE_STACK_DEPTH), dtype=torch.float32, device=dev)
    sp = torch.ones(n, dtype=torch.int64, device=dev)

    def push(idx, value, entry, ok):
        ok = ok & (sp[idx] < SHAPE_STACK_DEPTH)
        at = idx[ok]
        stack[at, sp[at]] = value[ok]
        entered[at, sp[at]] = entry[ok]
        sp[at] += 1

    while True:
        act = torch.nonzero(sp > 0).squeeze(1)
        if act.numel() == 0:
            break
        sp[act] -= 1
        v = stack[act, sp[act]]
        e = entered[act, sp[act]]
        bt, rt = best[act], reach[act]
        limit = torch.where(bt < rt, bt, rt) * CULL_SLACK
        keep = e <= limit
        act, v, limit = act[keep], v[keep], limit[keep]

        leaf = v >= SHAPE_BASE
        if bool(leaf.any()):
            consider(act[leaf], n_planes + v[leaf] - SHAPE_BASE)
        inner = ~leaf
        if bool(inner.any()):
            idx, lim = act[inner], limit[inner]
            counts[0, idx] += 1
            row = nodes[v[inner]]
            o = origin[:, idx].T[:, :, None]
            iv = inv[:, idx].T[:, :, None]
            t0 = (row[:, 0:24].reshape(-1, 3, 8) - o) * iv
            t1 = (row[:, 24:48].reshape(-1, 3, 8) - o) * iv
            t_lo, t_hi = torch.minimum(t0, t1), torch.maximum(t0, t1)
            entry = torch.maximum(torch.maximum(t_lo[:, 0], t_lo[:, 1]), t_lo[:, 2])
            exit_ = torch.minimum(torch.minimum(t_hi[:, 0], t_hi[:, 1]), t_hi[:, 2])
            metas = row[:, bvh8.META_LANE:bvh8.META_LANE + 8].round().to(torch.int64)
            enters = ((exit_ >= entry) & (exit_ >= 0.0) & (entry <= lim[:, None])
                      & (metas != 0))
            order = row.gather(1, (bvh8.PERM_LANE + octant[idx])[:, None])[:, 0]
            order = order.round().to(torch.int64)
            for k in range(8):
                ch = ((order >> (3 * k)) & 7)[:, None]
                push(idx, metas.gather(1, ch)[:, 0], entry.gather(1, ch)[:, 0],
                     enters.gather(1, ch)[:, 0])

    improved = best < reach
    complexity = hit['complexity'] + counts.sum(0).to(hit['complexity'].dtype)
    if table.shape[0] == 0:
        out = dict(hit, complexity=complexity)
    else:
        row = table[best_row]
        _, o, d = _shape_row_tests(row, origin, direction, reach)
        out = dict(
            time=torch.where(improved, best, reach),
            shape=torch.where(improved, row[:, SHAPE_LANE_INDEX].round().to(torch.int32),
                              hit['shape']),
            shape_type=torch.where(
                improved, row[:, SHAPE_LANE_TYPE].round().to(torch.int32),
                hit['shape_type']),
            primitive=torch.where(improved, torch.zeros_like(hit['primitive']),
                                  hit['primitive']),
            coords=torch.where(improved, o + d * best, hit['coords']),
            complexity=complexity,
        )
    return (out, counts) if stats else out


# --- Portable mesh BVH2 traversal -------------------------------------------


def intersect_aabb(origin, inv_dir, reach, lo, hi):
    """Slab test (common.glsl.inc:153-185). origin/inv_dir/lo/hi: (3, N)
    or broadcastable. Returns the entry time, INFINITY on a miss."""
    entry = exit_ = None
    for c in range(3):
        t0 = (lo[c] - origin[c]) * inv_dir[c]
        t1 = (hi[c] - origin[c]) * inv_dir[c]
        near, far = torch.minimum(t0, t1), torch.maximum(t0, t1)
        entry = near if entry is None else torch.maximum(entry, near)
        exit_ = far if exit_ is None else torch.minimum(exit_, far)
    miss = (exit_ < entry) | (exit_ <= 0.0) | (entry >= reach)
    return torch.where(miss, torch.full_like(entry, INFINITY), entry)


def moller_trumbore(origin, direction, p0, p1, p2, t_max):
    """Moller-Trumbore triangle test (scene.glsl.inc:304-334). All
    inputs (3, N); returns (t, u, v, valid)."""
    e1 = p1 - p0
    e2 = p2 - p0
    pvec = cross(direction, e2)
    det = dot(e1, pvec)
    valid = torch.abs(det) >= EPSILON
    inv_det = 1.0 / torch.where(valid, det, torch.ones_like(det))
    s = origin - p0
    u = inv_det * dot(s, pvec)
    qvec = cross(s, e1)
    v = inv_det * dot(direction, qvec)
    t = inv_det * dot(e2, qvec)
    valid = (valid & (u >= 0.0) & (u <= 1.0) & (v >= 0.0) & (u + v <= 1.0)
             & (t >= 0.0) & (t <= t_max))
    return t, u, v, valid


def traverse_mesh_bvh(packed, root, origin, direction, hit, shape_index):
    """BVH2 traversal of one mesh instance over all rays, near child
    first (scene.glsl.inc:336-399).

    origin/direction: (3, N), already in the mesh's object space (the
    direction is not renormalized, so t stays in world units). Every ray
    owns a current node and an (N, STACK_DEPTH) stack; each iteration
    advances the rays that still have a node or a stack entry: a leaf
    tests its up to MAX_LEAF_FACES faces, an interior node descends into
    its nearer child and pushes the farther one. `root` may be the
    degenerate root of a padded instance slot, whose inverted bounds no
    ray enters. Returns the updated hit record; mesh hits carry their
    barycentrics in `coords` and the BVH2 face in `primitive`, and every
    ray's `complexity` grows by the nodes it visited (the iterations in
    which it held a node).
    """
    dev = origin.device
    n = origin.shape[1]
    inv_dir = 1.0 / torch.where(torch.abs(direction) < 1e-12,
                                torch.full_like(direction, 1e-12), direction)
    node_min, node_max = packed.mesh_node_min, packed.mesh_node_max  # (3, B)
    node_a, node_b = packed.mesh_node_a, packed.mesh_node_b
    face_pos = packed.face_positions          # (3 vertices, 3 components, F)

    time = hit['time'].clone()
    primitive = hit['primitive'].clone()
    u = hit['coords'][1].clone()
    v = hit['coords'][2].clone()
    found = torch.zeros(n, dtype=torch.bool, device=dev)
    complexity = hit['complexity'].clone()

    root = int(root)
    root_entry = intersect_aabb(origin, inv_dir, time,
                                node_min[:, root, None], node_max[:, root, None])
    node = torch.where(root_entry < INFINITY,
                       torch.full((n,), root, dtype=torch.int64, device=dev),
                       torch.full((n,), -1, dtype=torch.int64, device=dev))
    stack = torch.zeros((n, STACK_DEPTH), dtype=torch.int64, device=dev)
    depth = torch.zeros(n, dtype=torch.int64, device=dev)

    while True:
        act = torch.nonzero((node >= 0) | (depth > 0)).squeeze(1)
        if act.numel() == 0:
            break
        complexity[act] += 1
        cur, dep = node[act], depth[act]
        pop = cur < 0
        dep = torch.where(pop, dep - 1, dep)
        cur = torch.where(pop, stack[act, dep.clamp(max=STACK_DEPTH - 1)], cur)
        a = node_a[cur].to(torch.int64)
        b = node_b[cur].to(torch.int64)
        is_leaf = b > 0
        nxt = torch.full_like(cur, -1)

        if bool(is_leaf.any()):
            idx = act[is_leaf]
            first, end = a[is_leaf], b[is_leaf]
            o, d = origin[:, idx], direction[:, idx]
            tb, pb, ub, vb, fb = (time[idx], primitive[idx], u[idx], v[idx],
                                  found[idx])
            for k in range(MAX_LEAF_FACES):
                face = first + k
                face_ok = face < end
                face = torch.where(face_ok, face, torch.zeros_like(face))
                ft, fu, fv, valid = moller_trumbore(
                    o, d, face_pos[0][:, face], face_pos[1][:, face],
                    face_pos[2][:, face], tb)
                take = face_ok & valid & (ft < tb)
                tb = torch.where(take, ft, tb)
                pb = torch.where(take, face.to(pb.dtype), pb)
                ub = torch.where(take, fu, ub)
                vb = torch.where(take, fv, vb)
                fb = fb | take
            time[idx], primitive[idx], u[idx], v[idx], found[idx] = (
                tb, pb, ub, vb, fb)

        inner = ~is_leaf
        if bool(inner.any()):
            idx = act[inner]
            child_a = a[inner]
            child_b = child_a + 1
            o, inv, reach = origin[:, idx], inv_dir[:, idx], time[idx]
            ta = intersect_aabb(o, inv, reach, node_min[:, child_a],
                                node_max[:, child_a])
            tb = intersect_aabb(o, inv, reach, node_min[:, child_b],
                                node_max[:, child_b])
            a_first = ta <= tb
            near = torch.where(a_first, child_a, child_b)
            far = torch.where(a_first, child_b, child_a)
            t_near, t_far = torch.minimum(ta, tb), torch.maximum(ta, tb)
            nxt[inner] = torch.where(t_near < INFINITY, near,
                                     torch.full_like(near, -1))
            d_in = dep[inner]
            push = (t_far < INFINITY) & (d_in < STACK_DEPTH)
            stack[idx[push], d_in[push]] = far[push]
            dep[inner] = d_in + push.to(torch.int64)

        node[act], depth[act] = nxt, dep

    coords = torch.stack([1.0 - u - v, u, v], dim=0)
    return dict(
        time=torch.where(found, time, hit['time']),
        shape=torch.where(found, torch.full_like(hit['shape'], int(shape_index)),
                          hit['shape']),
        shape_type=torch.where(
            found, torch.full_like(hit['shape_type'], SHAPE_TYPE_MESH_INSTANCE),
            hit['shape_type']),
        primitive=torch.where(found, primitive, hit['primitive']),
        coords=torch.where(found, coords, hit['coords']),
        complexity=complexity,
    )


def resolve_hit_attributes(packed, layout: SceneLayout, origin, direction, hit):
    """World normal, tangent frame, UV and material of each hit
    (scene.glsl.inc:532-611). Mesh hits of the kernel paths carry their
    world normal and uv (hit['mesh_normal'], hit['mesh_uv']); those of
    the portable traversal carry barycentrics in `coords` and the face
    in `primitive`, and their vertex attributes are gathered here."""
    n = origin.shape[1]
    shape = hit['shape']
    valid = shape != SHAPE_INDEX_NONE
    safe_shape = torch.where(valid, shape, torch.zeros_like(shape))
    to_world = take_matrix(packed.shape_world_from_object, safe_shape)
    from_world = take_matrix(packed.shape_object_from_world, safe_shape)
    material = packed.shape_material[safe_shape]

    coords = hit['coords']
    stype = hit['shape_type']
    zeros = torch.zeros(n, dtype=torch.float32, device=origin.device)
    ones = torch.ones_like(zeros)
    if 'mesh_normal' in hit:
        mesh_normal_obj = None
        mesh_normal_world = hit['mesh_normal']
        mesh_uv = hit['mesh_uv']
    else:
        fv = packed.face_vertices[:, hit['primitive']]          # (3, N)
        n0, n1, n2 = (packed.vertex_normals[:, fv[k]] for k in range(3))
        mesh_normal_obj = safe_normalize(
            n0 * coords[0] + n1 * coords[1] + n2 * coords[2])
        uv0, uv1, uv2 = (packed.vertex_uvs[:, fv[k]] for k in range(3))
        mesh_uv = uv0 * coords[0] + uv1 * coords[1] + uv2 * coords[2]

    plane_normal_obj = vec3(zeros, zeros, ones)
    sphere_normal_obj = coords
    q = torch.abs(coords)
    cube_axis_x = (q[0] >= q[1]) & (q[0] >= q[2])
    cube_axis_y = ~cube_axis_x & (q[1] >= q[0]) & (q[1] >= q[2])
    sx = torch.sign(coords[0])
    sy = torch.sign(coords[1])
    sz = torch.sign(coords[2])
    cube_normal_obj = torch.where(
        cube_axis_x, vec3(sx, zeros, zeros),
        torch.where(cube_axis_y, vec3(zeros, sy, zeros), vec3(zeros, zeros, sz)))

    is_mesh = stype == SHAPE_TYPE_MESH_INSTANCE
    is_plane = stype == SHAPE_TYPE_PLANE
    is_sphere = stype == SHAPE_TYPE_SPHERE
    analytic_normal_obj = torch.where(
        is_plane, plane_normal_obj,
        torch.where(is_sphere, sphere_normal_obj, cube_normal_obj))
    if mesh_normal_obj is None:
        normal = torch.where(is_mesh, mesh_normal_world,
                             transform_normal(analytic_normal_obj, from_world))
    else:
        normal = transform_normal(
            torch.where(is_mesh, mesh_normal_obj, analytic_normal_obj),
            from_world)

    mesh_tangent = compute_tangent_vector(normal)
    plane_tangent_obj = vec3(ones, zeros, zeros)
    p = coords
    sphere_tangent_obj = cross(p, vec3(-p[1], p[0], zeros))
    cube_tangent_obj = torch.where(
        cube_axis_x, vec3(zeros, sx, zeros),
        torch.where(cube_axis_y, vec3(zeros, zeros, sy), vec3(sz, zeros, zeros)))
    analytic_tangent_obj = torch.where(
        is_plane, plane_tangent_obj,
        torch.where(is_sphere, sphere_tangent_obj, cube_tangent_obj))
    analytic_tangent = safe_normalize(transform_vector(to_world, analytic_tangent_obj))
    tangent = torch.where(is_mesh, mesh_tangent, analytic_tangent)
    bitangent = cross(normal, tangent)
    # Re-orthogonalize (non-uniform instance scales).
    tangent = safe_normalize(cross(bitangent, normal))
    bitangent = cross(normal, tangent)

    plane_uv = coords[:2] - torch.floor(coords[:2])
    sphere_uv = torch.stack([(torch.atan2(p[1], p[0]) + PI) / TAU,
                             (p[2] + 1.0) * 0.5], dim=0)
    cube_uv = torch.where(
        cube_axis_x, 0.5 * (1.0 + coords[1:3]),
        torch.where(cube_axis_y,
                    0.5 * (1.0 + torch.stack([coords[0], coords[2]], 0)),
                    0.5 * (1.0 + coords[0:2])))
    uv = torch.where(is_mesh, mesh_uv,
                     torch.where(is_plane, plane_uv,
                                 torch.where(is_sphere, sphere_uv, cube_uv)))

    if profiling.enabled():
        # Bin 0 the misses, then mesh, plane, sphere, cube.
        profiling.count(ATTRIBUTE_LANES,
                        torch.where(valid, stype + 1, torch.zeros_like(stype)),
                        bins=ATTRIBUTE_BINS)
    return dict(
        time=hit['time'],
        shape=hit['shape'],
        shape_type=stype,
        primitive=hit['primitive'],
        material=torch.where(valid, material, torch.zeros_like(material)),
        position=origin + direction * hit['time'],
        normal=normal,
        tangent=tangent,
        bitangent=bitangent,
        uv=uv,
        complexity=hit.get('complexity', torch.zeros(
            n, dtype=torch.int32, device=origin.device)),
    )


def resolve_attributes(packed, layout: SceneLayout, origin, direction, hit,
                       winners=None):
    """The resolved hit record of `trace`: the mesh kernel's `winners` in
    lane order ((t, face, fu, fv, inst) in 'inst' mode, (t, face, fu, fv)
    in 'flat'; None where no mesh kernel ran: the portable traversal's
    mesh hits carry barycentrics) merged into `hit`, then the attributes
    of resolve_hit_attributes. On a CUDA device one launch of
    csrc/hit_attributes.cu (ops/hit_attributes.py), which adds the
    ATTRIBUTE_LANES counter itself while tracing is on; on the CPU the
    plain version, `resolve_attributes_plain`."""
    if origin.device.type == 'cuda':
        return hit_attributes.hit_attributes(
            packed, layout, origin, direction, hit, winners,
            stats=profiling.kernel_counts(ATTRIBUTE_LANES, origin.device,
                                          bins=ATTRIBUTE_BINS))
    return resolve_attributes_plain(packed, layout, origin, direction, hit,
                                    winners)


def resolve_attributes_plain(packed, layout: SceneLayout, origin, direction,
                             hit, winners=None):
    """`resolve_attributes` in plain PyTorch on any device: each winner
    whose face is set replaces the lane's hit, with its attribute row's
    normal (normalized) and uv, then resolve_hit_attributes."""
    if winners is None:
        return resolve_hit_attributes(packed, layout, origin, direction, hit)
    if layout.packet_mode == 'inst':
        t, face, fu, fv, inst = winners
        normal, uv, shp = trace_inst.resolve_inst_attributes(
            packed.inst_attrs, packed.inst_aux, face, fu, fv, inst,
            n_instances=layout.instance_slots)
    else:
        t, face, fu, fv = winners
        normal, uv, shp = trace_packet.resolve_wide_attributes(
            packed.wide_attrs, face, fu, fv)
    improved = face >= 0
    hit = dict(
        time=torch.where(improved, t, hit['time']),
        shape=torch.where(improved, shp, hit['shape']),
        shape_type=torch.where(
            improved,
            torch.full_like(hit['shape_type'], SHAPE_TYPE_MESH_INSTANCE),
            hit['shape_type']),
        # Face slot into the trace tables.
        primitive=torch.where(improved, face, hit['primitive']),
        coords=hit['coords'],
        # The kernels' own per-ray counters are not read here: no render
        # round launches the counting instantiation (nor does the JAX
        # package's trace). viewer/preview.py reads them.
        complexity=hit['complexity'],
        mesh_normal=torch.where(improved, safe_normalize(normal),
                                torch.zeros_like(normal)),
        mesh_uv=torch.where(improved, uv, torch.zeros_like(uv)),
    )
    return resolve_hit_attributes(packed, layout, origin, direction, hit)


def trace(packed, layout: SceneLayout, origin, direction,
          duration=HIT_TIME_LIMIT, use_packet=None):
    """Full trace: intersect every shape, resolve hit attributes.

    origin/direction: (3, N). Returns the resolved hit SoA dict; lanes
    that hit nothing have shape == SHAPE_INDEX_NONE and time == duration.

    use_packet None or True: mesh instances go through the kernel of
    the layout's packet mode in one call for all instances
    (ops.trace_inst.inst_trace in 'inst' mode, ops.trace_packet.
    wide_trace5 in 'flat' mode); there is no table budget on the card
    that could rule the kernel out; it takes the rays in lane order.
    use_packet False: the portable BVH2 traversal, one instance slot
    after the other.
    """
    with profiling.span('pt.trace'):
        n = origin.shape[1]
        hit = make_hit(n, duration, origin.device)
        with profiling.span('pt.trace.analytic'):
            hit = intersect_analytic(packed, layout, origin, direction, hit)

        if layout.instance_slots and use_packet in (None, True):
            with profiling.span('pt.trace.kernel'):
                if layout.packet_mode == 'inst':
                    counting = profiling.enabled()
                    out = trace_inst.inst_trace(
                        packed.inst_nodes, packed.inst_tris, packed.inst_rows,
                        origin, direction, hit['time'],
                        tlas_rows=layout.tlas_rows, stats=counting)
                    if counting:
                        *out, per_ray = out
                        for name, row in KERNEL_COUNTERS.items():
                            profiling.count(name, per_ray[row])
                else:
                    out = trace_packet.wide_trace5(
                        packed.wide_nodes_g, packed.wide_tris_g, origin,
                        direction, hit['time'])
            with profiling.span('pt.trace.attributes'):
                return resolve_attributes(packed, layout, origin, direction,
                                          hit, out)

        # The portable traversal. Padded slots point at the degenerate
        # root, which no ray enters.
        for k in range(layout.instance_slots):
            shape_index = int(packed.portable_inst_shape[k])
            from_world = packed.shape_object_from_world[:, :, shape_index]
            hit = traverse_mesh_bvh(
                packed, int(packed.portable_inst_root[k]),
                transform_point(from_world, origin),
                transform_vector(from_world, direction), hit, shape_index)
        with profiling.span('pt.trace.attributes'):
            return resolve_attributes(packed, layout, origin, direction, hit)
