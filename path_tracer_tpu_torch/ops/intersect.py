"""Ray-scene intersection: analytic primitives, the instanced mesh trace,
hit attribute resolution.

Port of the parts of path_tracer_tpu/ops/intersect.py that the main path
runs (behavioral reference: reference src/scene/scene.glsl.inc:
304-611). Analytic shapes are intersected as dense (S, N) batches per
shape type; mesh instances go through the two-level BVH8 traversal of
ops/trace_inst.py ('inst' packet mode, the mode compile.py picks for
every scene with a mesh). The portable BVH2 traversal of the JAX
package is not ported yet (ROADMAP.md), so a mesh scene compiled in
another mode raises.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch

from ..core.constants import (
    HIT_TIME_LIMIT,
    INFINITY,
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
    safe_normalize,
    take_matrix,
    transform_normal,
    transform_vector,
    vec3,
)
from . import trace_inst


def ray_sort_key(packed, origin, direction):
    """Coherence key: 3-bit direction octant (major), 15-bit Morton cell
    of the origin within the scene bounds, then a 12-bit direction
    Morton as the low-order tie-break (the JAX package's key, bit for
    bit). On the GPU it groups rays that pop the same BVH rows into the
    same warps."""
    lo = packed.scene_bounds[:, 0]
    hi = packed.scene_bounds[:, 1]
    span = torch.clamp(hi - lo, min=1e-6)
    q = torch.clamp((origin - lo[:, None]) / span[:, None], 0.0, 1.0)
    cells = (q * 31.0).to(torch.int32)
    morton = torch.zeros_like(cells[0])
    for b in range(5):
        morton = (morton
                  | (((cells[0] >> b) & 1) << (3 * b + 2))
                  | (((cells[1] >> b) & 1) << (3 * b + 1))
                  | (((cells[2] >> b) & 1) << (3 * b)))
    neg = (direction < 0).to(torch.int32)
    octant = (neg[0] << 2) | (neg[1] << 1) | neg[2]
    dcells = torch.clamp((direction + 1.0) * (0.5 * 15.0), 0.0, 15.0).to(torch.int32)
    dmorton = torch.zeros_like(dcells[0])
    for b in range(4):
        dmorton = (dmorton
                   | (((dcells[0] >> b) & 1) << (3 * b + 2))
                   | (((dcells[1] >> b) & 1) << (3 * b + 1))
                   | (((dcells[2] >> b) & 1) << (3 * b)))
    return (((octant << 15) | morton) << 12) | dmorton


@dataclass(frozen=True)
class SceneLayout:
    """Static scene structure, built on the host from the scene document
    (compile_scene attaches it as packed.host_layout). Fields as in the
    JAX package's SceneLayout, minus its TPU-budget gates (wide_fit,
    inst_fit) and the v5 table size."""

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
    package's build_layout_host for specialized programs; the generic
    programs of interactive sessions are not ported)."""
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
    analytic = tuple(sorted((t, len(idxs)) for t, idxs in by_type.items()))
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
    return SceneLayout(
        analytic, slots, _bucket(index),
        packet_mode=getattr(scene, 'packet_mode', 'flat'),
        tlas_rows=getattr(scene, 'packet_tlas_rows', 0),
        has_skybox_texture=scene.root.skybox_texture is not None,
        materials_textured=bool(textured_set),
        textured_attrs=tuple(sorted(textured_set)),
        atlas_size=choose_atlas_size([t for t in scene.textures
                                      if t.pixels is not None]),
        texture_filter_modes=_filter_modes(
            [t.enable_nearest_filtering for t in scene.textures
             if t.pixels is not None]),
        atlas_quad_fit=('quad' if packed.atlas_quad.shape[0] > 1 else
                        'pair' if packed.atlas_pair.shape[0] > 1 else False),
        has_opacity=any(getattr(m, 'opacity', 1.0) < 1.0
                        for m in scene.materials),
        material_types=tuple(sorted(mat_types)),
        scene_has_medium=_types_have_medium(mat_types)
        or float(scene.root.scatter_rate) > 0.0,
        has_skybox_sampling=float(scene.root.skybox_sampling_probability) > 0.0,
        has_transmissive=_types_have_medium(mat_types),
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
    sq = torch.sqrt(torch.clamp(d2, min=0.0))
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


def intersect_analytic(packed, layout: SceneLayout, origin, direction, hit):
    """Intersect all analytic shapes as type-grouped (S, N) batches; the
    lowest slot of the first group wins ties, as in the JAX package."""
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
    )


def resolve_hit_attributes(packed, layout: SceneLayout, origin, direction, hit):
    """World normal, tangent frame, UV and material of each hit
    (scene.glsl.inc:532-611). Mesh hits carry their world normal and uv
    from the instanced trace (hit['mesh_normal'], hit['mesh_uv'])."""
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
    mesh_normal_world = hit.get('mesh_normal', torch.zeros_like(origin))
    mesh_uv = hit.get('mesh_uv', torch.zeros((2, n), device=origin.device))

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
    normal = torch.where(is_mesh, mesh_normal_world,
                         transform_normal(analytic_normal_obj, from_world))

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
    )


def _permute(perm, *rows):
    return [r[..., perm] for r in rows]


def _unpermute(perm, *rows):
    """Inverse of _permute by a scatter: out[..., perm] = row."""
    outs = []
    for r in rows:
        out = torch.empty_like(r)
        out[..., perm] = r
        outs.append(out)
    return outs


def trace(packed, layout: SceneLayout, origin, direction,
          duration=HIT_TIME_LIMIT, sort_rays=False):
    """Full trace: intersect every shape, resolve hit attributes.

    origin/direction: (3, N). Returns the resolved hit SoA dict; lanes
    that hit nothing have shape == SHAPE_INDEX_NONE and time == duration.

    Mesh instances go through ops.trace_inst.inst_trace in one call for
    all instances. sort_rays=True feeds it rays in ray_sort_key order
    (a stable argsort) and scatters its outputs back to lane order: the
    results do not change, only which rays share a warp.
    """
    n = origin.shape[1]
    hit = make_hit(n, duration, origin.device)
    hit = intersect_analytic(packed, layout, origin, direction, hit)

    if layout.instance_slots:
        if layout.packet_mode != 'inst':
            raise NotImplementedError(
                'mesh scenes trace only through the instanced tables '
                "(packet_mode 'inst'); the portable BVH2 traversal is "
                'queued in ROADMAP.md (Queue 1)')
        k_origin, k_direction, k_tin = origin, direction, hit['time']
        if sort_rays:
            perm = torch.argsort(ray_sort_key(packed, origin, direction),
                                 stable=True)
            k_origin, k_direction, k_tin = _permute(perm, origin, direction,
                                                    hit['time'])
            k_origin, k_direction = k_origin.contiguous(), k_direction.contiguous()
        t, face, fu, fv, inst = trace_inst.inst_trace(
            packed.inst_nodes, packed.inst_tris, packed.inst_rows,
            k_origin, k_direction, k_tin.contiguous(),
            tlas_rows=layout.tlas_rows)
        if sort_rays:
            t, face, fu, fv, inst = _unpermute(perm, t, face, fu, fv, inst)
        normal, uv, shp = trace_inst.resolve_inst_attributes(
            packed.inst_attrs, packed.inst_aux, face, fu, fv, inst,
            n_instances=layout.instance_slots)
        improved = face >= 0
        hit = dict(
            time=torch.where(improved, t, hit['time']),
            shape=torch.where(improved, shp, hit['shape']),
            shape_type=torch.where(
                improved, torch.full_like(hit['shape_type'], SHAPE_TYPE_MESH_INSTANCE),
                hit['shape_type']),
            # Face slot into the instanced tables.
            primitive=torch.where(improved, face, hit['primitive']),
            coords=hit['coords'],
            mesh_normal=torch.where(improved, safe_normalize(normal),
                                    torch.zeros_like(normal)),
            mesh_uv=torch.where(improved, uv, torch.zeros_like(uv)),
        )
    return resolve_hit_attributes(packed, layout, origin, direction, hit)
