# Frozen copy of path_tracer_tpu_torch/ops/intersect.py, part of the benchmark's
# plain reference: not kept in step with the program.
"""Ray-scene intersection: analytic primitives and hit attribute
resolution (the program's ops/intersect.py without its traversals; the
reference's mesh trace is reference/trace.py)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch

from ..core.constants import (
    EPSILON,
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
    transform_vector,
    vec3,
)


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
    has_opacity: bool = False
    packet_mode: str = 'flat'
    material_types: Tuple[int, ...] = ()
    scene_has_medium: bool = True
    has_skybox_sampling: bool = True
    has_transmissive: bool = True

    @staticmethod
    def from_packed(packed):
        """The layout compile_scene attached to `packed`."""
        layout = getattr(packed, 'host_layout', None)
        if layout is None:
            raise ValueError('packed has no host_layout: build it with '
                             'compile_scene')
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
    return SceneLayout(
        analytic, slots, _bucket(index),
        packet_mode=packet_mode,
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
        # Every ray tests every (padded) slot of every group.
        complexity=hit['complexity'] + sum(k for _, k in layout.analytic_buckets),
    )


# --- Portable mesh BVH2 traversal -------------------------------------------


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

