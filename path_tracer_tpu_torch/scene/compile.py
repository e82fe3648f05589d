"""Scene compiler: flatten the scene document into padded tensors.

Port of path_tracer_tpu/scene/compile.py. The compile runs on the host
in numpy exactly as the JAX package's does (same bucketing, same BVH
builders, same table layouts), and only its last step differs: the
arrays become a `PackedScene` dataclass of torch tensors on the
requested device instead of a JAX pytree.

A recompile from a previous PackedScene (`compile_scene(scene, prev)`)
follows the JAX package's dirty-flag cascade (PackSceneData,
scene.cpp:1115-1621): each stage whose flag is set is recomputed in
numpy and moved to the device, and every other stage reuses `prev`'s
tensors as they are. The per-mesh wide-table memo makes a shape-stage
recompile skip the BVH builds of unchanged meshes.

Not carried over from the JAX compile (see ROADMAP.md): the VMEM-driven
leaf-row reorder (`_order_streamed_leaf_rows`); it permutes leaf rows by
a TPU residency heuristic and changes no hit.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from ..core.constants import (
    CAMERA_MODEL_PINHOLE,
    CAMERA_MODEL_THIN_LENS,
    MATERIAL_TYPE_BASIC_DIFFUSE,
    MATERIAL_TYPE_BASIC_METAL,
    MATERIAL_TYPE_BASIC_TRANSLUCENT,
    MATERIAL_TYPE_OPENPBR,
    SHAPE_TYPE_CUBE,
    SHAPE_TYPE_MESH_INSTANCE,
    SHAPE_TYPE_NONE,
    SHAPE_TYPE_PLANE,
    SHAPE_TYPE_SPHERE,
    TEXTURE_INDEX_NONE,
)
from ..core import uplift
from ..utils import log
from . import atlas as atlas_mod
from . import bvh as bvh_mod
from . import bvh8
from .model import (
    ENTITY_TYPE_CAMERA,
    ENTITY_TYPE_CUBE,
    ENTITY_TYPE_MESH_INSTANCE,
    ENTITY_TYPE_PLANE,
    ENTITY_TYPE_SPHERE,
    SCENE_DIRTY_ALL,
    SCENE_DIRTY_CAMERAS,
    SCENE_DIRTY_GLOBALS,
    SCENE_DIRTY_MATERIALS,
    SCENE_DIRTY_MESHES,
    SCENE_DIRTY_SHAPES,
    SCENE_DIRTY_SKYBOX_TEXTURE,
    SCENE_DIRTY_TEXTURES,
    OpenPBRMaterial,
    Scene,
)

_ENTITY_TO_SHAPE_TYPE = {
    ENTITY_TYPE_MESH_INSTANCE: SHAPE_TYPE_MESH_INSTANCE,
    ENTITY_TYPE_PLANE: SHAPE_TYPE_PLANE,
    ENTITY_TYPE_SPHERE: SHAPE_TYPE_SPHERE,
    ENTITY_TYPE_CUBE: SHAPE_TYPE_CUBE,
}


def _bucket(n, lo=4):
    """Pad a variable table dimension to the next power of two (minimum
    `lo`), as the JAX compile does; padded rows are inert."""
    n = max(int(n), 1)
    return max(lo, 1 << (n - 1).bit_length())


def _bucket_rows(n, lo=64):
    """Row bucket for the big geometry/node tables: next multiple of an
    eighth-of-magnitude quantum (<= 12.5% overhead)."""
    n = max(int(n), 1)
    q = max(lo, 1 << max((n - 1).bit_length() - 3, 0))
    return -(-n // q) * q


def _pad_rows(a, target, fill=0):
    """`a` padded along axis 0 to `target` rows of `fill`."""
    extra = target - len(a)
    if extra <= 0:
        return a
    return np.concatenate([a, np.full((extra,) + a.shape[1:], fill, a.dtype)])


def _to_device(value, device):
    if isinstance(value, dict):
        return {k: _to_device(v, device) for k, v in value.items()}
    if dataclasses.is_dataclass(value):
        return value.to(device)
    return value.to(device)


@dataclass
class MaterialTable:
    """Column-oriented material attribute table (SoA over materials).
    Slot 0 is the fallback OpenPBR material; spectra are (3, M)."""

    type: Any
    opacity: Any
    base_spectrum: Any
    base_texture: Any
    specular_spectrum: Any
    specular_texture: Any
    roughness: Any
    roughness_texture: Any
    roughness_anisotropy: Any
    roughness_anisotropy_texture: Any
    ior: Any
    abbe_number: Any
    transmission_spectrum: Any
    transmission_depth: Any
    scattering_spectrum: Any
    scattering_anisotropy: Any
    base_weight: Any
    base_metalness: Any
    base_diffuse_roughness: Any
    specular_weight: Any
    specular_ior: Any
    transmission_weight: Any
    transmission_scatter_spectrum: Any
    transmission_scatter_anisotropy: Any
    transmission_dispersion_abbe: Any
    coat_weight: Any
    coat_spectrum: Any
    coat_ior: Any
    coat_roughness: Any
    coat_roughness_anisotropy: Any
    coat_darkening: Any
    emission_spectrum: Any
    emission_texture: Any
    emission_luminance: Any
    layer_bounce_limit: Any

    def to(self, device):
        return MaterialTable(**{f.name: getattr(self, f.name).to(device)
                                for f in dataclasses.fields(self)})


@dataclass
class PackedScene:
    """Flattened scene as tensors: the contract between the compiler and
    the integrator. Field meanings and layouts are those of the JAX
    package's PackedScene."""

    shape_type: Any               # (S,) int32
    shape_material: Any           # (S,) int32
    shape_mesh_root: Any          # (S,) int32
    shape_world_from_object: Any  # (4, 4, S) float32
    shape_object_from_world: Any  # (4, 4, S) float32
    analytic_idx: Any             # {shape_type: (K,) int32}
    analytic_valid: Any           # {shape_type: (K,) float32}
    portable_inst_shape: Any      # (max(slots,1),) int32
    portable_inst_root: Any       # (max(slots,1),) int32
    scene_bounds: Any             # (3, 2) float32
    face_positions: Any           # (3, 3, F)
    face_vertices: Any            # (3, F) int32
    vertex_normals: Any           # (3, V)
    vertex_uvs: Any               # (2, V)
    mesh_node_min: Any            # (3, B)
    mesh_node_max: Any            # (3, B)
    mesh_node_a: Any              # (B,) int32
    mesh_node_b: Any              # (B,) int32
    wide_nodes: Any               # (W, 128) float32 flat BVH8, v3 kernel
    wide_tris: Any                # (R, 128) float32 4 tris/row + attributes
    wide_nodes_g: Any             # (W, 128) float32 flat BVH8, v5 kernel
    wide_tris_g: Any              # (Rg, 128) float32 8 tris/row, geometry
    wide_attrs: Any               # (Rg*8, 16) float32 attribute side table
    wide_face_map: Any            # (Rg*8,) int32 slot -> world face, -1 pad
    inst_nodes: Any               # (W, 128) float32 [TLAS | mesh nodes]
    inst_tris: Any                # (R, 128) float32 object-space leaves
    inst_attrs: Any               # (R*8, 16) float32
    inst_face_map: Any            # (R*8,) int32
    inst_rows: Any                # (I, 128) float32 inv 3x4 + mesh root
    inst_aux: Any                 # (I, 16) float32 inv 3x3 + shape index
    # The analytic shapes' tables of ops/trace_shapes.py (pack_shape_tables).
    plane_rows: Any               # (P, 16) float32 valid plane slots
    shape_rows: Any               # (B, 16) float32 valid sphere, cube slots
    shape_nodes: Any              # (W, 128) float32 BVH8 over their boxes
    materials: MaterialTable
    camera_model: Any             # (C,) int32
    camera_focal_length: Any      # (C,)
    camera_aperture_radius: Any   # (C,)
    camera_sensor_distance: Any   # (C,)
    camera_sensor_size: Any       # (C, 2)
    camera_world_from_camera: Any  # (C, 4, 4)
    atlas: Any                    # (L*A*A, 4) float32
    atlas_quad: Any               # (L*A*A, 16) float32 or (1, 16)
    atlas_pair: Any               # (L*A*A, 8) bfloat16 or (1, 8)
    atlas_layers: Any             # () int32
    atlas_size: Any               # () int32
    texture_placement_min: Any    # (2, T)
    texture_placement_max: Any    # (2, T)
    texture_layer: Any            # (T,) int32
    texture_flags: Any            # (T,) int32
    texture_meta: Any             # (T, 8) float32
    skybox_mean_direction: Any    # (3,)
    skybox_concentration: Any     # ()
    skybox_sampling_probability: Any  # ()
    skybox_brightness: Any        # ()
    skybox_texture_index: Any     # () int32
    scene_scatter_rate: Any       # ()

    def to(self, device):
        """A copy with every tensor on `device`; host metadata is kept."""
        out = PackedScene(**{f.name: _to_device(getattr(self, f.name), device)
                             for f in dataclasses.fields(self)})
        for attr in ('host_layout', 'host_camera_models'):
            if hasattr(self, attr):
                setattr(out, attr, getattr(self, attr))
        return out


def _tensor(value, device):
    """numpy -> torch on `device` (read-only or strided arrays are copied)."""
    return torch.from_numpy(np.require(value, requirements=('C', 'W'))).to(device)


def _uplift(color, table):
    return uplift.rgb_to_coefficients(np.asarray(color, np.float32), table)


def _texture_index(texture):
    if texture is None or texture.packed_texture_index < 0:
        return TEXTURE_INDEX_NONE
    return texture.packed_texture_index


def _pack_materials(scene: Scene, table):
    """Material columns as numpy, channels-first. Slot 0 = fallback OpenPBR."""
    mats = [OpenPBRMaterial()] + list(scene.materials)
    m_real = len(mats)
    m = _bucket(m_real)

    def zeros(shape=(), dtype=np.float32):
        return np.zeros((m,) + shape, dtype)

    def none_index():
        return np.full(m, TEXTURE_INDEX_NONE, np.int32)

    cols = dict(
        type=zeros(dtype=np.int32), opacity=zeros(),
        base_spectrum=zeros((3,)), base_texture=none_index(),
        specular_spectrum=zeros((3,)), specular_texture=none_index(),
        roughness=zeros(), roughness_texture=none_index(),
        roughness_anisotropy=zeros(),
        roughness_anisotropy_texture=none_index(),
        ior=np.full(m, 1.5, np.float32), abbe_number=np.full(m, 20.0, np.float32),
        transmission_spectrum=zeros((3,)), transmission_depth=zeros(),
        scattering_spectrum=zeros((3,)), scattering_anisotropy=zeros(),
        base_weight=zeros(), base_metalness=zeros(), base_diffuse_roughness=zeros(),
        specular_weight=zeros(), specular_ior=np.full(m, 1.5, np.float32),
        transmission_weight=zeros(), transmission_scatter_spectrum=zeros((3,)),
        transmission_scatter_anisotropy=zeros(),
        transmission_dispersion_abbe=np.full(m, 20.0, np.float32),
        coat_weight=zeros(), coat_spectrum=zeros((3,)),
        coat_ior=np.full(m, 1.6, np.float32), coat_roughness=zeros(),
        coat_roughness_anisotropy=zeros(), coat_darkening=zeros(),
        emission_spectrum=zeros((3,)),
        emission_texture=none_index(),
        emission_luminance=zeros(),
        layer_bounce_limit=np.full(m, 16, np.int32),
    )

    for i, mat in enumerate(mats):
        cols['type'][i] = mat.type
        cols['opacity'][i] = mat.opacity
        t = mat.type
        if t == MATERIAL_TYPE_BASIC_DIFFUSE:
            cols['base_spectrum'][i] = _uplift(mat.base_color, table)
            cols['base_texture'][i] = _texture_index(mat.base_texture)
        elif t == MATERIAL_TYPE_BASIC_METAL:
            cols['base_spectrum'][i] = _uplift(mat.base_color, table)
            cols['base_texture'][i] = _texture_index(mat.base_texture)
            cols['specular_spectrum'][i] = _uplift(mat.specular_color, table)
            cols['specular_texture'][i] = _texture_index(mat.specular_texture)
            cols['roughness'][i] = mat.roughness
            cols['roughness_texture'][i] = _texture_index(mat.roughness_texture)
            cols['roughness_anisotropy'][i] = mat.roughness_anisotropy
            cols['roughness_anisotropy_texture'][i] = _texture_index(mat.roughness_anisotropy_texture)
        elif t == MATERIAL_TYPE_BASIC_TRANSLUCENT:
            cols['ior'][i] = mat.ior
            cols['abbe_number'][i] = mat.abbe_number
            cols['roughness'][i] = mat.roughness
            cols['roughness_texture'][i] = _texture_index(mat.roughness_texture)
            cols['roughness_anisotropy'][i] = mat.roughness_anisotropy
            cols['roughness_anisotropy_texture'][i] = _texture_index(mat.roughness_anisotropy_texture)
            cols['transmission_spectrum'][i] = _uplift(mat.transmission_color, table)
            cols['transmission_depth'][i] = mat.transmission_depth
            cols['scattering_spectrum'][i] = _uplift(mat.scattering_color, table)
            cols['scattering_anisotropy'][i] = mat.scattering_anisotropy
        elif t == MATERIAL_TYPE_OPENPBR:
            cols['base_weight'][i] = mat.base_weight
            cols['base_spectrum'][i] = _uplift(mat.base_color, table)
            cols['base_texture'][i] = _texture_index(mat.base_color_texture)
            cols['base_metalness'][i] = mat.base_metalness
            cols['base_diffuse_roughness'][i] = mat.base_diffuse_roughness
            cols['specular_weight'][i] = mat.specular_weight
            cols['specular_spectrum'][i] = _uplift(mat.specular_color, table)
            cols['specular_ior'][i] = mat.specular_ior
            cols['roughness'][i] = mat.specular_roughness
            cols['roughness_texture'][i] = _texture_index(mat.specular_roughness_texture)
            cols['roughness_anisotropy'][i] = mat.specular_roughness_anisotropy
            cols['transmission_weight'][i] = mat.transmission_weight
            cols['transmission_spectrum'][i] = _uplift(mat.transmission_color, table)
            cols['transmission_depth'][i] = mat.transmission_depth
            cols['transmission_scatter_spectrum'][i] = _uplift(mat.transmission_scatter, table)
            cols['transmission_scatter_anisotropy'][i] = mat.transmission_scatter_anisotropy
            # abbe/scale as in openpbr.hpp:120; 0 scale disables dispersion.
            scale = mat.transmission_dispersion_scale
            cols['transmission_dispersion_abbe'][i] = (
                mat.transmission_dispersion_abbe_number / scale if scale > 0 else 1e9)
            cols['coat_weight'][i] = mat.coat_weight
            cols['coat_spectrum'][i] = _uplift(mat.coat_color, table)
            cols['coat_ior'][i] = mat.coat_ior
            cols['coat_roughness'][i] = mat.coat_roughness
            cols['coat_roughness_anisotropy'][i] = mat.coat_roughness_anisotropy
            cols['coat_darkening'][i] = mat.coat_darkening
            cols['emission_spectrum'][i] = _uplift(mat.emission_color, table)
            cols['emission_texture'][i] = _texture_index(mat.emission_color_texture)
            cols['emission_luminance'][i] = mat.emission_luminance
            cols['layer_bounce_limit'][i] = mat.layer_bounce_limit
        mat.packed_material_index = i

    # Padded slots read as fully opaque (the has_opacity layout flag).
    cols['opacity'][m_real:] = 1.0
    return {k: np.ascontiguousarray(v.T) if v.ndim == 2 else v
            for k, v in cols.items()}


def _pack_meshes(scene: Scene):
    """Concatenate mesh geometry with globally rebased indices (the BVH2
    tables of the portable traversal; scene.cpp:1266-1343)."""
    face_positions, face_vertices = [], []
    vertex_normals, vertex_uvs = [], []
    node_min, node_max, node_a, node_b = [], [], [], []
    vertex_base = face_base = node_base = 0

    for mesh in scene.meshes:
        if mesh.bvh is None:
            with log.timer('compile.bvh', tables='portable', faces=len(mesh.faces)):
                mesh.bvh = bvh_mod.build_bvh_cached(mesh.positions[mesh.faces])
        bvh = mesh.bvh
        faces = mesh.faces[bvh.face_order]

        face_positions.append(mesh.positions[faces])
        face_vertices.append(faces.astype(np.int32) + vertex_base)
        vertex_normals.append(mesh.normals)
        vertex_uvs.append(mesh.uvs)

        is_leaf = bvh.b > 0
        node_min.append(bvh.node_min)
        node_max.append(bvh.node_max)
        node_a.append(np.where(is_leaf, bvh.a + face_base, bvh.a + node_base).astype(np.int32))
        node_b.append(np.where(is_leaf, bvh.b + face_base, 0).astype(np.int32))

        mesh.packed_root_node_index = node_base
        vertex_base += len(mesh.positions)
        face_base += len(faces)
        node_base += len(bvh.a)

    # One degenerate node (inverted bounds): the root of padded
    # portable-instance slots.
    node_min.append(np.full((1, 3), 1e30, np.float32))
    node_max.append(np.full((1, 3), -1e30, np.float32))
    node_a.append(np.zeros(1, np.int32))
    node_b.append(np.zeros(1, np.int32))
    scene.packed_degenerate_root = node_base
    node_base += 1

    def cat(parts, empty_shape, dtype=np.float32):
        if parts:
            return np.concatenate(parts).astype(dtype)
        return np.zeros(empty_shape, dtype)

    def pad0(a, target):
        extra = target - len(a)
        if extra <= 0:
            return a
        return np.concatenate([a, np.zeros((extra,) + a.shape[1:], a.dtype)])

    faces_cat = pad0(cat(face_positions, (1, 3, 3)), _bucket_rows(max(face_base, 1)))
    fverts_cat = pad0(cat(face_vertices, (1, 3), np.int32), _bucket_rows(max(face_base, 1)))
    vn_cat = pad0(cat(vertex_normals, (1, 3)), _bucket_rows(max(vertex_base, 1)))
    vu_cat = pad0(cat(vertex_uvs, (1, 2)), _bucket_rows(max(vertex_base, 1)))
    nodes_target = _bucket_rows(node_base)
    return dict(
        face_positions=faces_cat.transpose(1, 2, 0),
        face_vertices=fverts_cat.T,
        vertex_normals=vn_cat.T,
        vertex_uvs=vu_cat.T,
        mesh_node_min=pad0(cat(node_min, (1, 3)), nodes_target).T,
        mesh_node_max=pad0(cat(node_max, (1, 3)), nodes_target).T,
        mesh_node_a=pad0(cat(node_a, (1,), np.int32), nodes_target),
        mesh_node_b=pad0(cat(node_b, (1,), np.int32), nodes_target),
    )


ATLAS_QUAD_LIMIT_BYTES = 128 * 1024 * 1024
ATLAS_PAIR_LIMIT_BYTES = 96 * 1024 * 1024


def atlas_quad_fits(num_layers, size):
    return num_layers * size * size * 16 * 4 <= ATLAS_QUAD_LIMIT_BYTES


def atlas_pair_fits(num_layers, size):
    return num_layers * size * size * 8 * 2 <= ATLAS_PAIR_LIMIT_BYTES


def _build_atlas_quad(atlas):
    """(L, A, A, 4) -> (L*A*A, 16) rows of each texel's clamped 2x2
    neighbourhood [c(x,y), c(x+1,y), c(x,y+1), c(x+1,y+1)], or a (1, 16)
    dummy over the size budget."""
    layers, size = atlas.shape[0], atlas.shape[1]
    if not atlas_quad_fits(layers, size):
        return np.zeros((1, 16), np.float32)
    xp = np.concatenate([atlas[:, :, 1:], atlas[:, :, -1:]], axis=2)
    yp = np.concatenate([atlas[:, 1:], atlas[:, -1:]], axis=1)
    xyp = np.concatenate([xp[:, 1:], xp[:, -1:]], axis=1)
    quad = np.concatenate([atlas, xp, yp, xyp], axis=-1)
    return quad.reshape(-1, 16).astype(np.float32)


def _build_atlas_pair(atlas):
    """(L, A, A, 4) -> (L*A*A, 8) float32 rows [c(x, y), c(x, y+1)] (the
    y-neighbour clamped at the layer edge), or a (1, 8) dummy over the
    budget. The caller stores it as torch.bfloat16; torch's float32 ->
    bfloat16 conversion rounds to nearest even, like the JAX compile's
    numpy cast to jnp.bfloat16."""
    layers, size = atlas.shape[0], atlas.shape[1]
    if not atlas_pair_fits(layers, size):
        return np.zeros((1, 8), np.float32)
    yp = np.concatenate([atlas[:, 1:], atlas[:, -1:]], axis=1)
    pair = np.concatenate([atlas, yp], axis=-1)
    return pair.reshape(-1, 8).astype(np.float32)


def gather_world_tris(instances):
    """World-space triangle soup of every mesh instance: (positions
    (F, 3, 3), normals (F, 3, 3), uvs (F, 3, 2), shape index (F,)), or
    None if the scene has no mesh faces."""
    pos_parts, nrm_parts, uv_parts, shp_parts = [], [], [], []
    for shape_index, entity, world, inv_world in instances:
        mesh = entity.mesh
        faces = np.asarray(mesh.faces)
        if len(faces) == 0:
            continue
        p = np.asarray(mesh.positions, np.float32)[faces]
        p = p @ world[:3, :3].T + world[:3, 3]
        n = np.asarray(mesh.normals, np.float32)[faces]
        n = n @ inv_world[:3, :3]   # row-vector form of (W^-1)^T n
        n = n / np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-12)
        uv = np.asarray(mesh.uvs, np.float32)[faces]
        pos_parts.append(p.astype(np.float32))
        nrm_parts.append(n.astype(np.float32))
        uv_parts.append(uv)
        shp_parts.append(np.full(len(faces), shape_index, np.float32))
    if not pos_parts:
        return None
    return (np.concatenate(pos_parts), np.concatenate(nrm_parts),
            np.concatenate(uv_parts), np.concatenate(shp_parts))


def _empty_wide():
    """The inert flat tree of a scene without flattened triangles."""
    return bvh8.WideBvh(nodes=np.zeros((1, 128), np.float32),
                        tris=np.zeros((1, 128), np.float32),
                        face_map=np.full(4, -1, np.int32),
                        num_nodes=0, num_leaves=0)


def _build_wide_tables(instances):
    """Flatten every mesh instance to world space and build one BVH8
    over all triangles (scene/bvh8.py): positions and inverse-transpose
    normals are transformed here, so the flat kernels transform no ray.
    Returns (WideBvh, world triangle soup or None)."""
    tris = gather_world_tris(instances)
    if tris is None:
        return _empty_wide(), None
    return bvh8.build_wide_bvh(*tris), tris


def choose_packet_mode(instances):
    """'inst' (two-level instanced tables, ops/trace_inst.py) for every
    scene with a mesh; 'flat' (one world-flattened BVH8,
    ops/trace_packet.py) for analytic-only scenes. Replace this function
    for the length of a compile to build a mesh scene's flat tables."""
    return 'inst' if instances else 'flat'


def _pack_tlas_rows(bounds_min, bounds_max, width=None):
    """Wide TLAS rows over instance world AABBs; leaf metas carry
    INST_BASE + instance (binary SAH over degenerate triangles whose
    AABBs equal the instance boxes, then the DP collapse)."""
    from ..ops.trace_inst import INST_BASE
    from .bvh import build_bvh

    width = width or bvh8.WIDE_WIDTH
    meta_lane = bvh8.NODE_LAYOUT[width]['meta']
    axis_lane = bvh8.NODE_LAYOUT[width]['axis']
    lo = np.asarray(bounds_min, np.float32)
    hi = np.asarray(bounds_max, np.float32)
    tris = np.stack([lo, hi, 0.5 * (lo + hi)], axis=1)
    bvh = build_bvh(tris, max_leaf_faces=1)
    children, axes = bvh8.collapse_bvh2_sah(
        bvh.node_min, bvh.node_max, bvh.a, bvh.b, leaf_max=1, width=width)
    rows = np.zeros((len(children), 128), np.float32)
    rows[:, 0:3 * width] = bvh8.BIG
    rows[:, 3 * width:6 * width] = -bvh8.BIG
    rows[:, axis_lane] = np.asarray(axes, np.float32)
    for w, entries in enumerate(children):
        for c, (kind, p0, _count, m) in enumerate(entries):
            blo, bhi = bvh.node_min[m], bvh.node_max[m]
            for ax in range(3):
                rows[w, width * ax + c] = blo[ax]
                rows[w, 3 * width + width * ax + c] = bhi[ax]
            if kind == 'leaf':
                rows[w, meta_lane + c] = np.float32(INST_BASE + int(bvh.face_order[p0]))
            else:
                rows[w, meta_lane + c] = np.float32(p0)
    bvh8.write_octant_perms(rows, width=width)
    return rows


# Analytic shape tables of ops/trace_shapes.py. A shape row (16 float32
# lanes) holds the object_from_world 3x4 row-major in lanes 0..11, then
# the shape type, the shape index and the tie rank: the slot's position
# in the analytic groups taken in order (intersect_analytic's tie rule).
SHAPE_ROW = 16
SHAPE_LANE_TYPE, SHAPE_LANE_INDEX, SHAPE_LANE_RANK = 12, 13, 14
# A stack of STACK_DEPTH entries (csrc/shape_trace.cu) holds any walk of
# a tree whose node rows are at most this deep: 7 entries a level, plus
# the root.
SHAPE_STACK_DEPTH = 128
# Outward pad of a shape's world box: the box must hold every hit the
# dense test finds, and a grazing ray's hit, rounded in object space, can
# lie outside the exact surface (by ~1e-4 radius for an origin 65 radii
# away). A 2^-8 fraction of the half-extent holds origins up to ~180
# radii away; the 2^-20 fraction of the coordinates covers their ulps.
SHAPE_BOX_PAD = 2.0 ** -8
SHAPE_BOX_ULPS = 2.0 ** -20


def _shape_world_box(shape_type, object_from_world):
    """World box of a sphere or cube slot, padded outward, from the
    inverse of the object_from_world that the intersection tests use."""
    world = np.linalg.inv(np.asarray(object_from_world, np.float64))
    lin, centre = world[:3, :3], world[:3, 3]
    if shape_type == SHAPE_TYPE_SPHERE:
        half = np.linalg.norm(lin, axis=1)
        lo, hi = centre - half, centre + half
    else:
        corners = np.array([[x, y, z] for x in (-1.0, 1.0) for y in (-1.0, 1.0)
                            for z in (-1.0, 1.0)]) @ lin.T + centre
        lo, hi = corners.min(axis=0), corners.max(axis=0)
    pad = (SHAPE_BOX_PAD * 0.5 * (hi - lo)
           + SHAPE_BOX_ULPS * np.maximum(np.abs(lo), np.abs(hi)))
    lo32 = np.nextafter((lo - pad).astype(np.float32), np.float32(-np.inf))
    hi32 = np.nextafter((hi + pad).astype(np.float32), np.float32(np.inf))
    return lo32, hi32


def _row_depth(rows, width):
    """Node rows on the longest path from the root row to a leaf."""
    from ..ops.trace_inst import INST_BASE

    meta_lane = bvh8.NODE_LAYOUT[width]['meta']
    metas = np.rint(rows[:, meta_lane:meta_lane + width]).astype(np.int64)
    depth, level = 0, [0]
    while level:
        depth += 1
        level = [int(m) for r in level for m in metas[r] if 0 < m < INST_BASE]
    return depth


def pack_shape_tables(object_from_world, analytic_idx, analytic_valid):
    """The tables of ops/trace_shapes.py from the shape tables and the
    analytic groups: `plane_rows` (P, 16), the valid plane slots, tested
    one after the other (a plane is unbounded); `shape_rows` (B, 16), the
    valid sphere and cube slots; `shape_nodes` (W, 128), wide BVH rows
    over the padded world boxes of `shape_rows`, built as the instance
    TLAS is (_pack_tlas_rows: binary SAH, then the BVH8 collapse), whose
    leaf metas are INST_BASE + the shape row. Padded (invalid) slots are
    in no table. Rows come in tie-rank order."""
    plane_rows, shape_rows, lo, hi = [], [], [], []
    rank = 0
    for stype in sorted(int(t) for t in analytic_idx):
        idx = np.asarray(analytic_idx[stype])
        valid = np.asarray(analytic_valid[stype]) > 0.0
        for slot, si in enumerate(idx):
            if not valid[slot]:
                continue
            si = int(si)
            m = np.asarray(object_from_world[:, :, si], np.float32)
            row = np.zeros(SHAPE_ROW, np.float32)
            row[0:12] = m[:3, :4].reshape(12)
            row[SHAPE_LANE_TYPE] = stype
            row[SHAPE_LANE_INDEX] = si
            row[SHAPE_LANE_RANK] = rank + slot
            if stype == SHAPE_TYPE_PLANE:
                plane_rows.append(row)
            else:
                shape_rows.append(row)
                box = _shape_world_box(stype, m)
                lo.append(box[0])
                hi.append(box[1])
        rank += len(idx)
    width = bvh8.WIDE_WIDTH
    if shape_rows:
        nodes = _pack_tlas_rows(lo, hi, width=width)
        depth = _row_depth(nodes, width)
        if 7 * depth + 1 > SHAPE_STACK_DEPTH:
            raise ValueError(f'shape BVH of {depth} levels: a walk could '
                             f'overflow the {SHAPE_STACK_DEPTH}-entry stack')
    else:
        nodes = np.zeros((1, 128), np.float32)
        nodes[:, 0:3 * width] = bvh8.BIG
        nodes[:, 3 * width:6 * width] = -bvh8.BIG
    return dict(
        plane_rows=np.asarray(plane_rows, np.float32).reshape(-1, SHAPE_ROW),
        shape_rows=np.asarray(shape_rows, np.float32).reshape(-1, SHAPE_ROW),
        shape_nodes=nodes)


def _build_inst_tables(instances, inst_bounds, width=None, leaf_max=None):
    """Two-level tables: per-unique-mesh object-space wide BVHs, rebased
    and concatenated behind the TLAS, plus per-instance rows. Returns
    (dict of numpy arrays, TLAS row count)."""
    width = width or bvh8.WIDE_WIDTH
    leaf_max = leaf_max or bvh8.LEAF_MAX
    meta_lane = bvh8.NODE_LAYOUT[width]['meta']
    mesh_tables = {}
    order = []
    for _, entity, _, _ in instances:
        mesh = entity.mesh
        if id(mesh) in mesh_tables:
            continue
        # Memoized per mesh: the tables depend only on its geometry and
        # the leaf format.
        key = (width, leaf_max, bvh8.LEAF_FMT, id(mesh.positions),
               id(mesh.faces), len(mesh.faces))
        cached = getattr(mesh, '_wide_table_cache', None)
        if cached is not None and cached[0] == key:
            mesh_tables[id(mesh)] = cached[1]
            order.append(id(mesh))
            continue
        faces = np.asarray(mesh.faces)
        tri = np.asarray(mesh.positions, np.float32)[faces]
        nrm = np.asarray(mesh.normals, np.float32)[faces]
        uv = np.asarray(mesh.uvs, np.float32)[faces]
        shp = np.zeros(len(faces), np.float32)
        # The mesh's BLAS: the SBVH build, its collapse to BVH8 rows and
        # the leaf rows.
        with log.timer('compile.bvh', tables='inst', faces=len(faces)):
            wide = bvh8.build_wide_bvh(tri, nrm, uv, shp, spatial=True,
                                       width=width, leaf_max=leaf_max)
            mesh_tables[id(mesh)] = bvh8.pack_wide_geom(wide, tri, nrm, uv, shp)
        mesh._wide_table_cache = (key, mesh_tables[id(mesh)])
        order.append(id(mesh))

    tlas = _pack_tlas_rows([b[0] for b in inst_bounds],
                           [b[1] for b in inst_bounds], width=width)
    t_rows = _bucket(len(tlas), lo=8)
    tlas = np.concatenate([tlas, np.zeros((t_rows - len(tlas), 128), np.float32)])

    node_parts, tri_parts, attr_parts, fmap_parts = [], [], [], []
    node_base = {}
    nb, rb = 0, 0
    for key in order:
        ng, tg, at, fm = mesh_tables[key]
        ng = ng.copy()
        metas = ng[:, meta_lane:meta_lane + width]
        interior = metas > 0
        leafm = metas < 0
        metas[interior] += t_rows + nb
        u = -metas[leafm]
        row = u % bvh8.LEAF_ROW_LIMIT + rb
        cnt = u // bvh8.LEAF_ROW_LIMIT
        metas[leafm] = -(cnt * bvh8.LEAF_ROW_LIMIT + row)
        ng[:, meta_lane:meta_lane + width] = metas
        node_base[key] = t_rows + nb
        nb += len(ng)
        rb += len(tg)
        node_parts.append(ng)
        tri_parts.append(tg)
        attr_parts.append(at)
        fmap_parts.append(fm.copy())
    if rb > bvh8.LEAF_ROW_LIMIT:
        raise ValueError(
            f'{rb} concatenated geometry rows exceed the '
            f'{bvh8.LEAF_ROW_LIMIT}-row leaf encoding')

    # One instance stays exact (resolve_inst_attributes' broadcast case).
    i_slots = 1 if len(instances) == 1 else _bucket(len(instances))
    inst_rows = np.zeros((i_slots, 128), np.float32)
    inst_aux = np.zeros((i_slots, 16), np.float32)
    for i, (shape_index, entity, _world, inv_world) in enumerate(instances):
        inst_rows[i, 0:12] = inv_world[:3, :4].reshape(12)
        inst_rows[i, 12] = np.float32(node_base[id(entity.mesh)])
        inst_aux[i, 0:9] = inv_world[:3, :3].reshape(9)
        inst_aux[i, 9] = np.float32(shape_index)

    tris_cat = np.concatenate(tri_parts).astype(np.float32)
    attrs_cat = np.concatenate(attr_parts).astype(np.float32)
    fmap_cat = np.concatenate(fmap_parts).astype(np.int32)
    nodes_cat = np.concatenate([tlas] + node_parts).astype(np.float32)

    # Trailing pad rows, as the JAX tables have them (a leaf's last row
    # index stays inside the table for any fixed-size row fetch).
    pad = leaf_max // 8 - 1
    if pad:
        tris_cat = np.concatenate([tris_cat, np.zeros((pad, 128), np.float32)])
        attrs_cat = np.concatenate([attrs_cat, np.zeros((pad * 8, 16), np.float32)])
        fmap_cat = np.concatenate([fmap_cat, np.full(pad * 8, -1, np.int32)])

    r_rows = _bucket_rows(len(tris_cat))
    return dict(
        inst_nodes=_pad_rows(nodes_cat, _bucket_rows(len(nodes_cat))),
        inst_tris=_pad_rows(tris_cat, r_rows),
        inst_attrs=_pad_rows(attrs_cat, r_rows * 8),
        inst_face_map=_pad_rows(fmap_cat, r_rows * 8, fill=-1),
        inst_rows=inst_rows,
        inst_aux=inst_aux,
    ), t_rows


def entity_packs_shape(entity):
    """A mesh instance without a mesh, or with a faceless one, packs no
    shape slot."""
    if entity.type not in _ENTITY_TO_SHAPE_TYPE:
        return False
    if entity.type == ENTITY_TYPE_MESH_INSTANCE:
        return entity.mesh is not None and len(entity.mesh.faces) > 0
    return True


def _shape_bounds(shape_type, world_from_object, mesh):
    """World AABB of a shape (scene.cpp:1031-1093)."""
    if shape_type == SHAPE_TYPE_MESH_INSTANCE:
        lo = mesh.bvh.node_min[0]
        hi = mesh.bvh.node_max[0]
    elif shape_type == SHAPE_TYPE_PLANE:
        lo = np.array([-1e9, -1e9, -1e-9], np.float32)
        hi = np.array([+1e9, +1e9, +1e-9], np.float32)
    else:  # sphere, cube
        lo = -np.ones(3, np.float32)
        hi = np.ones(3, np.float32)
    corners = np.array([[x, y, z, 1.0] for x in (lo[0], hi[0])
                        for y in (lo[1], hi[1]) for z in (lo[2], hi[2])], np.float32)
    world = corners @ world_from_object.T
    return world[:, :3].min(axis=0), world[:, :3].max(axis=0)


def _fit_skybox_vmf(pixels):
    """Fit a vMF lobe to an equirect HDR skybox (scene.cpp:1569-1600)."""
    h, w = pixels.shape[:2]
    y = np.arange(h)
    x = np.arange(w)
    theta = (0.5 - (y + 0.5) / h) * np.pi
    phi = ((x + 0.5) / w - 0.5) * 2 * np.pi
    lum = pixels[..., :3] @ np.array([0.2126, 0.7152, 0.0722], np.float32)
    weight = np.cos(theta)[:, None] * lum * lum
    ct, st = np.cos(theta), np.sin(theta)
    cp, sp = np.cos(phi), np.sin(phi)
    direction = np.stack([
        np.broadcast_to(ct[:, None] * cp[None, :], (h, w)),
        np.broadcast_to(ct[:, None] * sp[None, :], (h, w)),
        np.broadcast_to(st[:, None], (h, w)),
    ], axis=-1)
    wsum = weight.sum()
    mean = (weight[..., None] * direction).sum(axis=(0, 1)) / max(wsum, 1e-12)
    r = min(np.linalg.norm(mean), 0.9999)
    concentration = r * (3.0 - r * r) / (1.0 - r * r)
    return (mean / max(r, 1e-12)).astype(np.float32), np.float32(concentration)


def _pack_textures(scene, table):
    atlas, metas = atlas_mod.pack_textures(scene.textures, table)
    for i, texture in enumerate(scene.textures):
        texture.packed_texture_index = i
    if metas:
        out = dict(
            texture_placement_min=np.stack([m.placement_min for m in metas], axis=-1),
            texture_placement_max=np.stack([m.placement_max for m in metas], axis=-1),
            texture_layer=np.asarray([m.layer for m in metas], np.int32),
            texture_flags=np.asarray([m.flags for m in metas], np.int32),
        )
    else:
        out = dict(
            texture_placement_min=np.zeros((2, 1), np.float32),
            texture_placement_max=np.ones((2, 1), np.float32),
            texture_layer=np.zeros(1, np.int32),
            texture_flags=np.zeros(1, np.int32),
        )
    meta_rows = np.zeros((max(len(metas), 1), 8), np.float32)
    for i, m in enumerate(metas):
        meta_rows[i, 0:2] = m.placement_min
        meta_rows[i, 2:4] = m.placement_max
        meta_rows[i, 4] = np.float32(m.layer)
        meta_rows[i, 5] = np.float32(m.flags)
    if not metas:
        meta_rows[0, 2:4] = 1.0
    out.update(
        texture_meta=meta_rows,
        atlas=atlas.reshape(-1, 4),
        atlas_quad=_build_atlas_quad(atlas),
        atlas_pair=_build_atlas_pair(atlas),
        atlas_layers=np.asarray(atlas.shape[0], np.int32),
        atlas_size=np.asarray(atlas.shape[1], np.int32),
    )
    return out


def _pack_shapes(scene, out):
    """Shape tables, analytic groups, portable-instance table, scene
    bounds, and the trace tables of the scene's packet mode: two-level
    instanced ('inst') or world-flattened ('flat')."""
    shape_type, shape_material, shape_mesh_root = [], [], []
    world_from_object, object_from_world = [], []
    bounds_lo, bounds_hi = [], []
    instances = []  # (shape_index, entity, world, object_from_world)

    for entity, world in scene.walk_entities_with_transform():
        if not entity_packs_shape(entity):
            continue
        stype = _ENTITY_TO_SHAPE_TYPE[entity.type]
        entity.packed_shape_index = len(shape_type)
        shape_type.append(stype)
        shape_material.append(entity.material.packed_material_index
                              if entity.material is not None else 0)
        shape_mesh_root.append(entity.mesh.packed_root_node_index
                               if entity.type == ENTITY_TYPE_MESH_INSTANCE else 0)
        world_from_object.append(world)
        inv_world = np.linalg.inv(world.astype(np.float64)).astype(np.float32)
        object_from_world.append(inv_world)
        if stype == SHAPE_TYPE_MESH_INSTANCE:
            instances.append((entity.packed_shape_index, entity, world, inv_world))
        lo, hi = _shape_bounds(stype, world, getattr(entity, 'mesh', None))
        bounds_lo.append(lo)
        bounds_hi.append(hi)

    s = len(shape_type)
    eye = np.eye(4, dtype=np.float32)
    for _ in range(_bucket(s) - s):
        shape_type.append(SHAPE_TYPE_NONE)
        shape_material.append(0)
        shape_mesh_root.append(0)
        world_from_object.append(eye)
        object_from_world.append(eye)
    out.update(
        shape_type=np.asarray(shape_type, np.int32),
        shape_material=np.asarray(shape_material, np.int32),
        shape_mesh_root=np.asarray(shape_mesh_root, np.int32),
        shape_world_from_object=np.stack(world_from_object, axis=-1).astype(np.float32),
        shape_object_from_world=np.stack(object_from_world, axis=-1).astype(np.float32),
    )

    by_type = {}
    for i, t in enumerate(shape_type[:s]):
        if t != SHAPE_TYPE_MESH_INSTANCE and t != SHAPE_TYPE_NONE:
            by_type.setdefault(int(t), []).append(i)
    # Generic programs (scene.compile_generic, set by app.Session): every
    # analytic type gets a group, padded to its bucket, as in the JAX
    # package; padded slots are invalid and never hit.
    generic = bool(getattr(scene, 'compile_generic', False))
    if generic:
        for t in (SHAPE_TYPE_PLANE, SHAPE_TYPE_SPHERE, SHAPE_TYPE_CUBE):
            by_type.setdefault(int(t), [])
    a_idx, a_valid = {}, {}
    for t, idxs in sorted(by_type.items()):
        k_pad = _bucket(len(idxs)) if generic else max(len(idxs), 1)
        arr = np.zeros(k_pad, np.int32)
        arr[:len(idxs)] = idxs
        val = np.zeros(k_pad, np.float32)
        val[:len(idxs)] = 1.0
        a_idx[t] = arr
        a_valid[t] = val
    out['analytic_idx'] = a_idx
    out['analytic_valid'] = a_valid
    out.update(pack_shape_tables(out['shape_object_from_world'], a_idx, a_valid))

    i_real = len(instances)
    i_slots = 0 if i_real == 0 else 1 if i_real == 1 else _bucket(i_real)
    pi_shape = np.zeros(max(i_slots, 1), np.int32)
    pi_root = np.full(max(i_slots, 1), int(scene.packed_degenerate_root), np.int32)
    for k, (si, entity, _w, _iw) in enumerate(instances):
        pi_shape[k] = si
        pi_root[k] = int(entity.mesh.packed_root_node_index)
    out['portable_inst_shape'] = pi_shape
    out['portable_inst_root'] = pi_root

    if bounds_lo:
        lo = np.min(np.stack(bounds_lo), axis=0)
        hi = np.max(np.stack(bounds_hi), axis=0)
    else:
        lo, hi = np.zeros(3, np.float32), np.zeros(3, np.float32)
    out['scene_bounds'] = np.stack([lo, hi], axis=-1).astype(np.float32)

    packet_mode = choose_packet_mode(instances)
    if packet_mode == 'inst':
        inst_bounds = [(bounds_lo[si], bounds_hi[si]) for si, _, _, _ in instances]
        tables, t_rows = _build_inst_tables(instances, inst_bounds)
        out.update(tables)
        scene.packet_tlas_rows = t_rows
        # The flat tables are not built in this mode.
        wide, world_tris = _empty_wide(), None
    else:
        wide, world_tris = _build_wide_tables(instances)
        scene.packet_tlas_rows = 0
        for k, shape in (('inst_nodes', (1, 128)), ('inst_tris', (1, 128)),
                         ('inst_attrs', (8, 16)), ('inst_rows', (1, 128)),
                         ('inst_aux', (1, 16))):
            out[k] = np.zeros(shape, np.float32)
        out['inst_face_map'] = np.full(8, -1, np.int32)
    scene.packet_mode = packet_mode

    out['wide_nodes'] = _pad_rows(wide.nodes, _bucket_rows(len(wide.nodes)))
    out['wide_tris'] = _pad_rows(wide.tris, _bucket_rows(len(wide.tris)))
    if world_tris is not None:
        nodes_g, tris_g, attrs, face_map_g = bvh8.pack_wide_geom(
            wide, *world_tris)
        # Same row bucketing as the instanced tables; padded rows are inert.
        rg = _bucket_rows(len(tris_g))
        nodes_g = _pad_rows(nodes_g, _bucket_rows(len(nodes_g)))
        tris_g = _pad_rows(tris_g, rg)
        attrs = _pad_rows(attrs, rg * 8)
        face_map_g = _pad_rows(face_map_g, rg * 8, fill=-1)
    else:
        nodes_g = wide.nodes
        tris_g = np.zeros((1, 128), np.float32)
        attrs = np.zeros((8, 16), np.float32)
        face_map_g = np.full(8, -1, np.int32)
    out.update(wide_nodes_g=nodes_g, wide_tris_g=tris_g, wide_attrs=attrs,
               wide_face_map=face_map_g)


def _pack_cameras(scene, aspect_ratio):
    def default():
        return dict(model=CAMERA_MODEL_PINHOLE, focal_length=0.0, aperture=0.0,
                    sensor_distance=1.0, sensor_size=(2.0, 1.0),
                    world=np.eye(4, dtype=np.float32))

    cameras = []
    for entity, world in scene.walk_entities_with_transform():
        if entity.type != ENTITY_TYPE_CAMERA:
            continue
        entity.packed_camera_index = len(cameras)
        if entity.camera_model == CAMERA_MODEL_PINHOLE:
            sensor_x = 2.0 * np.tan(np.radians(entity.pinhole.field_of_view_in_degrees / 2))
            cameras.append(dict(
                model=CAMERA_MODEL_PINHOLE, focal_length=0.0,
                aperture=entity.pinhole.aperture_diameter_in_mm / 2000.0,
                sensor_distance=1.0,
                sensor_size=(sensor_x, sensor_x / aspect_ratio), world=world))
        elif entity.camera_model == CAMERA_MODEL_THIN_LENS:
            tl = entity.thin_lens
            cameras.append(dict(
                model=CAMERA_MODEL_THIN_LENS,
                focal_length=tl.focal_length_in_mm / 1000.0,
                aperture=tl.aperture_diameter_in_mm / 2000.0,
                sensor_distance=1.0 / (1000.0 / tl.focal_length_in_mm - 1.0 / tl.focus_distance),
                sensor_size=tuple(np.asarray(tl.sensor_size_in_mm) / 1000.0),
                world=world))
        else:  # 360
            cameras.append(dict(
                model=entity.camera_model, focal_length=0.0, aperture=0.0,
                sensor_distance=1.0, sensor_size=(1.0, 1.0), world=world))
    if not cameras:
        cameras.append(default())
    while len(cameras) < _bucket(len(cameras)):
        cameras.append(default())
    return dict(
        camera_model=np.asarray([c['model'] for c in cameras], np.int32),
        camera_focal_length=np.asarray([c['focal_length'] for c in cameras], np.float32),
        camera_aperture_radius=np.asarray([c['aperture'] for c in cameras], np.float32),
        camera_sensor_distance=np.asarray([c['sensor_distance'] for c in cameras], np.float32),
        camera_sensor_size=np.asarray([c['sensor_size'] for c in cameras], np.float32),
        camera_world_from_camera=np.stack([c['world'] for c in cameras]).astype(np.float32),
    )


def _pack_skybox(scene):
    skybox = scene.root.skybox_texture
    if skybox is not None and skybox.pixels is not None:
        mean, concentration = _fit_skybox_vmf(np.asarray(skybox.pixels, np.float32))
        return dict(skybox_mean_direction=mean,
                    skybox_concentration=np.asarray(concentration, np.float32),
                    skybox_texture_index=np.asarray(skybox.packed_texture_index, np.int32))
    return dict(skybox_mean_direction=np.asarray([0.0, 0.0, 1.0], np.float32),
                skybox_concentration=np.asarray(0.0, np.float32),
                skybox_texture_index=np.asarray(TEXTURE_INDEX_NONE, np.int32))


def _pack_globals(scene):
    return dict(
        skybox_sampling_probability=np.asarray(scene.root.skybox_sampling_probability, np.float32),
        skybox_brightness=np.asarray(scene.root.skybox_brightness, np.float32),
        scene_scatter_rate=np.asarray(scene.root.scatter_rate, np.float32),
    )


def _compile_stages(scene: Scene, dirty, aspect_ratio, table):
    """The host compile: {field: numpy array} of the stages that `dirty`
    selects (materials as a nested dict of columns, analytic groups as
    {type: array}, the atlas pair table in float32), with the JAX
    package's cascade: textures dirty the materials and the skybox,
    materials and meshes the shapes, shapes and the skybox the globals."""
    out = {}
    if dirty & SCENE_DIRTY_TEXTURES:
        out.update(_pack_textures(scene, table))
        dirty |= SCENE_DIRTY_MATERIALS | SCENE_DIRTY_SKYBOX_TEXTURE
    if dirty & SCENE_DIRTY_MATERIALS:
        out['materials'] = _pack_materials(scene, table)
        dirty |= SCENE_DIRTY_SHAPES
    if dirty & SCENE_DIRTY_MESHES:
        out.update(_pack_meshes(scene))
        dirty |= SCENE_DIRTY_SHAPES
    if dirty & SCENE_DIRTY_SHAPES:
        _pack_shapes(scene, out)
        dirty |= SCENE_DIRTY_GLOBALS
    if dirty & SCENE_DIRTY_CAMERAS:
        out.update(_pack_cameras(scene, aspect_ratio))
    if dirty & SCENE_DIRTY_SKYBOX_TEXTURE:
        out.update(_pack_skybox(scene))
        dirty |= SCENE_DIRTY_GLOBALS
    if dirty & SCENE_DIRTY_GLOBALS:
        out.update(_pack_globals(scene))
    scene.dirty_flags = 0
    return out


def _field_tensor(name, value, device):
    """One PackedScene field from its numpy form, on `device`."""
    if name == 'materials':
        return MaterialTable(**{
            f.name: _tensor(np.asarray(value[f.name]), device)
            for f in dataclasses.fields(MaterialTable)})
    if name in ('analytic_idx', 'analytic_valid'):
        return {int(k): _tensor(np.asarray(v), device) for k, v in value.items()}
    if name == 'atlas_pair':
        return _tensor(np.asarray(value, np.float32), device).to(torch.bfloat16)
    return _tensor(np.asarray(value), device)


def packed_from_numpy(fields, layout_fields=None, device='cuda'):
    """Build the port's PackedScene from numpy arrays.

    fields: {PackedScene field: numpy array}; 'materials' is a dict of
    MaterialTable columns, 'analytic_idx'/'analytic_valid' are dicts
    keyed by shape type. Extra keys are ignored, and the fields are
    those of the JAX PackedScene, so the JAX package's compile can be
    carried across leaf by leaf; the analytic shapes' tables, which the
    JAX PackedScene lacks, are built here from its shape transforms and
    groups when `fields` has none. layout_fields: optional {SceneLayout
    field: value}; when given, the SceneLayout is attached as
    `host_layout` (unknown keys are ignored).
    """
    if 'shape_nodes' not in fields:
        fields = dict(fields, **pack_shape_tables(
            np.asarray(fields['shape_object_from_world']),
            fields['analytic_idx'], fields['analytic_valid']))
    packed = PackedScene(**{f.name: _field_tensor(f.name, fields[f.name], device)
                            for f in dataclasses.fields(PackedScene)})
    if layout_fields is not None:
        from ..ops.intersect import SceneLayout
        known = {f.name for f in dataclasses.fields(SceneLayout)}
        packed.host_layout = SceneLayout(**{k: v for k, v in layout_fields.items()
                                            if k in known})
    return packed


def compile_scene(scene: Scene, prev: PackedScene = None, aspect_ratio=2.0,
                  spectrum_table=None, *, device='cuda') -> PackedScene:
    """Compile (or incrementally recompile) the scene into a PackedScene
    of tensors on `device`.

    With `prev`, only the stages that the scene's dirty flags select are
    recomputed; the others keep `prev`'s tensors (the same objects).
    `prev` must live on `device`. `aspect_ratio` feeds pinhole sensor
    sizing. The SceneLayout built from the host document rides along as
    `packed.host_layout`, and the cameras' models as
    `packed.host_camera_models`; both are rebuilt on every call.
    """
    from ..ops.intersect import build_layout_host

    device = torch.device(device)
    if prev is not None:
        have = prev.camera_model.device
        if have.type != device.type or (
                device.index is not None and have.index != device.index):
            raise ValueError(f'compile_scene: prev lives on {have}, not on '
                             f'{device}; recompile without prev')
    dirty = scene.dirty_flags if prev is not None else SCENE_DIRTY_ALL
    table = spectrum_table if spectrum_table is not None else uplift.get_table()
    with log.timer('compile.pack', dirty=int(dirty),
                   incremental=prev is not None):
        fields = _compile_stages(scene, dirty, aspect_ratio, table)
    out = {} if prev is None else {f.name: getattr(prev, f.name)
                                   for f in dataclasses.fields(PackedScene)}
    out.update({name: _field_tensor(name, value, device)
                for name, value in fields.items()})
    packed = PackedScene(**out)
    packed.host_layout = build_layout_host(scene, packed)
    packed.host_camera_models = tuple(
        int(e.camera_model) for e in scene.walk_entities()
        if e.type == ENTITY_TYPE_CAMERA) or (0,)
    return packed
