# Frozen copy of path_tracer_tpu_torch/scene/compile.py, part of the benchmark's
# plain reference: not kept in step with the program.
"""Scene compiler: flatten the scene document into padded tensors.

The program's scene/compile.py without its BVH builds and trace tables:
meshes keep their faces in document order and record their face range,
which reference/trace.py tests face by face."""

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
from . import atlas as atlas_mod
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


@dataclass
class PackedScene:
    """Flattened scene as tensors: the contract between the compiler and
    the integrator. Field meanings and layouts are those of the JAX
    package's PackedScene."""

    shape_type: Any               # (S,) int32
    shape_material: Any           # (S,) int32
    shape_world_from_object: Any  # (4, 4, S) float32
    shape_object_from_world: Any  # (4, 4, S) float32
    analytic_idx: Any             # {shape_type: (K,) int32}
    analytic_valid: Any           # {shape_type: (K,) float32}
    scene_bounds: Any             # (3, 2) float32
    face_positions: Any           # (3, 3, F)
    face_vertices: Any            # (3, F) int32
    vertex_normals: Any           # (3, V)
    vertex_uvs: Any               # (2, V)
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
    """Concatenate mesh geometry with globally rebased indices
    (scene.cpp:1266-1343)."""
    face_positions, face_vertices = [], []
    vertex_normals, vertex_uvs = [], []
    vertex_base = face_base = 0

    # The reference builds no BVH: its trace tests every face of a mesh
    # (reference/trace.py), so faces keep the document's order and each
    # mesh records the range of its faces.
    for mesh in scene.meshes:
        faces = mesh.faces

        face_positions.append(mesh.positions[faces])
        face_vertices.append(faces.astype(np.int32) + vertex_base)
        vertex_normals.append(mesh.normals)
        vertex_uvs.append(mesh.uvs)

        mesh.packed_face_range = (face_base, face_base + len(faces))
        vertex_base += len(mesh.positions)
        face_base += len(faces)

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
    return dict(
        face_positions=faces_cat.transpose(1, 2, 0),
        face_vertices=fverts_cat.T,
        vertex_normals=vn_cat.T,
        vertex_uvs=vu_cat.T,
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
        lo = mesh.positions.min(axis=0)
        hi = mesh.positions.max(axis=0)
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
    """Shape tables, analytic groups, scene bounds, and the mesh
    instances the reference trace tests face by face."""
    shape_type, shape_material = [], []
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
        world_from_object.append(eye)
        object_from_world.append(eye)
    out.update(
        shape_type=np.asarray(shape_type, np.int32),
        shape_material=np.asarray(shape_material, np.int32),
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

    if bounds_lo:
        lo = np.min(np.stack(bounds_lo), axis=0)
        hi = np.max(np.stack(bounds_hi), axis=0)
    else:
        lo, hi = np.zeros(3, np.float32), np.zeros(3, np.float32)
    out['scene_bounds'] = np.stack([lo, hi], axis=-1).astype(np.float32)

    # The mesh instances, with their shape index, face range and
    # object_from_world, are what the reference trace reads.
    scene.reference_instances = [
        (si, entity.mesh.packed_face_range, inv_world)
        for si, entity, _w, inv_world in instances]
    scene.packet_mode = 'reference'


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
