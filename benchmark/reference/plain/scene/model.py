# Frozen copy of path_tracer_tpu_torch/scene/model.py, part of the benchmark's
# plain reference: not kept in step with the program.
"""High-level scene document model: entities, materials, textures, meshes.

Python equivalent of the reference's scene description layer
(reference src/scene/scene.hpp:176-340): an editable entity tree
with polymorphic materials, texture and mesh assets, prefabs, and a
dirty-flag system for incremental recompilation. This layer is pure host
Python/numpy; `path_tracer_tpu_torch.scene.compile` flattens it into padded
device arrays for the TPU integrator.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from ..core.constants import (
    CAMERA_MODEL_PINHOLE,
    MATERIAL_TYPE_BASIC_DIFFUSE,
    MATERIAL_TYPE_BASIC_METAL,
    MATERIAL_TYPE_BASIC_TRANSLUCENT,
    MATERIAL_TYPE_OPENPBR,
    TEXTURE_TYPE_RAW,
)

# Dirty flags (scene.hpp:323-333).
SCENE_DIRTY_GLOBALS = 1 << 0
SCENE_DIRTY_TEXTURES = 1 << 1
SCENE_DIRTY_MATERIALS = 1 << 2
SCENE_DIRTY_SHAPES = 1 << 3
SCENE_DIRTY_MESHES = 1 << 4
SCENE_DIRTY_CAMERAS = 1 << 5
SCENE_DIRTY_SKYBOX_TEXTURE = 1 << 6
SCENE_DIRTY_ALL = 0xFFFFFFFF

# Entity types (scene.hpp:229-244).
ENTITY_TYPE_ROOT = 0
ENTITY_TYPE_CONTAINER = 1
ENTITY_TYPE_CAMERA = 2
ENTITY_TYPE_MESH_INSTANCE = 3
ENTITY_TYPE_PLANE = 4
ENTITY_TYPE_SPHERE = 5
ENTITY_TYPE_CUBE = 6


@dataclass
class Transform:
    """Position / euler rotation / scale (common.hpp:48-54)."""

    position: np.ndarray = field(default_factory=lambda: np.zeros(3, np.float32))
    rotation: np.ndarray = field(default_factory=lambda: np.zeros(3, np.float32))
    scale: np.ndarray = field(default_factory=lambda: np.ones(3, np.float32))
    scale_is_uniform: bool = True

    def __post_init__(self):
        self.position = np.asarray(self.position, np.float32)
        self.rotation = np.asarray(self.rotation, np.float32)
        scale = np.asarray(self.scale, np.float32)
        if scale.ndim == 0:
            scale = np.full(3, float(scale), np.float32)
        self.scale = scale


def _euler_zyx_matrix(rotation):
    """Rotation matrix for euler angles applied Z*Y*X (common.hpp:62-69)."""
    rx, ry, rz = [float(v) for v in rotation]
    cx, sx = np.cos(rx), np.sin(rx)
    cy, sy = np.cos(ry), np.sin(ry)
    cz, sz = np.cos(rz), np.sin(rz)
    mx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
    my = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    mz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
    return mz @ my @ mx


def make_transform_matrix(position, rotation, scale=None):
    """4x4 affine transform: translate * rotZYX * scale (common.hpp:62-81)."""
    m = np.eye(4, dtype=np.float64)
    r = _euler_zyx_matrix(rotation)
    if scale is not None:
        r = r @ np.diag(np.asarray(scale, np.float64))
    m[:3, :3] = r
    m[:3, 3] = np.asarray(position, np.float64)
    return m.astype(np.float32)


@dataclass
class Texture:
    name: str = 'New Texture'
    type: int = TEXTURE_TYPE_RAW
    enable_nearest_filtering: bool = False
    pixels: Optional[np.ndarray] = None  # (H, W, 4) float32
    packed_texture_index: int = -1

    @property
    def width(self):
        return 0 if self.pixels is None else self.pixels.shape[1]

    @property
    def height(self):
        return 0 if self.pixels is None else self.pixels.shape[0]


@dataclass
class Material:
    name: str = 'New Material'
    opacity: float = 1.0
    flags: int = 0
    packed_material_index: int = 0

    type = None  # overridden per subclass

    def textures(self):
        """All texture references of this material, in packing order."""
        return []


@dataclass
class BasicDiffuseMaterial(Material):
    """Lambertian diffuse (basic_diffuse.hpp:3-9)."""

    type = MATERIAL_TYPE_BASIC_DIFFUSE
    base_color: np.ndarray = field(default_factory=lambda: np.ones(3, np.float32))
    base_texture: Optional[Texture] = None

    def textures(self):
        return [self.base_texture]


@dataclass
class BasicMetalMaterial(Material):
    """GGX metal with F82 tint (basic_metal.hpp:3-15)."""

    type = MATERIAL_TYPE_BASIC_METAL
    base_color: np.ndarray = field(default_factory=lambda: np.ones(3, np.float32))
    base_texture: Optional[Texture] = None
    specular_color: np.ndarray = field(default_factory=lambda: np.ones(3, np.float32))
    specular_texture: Optional[Texture] = None
    roughness: float = 0.3
    roughness_texture: Optional[Texture] = None
    roughness_anisotropy: float = 0.0
    roughness_anisotropy_texture: Optional[Texture] = None

    def textures(self):
        return [self.base_texture, self.specular_texture,
                self.roughness_texture, self.roughness_anisotropy_texture]


@dataclass
class BasicTranslucentMaterial(Material):
    """Rough dispersive dielectric with interior medium
    (basic_translucent.hpp:3-17)."""

    type = MATERIAL_TYPE_BASIC_TRANSLUCENT
    ior: float = 1.5
    abbe_number: float = 20.0
    roughness: float = 0.3
    roughness_texture: Optional[Texture] = None
    roughness_anisotropy: float = 0.0
    roughness_anisotropy_texture: Optional[Texture] = None
    transmission_color: np.ndarray = field(default_factory=lambda: np.ones(3, np.float32))
    transmission_depth: float = 0.0
    scattering_color: np.ndarray = field(default_factory=lambda: np.ones(3, np.float32))
    scattering_anisotropy: float = 0.0

    def textures(self):
        return [self.roughness_texture, self.roughness_anisotropy_texture]


@dataclass
class OpenPBRMaterial(Material):
    """OpenPBR layered slab surface (openpbr.hpp:3-41)."""

    type = MATERIAL_TYPE_OPENPBR
    base_weight: float = 1.0
    base_color: np.ndarray = field(default_factory=lambda: np.ones(3, np.float32))
    base_color_texture: Optional[Texture] = None
    base_metalness: float = 0.0
    base_diffuse_roughness: float = 0.0
    specular_weight: float = 1.0
    specular_color: np.ndarray = field(default_factory=lambda: np.ones(3, np.float32))
    specular_roughness: float = 0.3
    specular_roughness_texture: Optional[Texture] = None
    specular_roughness_anisotropy: float = 0.0
    specular_ior: float = 1.5
    transmission_weight: float = 0.0
    transmission_color: np.ndarray = field(default_factory=lambda: np.ones(3, np.float32))
    transmission_depth: float = 0.0
    transmission_scatter: np.ndarray = field(default_factory=lambda: np.zeros(3, np.float32))
    transmission_scatter_anisotropy: float = 0.0
    transmission_dispersion_scale: float = 0.0
    transmission_dispersion_abbe_number: float = 20.0
    coat_weight: float = 0.0
    coat_color: np.ndarray = field(default_factory=lambda: np.ones(3, np.float32))
    coat_roughness: float = 0.0
    coat_roughness_anisotropy: float = 0.0
    coat_ior: float = 1.6
    coat_darkening: float = 1.0
    emission_luminance: float = 0.0
    emission_color: np.ndarray = field(default_factory=lambda: np.zeros(3, np.float32))
    emission_color_texture: Optional[Texture] = None
    layer_bounce_limit: int = 16

    def textures(self):
        return [self.base_color_texture, self.specular_roughness_texture,
                self.emission_color_texture]


@dataclass
class Mesh:
    """Triangle mesh asset with a prebuilt BVH.

    positions: (V, 3), normals: (V, 3), uvs: (V, 2), faces: (F, 3) int32.
    bvh holds the builder output (see scene.bvh.Bvh) and is rebuilt on
    demand when faces change.
    """

    name: str = 'New Mesh'
    positions: np.ndarray = field(default_factory=lambda: np.zeros((0, 3), np.float32))
    normals: np.ndarray = field(default_factory=lambda: np.zeros((0, 3), np.float32))
    uvs: np.ndarray = field(default_factory=lambda: np.zeros((0, 2), np.float32))
    faces: np.ndarray = field(default_factory=lambda: np.zeros((0, 3), np.int32))
    bvh: object = None
    packed_root_node_index: int = 0

    def __post_init__(self):
        # Enforce the documented (F, 3) faces contract: empty imports
        # often arrive as shape (0,), which would poison the pack
        # concatenations with mismatched ranks (compile._pack_meshes).
        self.faces = np.asarray(self.faces, np.int32).reshape(-1, 3)


@dataclass
class Entity:
    name: str = 'Entity'
    type: int = ENTITY_TYPE_CONTAINER
    active: bool = True
    transform: Transform = field(default_factory=Transform)
    children: List['Entity'] = field(default_factory=list)
    material: Optional[Material] = None
    parent: Optional['Entity'] = None
    packed_shape_index: int = -1


@dataclass
class RootEntity(Entity):
    type: int = ENTITY_TYPE_ROOT
    scatter_rate: float = 0.0
    skybox_brightness: float = 1.0
    skybox_sampling_probability: float = 0.0
    skybox_texture: Optional[Texture] = None

    def __post_init__(self):
        self.name = 'Root'


@dataclass
class ContainerEntity(Entity):
    type: int = ENTITY_TYPE_CONTAINER


@dataclass
class CameraPinhole:
    field_of_view_in_degrees: float = 90.0
    aperture_diameter_in_mm: float = 0.0


@dataclass
class CameraThinLens:
    sensor_size_in_mm: np.ndarray = field(default_factory=lambda: np.array([32.0, 18.0], np.float32))
    focal_length_in_mm: float = 20.0
    aperture_diameter_in_mm: float = 10.0
    focus_distance: float = 1.0


@dataclass
class CameraEntity(Entity):
    type: int = ENTITY_TYPE_CAMERA
    camera_model: int = CAMERA_MODEL_PINHOLE
    pinhole: CameraPinhole = field(default_factory=CameraPinhole)
    thin_lens: CameraThinLens = field(default_factory=CameraThinLens)
    velocity: np.ndarray = field(default_factory=lambda: np.zeros(3, np.float32))
    packed_camera_index: int = 0


@dataclass
class MeshEntity(Entity):
    type: int = ENTITY_TYPE_MESH_INSTANCE
    mesh: Optional[Mesh] = None


@dataclass
class PlaneEntity(Entity):
    type: int = ENTITY_TYPE_PLANE


@dataclass
class SphereEntity(Entity):
    type: int = ENTITY_TYPE_SPHERE


@dataclass
class CubeEntity(Entity):
    type: int = ENTITY_TYPE_CUBE


@dataclass
class Prefab:
    entity: Optional[Entity] = None


ENTITY_CLASSES = {
    ENTITY_TYPE_ROOT: RootEntity,
    ENTITY_TYPE_CONTAINER: ContainerEntity,
    ENTITY_TYPE_CAMERA: CameraEntity,
    ENTITY_TYPE_MESH_INSTANCE: MeshEntity,
    ENTITY_TYPE_PLANE: PlaneEntity,
    ENTITY_TYPE_SPHERE: SphereEntity,
    ENTITY_TYPE_CUBE: CubeEntity,
}

MATERIAL_CLASSES = {
    MATERIAL_TYPE_BASIC_DIFFUSE: BasicDiffuseMaterial,
    MATERIAL_TYPE_BASIC_METAL: BasicMetalMaterial,
    MATERIAL_TYPE_BASIC_TRANSLUCENT: BasicTranslucentMaterial,
    MATERIAL_TYPE_OPENPBR: OpenPBRMaterial,
}


class Scene:
    """Editable scene document with dirty-flag change tracking.

    Mirrors the CRUD surface of the reference scene layer
    (scene.hpp:410-442 / scene.cpp:161-422): create/destroy of entities,
    materials, textures, meshes; every mutation marks the corresponding
    dirty bits so the compiler can repack incrementally.
    """

    def __init__(self):
        self.root = RootEntity()
        self.meshes: List[Mesh] = []
        self.materials: List[Material] = []
        self.textures: List[Texture] = []
        self.prefabs: List[Prefab] = []
        self.dirty_flags = SCENE_DIRTY_ALL

    # -- CRUD ---------------------------------------------------------

    def mark_dirty(self, flags):
        self.dirty_flags |= flags

    def create_entity(self, entity_type, parent=None, **kwargs):
        entity = ENTITY_CLASSES[entity_type](**kwargs)
        parent = parent or self.root
        entity.parent = parent
        parent.children.append(entity)
        self.mark_dirty(SCENE_DIRTY_SHAPES | SCENE_DIRTY_CAMERAS)
        return entity

    def destroy_entity(self, entity):
        if entity.parent is not None:
            entity.parent.children.remove(entity)
        self.mark_dirty(SCENE_DIRTY_SHAPES | SCENE_DIRTY_CAMERAS)

    def create_material(self, material_type, **kwargs):
        material = MATERIAL_CLASSES[material_type](**kwargs)
        self.materials.append(material)
        self.mark_dirty(SCENE_DIRTY_MATERIALS)
        return material

    def destroy_material(self, material):
        # Clear references from entities (scene.cpp reference fix-up).
        for entity in self.walk_entities():
            if entity.material is material:
                entity.material = None
        self.materials.remove(material)
        self.mark_dirty(SCENE_DIRTY_MATERIALS | SCENE_DIRTY_SHAPES)

    def create_texture(self, **kwargs):
        texture = Texture(**kwargs)
        self.textures.append(texture)
        self.mark_dirty(SCENE_DIRTY_TEXTURES)
        return texture

    def destroy_texture(self, texture):
        for material in self.materials:
            for f in dataclasses.fields(material):
                if getattr(material, f.name, None) is texture:
                    setattr(material, f.name, None)
        if self.root.skybox_texture is texture:
            self.root.skybox_texture = None
            self.mark_dirty(SCENE_DIRTY_SKYBOX_TEXTURE)
        self.textures.remove(texture)
        self.mark_dirty(SCENE_DIRTY_TEXTURES | SCENE_DIRTY_MATERIALS)

    def create_mesh(self, **kwargs):
        mesh = Mesh(**kwargs)
        self.meshes.append(mesh)
        self.mark_dirty(SCENE_DIRTY_MESHES)
        return mesh

    def destroy_mesh(self, mesh):
        for entity in self.walk_entities():
            if getattr(entity, 'mesh', None) is mesh:
                entity.mesh = None
        self.meshes.remove(mesh)
        self.mark_dirty(SCENE_DIRTY_MESHES | SCENE_DIRTY_SHAPES)

    def instantiate_prefab(self, prefab, parent=None):
        """Clone the prefab's entity tree into the scene. Assets (meshes,
        materials, textures) are shared by reference, not copied --
        matching the reference's prefab semantics (scene.cpp:877-903)."""

        def clone(entity, parent):
            new = ENTITY_CLASSES[entity.type]()
            for f in dataclasses.fields(entity):
                if f.name in ('children', 'parent'):
                    continue
                value = getattr(entity, f.name)
                if f.name == 'transform':
                    value = Transform(position=value.position.copy(),
                                      rotation=value.rotation.copy(),
                                      scale=value.scale.copy(),
                                      scale_is_uniform=value.scale_is_uniform)
                setattr(new, f.name, value)
            new.parent = parent
            new.children = [clone(c, new) for c in entity.children]
            return new

        parent = parent or self.root
        entity = clone(prefab.entity, parent)
        parent.children.append(entity)
        self.mark_dirty(SCENE_DIRTY_SHAPES | SCENE_DIRTY_CAMERAS)
        return entity

    # -- traversal ------------------------------------------------------

    def walk_entities(self, entity=None, include_inactive=False):
        """Depth-first iteration over active entities."""
        entity = entity or self.root
        if not entity.active and not include_inactive:
            return
        yield entity
        for child in entity.children:
            yield from self.walk_entities(child, include_inactive)

    def walk_entities_with_transform(self):
        """Yield (entity, world_matrix) pairs for active entities.

        Matches ForEachEntityWithTransform: parents contribute
        position+rotation+scale; the reference composes full TRS down the
        tree.
        """

        def recurse(entity, parent_matrix):
            if not entity.active:
                return
            m = parent_matrix @ make_transform_matrix(
                entity.transform.position, entity.transform.rotation,
                entity.transform.scale)
            yield entity, m
            for child in entity.children:
                yield from recurse(child, m)

        yield from recurse(self.root, np.eye(4, dtype=np.float32))

    def find_camera_entities(self):
        return [e for e, _ in self.walk_entities_with_transform()
                if e.type == ENTITY_TYPE_CAMERA]
