# Copied from path_tracer_tpu/scene/serializer.py (numpy-only host code shared with the JAX package).
"""Scene persistence: JSON document + zlib-compressed binary sidecars.

File-format compatible with the reference serializer
(reference src/scene/serializer.cpp): the scene is a JSON document
with "Textures"/"Materials"/"Meshes"/"Prefabs"/"Root" sections holding
CamelCase fields, entity trees with type-tagged children, and
pointer<->index maps for asset references; texture pixels and mesh
geometry live in per-asset `.texture`/`.mesh` sidecar files whose
payload blocks are zlib streams prefixed by an 8-byte compressed size
(the reference's miniz WriteCompressed framing, serializer.cpp:136-164).

Deviation (documented): the reference's `.mesh` sidecar stores faces and
prebuilt BVH nodes but NOT vertices (serializer.cpp:268-309), so its own
scenes cannot faithfully reload mesh geometry. We write Version=1
sidecars that append the vertex arrays after the reference blocks and
can still read Version=0 files (vertices empty).
"""

from __future__ import annotations

import json
import os
import re
import struct
import zlib

import numpy as np

from ..core.constants import (
    MATERIAL_TYPE_BASIC_DIFFUSE,
    MATERIAL_TYPE_BASIC_METAL,
    MATERIAL_TYPE_BASIC_TRANSLUCENT,
    MATERIAL_TYPE_OPENPBR,
)
from . import bvh as bvh_mod
from .model import (
    ENTITY_TYPE_CAMERA,
    ENTITY_TYPE_MESH_INSTANCE,
    ENTITY_TYPE_ROOT,
    ENTITY_CLASSES,
    MATERIAL_CLASSES,
    SCENE_DIRTY_ALL,
    CameraEntity,
    Mesh,
    Prefab,
    RootEntity,
    Scene,
    Texture,
    Transform,
)

TEX_MAGIC = 0x54455820   # 'TEX '
MESH_MAGIC = 0x4D455348  # 'MESH'
SPEC_MAGIC = 0x53504543  # 'SPEC'


def _make_file_name(name, extension):
    """serializer.cpp:166-179: non-alnum -> '_', strip leading space."""
    out = ''.join(ch if ch.isalnum() else '_' for ch in name)
    out = re.sub(r'^\s+', '', out)
    return f'{out}.{extension}'


def _write_compressed(f, data: bytes):
    comp = zlib.compress(data)
    f.write(struct.pack('<Q', len(comp)))
    f.write(comp)


def _read_compressed(f) -> bytes:
    (size,) = struct.unpack('<Q', f.read(8))
    return zlib.decompress(f.read(size))


def _vecjson(v):
    return [float(x) for x in np.asarray(v).reshape(-1)]


# --- materials: CamelCase field maps (match the reference F() macros) -----

_MATERIAL_FIELDS = {
    MATERIAL_TYPE_BASIC_DIFFUSE: [
        ('BaseColor', 'base_color', 'vec3'),
        ('BaseTexture', 'base_texture', 'texture'),
    ],
    MATERIAL_TYPE_BASIC_METAL: [
        ('BaseColor', 'base_color', 'vec3'),
        ('BaseTexture', 'base_texture', 'texture'),
        ('SpecularColor', 'specular_color', 'vec3'),
        ('SpecularTexture', 'specular_texture', 'texture'),
        ('Roughness', 'roughness', 'float'),
        ('RoughnessTexture', 'roughness_texture', 'texture'),
        ('RoughnessAnisotropy', 'roughness_anisotropy', 'float'),
        ('RoughnessAnisotropyTexture', 'roughness_anisotropy_texture', 'texture'),
    ],
    MATERIAL_TYPE_BASIC_TRANSLUCENT: [
        ('IOR', 'ior', 'float'),
        ('AbbeNumber', 'abbe_number', 'float'),
        ('Roughness', 'roughness', 'float'),
        ('RoughnessTexture', 'roughness_texture', 'texture'),
        ('RoughnessAnisotropy', 'roughness_anisotropy', 'float'),
        ('RoughnessAnisotropyTexture', 'roughness_anisotropy_texture', 'texture'),
        ('TransmissionColor', 'transmission_color', 'vec3'),
        ('TransmissionDepth', 'transmission_depth', 'float'),
        ('ScatteringColor', 'scattering_color', 'vec3'),
        ('ScatteringAnisotropy', 'scattering_anisotropy', 'float'),
    ],
    MATERIAL_TYPE_OPENPBR: [
        ('BaseWeight', 'base_weight', 'float'),
        ('BaseColor', 'base_color', 'vec3'),
        ('BaseColorTexture', 'base_color_texture', 'texture'),
        ('BaseMetalness', 'base_metalness', 'float'),
        ('BaseDiffuseRoughness', 'base_diffuse_roughness', 'float'),
        ('SpecularWeight', 'specular_weight', 'float'),
        ('SpecularColor', 'specular_color', 'vec3'),
        ('SpecularRoughness', 'specular_roughness', 'float'),
        ('SpecularRoughnessTexture', 'specular_roughness_texture', 'texture'),
        ('SpecularRoughnessAnisotropy', 'specular_roughness_anisotropy', 'float'),
        ('SpecularIOR', 'specular_ior', 'float'),
        ('TransmissionWeight', 'transmission_weight', 'float'),
        ('TransmissionColor', 'transmission_color', 'vec3'),
        ('TransmissionDepth', 'transmission_depth', 'float'),
        ('TransmissionScatter', 'transmission_scatter', 'vec3'),
        ('TransmissionScatterAnisotropy', 'transmission_scatter_anisotropy', 'float'),
        ('TransmissionDispersionScale', 'transmission_dispersion_scale', 'float'),
        ('TransmissionDispersionAbbeNumber', 'transmission_dispersion_abbe_number', 'float'),
        ('CoatWeight', 'coat_weight', 'float'),
        ('CoatColor', 'coat_color', 'vec3'),
        ('CoatRoughness', 'coat_roughness', 'float'),
        ('CoatRoughnessAnisotropy', 'coat_roughness_anisotropy', 'float'),
        ('CoatIOR', 'coat_ior', 'float'),
        ('CoatDarkening', 'coat_darkening', 'float'),
        ('EmissionLuminance', 'emission_luminance', 'float'),
        ('EmissionColor', 'emission_color', 'vec3'),
        ('EmissionColorTexture', 'emission_color_texture', 'texture'),
        ('LayerBounceLimit', 'layer_bounce_limit', 'int'),
    ],
}


class _Maps:
    def __init__(self, scene):
        self.texture = {id(t): i for i, t in enumerate(scene.textures)}
        self.material = {id(m): i for i, m in enumerate(scene.materials)}
        self.mesh = {id(m): i for i, m in enumerate(scene.meshes)}


def _material_to_json(material, maps):
    out = {
        'Type': int(material.type),
        'Name': material.name,
        'Flags': int(material.flags),
        'Opacity': float(material.opacity),
    }
    for key, attr, kind in _MATERIAL_FIELDS[material.type]:
        value = getattr(material, attr)
        if kind == 'vec3':
            out[key] = _vecjson(value)
        elif kind == 'texture':
            out[key] = maps.texture.get(id(value), -1) if value is not None else -1
        elif kind == 'int':
            out[key] = int(value)
        else:
            out[key] = float(value)
    return out


def _material_from_json(data, scene):
    material = MATERIAL_CLASSES[int(data['Type'])]()
    material.name = data.get('Name', material.name)
    material.flags = int(data.get('Flags', 0))
    material.opacity = float(data.get('Opacity', 1.0))
    for key, attr, kind in _MATERIAL_FIELDS[material.type]:
        if key not in data:
            continue
        value = data[key]
        if kind == 'vec3':
            setattr(material, attr, np.asarray(value, np.float32))
        elif kind == 'texture':
            setattr(material, attr,
                    scene.textures[value] if value >= 0 else None)
        elif kind == 'int':
            setattr(material, attr, int(value))
        else:
            setattr(material, attr, float(value))
    return material


def _entity_to_json(entity, maps):
    out = {
        'Type': int(entity.type),
        'Position': _vecjson(entity.transform.position),
        'Rotation': _vecjson(entity.transform.rotation),
        'Scale': _vecjson(entity.transform.scale),
        'Name': entity.name,
        'Active': bool(entity.active),
        'Material': maps.material.get(id(entity.material), -1)
                    if entity.material is not None else -1,
    }
    if entity.type == ENTITY_TYPE_ROOT:
        out['ScatterRate'] = float(entity.scatter_rate)
        out['SkyboxBrightness'] = float(entity.skybox_brightness)
        out['SkyboxSamplingProbability'] = float(entity.skybox_sampling_probability)
        out['SkyboxTexture'] = (maps.texture.get(id(entity.skybox_texture), -1)
                                if entity.skybox_texture is not None else -1)
    elif entity.type == ENTITY_TYPE_CAMERA:
        out['CameraModel'] = int(entity.camera_model)
        out['Pinhole'] = {
            'FieldOfViewInDegrees': float(entity.pinhole.field_of_view_in_degrees),
            'ApertureDiameterInMM': float(entity.pinhole.aperture_diameter_in_mm),
        }
        out['ThinLens'] = {
            'SensorSizeInMM': _vecjson(entity.thin_lens.sensor_size_in_mm),
            'FocalLengthInMM': float(entity.thin_lens.focal_length_in_mm),
            'ApertureDiameterInMM': float(entity.thin_lens.aperture_diameter_in_mm),
            'FocusDistance': float(entity.thin_lens.focus_distance),
        }
    elif entity.type == ENTITY_TYPE_MESH_INSTANCE:
        out['Mesh'] = maps.mesh.get(id(entity.mesh), -1) \
            if entity.mesh is not None else -1
    out['Children'] = [_entity_to_json(c, maps) for c in entity.children]
    return out


def _entity_from_json(data, scene, parent=None):
    entity = ENTITY_CLASSES[int(data['Type'])]()
    entity.transform = Transform(
        position=np.asarray(data.get('Position', [0, 0, 0]), np.float32),
        rotation=np.asarray(data.get('Rotation', [0, 0, 0]), np.float32),
        scale=np.asarray(data.get('Scale', [1, 1, 1]), np.float32),
    )
    entity.name = data.get('Name', entity.name)
    entity.active = bool(data.get('Active', True))
    mat_index = int(data.get('Material', -1))
    entity.material = scene.materials[mat_index] if mat_index >= 0 else None
    entity.parent = parent

    if entity.type == ENTITY_TYPE_ROOT:
        entity.scatter_rate = float(data.get('ScatterRate', 0.0))
        entity.skybox_brightness = float(data.get('SkyboxBrightness', 1.0))
        entity.skybox_sampling_probability = float(
            data.get('SkyboxSamplingProbability', 0.0))
        tex = int(data.get('SkyboxTexture', -1))
        entity.skybox_texture = scene.textures[tex] if tex >= 0 else None
    elif entity.type == ENTITY_TYPE_CAMERA:
        entity.camera_model = int(data.get('CameraModel', 0))
        ph = data.get('Pinhole', {})
        entity.pinhole.field_of_view_in_degrees = float(
            ph.get('FieldOfViewInDegrees', 90.0))
        entity.pinhole.aperture_diameter_in_mm = float(
            ph.get('ApertureDiameterInMM', 0.0))
        tl = data.get('ThinLens', {})
        entity.thin_lens.sensor_size_in_mm = np.asarray(
            tl.get('SensorSizeInMM', [32.0, 18.0]), np.float32)
        entity.thin_lens.focal_length_in_mm = float(tl.get('FocalLengthInMM', 20.0))
        entity.thin_lens.aperture_diameter_in_mm = float(
            tl.get('ApertureDiameterInMM', 10.0))
        entity.thin_lens.focus_distance = float(tl.get('FocusDistance', 1.0))
    elif entity.type == ENTITY_TYPE_MESH_INSTANCE:
        mesh_index = int(data.get('Mesh', -1))
        entity.mesh = scene.meshes[mesh_index] if mesh_index >= 0 else None

    for child in data.get('Children', []):
        entity.children.append(_entity_from_json(child, scene, entity))
    return entity


def save_scene(path, scene: Scene):
    """SaveScene (serializer.cpp:518-529): JSON + sidecars next to it."""
    directory = os.path.dirname(os.path.abspath(path))
    os.makedirs(directory, exist_ok=True)
    maps = _Maps(scene)

    doc = {'Textures': [], 'Materials': [], 'Meshes': [], 'Prefabs': []}

    for texture in scene.textures:
        doc['Textures'].append({
            'Type': int(texture.type),
            'Name': texture.name,
            'EnableNearestFiltering': bool(texture.enable_nearest_filtering),
        })
        pixels = np.asarray(texture.pixels, np.float32)
        if pixels.shape[-1] == 3:
            pixels = np.concatenate(
                [pixels, np.ones(pixels.shape[:-1] + (1,), np.float32)], -1)
        with open(os.path.join(directory, _make_file_name(texture.name, 'texture')),
                  'wb') as f:
            f.write(struct.pack('<4I', TEX_MAGIC, 0,
                                texture.width, texture.height))
            _write_compressed(f, pixels.tobytes())

    for material in scene.materials:
        doc['Materials'].append(_material_to_json(material, maps))

    for mesh in scene.meshes:
        doc['Meshes'].append({'Name': mesh.name})
        if mesh.bvh is None:
            mesh.bvh = bvh_mod.build_bvh_cached(mesh.positions[mesh.faces])
        b = mesh.bvh
        faces = np.ascontiguousarray(mesh.faces, np.int32)
        # Reference-layout packed nodes: bounds (6 f32) + FaceBegin,
        # FaceEnd, ChildNodeIndex (3 u32) = 36 bytes (serializer.cpp:268).
        is_leaf = b.b > 0
        nodes = np.zeros((len(b.a), 9), np.float32)
        nodes[:, 0:3] = b.node_min
        nodes[:, 3:6] = b.node_max
        meta = nodes[:, 6:9].view(np.int32)
        meta[:, 0] = np.where(is_leaf, b.a, 0)
        meta[:, 1] = np.where(is_leaf, b.b, 0)
        meta[:, 2] = np.where(is_leaf, 0, b.a)
        with open(os.path.join(directory, _make_file_name(mesh.name, 'mesh')),
                  'wb') as f:
            f.write(struct.pack('<4I', MESH_MAGIC, 1, len(faces), len(b.a)))
            _write_compressed(f, faces[b.face_order].tobytes())
            _write_compressed(f, nodes.tobytes())
            # Version-1 extension: vertex arrays (the reference omits
            # them and cannot reload geometry).
            _write_compressed(f, np.ascontiguousarray(
                mesh.positions, np.float32).tobytes())
            _write_compressed(f, np.ascontiguousarray(
                mesh.normals, np.float32).tobytes())
            _write_compressed(f, np.ascontiguousarray(
                mesh.uvs, np.float32).tobytes())

    for prefab in scene.prefabs:
        doc['Prefabs'].append(_entity_to_json(prefab.entity, maps))

    doc['Root'] = _entity_to_json(scene.root, maps)

    with open(path, 'w') as f:
        json.dump(doc, f, indent=4)


def load_scene(path) -> Scene:
    """LoadScene (serializer.cpp:501-516); marks everything dirty."""
    directory = os.path.dirname(os.path.abspath(path))
    with open(path) as f:
        doc = json.load(f)

    scene = Scene()

    for tex_json in doc.get('Textures', []):
        name = tex_json.get('Name', 'Texture')
        texture = Texture(name=name, type=int(tex_json.get('Type', 0)),
                          enable_nearest_filtering=bool(
                              tex_json.get('EnableNearestFiltering', False)))
        sidecar = os.path.join(directory, _make_file_name(name, 'texture'))
        if os.path.exists(sidecar):
            with open(sidecar, 'rb') as f:
                magic, _, width, height = struct.unpack('<4I', f.read(16))
                assert magic == TEX_MAGIC, hex(magic)
                pixels = np.frombuffer(_read_compressed(f), np.float32)
                texture.pixels = pixels.reshape(height, width, 4).copy()
        scene.textures.append(texture)

    for mat_json in doc.get('Materials', []):
        scene.materials.append(_material_from_json(mat_json, scene))

    for mesh_json in doc.get('Meshes', []):
        name = mesh_json.get('Name', 'Mesh')
        mesh = Mesh(name=name)
        sidecar = os.path.join(directory, _make_file_name(name, 'mesh'))
        if os.path.exists(sidecar):
            with open(sidecar, 'rb') as f:
                magic, version, face_count, node_count = struct.unpack(
                    '<4I', f.read(16))
                assert magic == MESH_MAGIC, hex(magic)
                faces = np.frombuffer(_read_compressed(f), np.int32)
                mesh.faces = faces.reshape(face_count, 3).copy()
                nodes = np.frombuffer(_read_compressed(f), np.float32)
                nodes = nodes.reshape(node_count, 9)
                meta = nodes[:, 6:9].view(np.int32)
                is_leaf = meta[:, 2] == 0
                mesh.bvh = bvh_mod.Bvh(
                    node_min=nodes[:, 0:3].copy(),
                    node_max=nodes[:, 3:6].copy(),
                    a=np.where(is_leaf, meta[:, 0], meta[:, 2]).astype(np.int32),
                    b=np.where(is_leaf, meta[:, 1], 0).astype(np.int32),
                    face_order=np.arange(face_count, dtype=np.int32),
                    depth=0,
                )
                if version >= 1:
                    mesh.positions = np.frombuffer(
                        _read_compressed(f), np.float32).reshape(-1, 3).copy()
                    mesh.normals = np.frombuffer(
                        _read_compressed(f), np.float32).reshape(-1, 3).copy()
                    mesh.uvs = np.frombuffer(
                        _read_compressed(f), np.float32).reshape(-1, 2).copy()
        scene.meshes.append(mesh)

    for prefab_json in doc.get('Prefabs', []):
        scene.prefabs.append(Prefab(entity=_entity_from_json(prefab_json, scene)))

    scene.root = _entity_from_json(doc['Root'], scene)
    scene.dirty_flags = SCENE_DIRTY_ALL
    return scene
