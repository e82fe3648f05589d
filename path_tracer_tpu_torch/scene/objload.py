# Copied from path_tracer_tpu/scene/objload.py (numpy-only host code shared with the JAX package).
"""Wavefront OBJ/MTL import -> meshes, materials, prefab.

Own parser (the reference vendors tinyobjloader; scene.cpp:601-903 does
the import): supports v/vn/vt/f (triangulating fans), usemtl/mtllib,
`o`/`g` object splits. Like the reference, geometry is split into one
mesh per (object, material) pair, vertices are deduplicated per mesh,
missing normals are generated area-weighted, and everything is wrapped
in a prefab whose root carries one mesh-instance child per mesh.
"""

from __future__ import annotations

import os
from collections import defaultdict

import numpy as np

from ..core.constants import MATERIAL_TYPE_BASIC_DIFFUSE, TEXTURE_TYPE_REFLECTANCE_WITH_ALPHA
from .model import (
    ENTITY_TYPE_CONTAINER,
    ENTITY_TYPE_MESH_INSTANCE,
    ContainerEntity,
    MeshEntity,
    Prefab,
    SCENE_DIRTY_ALL,
)


def _parse_mtl(path, scene, texture_loader=None):
    """Parse a .mtl file into BasicDiffuse materials (Kd / map_Kd)."""
    materials = {}
    current = None
    if not os.path.exists(path):
        return materials
    directory = os.path.dirname(path)
    for raw in open(path, errors='replace'):
        parts = raw.split()
        if not parts or parts[0].startswith('#'):
            continue
        if parts[0] == 'newmtl':
            name = parts[1] if len(parts) > 1 else 'material'
            current = scene.create_material(MATERIAL_TYPE_BASIC_DIFFUSE, name=name)
            materials[name] = current
        elif current is not None and parts[0] == 'Kd':
            current.base_color = np.asarray(
                [float(parts[1]), float(parts[2]), float(parts[3])], np.float32)
        elif current is not None and parts[0] == 'map_Kd' and texture_loader:
            tex_path = os.path.join(directory, ' '.join(parts[1:]))
            try:
                pixels = texture_loader(tex_path)
                texture = scene.create_texture(
                    name=os.path.basename(tex_path),
                    type=TEXTURE_TYPE_REFLECTANCE_WITH_ALPHA, pixels=pixels)
                current.base_texture = texture
            except (OSError, ValueError):
                pass
    return materials


def load_model_as_prefab(scene, path, name=None, texture_loader=None):
    """LoadModelAsPrefab (scene.cpp:601-903): OBJ -> meshes + prefab."""
    positions = [(0.0, 0.0, 0.0)]
    normals = [(0.0, 0.0, 1.0)]
    uvs = [(0.0, 0.0)]
    # (object, material) -> list of faces, each face = 3 (v, vt, vn)
    groups = defaultdict(list)
    materials = {}
    current_material = None
    current_object = ''

    directory = os.path.dirname(os.path.abspath(path))

    for raw in open(path, errors='replace'):
        parts = raw.split()
        if not parts or parts[0].startswith('#'):
            continue
        tag = parts[0]
        if tag == 'v':
            positions.append(tuple(float(x) for x in parts[1:4]))
        elif tag == 'vn':
            normals.append(tuple(float(x) for x in parts[1:4]))
        elif tag == 'vt':
            uvs.append((float(parts[1]), float(parts[2])))
        elif tag in ('o', 'g'):
            current_object = ' '.join(parts[1:]) if len(parts) > 1 else ''
        elif tag == 'mtllib':
            materials.update(_parse_mtl(os.path.join(directory, ' '.join(parts[1:])),
                                        scene, texture_loader))
        elif tag == 'usemtl':
            current_material = ' '.join(parts[1:]) if len(parts) > 1 else None
        elif tag == 'f':
            verts = []
            for spec in parts[1:]:
                comps = spec.split('/')
                vi = int(comps[0])
                ti = int(comps[1]) if len(comps) > 1 and comps[1] else 0
                ni = int(comps[2]) if len(comps) > 2 and comps[2] else 0
                # Negative indices are relative to the current end.
                vi = vi if vi >= 0 else len(positions) + vi
                ti = ti if ti >= 0 else len(uvs) + ti
                ni = ni if ni >= 0 else len(normals) + ni
                verts.append((vi, ti, ni))
            for k in range(1, len(verts) - 1):  # triangulate fan
                groups[(current_object, current_material)].append(
                    (verts[0], verts[k], verts[k + 1]))

    positions = np.asarray(positions, np.float32)
    normals_in = np.asarray(normals, np.float32)
    uvs_in = np.asarray(uvs, np.float32)

    name = name or os.path.splitext(os.path.basename(path))[0]
    root = ContainerEntity()
    root.name = name

    for (obj_name, mat_name), faces in groups.items():
        # Vertex dedup per (object, material) mesh (scene.cpp:820-850).
        remap = {}
        mesh_positions, mesh_normals, mesh_uvs, mesh_faces = [], [], [], []
        missing_normals = False
        for tri in faces:
            idx = []
            for v, t, n in tri:
                key = (v, t, n)
                if key not in remap:
                    remap[key] = len(mesh_positions)
                    mesh_positions.append(positions[v])
                    mesh_normals.append(normals_in[n] if n else np.zeros(3, np.float32))
                    if n == 0:
                        missing_normals = True
                    mesh_uvs.append(uvs_in[t] if t else np.zeros(2, np.float32))
                idx.append(remap[key])
            mesh_faces.append(idx)

        p = np.asarray(mesh_positions, np.float32)
        n = np.asarray(mesh_normals, np.float32)
        u = np.asarray(mesh_uvs, np.float32)
        f = np.asarray(mesh_faces, np.int32)

        if missing_normals:
            # Area-weighted vertex normals (scene.cpp normal generation).
            fn = np.cross(p[f[:, 1]] - p[f[:, 0]], p[f[:, 2]] - p[f[:, 0]])
            acc = np.zeros_like(p)
            for c in range(3):
                np.add.at(acc, f[:, c], fn)
            norm = np.linalg.norm(acc, axis=-1, keepdims=True)
            generated = acc / np.maximum(norm, 1e-12)
            missing = np.linalg.norm(n, axis=-1) < 1e-6
            n = np.where(missing[:, None], generated, n)

        mesh_label = ' / '.join(x for x in (name, obj_name, mat_name) if x) or name
        mesh = scene.create_mesh(name=mesh_label, positions=p, normals=n,
                                 uvs=u, faces=f)
        instance = MeshEntity(mesh=mesh,
                              material=materials.get(mat_name))
        instance.name = mesh_label
        instance.parent = root
        root.children.append(instance)

    prefab = Prefab(entity=root)
    scene.prefabs.append(prefab)
    scene.mark_dirty(SCENE_DIRTY_ALL)
    return prefab
