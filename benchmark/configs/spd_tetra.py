"""The `tetra` scene of Eric Haines's Standard Procedural Databases
(`tetra.c`): a Sierpinski tetrahedron, in which a regular tetrahedron is
replaced by four copies at half scale, one at each of its corners, down
to the configuration's depth, every leaf tetrahedron drawn as its four
triangles (`spd_tetra.json`). Lit here by a uniform white sky and seen
by a pinhole camera off the axes.

`make_scene(api, cfg)` builds the scene through `api`, a namespace of a
scene model module and its constants (`Scene`, `Transform`,
`ENTITY_TYPE_*`, `MATERIAL_TYPE_*`, `TEXTURE_TYPE_*`): the program's, or
the plain reference's copy of it. The same calls on either give the same
document. `tetrahedra(depth, base)` and `tetra_mesh(tets)` are the
geometry, built whole in numpy.
"""

from __future__ import annotations

import math

import numpy as np


def tetrahedra(depth, base):
    """(4^depth, 4, 3) float64 corners of the leaf tetrahedra: each level
    replaces every tetrahedron by its four children, child j having the
    corners 0.5 x corner k + 0.5 x corner j of its parent. Children of
    one parent are consecutive, in corner order."""
    tets = np.asarray(base, np.float64)[None]
    for _ in range(depth):
        # [n, j, k] = midpoint of corners j and k of tetrahedron n.
        tets = (0.5 * (tets[:, :, None, :] + tets[:, None, :, :])).reshape(-1, 4, 3)
    return tets


# The triangle left when corner k is dropped: the other three, in order.
FACES_OF_TETRAHEDRON = np.asarray([[1, 2, 3], [0, 2, 3], [0, 1, 3], [0, 1, 2]])


def tetra_mesh(tets):
    """(positions, normals, uvs, faces) of the tetrahedra's 4 triangles
    each, flat-shaded: three vertices of their own a triangle, wound so
    that the normal points away from the dropped corner (outward), and
    zero uvs. Triangle 4 t + k is tetrahedron t without corner k."""
    tri = tets[:, FACES_OF_TETRAHEDRON]                          # (T, 4, 3, 3)
    n = np.cross(tri[..., 1, :] - tri[..., 0, :], tri[..., 2, :] - tri[..., 0, :])
    inward = np.einsum('tkc,tkc->tk', n, tets - tri[..., 0, :]) > 0
    tri[inward] = tri[inward][:, [0, 2, 1]]
    n[inward] = -n[inward]
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    tri = tri.reshape(-1, 3, 3)
    positions = tri.reshape(-1, 3).astype(np.float32)
    normals = np.repeat(n.reshape(-1, 3), 3, axis=0).astype(np.float32)
    faces = np.arange(len(positions), dtype=np.int32).reshape(-1, 3)
    return positions, normals, np.zeros((len(positions), 2), np.float32), faces


def make_scene(api, cfg):
    depth = cfg['depth']
    if 4 ** depth != cfg['tetrahedra'] or 4 ** (depth + 1) != cfg['triangles']:
        raise ValueError(f'spd_tetra: depth {depth} gives {4 ** depth} tetrahedra '
                         f'and {4 ** (depth + 1)} triangles, the configuration '
                         f'states {cfg["tetrahedra"]} and {cfg["triangles"]}')
    scene = api.Scene()
    positions, normals, uvs, faces = tetra_mesh(tetrahedra(depth, cfg['vertices']))
    mesh = scene.create_mesh(name='tetra', positions=positions, normals=normals,
                             uvs=uvs, faces=faces)
    surface = scene.create_material(
        api.MATERIAL_TYPE_BASIC_DIFFUSE, name='tetra',
        base_color=np.asarray(cfg['material']['base_color'], np.float32))
    scene.create_entity(api.ENTITY_TYPE_MESH_INSTANCE, mesh=mesh,
                        material=surface, name='tetra')

    cam = cfg['camera']
    look_from = np.asarray(cam['look_from'], np.float64)
    forward = np.asarray(cam['look_at'], np.float64) - look_from
    forward /= np.linalg.norm(forward)
    if list(cam['vup']) != [0.0, 1.0, 0.0]:
        raise ValueError('spd_tetra: the maker states vup +y')
    # The camera looks down its local -z with +y up: a pitch about x, then
    # a turn about +y, point it along `forward` with no roll.
    pitch = math.asin(forward[1])
    yaw = math.atan2(-forward[0], -forward[2])
    camera = scene.create_entity(
        api.ENTITY_TYPE_CAMERA, name='camera',
        transform=api.Transform(position=look_from, rotation=[pitch, yaw, 0.0]))
    # The pinhole's field of view is horizontal: the one that gives the
    # stated vertical one on the configuration's film.
    aspect = cfg['image']['width'] / cfg['image']['height']
    half = math.radians(cam['vfov_degrees'] / 2.0)
    camera.pinhole.field_of_view_in_degrees = math.degrees(
        2.0 * math.atan(aspect * math.tan(half)))

    sky = cfg['sky']
    w, h = sky['equirect']
    pixels = np.ones((h, w, 4), np.float32)
    pixels[..., :3] = np.asarray(sky['radiance'], np.float32)
    scene.root.skybox_texture = scene.create_texture(
        name='sky', type=api.TEXTURE_TYPE_RADIANCE, pixels=pixels)
    scene.root.skybox_brightness = sky['brightness']
    scene.root.skybox_sampling_probability = sky['sampling_probability']
    return scene
