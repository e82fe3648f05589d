"""The Cornell box as its data page publishes it: five walls, two
blocks, the ceiling light and the camera, in mm (`cornell_box.json`).

`make_scene(api, cfg)` builds the scene through `api`, a namespace of a
scene model module and its constants (`Scene`, `Transform`,
`ENTITY_TYPE_*`, `MATERIAL_TYPE_*`): the program's, or the plain
reference's copy of it. The same calls on either give the same document.
Each quad is two triangles; the surfaces of one material are one mesh,
with flat normals facing into the room (walls) or out of the block.
"""

from __future__ import annotations

import math

import numpy as np

ROOM_CENTRE = np.asarray([278.0, 274.4, 279.6])


def quads_mesh(quads, inward, centres):
    """(positions, normals, uvs, faces) of flat-shaded quads; each normal
    faces its `centres` point when `inward`, else away from it."""
    positions, normals, faces = [], [], []
    for quad, centre in zip(quads, centres):
        q = np.asarray(quad, np.float64)
        n = np.cross(q[1] - q[0], q[2] - q[0])
        n /= np.linalg.norm(n)
        towards = np.dot(centre - q.mean(0), n) > 0
        if towards != inward:
            n = -n
        base = len(positions)
        positions.extend(q)
        normals.extend([n] * 4)
        faces.extend([[base, base + 1, base + 2], [base, base + 2, base + 3]])
    return (np.asarray(positions, np.float32), np.asarray(normals, np.float32),
            np.zeros((len(positions), 2), np.float32),
            np.asarray(faces, np.int32))


def make_scene(api, cfg):
    scene = api.Scene()
    materials = {
        name: scene.create_material(api.MATERIAL_TYPE_BASIC_DIFFUSE, name=name,
                                    base_color=np.asarray(rgb, np.float32))
        for name, rgb in cfg['materials'].items()}
    parts = {}
    for s in cfg['surfaces']:
        quads = np.asarray(s['quads'], np.float64)
        centre = ROOM_CENTRE if s['inward'] else \
            quads.reshape(-1, 3).mean(0)
        parts.setdefault(s['material'], []).append(
            (quads, s['inward'], [centre] * len(quads)))
    for name, group in parts.items():
        meshes = [quads_mesh(*g) for g in group]
        p, n, u, f = [], [], [], []
        base = 0
        for mp, mn, mu, mf in meshes:
            p.append(mp)
            n.append(mn)
            u.append(mu)
            f.append(mf + base)
            base += len(mp)
        mesh = scene.create_mesh(name=name, positions=np.concatenate(p),
                                 normals=np.concatenate(n),
                                 uvs=np.concatenate(u),
                                 faces=np.concatenate(f))
        scene.create_entity(api.ENTITY_TYPE_MESH_INSTANCE, mesh=mesh,
                            material=materials[name], name=name)

    light = cfg['light']
    quad = np.asarray(light['quad'], np.float64)
    quad[:, 1] -= light['light_drop_mm']
    p, n, u, f = quads_mesh([quad], True, [ROOM_CENTRE])
    mesh = scene.create_mesh(name='light', positions=p, normals=n, uvs=u,
                             faces=f)
    emitter = scene.create_material(
        api.MATERIAL_TYPE_OPENPBR, name='light', base_weight=0.0,
        specular_weight=0.0, emission_luminance=light['emission_luminance'],
        emission_color=np.asarray(light['emission_color'], np.float32))
    scene.create_entity(api.ENTITY_TYPE_MESH_INSTANCE, mesh=mesh,
                        material=emitter, name='light')

    triangles = sum(len(m.faces) for m in scene.meshes)
    if triangles != cfg['triangles']:
        raise ValueError(f'cornell_box: {triangles} triangles, the '
                         f'configuration states {cfg["triangles"]}')

    cam = cfg['camera']
    d = np.asarray(cam['direction'], np.float64)
    if list(cam['up']) != [0.0, 1.0, 0.0] or abs(d[1]) > 0:
        raise ValueError('cornell_box: the maker turns the camera about +y only')
    # The camera looks down its local -z; a turn about +y points it at d.
    yaw = math.atan2(-d[0], -d[2])
    camera = scene.create_entity(
        api.ENTITY_TYPE_CAMERA, name='camera',
        transform=api.Transform(position=cam['position'], rotation=[0.0, yaw, 0.0]))
    film_w, film_h = cam['film_m']
    if film_w != film_h:
        raise ValueError('cornell_box: the maker states a square film')
    camera.pinhole.field_of_view_in_degrees = math.degrees(
        2.0 * math.atan(0.5 * film_h / cam['focal_length_m']))
    scene.root.skybox_brightness = cfg['skybox_brightness']
    return scene
