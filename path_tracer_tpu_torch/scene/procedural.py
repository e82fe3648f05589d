# Copied from path_tracer_tpu/scene/procedural.py (numpy-only host code shared with the JAX package).
"""Procedural test scenes and meshes for the benchmark configs.

The reference ships no scene assets (its README screenshot uses the
Viking-room OBJ, not in the repo), so the benchmark configs from
BASELINE.md are built procedurally: analytic Cornell-style box, sphere
arrays, and a "viking-hall" interior mesh whose triangle count and
occlusion structure stand in for the Viking-room scan. All generators
are deterministic.
"""

from __future__ import annotations

import numpy as np

from ..core.constants import (
    CAMERA_MODEL_360,
    CAMERA_MODEL_PINHOLE,
    CAMERA_MODEL_THIN_LENS,
    MATERIAL_TYPE_BASIC_DIFFUSE,
    MATERIAL_TYPE_BASIC_METAL,
    MATERIAL_TYPE_BASIC_TRANSLUCENT,
    TEXTURE_TYPE_RADIANCE,
)
from .model import (
    ENTITY_TYPE_CAMERA,
    ENTITY_TYPE_CUBE,
    ENTITY_TYPE_MESH_INSTANCE,
    ENTITY_TYPE_PLANE,
    ENTITY_TYPE_SPHERE,
    Scene,
    Transform,
)

# --- mesh generators --------------------------------------------------------


def _grid_mesh(nu, nv, fn, close_u=False, close_v=False):
    """Tessellate a parametric surface fn(u, v) -> (pos, normal, uv)."""
    us = np.linspace(0.0, 1.0, nu, endpoint=not close_u)
    vs = np.linspace(0.0, 1.0, nv, endpoint=not close_v)
    uu, vv = np.meshgrid(us, vs, indexing='ij')
    pos, nrm, uv = fn(uu, vv)
    positions = pos.reshape(-1, 3).astype(np.float32)
    normals = nrm.reshape(-1, 3).astype(np.float32)
    uvs = uv.reshape(-1, 2).astype(np.float32)

    def vid(i, j):
        return (i % nu) * nv + (j % nv)

    faces = []
    iu = nu if close_u else nu - 1
    iv = nv if close_v else nv - 1
    for i in range(iu):
        for j in range(iv):
            a, b, c, d = vid(i, j), vid(i + 1, j), vid(i + 1, j + 1), vid(i, j + 1)
            faces.append((a, b, c))
            faces.append((a, c, d))
    return positions, normals, uvs, np.asarray(faces, np.int32)


def uv_sphere(nu=64, nv=32, radius=1.0):
    def fn(u, v):
        phi = u * 2 * np.pi
        theta = v * np.pi
        st, ct = np.sin(theta), np.cos(theta)
        n = np.stack([st * np.cos(phi), st * np.sin(phi), ct], -1)
        return radius * n, n, np.stack([u, v], -1)
    return _grid_mesh(nu, nv, fn, close_u=True)


def torus(nu=64, nv=32, major=1.0, minor=0.35):
    def fn(u, v):
        pu = u * 2 * np.pi
        pv = v * 2 * np.pi
        cu, su = np.cos(pu), np.sin(pu)
        cv, sv = np.cos(pv), np.sin(pv)
        center = np.stack([major * cu, major * su, np.zeros_like(cu)], -1)
        n = np.stack([cv * cu, cv * su, sv], -1)
        return center + minor * n, n, np.stack([u, v], -1)
    return _grid_mesh(nu, nv, fn, close_u=True, close_v=True)


def heightfield(n=128, size=8.0, amplitude=0.6, seed=3):
    rs = np.random.RandomState(seed)
    # Smooth random field from a few sine octaves (deterministic).
    ph = rs.rand(6, 4) * 2 * np.pi
    fr = rs.rand(6, 2) * 3 + 0.5

    def height(x, y):
        h = np.zeros_like(x)
        for k in range(6):
            h += np.sin(fr[k, 0] * x + ph[k, 0]) * np.sin(fr[k, 1] * y + ph[k, 1]) / (k + 1)
        return amplitude * h

    def fn(u, v):
        x = (u - 0.5) * size
        y = (v - 0.5) * size
        z = height(x, y)
        eps = 1e-3
        dzdx = (height(x + eps, y) - height(x - eps, y)) / (2 * eps)
        dzdy = (height(x, y + eps) - height(x, y - eps)) / (2 * eps)
        nrm = np.stack([-dzdx, -dzdy, np.ones_like(z)], -1)
        nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
        return np.stack([x, y, z], -1), nrm, np.stack([u, v], -1)

    return _grid_mesh(n, n, fn)


def merge_meshes(parts):
    """Concatenate (positions, normals, uvs, faces) tuples."""
    positions, normals, uvs, faces = [], [], [], []
    base = 0
    for p, n, u, f in parts:
        positions.append(p)
        normals.append(n)
        uvs.append(u)
        faces.append(f + base)
        base += len(p)
    return (np.concatenate(positions), np.concatenate(normals),
            np.concatenate(uvs), np.concatenate(faces))


def transform_mesh(part, scale=1.0, offset=(0, 0, 0)):
    p, n, u, f = part
    s = np.asarray(scale, np.float32)
    o = np.asarray(offset, np.float32)
    return p * s + o, n, u, f


def viking_hall_mesh(detail=1):
    """Interior-hall stand-in for the Viking room scan.

    detail=1 gives ~90k triangles: a terraced floor, a torus
    chandelier, columns and spheres -- enough BVH depth and occlusion
    variety to be a fair traversal benchmark.
    """
    d = detail
    parts = [
        transform_mesh(heightfield(96 * d, size=10.0, amplitude=0.4), 1.0, (0, 0, 0)),
        transform_mesh(torus(96 * d, 48 * d, 1.2, 0.3), 1.0, (0, 0, 2.2)),
        transform_mesh(uv_sphere(64 * d, 32 * d, 0.8), 1.0, (-2.0, 1.5, 0.9)),
        transform_mesh(uv_sphere(64 * d, 32 * d, 0.6), 1.0, (2.2, -1.0, 0.7)),
    ]
    for i in range(6):
        ang = i * np.pi / 3
        parts.append(transform_mesh(
            torus(32 * d, 16 * d, 0.25, 0.12), 1.0,
            (3.2 * np.cos(ang), 3.2 * np.sin(ang), 1.2)))
    return merge_meshes(parts)


def wood_grain_texture(size=1024, seed=5):
    """Procedural wood-grain albedo, (size, size, 4) float32.

    Concentric growth rings warped by low-frequency sine turbulence
    plus fine along-grain streaks -- deterministic, so the flagship
    bench scene's per-hit texture taps are reproducible. Mirrors the
    role of the Viking room's 4096^2 diffuse atlas in the reference's
    signature scene (README screenshot; sampled per hit at
    scene.glsl.inc:181-205)."""
    rs = np.random.RandomState(seed)
    x = (np.arange(size) + 0.5) / size
    u, v = np.meshgrid(x, x, indexing='ij')
    turb = np.zeros_like(u)
    ph = rs.rand(5, 2) * 2 * np.pi
    fr = rs.rand(5, 2) * 9 + 2
    for k in range(5):
        turb += np.sin(fr[k, 0] * u * 2 * np.pi + ph[k, 0]) \
            * np.sin(fr[k, 1] * v * 2 * np.pi + ph[k, 1]) / (k + 1.5)
    r = np.hypot(u - 0.35, (v - 0.6) * 2.0)
    rings = 0.5 + 0.5 * np.sin(2 * np.pi * (22.0 * r + 0.35 * turb))
    rings = rings ** 2.2
    streaks = 0.08 * np.sin(260.0 * v * 2 * np.pi
                            + 3.0 * np.sin(u * 11 * np.pi))
    t = np.clip(rings + streaks, 0.0, 1.0)[..., None]
    dark = np.asarray([0.26, 0.155, 0.085], np.float32)
    light = np.asarray([0.56, 0.40, 0.225], np.float32)
    rgb = dark * t + light * (1.0 - t)
    alpha = np.ones((size, size, 1), np.float32)
    return np.concatenate([rgb.astype(np.float32), alpha], -1)


def gradient_sky_texture(width=256, height=128, horizon=(1.0, 0.7, 0.4),
                         zenith=(0.3, 0.5, 1.0), sun_dir=(0.4, 0.3, 0.85),
                         sun_intensity=50.0):
    """Synthetic HDR sky: vertical gradient + a bright sun disk."""
    y = np.linspace(0, 1, height)[:, None, None]
    x = np.linspace(0, 1, width)[None, :, None]
    horizon = np.asarray(horizon, np.float32)
    zenith = np.asarray(zenith, np.float32)
    img = horizon * (1 - y) + zenith * y
    theta = (0.5 - (np.linspace(0, 1, height) + 0.5 / height)) * np.pi
    phi = ((np.linspace(0, 1, width) + 0.5 / width) - 0.5) * 2 * np.pi
    ct = np.cos(theta)[:, None]
    st = np.sin(theta)[:, None]
    dirs = np.stack(np.broadcast_arrays(
        ct * np.cos(phi)[None, :], ct * np.sin(phi)[None, :],
        np.broadcast_to(st, (height, width))), -1)
    sun = np.asarray(sun_dir, np.float32)
    sun = sun / np.linalg.norm(sun)
    cos = (dirs * sun).sum(-1)
    img = img + sun_intensity * np.exp((cos - 1.0) * 400.0)[..., None]
    alpha = np.ones((height, width, 1), np.float32)
    return np.concatenate([img.astype(np.float32), alpha], -1)


# --- benchmark scene configs ------------------------------------------------


def make_checker_texture(scene, name='Plane Texture',
                         type=TEXTURE_TYPE_RADIANCE,
                         color_a=(1, 1, 1, 1), color_b=(0.5, 0.5, 0.5, 1)):
    """2x2 nearest-filtered checker (CreateCheckerTexture,
    scene.cpp:270-292)."""
    pixels = np.asarray([[color_a, color_b], [color_b, color_a]], np.float32)
    return scene.create_texture(name=name, type=type, pixels=pixels,
                                enable_nearest_filtering=True)


def make_default_scene():
    """The reference's startup scene (CreateScene, scene.cpp:912-943):
    a checker-textured diffuse plane and a pinhole camera at z=1."""
    from ..core.constants import TEXTURE_TYPE_REFLECTANCE_WITH_ALPHA

    scene = Scene()
    checker = make_checker_texture(
        scene, type=TEXTURE_TYPE_REFLECTANCE_WITH_ALPHA)
    plane_material = scene.create_material(
        MATERIAL_TYPE_BASIC_DIFFUSE, name='Plane Material',
        base_texture=checker)
    scene.create_entity(ENTITY_TYPE_PLANE, material=plane_material,
                        name='Plane')
    scene.create_entity(ENTITY_TYPE_CAMERA, name='Camera',
                        transform=Transform(position=[0, 0, 1]))
    return scene


def make_cornell_scene():
    """Config 1: Cornell-style open box of planes + diffuse spheres."""
    scene = Scene()
    white = scene.create_material(MATERIAL_TYPE_BASIC_DIFFUSE, name='white',
                                  base_color=np.asarray([0.73, 0.73, 0.73]))
    red = scene.create_material(MATERIAL_TYPE_BASIC_DIFFUSE, name='red',
                                base_color=np.asarray([0.65, 0.05, 0.05]))
    green = scene.create_material(MATERIAL_TYPE_BASIC_DIFFUSE, name='green',
                                  base_color=np.asarray([0.12, 0.45, 0.15]))

    # Walls are thin finite cubes (planes are infinite and would seal the
    # box against the skybox light); the top stays open to the sky.
    scene.create_entity(ENTITY_TYPE_PLANE, material=white, name='floor')
    scene.create_entity(ENTITY_TYPE_CUBE, material=red, name='left',
                        transform=Transform(position=[-2.05, 0, 2],
                                            scale=[0.05, 2.0, 2.0],
                                            scale_is_uniform=False))
    scene.create_entity(ENTITY_TYPE_CUBE, material=green, name='right',
                        transform=Transform(position=[2.05, 0, 2],
                                            scale=[0.05, 2.0, 2.0],
                                            scale_is_uniform=False))
    scene.create_entity(ENTITY_TYPE_CUBE, material=white, name='back',
                        transform=Transform(position=[0, 2.05, 2],
                                            scale=[2.1, 0.05, 2.0],
                                            scale_is_uniform=False))
    scene.create_entity(ENTITY_TYPE_SPHERE, material=white, name='ball-a',
                        transform=Transform(position=[-0.8, 0.8, 0.6],
                                            scale=0.6))
    scene.create_entity(ENTITY_TYPE_SPHERE, material=white, name='ball-b',
                        transform=Transform(position=[0.9, 0.2, 0.45],
                                            scale=0.45))
    cam = scene.create_entity(ENTITY_TYPE_CAMERA, name='camera',
                              transform=Transform(position=[0, -4.5, 2.0],
                                                  rotation=[np.pi / 2, 0, 0]))
    cam.pinhole.field_of_view_in_degrees = 60.0
    scene.root.skybox_brightness = 1.0
    return scene


def make_sphere_array_scene():
    """Config 2: reflective + refractive sphere array, thin-lens DoF."""
    scene = Scene()
    floor = scene.create_material(MATERIAL_TYPE_BASIC_DIFFUSE, name='floor',
                                  base_color=np.asarray([0.6, 0.6, 0.65]))
    scene.create_entity(ENTITY_TYPE_PLANE, material=floor)
    for i in range(4):
        for j in range(3):
            if (i + j) % 2 == 0:
                m = scene.create_material(
                    MATERIAL_TYPE_BASIC_METAL, name=f'metal{i}{j}',
                    base_color=np.asarray([0.9, 0.6 + 0.1 * j, 0.3 + 0.2 * i / 3]),
                    roughness=0.05 * (1 + i))
            else:
                m = scene.create_material(
                    MATERIAL_TYPE_BASIC_TRANSLUCENT, name=f'glass{i}{j}',
                    ior=1.45 + 0.05 * j, abbe_number=30.0, roughness=0.02,
                    transmission_color=np.asarray([0.9, 0.95, 1.0]),
                    transmission_depth=0.5)
            scene.create_entity(
                ENTITY_TYPE_SPHERE, material=m,
                transform=Transform(position=[(i - 1.5) * 1.4, j * 1.6, 0.6],
                                    scale=0.6))
    cam = scene.create_entity(
        ENTITY_TYPE_CAMERA,
        transform=Transform(position=[0, -4.0, 1.4], rotation=[np.pi / 2.3, 0, 0]))
    cam.camera_model = CAMERA_MODEL_THIN_LENS
    cam.thin_lens.focus_distance = 4.2
    cam.thin_lens.focal_length_in_mm = 35.0
    cam.thin_lens.aperture_diameter_in_mm = 8.0
    return scene


def make_viking_hall_scene(detail=1, with_sky=True, textured=True):
    """Config 3: triangle-mesh interior + BVH + HDR skybox.

    textured=True (the default and the headline configuration since
    round 4) gives the hall material a 1024^2 wood-grain base texture
    and a 2048x1024 HDR sky, so every mesh hit pays a real per-hit
    atlas tap and the skybox taps sample a production-size panorama --
    matching the reference's signature textured Viking-room workload
    (scene.glsl.inc:181-205; its .hdr imports are 4096^2 layers,
    scene.cpp:1119-1233). textured=False keeps the round-3
    constant-color variant for A/B measurement."""
    scene = Scene()
    p, n, u, f = viking_hall_mesh(detail)
    mesh = scene.create_mesh(name='viking-hall', positions=p, normals=n,
                             uvs=u, faces=f)
    wood_kwargs = dict(base_color=np.asarray([0.45, 0.31, 0.18]))
    if textured:
        from ..core.constants import TEXTURE_TYPE_REFLECTANCE_WITH_ALPHA
        grain = scene.create_texture(
            name='wood-grain', type=TEXTURE_TYPE_REFLECTANCE_WITH_ALPHA,
            pixels=wood_grain_texture(1024))
        wood_kwargs = dict(base_color=np.asarray([0.9, 0.9, 0.9]),
                           base_texture=grain)
    wood = scene.create_material(MATERIAL_TYPE_BASIC_DIFFUSE, name='wood',
                                 **wood_kwargs)
    scene.create_entity(ENTITY_TYPE_MESH_INSTANCE, mesh=mesh, material=wood)
    cam = scene.create_entity(
        ENTITY_TYPE_CAMERA,
        transform=Transform(position=[0.0, -6.5, 2.4], rotation=[np.pi / 2.2, 0, 0]))
    cam.pinhole.field_of_view_in_degrees = 70.0
    if with_sky:
        size = (2048, 1024) if textured else (256, 128)
        sky = scene.create_texture(name='sky', type=TEXTURE_TYPE_RADIANCE,
                                   pixels=gradient_sky_texture(*size))
        scene.root.skybox_texture = sky
        scene.root.skybox_sampling_probability = 0.25
    return scene


def make_360_scene():
    """Config 4: 360 camera over a mixed mesh/primitive scene."""
    scene = make_sphere_array_scene()
    p, n, u, f = torus(128, 64, 1.5, 0.4)
    mesh = scene.create_mesh(name='torus', positions=p, normals=n, uvs=u, faces=f)
    shiny = scene.create_material(MATERIAL_TYPE_BASIC_METAL, name='torus-metal',
                                  base_color=np.asarray([0.8, 0.8, 0.9]),
                                  roughness=0.15)
    scene.create_entity(ENTITY_TYPE_MESH_INSTANCE, mesh=mesh, material=shiny,
                        transform=Transform(position=[0, 1.0, 2.5]))
    for e in scene.walk_entities():
        if e.type == 2:  # camera entity
            e.camera_model = CAMERA_MODEL_360
    return scene


def make_multi_mesh_scene(detail=1):
    """Config 5: multi-mesh editor scene (pod-sharded 4K accumulation)."""
    scene = make_viking_hall_scene(detail)
    p, n, u, f = uv_sphere(96, 48)
    ball = scene.create_mesh(name='ball', positions=p, normals=n, uvs=u, faces=f)
    glass = scene.create_material(MATERIAL_TYPE_BASIC_TRANSLUCENT, name='glass',
                                  ior=1.5, abbe_number=35.0, roughness=0.0,
                                  transmission_color=np.asarray([0.95, 0.97, 1.0]),
                                  transmission_depth=1.0)
    scene.create_entity(ENTITY_TYPE_MESH_INSTANCE, mesh=ball, material=glass,
                        transform=Transform(position=[0.3, -2.0, 1.2], scale=0.7))
    cube_mat = scene.create_material(MATERIAL_TYPE_BASIC_METAL, name='cube-metal',
                                     base_color=np.asarray([0.95, 0.64, 0.54]),
                                     roughness=0.2)
    scene.create_entity(ENTITY_TYPE_CUBE, material=cube_mat,
                        transform=Transform(position=[-2.5, -1.5, 0.5], scale=0.5))
    return scene


def make_terrain_scene(side=900, with_sky=True):
    """Config 6: a ~2*side^2-triangle displaced terrain of UNIQUE
    geometry (no instancing to share), sized so the two-level tables
    oversubscribe the 64 MB VMEM budget and the trace kernel streams
    cold rows from HBM (ops/trace_inst.py residency_split). The
    large-scene analog of the reference's 256 MiB+ SSBO scenes
    (scene.cpp:1648-1661)."""
    rng = np.random.default_rng(11)
    scene = Scene()
    x = np.linspace(-50, 50, side + 1, dtype=np.float32)
    gx, gy = np.meshgrid(x, x, indexing='ij')
    gz = (2.0 * np.sin(gx * 0.37) * np.cos(gy * 0.29)
          + 0.7 * np.sin(gx * 1.7 + gy * 1.3)
          + rng.normal(0, 0.15, gx.shape)).astype(np.float32)
    pos = np.stack([gx, gy, gz], axis=-1).reshape(-1, 3)
    ii = np.arange(side * (side + 1)).reshape(side, side + 1)[:, :side]
    a = ii.ravel()
    b = a + 1
    c = a + side + 1
    d = c + 1
    faces = np.concatenate([np.stack([a, b, c], 1),
                            np.stack([b, d, c], 1)]).astype(np.int32)
    nrm = np.zeros_like(pos)
    nrm[:, 2] = 1.0
    uv = ((pos[:, :2] + 50.0) / 100.0).astype(np.float32)
    mesh = scene.create_mesh(name='terrain', positions=pos, normals=nrm,
                             uvs=uv, faces=faces)
    ground = scene.create_material(MATERIAL_TYPE_BASIC_DIFFUSE, name='ground',
                                   base_color=np.asarray([0.35, 0.42, 0.25]))
    scene.create_entity(ENTITY_TYPE_MESH_INSTANCE, mesh=mesh,
                        material=ground)
    cam = scene.create_entity(
        ENTITY_TYPE_CAMERA,
        transform=Transform(position=[0.0, -40.0, 14.0],
                            rotation=[np.pi / 2.5, 0, 0]))
    cam.pinhole.field_of_view_in_degrees = 75.0
    if with_sky:
        sky = scene.create_texture(name='sky', type=TEXTURE_TYPE_RADIANCE,
                                   pixels=gradient_sky_texture())
        scene.root.skybox_texture = sky
        scene.root.skybox_sampling_probability = 0.25
    return scene
