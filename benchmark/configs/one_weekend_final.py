"""The final render of Ray Tracing in One Weekend (Shirley, Black,
Hollasch, v4.0.1, section 14.1): a ground sphere, the small spheres of
the 22 x 22 grid as drawn once by the book's rule, the three large
spheres, the thin-lens camera and the sky gradient
(`one_weekend_final.json`, in metres).

`make_scene(api, cfg)` builds the scene through `api`, a namespace of a
scene model module and its constants (`Scene`, `Transform`,
`ENTITY_TYPE_*`, `MATERIAL_TYPE_*`, `TEXTURE_TYPE_*`): the program's, or
the plain reference's copy of it. The same calls on either give the same
document. `draw_small_spheres(seed)` is the draw that the file froze.
"""

from __future__ import annotations

import math

import numpy as np

GRID = range(-11, 11)
SMALL_RADIUS = 0.2
KEEP_OUT = (4.0, 0.2, 0.0)
KEEP_OUT_RADIUS = 0.9
DECIMALS = 6


def draw_small_spheres(seed):
    """The book's grid of small spheres (section 14.1), drawn from
    numpy's default_rng(seed) in the book's order of draws: the material
    choice, the centre's two offsets, then the material's parameters.
    Values rounded to DECIMALS places, as the configuration stores them."""
    rng = np.random.default_rng(seed)
    out = []

    def r(x):
        return [round(float(v), DECIMALS) for v in np.atleast_1d(x)]

    for a in GRID:
        for b in GRID:
            choose = rng.random()
            centre = np.asarray([a + 0.9 * rng.random(), SMALL_RADIUS,
                                 b + 0.9 * rng.random()])
            if np.linalg.norm(centre - np.asarray(KEEP_OUT)) <= KEEP_OUT_RADIUS:
                continue
            sphere = dict(centre=r(centre), radius=SMALL_RADIUS)
            if choose < 0.8:
                sphere.update(material='lambertian',
                              albedo=r(rng.random(3) * rng.random(3)))
            elif choose < 0.95:
                sphere.update(material='metal',
                              albedo=r(rng.uniform(0.5, 1.0, 3)),
                              fuzz=r(rng.uniform(0.0, 0.5))[0])
            else:
                sphere.update(material='dielectric', ior=1.5)
            out.append(sphere)
    return out


def sky_pixels(cfg):
    """The book's sky, lerp(bottom, top, 0.5 (dir.y + 1)), baked into an
    equirect of the program's skybox lookup: u = 0.5 + atan2(d.y, d.x) /
    2 pi, v = 0.5 + asin(d.z) / pi, pixel row 0 at v = 1."""
    sky = cfg['sky']
    w, h = sky['equirect']
    u = (np.arange(w) + 0.5) / w
    v = 1.0 - (np.arange(h) + 0.5) / h
    phi = (u - 0.5) * 2.0 * np.pi
    theta = (v - 0.5) * np.pi
    dir_y = np.cos(theta)[:, None] * np.sin(phi)[None, :]
    a = (0.5 * (dir_y + 1.0))[..., None]
    rgb = (1.0 - a) * np.asarray(sky['bottom']) + a * np.asarray(sky['top'])
    return np.concatenate([rgb, np.ones((h, w, 1))], -1).astype(np.float32)


def _material(api, scene, sphere, glass, abbe):
    kind = sphere['material']
    if kind == 'lambertian':
        return scene.create_material(
            api.MATERIAL_TYPE_BASIC_DIFFUSE,
            base_color=np.asarray(sphere['albedo'], np.float32))
    if kind == 'metal':
        return scene.create_material(
            api.MATERIAL_TYPE_BASIC_METAL,
            base_color=np.asarray(sphere['albedo'], np.float32),
            specular_color=np.ones(3, np.float32), roughness=sphere['fuzz'],
            roughness_anisotropy=0.0)
    if kind == 'dielectric':
        key = float(sphere['ior'])
        if key not in glass:
            glass[key] = scene.create_material(
                api.MATERIAL_TYPE_BASIC_TRANSLUCENT, ior=key,
                abbe_number=abbe, roughness=0.0,
                roughness_anisotropy=0.0)
        return glass[key]
    raise ValueError(f'one_weekend_final: unknown material {kind!r}')


def make_scene(api, cfg):
    scene = api.Scene()
    spheres = [cfg['ground']] + cfg['small_spheres'] + cfg['large_spheres']
    if len(spheres) != cfg['spheres']:
        raise ValueError(f'one_weekend_final: {len(spheres)} spheres, the '
                         f'configuration states {cfg["spheres"]}')
    glass = {}
    for s in spheres:
        scene.create_entity(
            api.ENTITY_TYPE_SPHERE,
            material=_material(api, scene, s, glass, cfg['glass_abbe_number']),
            transform=api.Transform(position=s['centre'], scale=s['radius']))

    cam = cfg['camera']
    look_from = np.asarray(cam['look_from'], np.float64)
    forward = np.asarray(cam['look_at'], np.float64) - look_from
    forward /= np.linalg.norm(forward)
    if list(cam['vup']) != [0.0, 1.0, 0.0]:
        raise ValueError('one_weekend_final: the maker states vup +y')
    # The camera looks down its local -z with +y up: a pitch about x, then
    # a turn about +y, point it along `forward` with no roll.
    pitch = math.asin(forward[1])
    yaw = math.atan2(-forward[0], -forward[2])
    camera = scene.create_entity(
        api.ENTITY_TYPE_CAMERA, name='camera',
        camera_model=api.CAMERA_MODEL_THIN_LENS,
        transform=api.Transform(position=look_from, rotation=[pitch, yaw, 0.0]))
    lens = camera.thin_lens
    focal_mm = cam['focal_length_mm']
    focus = cam['focus_distance']
    # The sensor distance the program derives (1 / (1/f - 1/focus)), and
    # the sensor that gives the vertical field of view at it.
    s = 1.0 / (1000.0 / focal_mm - 1.0 / focus)
    sensor_h = 2.0 * s * math.tan(math.radians(cam['vfov_degrees'] / 2.0)) * 1000.0
    aspect = cfg['image']['width'] / cfg['image']['height']
    lens.sensor_size_in_mm = np.asarray([aspect * sensor_h, sensor_h], np.float32)
    lens.focal_length_in_mm = focal_mm
    lens.focus_distance = focus
    lens.aperture_diameter_in_mm = 2.0 * focus * math.tan(
        math.radians(cam['defocus_angle_degrees'] / 2.0)) * 1000.0

    sky = scene.create_texture(name='sky', type=api.TEXTURE_TYPE_RADIANCE,
                               pixels=sky_pixels(cfg))
    scene.root.skybox_texture = sky
    scene.root.skybox_brightness = cfg['sky']['brightness']
    scene.root.skybox_sampling_probability = cfg['sky']['sampling_probability']
    return scene
