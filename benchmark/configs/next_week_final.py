"""The closing scene of Ray Tracing: The Next Week (Shirley, Black,
Hollasch, v4.0.1, section 10, `final_scene(800, 10000, 40)`): a ground of
20 x 20 boxes, a quad light, a diffuse sphere, two glass spheres (one
filled with a scattering medium), a fuzzy metal sphere, a diffuse sphere
in the earth's place, a marble sphere and a rotated cluster of 1,000 white
spheres, seen by a pinhole camera on a black background
(`next_week_final.json`, in the book's world units).

`make_scene(api, cfg)` builds the scene through `api`, a namespace of a
scene model module and its constants (`Scene`, `Transform`,
`ENTITY_TYPE_*`, `MATERIAL_TYPE_*`, `TEXTURE_TYPE_*`): the program's, or
the plain reference's copy of it. The same calls on either give the same
document. `draw(seed)` is the draw that the file froze;
`marble_pixels(cfg)` bakes the marble sphere's `noise_texture` into the
texture it wears.
"""

from __future__ import annotations

import json
import math

import numpy as np

DECIMALS = 6
BOXES_PER_SIDE = 20
PERLIN_POINTS = 256
CLUSTER_COUNT = 1000
BAKE_BLOCK = 1 << 16

# The bake of the last configuration seen: make_scene runs twice in a run
# (the program's scene and the reference's), on the same tables.
_BAKED = {}


def draw(seed):
    """The book's random draws of `final_scene`, from numpy's
    default_rng(seed) in the book's order: the ground boxes' heights
    (i-major), the Perlin generator's unit vectors and three permutations,
    then the cluster's centres. Floats rounded to DECIMALS places, as the
    configuration stores them."""
    rng = np.random.default_rng(seed)

    def random_double(lo=0.0, hi=1.0):
        return lo + (hi - lo) * rng.random()

    def r(x):
        return round(float(x), DECIMALS)

    heights = [r(random_double(1.0, 101.0))
               for _ in range(BOXES_PER_SIDE * BOXES_PER_SIDE)]
    vectors = []
    for _ in range(PERLIN_POINTS):
        v = np.asarray([random_double(-1.0, 1.0) for _ in range(3)])
        vectors.append([r(c) for c in v / np.linalg.norm(v)])
    perms = []
    for _ in range(3):
        p = list(range(PERLIN_POINTS))
        for i in range(PERLIN_POINTS - 1, 0, -1):
            target = int(random_double(0.0, i + 1.0))   # random_int(0, i)
            p[i], p[target] = p[target], p[i]
        perms.append(p)
    centres = [[r(random_double(0.0, 165.0)) for _ in range(3)]
               for _ in range(CLUSTER_COUNT)]
    return dict(heights=heights,
                perlin=dict(vectors=vectors, perm_x=perms[0], perm_y=perms[1],
                            perm_z=perms[2]),
                centres=centres)


def perlin_noise(p, perlin):
    """The book's `perlin::noise` at the points p ((3, N) float64 tensor):
    the gradients of the lattice cell's 8 corners, hashed by the three
    permutations, dotted with the offsets and blended with Hermite-smoothed
    trilinear weights."""
    import torch

    dev = p.device
    vectors = torch.as_tensor(perlin['vectors'], dtype=torch.float64,
                              device=dev).T.contiguous()
    perms = [torch.as_tensor(perlin[k], dtype=torch.int64, device=dev)
             for k in ('perm_x', 'perm_y', 'perm_z')]
    floor = torch.floor(p)
    frac = p - floor
    cell = floor.to(torch.int64)
    smooth = frac * frac * (3.0 - 2.0 * frac)
    # Per axis and corner side c: the permutation entry, the weight
    # c s + (1 - c)(1 - s) and the offset frac - c.
    hashed = [[perms[a][(cell[a] + c) & 255] for c in (0, 1)] for a in range(3)]
    weight = [[1.0 - smooth[a], smooth[a]] for a in range(3)]
    offset = [[frac[a], frac[a] - 1.0] for a in range(3)]
    accum = torch.zeros_like(p[0])
    for i, j, k in ((i, j, k) for i in (0, 1) for j in (0, 1) for k in (0, 1)):
        h = hashed[0][i] ^ hashed[1][j] ^ hashed[2][k]
        dot = (vectors[0][h] * offset[0][i] + vectors[1][h] * offset[1][j]
               + vectors[2][h] * offset[2][k])
        accum += weight[0][i] * weight[1][j] * weight[2][k] * dot
    return accum


def turbulence(p, perlin, depth):
    """The book's `perlin::turb`: |sum of depth octaves, each twice the
    frequency and half the weight of the one before|."""
    import torch

    accum = torch.zeros_like(p[0])
    weight = 1.0
    for _ in range(depth):
        accum += weight * perlin_noise(p, perlin)
        weight *= 0.5
        p = p * 2.0
    return torch.abs(accum)


def marble_value(p, cfg):
    """The book's `noise_texture(scale)` at world points p ((3, N) float64
    tensor), one channel: 0.5 (1 + sin(scale p.z + 10 turb(p, depth)))."""
    import torch

    m = cfg['marble_sphere']
    return 0.5 * (1.0 + torch.sin(m['noise_scale'] * p[2]
                                  + 10.0 * turbulence(p, cfg['perlin'],
                                                      m['turbulence_depth'])))


def texel_points(cfg):
    """World points ((3, H W) float64, row-major) at which the marble
    texture's texels sit: the inverse of the program's sphere uv on the
    sphere's object frame (u = (atan2(y, x) + pi) / 2 pi, v = (z + 1) / 2)
    and of the atlas placement (column i at u = i / (W - 1), row j at
    v = 1 - j / (H - 1))."""
    m = cfg['marble_sphere']
    w, h = m['texture']
    rows, cols = np.meshgrid(np.arange(h, dtype=np.float64),
                             np.arange(w, dtype=np.float64), indexing='ij')
    rows, cols = rows.reshape(-1), cols.reshape(-1)
    u = cols / (w - 1)
    v = 1.0 - rows / (h - 1)
    phi = 2.0 * np.pi * u - np.pi
    z = 2.0 * v - 1.0
    s = np.sqrt(np.clip(1.0 - z * z, 0.0, None))
    local = np.stack([s * np.cos(phi), s * np.sin(phi), z])
    return np.asarray(m['centre'], np.float64)[:, None] + m['radius'] * local


def marble_pixels(cfg):
    """The marble texture, (H, W, 4) float32 RGBA: every texel the grey
    value of `marble_value` at its world point, evaluated in float64 (on
    the CUDA card where there is one)."""
    key = json.dumps([cfg['marble_sphere'], cfg['perlin']])
    if key not in _BAKED:
        import torch

        w, h = cfg['marble_sphere']['texture']
        dev = 'cuda' if torch.cuda.is_available() else 'cpu'
        p = torch.as_tensor(texel_points(cfg), dtype=torch.float64, device=dev)
        # In blocks of texels whose temporaries stay in a CPU's cache.
        grey = torch.cat([marble_value(q, cfg) for q in p.split(BAKE_BLOCK, 1)])
        grey = grey.reshape(h, w).cpu().numpy()
        rgba = np.ones((h, w, 4), np.float32)
        rgba[..., :3] = grey[..., None]
        _BAKED.clear()
        _BAKED[key] = rgba
    return _BAKED[key]


def rotate_y(p, degrees):
    """The book's `rotate_y` of points p ((N, 3)): x' = cos x + sin z,
    z' = -sin x + cos z."""
    t = math.radians(degrees)
    c, s = math.cos(t), math.sin(t)
    p = np.asarray(p, np.float64)
    return np.stack([c * p[:, 0] + s * p[:, 2], p[:, 1],
                     -s * p[:, 0] + c * p[:, 2]], axis=1)


def cluster_centres(cfg):
    """The cluster's centres in world space: rotated about y, then moved."""
    c = cfg['cluster']
    return rotate_y(c['centres'], c['rotate_y_degrees']) + np.asarray(c['translate'])


def _diffuse(api, scene, rgb, **kwargs):
    return scene.create_material(api.MATERIAL_TYPE_BASIC_DIFFUSE,
                                 base_color=np.asarray(rgb, np.float32), **kwargs)


def _glass(api, scene, ior, abbe, depth=0.0, transmission=(1.0, 1.0, 1.0),
           scattering=(1.0, 1.0, 1.0)):
    return scene.create_material(
        api.MATERIAL_TYPE_BASIC_TRANSLUCENT, ior=ior, abbe_number=abbe,
        roughness=0.0, roughness_anisotropy=0.0, transmission_depth=depth,
        transmission_color=np.asarray(transmission, np.float32),
        scattering_color=np.asarray(scattering, np.float32),
        scattering_anisotropy=0.0)


def _sphere(api, scene, material, centre, radius):
    scene.create_entity(api.ENTITY_TYPE_SPHERE, material=material,
                        transform=api.Transform(position=centre, scale=radius))


def make_scene(api, cfg):
    scene = api.Scene()
    abbe = cfg['glass_abbe_number']

    # The ground: boxes from (x0, 0, z0) to (x0 + w, height, z0 + w); a
    # cube spans [-1, 1]^3 in its object frame, so its scale is the half
    # extents.
    g = cfg['ground']
    ground = _diffuse(api, scene, g['albedo'], name='ground')
    w, n = g['box_width'], g['boxes_per_side']
    heights = np.asarray(g['heights'], np.float64).reshape(n, n)
    for i in range(n):
        for j in range(n):
            x0, z0 = -1000.0 + i * w, -1000.0 + j * w
            y1 = heights[i, j]
            scene.create_entity(
                api.ENTITY_TYPE_CUBE, material=ground,
                transform=api.Transform(
                    position=[x0 + 0.5 * w, 0.5 * y1, z0 + 0.5 * w],
                    scale=[0.5 * w, 0.5 * y1, 0.5 * w]))

    # The light: the quad Q, Q + u, Q + u + v, Q + v as two triangles
    # whose normal faces -y, an OpenPBR emitter with no base or specular.
    light = cfg['light']
    q, u, v = (np.asarray(light[k], np.float64) for k in ('q', 'u', 'v'))
    corners = np.stack([q, q + u, q + u + v, q + v]).astype(np.float32)
    mesh = scene.create_mesh(
        name='light', positions=corners,
        normals=np.tile(np.asarray([[0.0, -1.0, 0.0]], np.float32), (4, 1)),
        uvs=np.zeros((4, 2), np.float32),
        faces=np.asarray([[0, 1, 2], [0, 2, 3]], np.int32))
    emitter = scene.create_material(
        api.MATERIAL_TYPE_OPENPBR, name='light', base_weight=0.0,
        specular_weight=0.0, emission_luminance=light['emission_luminance'],
        emission_color=np.asarray(light['emission_color'], np.float32))
    scene.create_entity(api.ENTITY_TYPE_MESH_INSTANCE, mesh=mesh,
                        material=emitter, name='light')

    # The moving sphere, still at its shutter-midpoint centre.
    s = cfg['moving_sphere']
    centre = 0.5 * (np.asarray(s['centre_start']) + np.asarray(s['centre_end']))
    _sphere(api, scene, _diffuse(api, scene, s['albedo']), centre, s['radius'])

    s = cfg['glass_sphere']
    _sphere(api, scene, _glass(api, scene, s['ior'], abbe), s['centre'],
            s['radius'])

    s = cfg['metal_sphere']
    metal = scene.create_material(
        api.MATERIAL_TYPE_BASIC_METAL,
        base_color=np.asarray(s['albedo'], np.float32),
        specular_color=np.ones(3, np.float32), roughness=s['fuzz'],
        roughness_anisotropy=0.0)
    _sphere(api, scene, metal, s['centre'], s['radius'])

    # The glass sphere filled with a constant medium of the book's density
    # and albedo: over the depth D the program's medium takes extinction
    # -ln(transmission) / D and scattering scattering_color / D, so a grey
    # transmission exp(-density D) and scattering_color albedo density D
    # give extinction `density` and scattering density x albedo.
    s = cfg['medium_sphere']
    depth, density = s['transmission_depth'], s['density']
    medium = _glass(api, scene, s['ior'], abbe, depth=depth,
                    transmission=[math.exp(-density * depth)] * 3,
                    scattering=np.asarray(s['albedo']) * density * depth)
    _sphere(api, scene, medium, s['centre'], s['radius'])

    s = cfg['earth_sphere']
    _sphere(api, scene, _diffuse(api, scene, s['albedo']), s['centre'],
            s['radius'])

    s = cfg['marble_sphere']
    marble = scene.create_texture(
        name='marble', type=api.TEXTURE_TYPE_REFLECTANCE_WITH_ALPHA,
        pixels=marble_pixels(cfg))
    _sphere(api, scene,
            _diffuse(api, scene, [1.0, 1.0, 1.0], name='marble',
                     base_texture=marble),
            s['centre'], s['radius'])

    c = cfg['cluster']
    white = _diffuse(api, scene, c['albedo'], name='white')
    for centre in cluster_centres(cfg):
        _sphere(api, scene, white, centre, c['radius'])

    counts = dict(
        cubes=sum(e.type == api.ENTITY_TYPE_CUBE for e in scene.walk_entities()),
        spheres=sum(e.type == api.ENTITY_TYPE_SPHERE for e in scene.walk_entities()),
        triangles=sum(len(m.faces) for m in scene.meshes))
    for key, got in counts.items():
        if got != cfg[key]:
            raise ValueError(f'next_week_final: {got} {key}, the '
                             f'configuration states {cfg[key]}')

    cam = cfg['camera']
    look_from = np.asarray(cam['look_from'], np.float64)
    forward = np.asarray(cam['look_at'], np.float64) - look_from
    forward /= np.linalg.norm(forward)
    if list(cam['vup']) != [0.0, 1.0, 0.0]:
        raise ValueError('next_week_final: the maker states vup +y')
    if cam['defocus_angle_degrees'] != 0.0:
        raise ValueError('next_week_final: the maker states a pinhole')
    # The camera looks down its local -z with +y up: a pitch about x, then
    # a turn about +y, point it along `forward` with no roll.
    pitch = math.asin(forward[1])
    yaw = math.atan2(-forward[0], -forward[2])
    camera = scene.create_entity(
        api.ENTITY_TYPE_CAMERA, name='camera',
        camera_model=api.CAMERA_MODEL_PINHOLE,
        transform=api.Transform(position=look_from, rotation=[pitch, yaw, 0.0]))
    # The program's pinhole angle spans the film's width: the sensor of
    # the vertical field of view at unit distance, widened by the aspect.
    aspect = cfg['image']['width'] / cfg['image']['height']
    half_h = math.tan(math.radians(cam['vfov_degrees'] / 2.0))
    camera.pinhole.field_of_view_in_degrees = math.degrees(
        2.0 * math.atan(aspect * half_h))
    scene.root.skybox_brightness = cfg['skybox_brightness']
    return scene
