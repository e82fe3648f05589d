"""Scenes shared by the port's tests, and the port's tests that need a card.

`blob_scene`, `textured_scene`, `two_instance_scene`, `glass_ball_scene`,
`openpbr_scene` and `opacity_scene` take the scene-model module (and the
procedural module) of either package, so the JAX package and the port
build the same scene from the same numbers;
`flat_mode` compiles a mesh scene's world-flattened tables; `tied_leaf`
builds `wide_trace`'s tables with one triangle in two slots of a leaf;
`openpbr_ctx` makes the material columns of OpenPBR lanes (with
`unit_directions` and `spectrum_beta`) for the JAX comparison and for the
walk kernel's tests, `basic_lanes` those of lanes of all four models for
the basic-sample kernel's.

The tests here launch the hand-written CUDA kernels and compare them
with their plain PyTorch versions on the card. They carry the `cuda`
marker and skip on a machine without one; on the GPU machine run them
with `python -m pytest tests/test_torch_cuda.py -m cuda`.
"""

import contextlib
import dataclasses
import itertools

import numpy as np
import pytest
import torch

from path_tracer_tpu_torch.core.constants import (
    MATERIAL_TYPE_BASIC_DIFFUSE, MATERIAL_TYPE_BASIC_METAL,
    MATERIAL_TYPE_BASIC_TRANSLUCENT, MATERIAL_TYPE_OPENPBR, SHAPE_INDEX_NONE,
    TEXTURE_TYPE_RADIANCE, TEXTURE_TYPE_REFLECTANCE_WITH_ALPHA)
from path_tracer_tpu_torch.utils import profiling


def launches(kernel):
    """Launches of the hand-written kernel `kernel` (utils/profiling.py's
    `kernel.<name>` counter)."""
    return profiling.counters().get('kernel.' + kernel, 0)


def blob_scene(m, n_instances=6, seed=7):
    """tests/test_trace_inst.py's instanced blob scene: one random
    48-triangle mesh under n_instances rotated, scaled, moved instances.
    Returns (scene, rng) with rng advanced past the scene's draws."""
    rng = np.random.default_rng(seed)
    scene = m.Scene()
    pos = rng.normal(0, 1, (40, 3)).astype(np.float32)
    faces = rng.integers(0, 40, (48, 3)).astype(np.int32)
    nrm = rng.normal(0, 1, (40, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    uv = rng.uniform(0, 1, (40, 2)).astype(np.float32)
    mesh = scene.create_mesh(name='blob', positions=pos, normals=nrm,
                             uvs=uv, faces=faces)
    scene.create_entity(m.ENTITY_TYPE_CAMERA)
    material = scene.create_material(1)
    for _ in range(n_instances):
        e = scene.create_entity(m.ENTITY_TYPE_MESH_INSTANCE, mesh=mesh,
                                material=material)
        e.transform.position = rng.uniform(-4, 4, 3).astype(np.float32)
        e.transform.rotation = rng.uniform(0, 6.28, 3).astype(np.float32)
        e.transform.scale = (np.float32(rng.uniform(0.5, 2.0))
                             * np.ones(3, np.float32))
    return scene, rng


def textured_scene(m, p):
    """A small stand-in for the textured viking hall: a terraced floor
    and a torus in one mesh instance with a wood-grain base texture, a
    pinhole camera and an HDR sky sampled with probability 0.25."""
    scene = m.Scene()
    pos, nrm, uv, faces = p.merge_meshes([
        p.transform_mesh(p.heightfield(12, size=10.0, amplitude=0.4)),
        p.transform_mesh(p.torus(16, 8, 1.2, 0.3), 1.0, (0, 0, 1.6)),
    ])
    mesh = scene.create_mesh(name='hall', positions=pos, normals=nrm,
                             uvs=uv, faces=faces)
    grain = scene.create_texture(
        name='wood-grain', type=TEXTURE_TYPE_REFLECTANCE_WITH_ALPHA,
        pixels=p.wood_grain_texture(64))
    wood = scene.create_material(MATERIAL_TYPE_BASIC_DIFFUSE, name='wood',
                                 base_color=np.asarray([0.9, 0.9, 0.9]),
                                 base_texture=grain)
    scene.create_entity(m.ENTITY_TYPE_MESH_INSTANCE, mesh=mesh, material=wood)
    cam = scene.create_entity(
        m.ENTITY_TYPE_CAMERA,
        transform=m.Transform(position=[0.0, -6.5, 2.4],
                              rotation=[np.pi / 2.2, 0, 0]))
    cam.pinhole.field_of_view_in_degrees = 70.0
    sky = scene.create_texture(name='sky', type=TEXTURE_TYPE_RADIANCE,
                               pixels=p.gradient_sky_texture(64, 32))
    scene.root.skybox_texture = sky
    scene.root.skybox_sampling_probability = 0.25
    return scene


def two_instance_scene(m, p, roughness=0.3):
    """tests/test_trace_wide.py's multi-instance scene with a camera: a
    diffuse ball (scaled unevenly) and a metal torus as mesh instances, a
    diffuse plane and a metal sphere as analytic shapes."""
    scene = m.Scene()
    pos, nrm, uv, faces = p.uv_sphere(16, 8)
    ball = scene.create_mesh(name='ball', positions=pos, normals=nrm, uvs=uv,
                             faces=faces)
    pos, nrm, uv, faces = p.torus(16, 8, 1.2, 0.4)
    ring = scene.create_mesh(name='ring', positions=pos, normals=nrm, uvs=uv,
                             faces=faces)
    m1 = scene.create_material(MATERIAL_TYPE_BASIC_DIFFUSE, name='m1',
                               base_color=np.asarray([0.7, 0.3, 0.2]))
    m2 = scene.create_material(MATERIAL_TYPE_BASIC_METAL, name='m2',
                               base_color=np.asarray([0.8, 0.8, 0.9]),
                               roughness=roughness)
    scene.create_entity(m.ENTITY_TYPE_MESH_INSTANCE, mesh=ball, material=m1,
                        transform=m.Transform(position=[1.0, 0.5, 0.2],
                                              rotation=[0.3, 0.7, 0.1],
                                              scale=[0.8, 1.4, 0.6]))
    scene.create_entity(m.ENTITY_TYPE_MESH_INSTANCE, mesh=ring, material=m2,
                        transform=m.Transform(position=[-1.2, -0.4, 0.8],
                                              rotation=[0.0, 0.4, 1.1],
                                              scale=1.3))
    scene.create_entity(m.ENTITY_TYPE_PLANE, material=m1,
                        transform=m.Transform(position=[0, 0, -1.5]))
    scene.create_entity(m.ENTITY_TYPE_SPHERE, material=m2,
                        transform=m.Transform(position=[0.2, 2.0, 0.0]))
    cam = scene.create_entity(
        m.ENTITY_TYPE_CAMERA,
        transform=m.Transform(position=[0.0, -6.5, 2.4],
                              rotation=[np.pi / 2.2, 0, 0]))
    cam.pinhole.field_of_view_in_degrees = 70.0
    return scene


def glass_ball_scene(m, p):
    """Bench config 5 (`make_multi_mesh_scene`) cut to a test's size: a
    terraced diffuse floor mesh, config 5's glass mesh ball
    (BASIC_TRANSLUCENT, IOR 1.5, Abbe 35, transmission depth 1, so its
    medium absorbs and scatters) as a second mesh instance, and its metal
    cube, under the default sky."""
    scene = m.Scene()
    pos, nrm, uv, faces = p.heightfield(12, size=10.0, amplitude=0.3)
    floor = scene.create_mesh(name='floor', positions=pos, normals=nrm,
                              uvs=uv, faces=faces)
    pos, nrm, uv, faces = p.uv_sphere(24, 12)
    ball = scene.create_mesh(name='ball', positions=pos, normals=nrm, uvs=uv,
                             faces=faces)
    wood = scene.create_material(MATERIAL_TYPE_BASIC_DIFFUSE, name='wood',
                                 base_color=np.asarray([0.45, 0.31, 0.18]))
    glass = scene.create_material(
        MATERIAL_TYPE_BASIC_TRANSLUCENT, name='glass', ior=1.5,
        abbe_number=35.0, roughness=0.0,
        transmission_color=np.asarray([0.95, 0.97, 1.0]),
        transmission_depth=1.0)
    metal = scene.create_material(MATERIAL_TYPE_BASIC_METAL, name='cube-metal',
                                  base_color=np.asarray([0.95, 0.64, 0.54]),
                                  roughness=0.2)
    scene.create_entity(m.ENTITY_TYPE_MESH_INSTANCE, mesh=floor, material=wood,
                        transform=m.Transform(position=[0, 0, -0.6]))
    scene.create_entity(m.ENTITY_TYPE_MESH_INSTANCE, mesh=ball, material=glass,
                        transform=m.Transform(position=[0.2, -1.5, 0.6],
                                              scale=0.9))
    scene.create_entity(m.ENTITY_TYPE_CUBE, material=metal,
                        transform=m.Transform(position=[-1.6, -0.5, 0.0],
                                              scale=0.5))
    cam = scene.create_entity(
        m.ENTITY_TYPE_CAMERA,
        transform=m.Transform(position=[0.0, -5.0, 1.2],
                              rotation=[np.pi / 2.1, 0, 0]))
    cam.pinhole.field_of_view_in_degrees = 60.0
    return scene


def openpbr_scene(m, p):
    """tests/test_openpbr.py's OpenPBR sphere, four times over: with a
    coat, with a metal base, with a translucent base and emissive; in
    front of them a smooth glass mesh ball whose medium scatters,
    overlapped by a rough analytic glass sphere (nested dielectrics);
    all on a plane with no material (the fallback OpenPBR slot 0), under
    a dim emissive OpenPBR ceiling, in fog."""
    scene = m.Scene()
    kinds = [
        dict(base_color=np.asarray([0.6, 0.1, 0.1]), coat_weight=1.0,
             coat_roughness=0.05, coat_color=np.asarray([0.9, 0.8, 0.6]),
             specular_roughness=0.4),
        dict(base_color=np.asarray([0.95, 0.8, 0.6]), base_metalness=1.0,
             specular_roughness=0.2, layer_bounce_limit=4),
        dict(base_color=np.asarray([0.9, 0.9, 0.9]), transmission_weight=1.0,
             transmission_depth=0.5, specular_roughness=0.1,
             transmission_color=np.asarray([0.7, 0.9, 1.0]),
             transmission_dispersion_abbe_number=30.0),
        dict(base_color=np.zeros(3), specular_weight=0.5,
             emission_color=np.asarray([1.0, 0.4, 0.1]),
             emission_luminance=5.0),
    ]
    for k, kw in enumerate(kinds):
        mat = scene.create_material(MATERIAL_TYPE_OPENPBR, **kw)
        scene.create_entity(m.ENTITY_TYPE_SPHERE, material=mat,
                            transform=m.Transform(
                                position=[-1.8 + 1.2 * k, 2.5, 0.5],
                                scale=0.5))
    pos, nrm, uv, faces = p.uv_sphere(24, 12)
    ball = scene.create_mesh(name='ball', positions=pos, normals=nrm, uvs=uv,
                             faces=faces)
    smooth = scene.create_material(
        MATERIAL_TYPE_BASIC_TRANSLUCENT, name='smooth-glass', ior=1.5,
        abbe_number=35.0, roughness=0.0,
        transmission_color=np.asarray([0.9, 0.95, 1.0]),
        transmission_depth=1.0, scattering_anisotropy=0.4)
    rough = scene.create_material(
        MATERIAL_TYPE_BASIC_TRANSLUCENT, name='rough-glass', ior=1.33,
        abbe_number=25.0, roughness=0.25,
        transmission_color=np.asarray([1.0, 0.9, 0.8]),
        transmission_depth=0.5, scattering_color=np.asarray([0.2, 0.2, 0.2]))
    scene.create_entity(m.ENTITY_TYPE_MESH_INSTANCE, mesh=ball, material=smooth,
                        transform=m.Transform(position=[-0.4, 1.0, 0.5],
                                              scale=0.5))
    scene.create_entity(m.ENTITY_TYPE_SPHERE, material=rough,
                        transform=m.Transform(position=[0.2, 1.1, 0.45],
                                              scale=0.4))
    scene.create_entity(m.ENTITY_TYPE_PLANE,
                        transform=m.Transform(position=[0, 0, 0]))
    # A dim emissive ceiling facing down: in fog the sky is out of reach
    # (every ray that misses scatters before it), so this lights the frame.
    ceiling = scene.create_material(
        MATERIAL_TYPE_OPENPBR, base_color=np.asarray([0.5, 0.5, 0.5]),
        emission_color=np.ones(3), emission_luminance=1.0)
    scene.create_entity(m.ENTITY_TYPE_PLANE, material=ceiling,
                        transform=m.Transform(position=[0, 0, 3.0],
                                              rotation=[np.pi, 0, 0]))
    cam = scene.create_entity(m.ENTITY_TYPE_CAMERA,
                              transform=m.Transform(position=[0, -1.5, 0.8],
                                                    rotation=[np.pi / 2, 0, 0]))
    cam.pinhole.field_of_view_in_degrees = 60.0
    scene.root.scatter_rate = 0.05
    return scene


def opacity_scene(m, p, nearest=True):
    """A half-transparent diffuse sphere and a nearly transparent metal one
    on a diffuse plane, under a gradient sky texture (filtered nearest, or
    bilinear)."""
    scene = m.Scene()
    ghost = scene.create_material(MATERIAL_TYPE_BASIC_DIFFUSE,
                                  base_color=np.asarray([0.6, 0.5, 0.4]),
                                  opacity=0.5)
    faint = scene.create_material(MATERIAL_TYPE_BASIC_METAL, base_color=np.asarray([0.9, 0.9, 0.9]),
                                  roughness=0.1, opacity=0.2)
    floor = scene.create_material(MATERIAL_TYPE_BASIC_DIFFUSE,
                                  base_color=np.asarray([0.3, 0.3, 0.3]))
    scene.create_entity(m.ENTITY_TYPE_SPHERE, material=ghost,
                        transform=m.Transform(position=[-0.6, 2.5, 0.5]))
    scene.create_entity(m.ENTITY_TYPE_SPHERE, material=faint,
                        transform=m.Transform(position=[0.8, 3.0, 0.6],
                                              scale=0.7))
    scene.create_entity(m.ENTITY_TYPE_PLANE, material=floor,
                        transform=m.Transform(position=[0, 0, -0.5]))
    cam = scene.create_entity(
        m.ENTITY_TYPE_CAMERA,
        transform=m.Transform(position=[0, -1.5, 0.4],
                              rotation=[np.pi / 2, 0, 0]))
    cam.pinhole.field_of_view_in_degrees = 60.0
    scene.root.skybox_texture = scene.create_texture(
        name='sky', type=TEXTURE_TYPE_RADIANCE, pixels=p.gradient_sky_texture(32, 16),
        enable_nearest_filtering=nearest)
    return scene


def unit_directions(rng, n, z_sign=None):
    """Unit directions (3, n); z_sign +1 / -1 keeps them on one side
    (|z| > 0.02), None on both."""
    v = rng.normal(0, 1, (3, n)).astype(np.float32)
    if z_sign is not None:
        v[2] = z_sign * (np.abs(v[2]) + 0.02)
    return (v / np.linalg.norm(v, axis=0, keepdims=True)).astype(np.float32)


def spectrum_beta(rng, n):
    """Sigmoid-polynomial spectrum coefficients (3, n)."""
    return np.stack([rng.uniform(-1e-5, 1e-5, n), rng.uniform(-5e-3, 5e-3, n),
                     rng.uniform(-1, 3, n)]).astype(np.float32)


def openpbr_ctx(rng, n, case='mixed', limit=16, roughness=None):
    """OpenPBR context columns as numpy. `case` fixes the layer
    composition: 'coat' (a coat over a dielectric base), 'no_coat',
    'metal' (a metal base, coat on half the lanes), 'translucent' (a
    translucent base, coat on half the lanes) or 'mixed' (random
    weights); `limit` is every lane's layer bounce limit; `roughness`
    'rough' or 'smooth' makes every base lane so (None: a quarter of them
    smooth). The draws from `rng` are the same whatever the options.

    The coats are nearly clear (transmittance 0.9 to 0.99, as the default
    white coat color): the coat's absorption is the transmittance to the
    power of the in-coat path length, which reaches 1e4 at grazing
    angles, where a dark coat turns a last-bit difference of that length
    into 1e-3. The coat IOR (1.3 to 1.45) stays apart from the base's
    (1.6 to 1.9): at an index match the base's refraction half vectors
    nearly vanish, as in tests/test_torch_media.py::translucent_ctx. The
    rough base lanes have roughness 0.2 to 0.8, the smooth ones are
    Dirac: the secondary wavelengths' refraction densities are GGX values
    of their half vectors, and a lobe of alpha 0.01 (roughness 0.1)
    divides a last-bit difference of a half vector by alpha."""
    def u(lo, hi, shape=n):
        return rng.uniform(lo, hi, shape).astype(np.float32)

    def full(v):
        return np.full(n, v, np.float32)

    weights = dict(
        coat=(full(1.0), full(0.0), full(0.0)),
        no_coat=(full(0.0), full(0.0), full(0.0)),
        metal=(full(0.5), full(1.0), full(0.0)),
        translucent=(full(0.5), full(0.0), full(1.0)),
        mixed=(u(0, 1), u(0, 1), u(0, 1)),
    )[case]
    def base_roughness():
        smooth = rng.uniform(0, 1, n) < 0.25
        rough = rng.uniform(0.2, 0.8, n)
        if roughness is not None:
            smooth = np.full(n, roughness == 'smooth')
        return np.where(smooth, 5e-4, rough).astype(np.float32)

    return dict(
        type=np.full(n, MATERIAL_TYPE_OPENPBR, np.int32),
        lam=u(380, 720, (4, n)),
        exterior_ior=np.where(rng.uniform(0, 1, n) < 0.5, 1.0, 1.33)
        .astype(np.float32) * np.ones((4, 1), np.float32),
        base_reflectance=u(0.05, 0.95, (4, n)),
        specular_reflectance=u(0.3, 1.0, (4, n)),
        roughness=base_roughness(),
        roughness_anisotropy=u(0, 0.8),
        base_weight=u(0.5, 1.0),
        base_metalness=weights[1],
        base_diffuse_roughness=u(0, 1),
        specular_weight=np.where(rng.uniform(0, 1, n) < 0.5, 1.0,
                                 rng.uniform(0.2, 1.0, n)).astype(np.float32),
        specular_ior=u(1.6, 1.9),
        transmission_weight=weights[2],
        transmission_spectrum=spectrum_beta(rng, n),
        transmission_depth=np.where(rng.uniform(0, 1, n) < 0.25, 0.0,
                                    rng.uniform(0.2, 2.0, n)).astype(np.float32),
        transmission_scatter_spectrum=spectrum_beta(rng, n),
        transmission_scatter_anisotropy=u(-0.9, 0.9),
        transmission_dispersion_abbe=u(20, 60),
        coat_weight=weights[0],
        coat_spectrum=np.stack([u(-1e-6, 1e-6), u(-1e-3, 1e-3),
                                u(2.5, 5.0)]),
        coat_ior=u(1.3, 1.45),
        coat_roughness=u(0.01, 0.5),
        coat_roughness_anisotropy=u(0, 0.5),
        emission_reflectance=u(0, 1, (4, n)),
        emission_luminance=np.where(rng.uniform(0, 1, n) < 0.5, 0.0,
                                    rng.uniform(0.5, 5, n)).astype(np.float32),
        layer_bounce_limit=np.full(n, limit, np.int32),
    )


@contextlib.contextmanager
def flat_mode(*compile_modules):
    """Within the block, the given scene/compile modules (either
    package's) build every mesh scene's world-flattened tables:
    `choose_packet_mode` is replaced and then restored."""
    saved = [c.choose_packet_mode for c in compile_modules]
    for c in compile_modules:
        c.choose_packet_mode = lambda instances: 'flat'
    try:
        yield
    finally:
        for c, fn in zip(compile_modules, saved):
            c.choose_packet_mode = fn


def tied_leaf(bvh8, rng, n=4096):
    """`wide_trace`'s tables of 300 random triangles in which the fullest
    leaf holds two triangles twice: the positions of its slot 0 copied to
    slot 5 (the next row) and those of slot 2 to slot 3 (the same row),
    each copy with other normals, uvs and shape index. Returns numpy
    (nodes, tris, origin (3, n), direction (3, n), t_in (n,), {lower
    face: upper face}); half the rays fly at each doubled triangle from
    0.02 in front of it. Both slots of a pair give the same t to the bit,
    and the lower slot must win, as the sequential leaf loop decides."""
    tri = (rng.uniform(0, 1, (300, 1, 3))
           + rng.uniform(-0.06, 0.06, (300, 3, 3))).astype(np.float32)
    nrm = rng.normal(size=(300, 3, 3)).astype(np.float32)
    uv = rng.uniform(0, 1, (300, 3, 2)).astype(np.float32)
    shp = rng.integers(0, 5, 300).astype(np.float32)
    wide = bvh8.build_wide_bvh(tri, nrm, uv, shp)
    metas = wide.nodes[:, bvh8.NODE_LAYOUT[8]['meta']:][:, :8]
    leaves = -metas[metas < 0].astype(np.int64)
    u = leaves[np.argmax(leaves // bvh8.LEAF_ROW_LIMIT)]
    assert u // bvh8.LEAF_ROW_LIMIT >= 6
    row = int(u % bvh8.LEAF_ROW_LIMIT)
    tris = wide.tris.copy()
    flat = tris.reshape(-1, bvh8.TRI_STRIDE)   # one slot a line
    base = row * bvh8.TRIS_PER_ROW
    pairs = {base: base + 5, base + 2: base + 3}
    o, d = [], []
    for k, (lo, hi) in enumerate(pairs.items()):
        flat[hi, 0:9] = flat[lo, 0:9]
        flat[hi, 9:24] = rng.uniform(-1, 1, 15)
        flat[hi, 24] = flat[lo, 24] + 1
        p = flat[lo, 0:9].reshape(3, 3).astype(np.float64)
        g = np.cross(p[1] - p[0], p[2] - p[0])
        g /= np.linalg.norm(g)
        w = rng.dirichlet((4, 4, 4), n // 2)
        o.append((w @ p + 0.02 * g).T)
        d.append(np.repeat(-g[:, None], n // 2, 1))
    o = np.ascontiguousarray(np.concatenate(o, 1), np.float32)
    d = np.ascontiguousarray(np.concatenate(d, 1), np.float32)
    return wide.nodes, tris, o, d, np.full(n, 1e5, np.float32), pairs


pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    return torch.device('cuda')


def _random_rays(rng, n, device):
    o = rng.uniform(-6, 6, (3, n)).astype(np.float32)
    d = rng.normal(0, 1, (3, n)).astype(np.float32)
    d /= np.linalg.norm(d, axis=0, keepdims=True)
    return (torch.from_numpy(o).to(device), torch.from_numpy(d).to(device),
            torch.full((n,), 1e6, dtype=torch.float32, device=device))


@pytest.mark.parametrize('leaf_fmt', ['mt', 'bary', 'woop'])
def test_kernel_matches_plain_version(cuda, leaf_fmt, monkeypatch):
    """csrc/trace_inst.cu against inst_trace_plain, both on the card, on
    the instanced blob scene. Both traverse each ray in the same order
    with the same float32 operations (the kernel is built without FMA
    contraction), so every output and every per-ray counter is equal to
    the bit. The outputs compared are those of the launch without
    counters, the kernel instantiation the render path runs; the launch
    with counters is another instantiation and must give the same."""
    import path_tracer_tpu_torch.scene.bvh8 as bvh8
    import path_tracer_tpu_torch.scene.model as model
    from path_tracer_tpu_torch.ops import trace_inst
    from path_tracer_tpu_torch.scene.compile import compile_scene

    monkeypatch.setattr(bvh8, 'LEAF_FMT', leaf_fmt)
    scene, rng = blob_scene(model)
    packed = compile_scene(scene, device=cuda)
    tables = (packed.inst_nodes, packed.inst_tris, packed.inst_rows)
    o, d, t_in = _random_rays(rng, 8192, cuda)
    tlas = packed.host_layout.tlas_rows
    before = launches('inst_trace')
    kernel = trace_inst.inst_trace(*tables, o, d, t_in, tlas)
    counted = trace_inst.inst_trace(*tables, o, d, t_in, tlas, stats=True)
    torch.cuda.synchronize()
    assert launches('inst_trace') == before + 2
    plain = trace_inst.inst_trace_plain(*tables, o, d, t_in, tlas,
                                        leaf_fmt=leaf_fmt, stats=True)
    assert int((plain[1] >= 0).sum()) > 30
    for name, k, c, p in zip(('t', 'face', 'fu', 'fv', 'inst'), kernel,
                             counted, plain):
        assert torch.equal(k, p), name
        assert torch.equal(c, p), name + ' (launch with counters)'
    assert torch.equal(counted[-1], plain[-1]), 'counts'
    assert bool((kernel[4][kernel[1] < 0] == -1).all())


def _blob_soup(rng, faces=300):
    """Random triangles with normals, uvs and shape indices, clustered
    so that leaves fill more than one row."""
    base = rng.uniform(-4, 4, (faces, 1, 3)).astype(np.float32)
    tri = (base + rng.uniform(-0.6, 0.6, (faces, 3, 3))).astype(np.float32)
    nrm = rng.normal(size=(faces, 3, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    uv = rng.uniform(0, 1, (faces, 3, 2)).astype(np.float32)
    shp = rng.integers(0, 5, faces).astype(np.float32)
    return tri, nrm, uv, shp


@pytest.mark.parametrize('leaf_fmt', ['mt', 'bary', 'woop'])
def test_wide_trace5_kernel_matches_plain_version(cuda, leaf_fmt, monkeypatch):
    """csrc/trace_packet.cu against wide_trace5_plain, both on the card:
    same per-ray order, same float32 operations, so every output and
    every per-ray counter is equal to the bit, for the launch without
    counters (what the render path runs) and the one with them."""
    import path_tracer_tpu_torch.scene.bvh8 as bvh8
    from path_tracer_tpu_torch.ops import trace_packet

    monkeypatch.setattr(bvh8, 'LEAF_FMT', leaf_fmt)
    rng = np.random.default_rng(7)
    soup = _blob_soup(rng)
    nodes, tris = (torch.from_numpy(x).to(cuda) for x in bvh8.pack_wide_geom(
        bvh8.build_wide_bvh(*soup), *soup)[:2])
    o, d, t_in = _random_rays(rng, 8192, cuda)
    before = launches('wide_trace5')
    kernel = trace_packet.wide_trace5(nodes, tris, o, d, t_in)
    counted = trace_packet.wide_trace5(nodes, tris, o, d, t_in, stats=True)
    torch.cuda.synchronize()
    assert launches('wide_trace5') == before + 2
    plain = trace_packet.wide_trace5_plain(nodes, tris, o, d, t_in,
                                           leaf_fmt=leaf_fmt, stats=True)
    assert int((plain[1] >= 0).sum()) > 30
    for name, k, c, p in zip(('t', 'face', 'fu', 'fv'), kernel, counted, plain):
        assert torch.equal(k, p), name
        assert torch.equal(c, p), name + ' (launch with counters)'
    assert torch.equal(counted[-1], plain[-1]), 'counts'


def test_wide_trace_kernel_matches_plain_version(cuda):
    """csrc/trace_wide.cu against wide_trace_plain, both on the card: all
    eight outputs and the per-ray counters equal to the bit, for the
    launch without counters (what the direct call makes) and the one with
    them; shape is 0 on a miss."""
    import path_tracer_tpu_torch.scene.bvh8 as bvh8
    from path_tracer_tpu_torch.ops import trace_wide

    rng = np.random.default_rng(8)
    wide = bvh8.build_wide_bvh(*_blob_soup(rng))
    nodes = torch.from_numpy(wide.nodes).to(cuda)
    tris = torch.from_numpy(wide.tris).to(cuda)
    o, d, t_in = _random_rays(rng, 8192, cuda)
    before = launches('wide_trace')
    kernel = trace_wide.wide_trace(nodes, tris, o, d, t_in)
    counted = trace_wide.wide_trace(nodes, tris, o, d, t_in, stats=True)
    torch.cuda.synchronize()
    assert launches('wide_trace') == before + 2
    plain = trace_wide.wide_trace_plain(nodes, tris, o, d, t_in, stats=True)
    assert int((plain[1] >= 0).sum()) > 30
    for name, k, c, p in zip(('t', 'face', 'normal', 'uv', 'shape'), kernel,
                             counted, plain):
        assert torch.equal(k, p), name
        assert torch.equal(c, p), name + ' (launch with counters)'
    assert torch.equal(counted[-1], plain[-1]), 'counts'
    assert bool((kernel[4][kernel[1] < 0] == 0).all())


@pytest.mark.parametrize('spread', [1, 8])
def test_wide_trace_tie_goes_to_the_lower_slot(cuda, spread):
    """On a leaf that holds one triangle in two slots, the kernel returns
    the lower slot, as the plain version's sequential loop does, and
    equals the plain version to the bit on every output, with and without
    counters. With spread=8 one lane in eight holds a ray at the leaf and
    the others miss the scene, so a warp holds at most four leaves at a
    time: the redesigned kernel then spreads them over the warp (its leaf
    body keeps more than 4 of 32 lanes busy, which one lane a leaf
    cannot), and its segmented min must still pick the lower slot."""
    import path_tracer_tpu_torch.scene.bvh8 as bvh8
    from path_tracer_tpu_torch.ops import trace_wide

    nodes, tris, o, d, t_in, pairs = tied_leaf(bvh8, np.random.default_rng(16))
    n = t_in.size * spread
    origin = np.full((3, n), 5.0, np.float32)
    direction = np.zeros((3, n), np.float32)
    direction[0] = 1.0
    origin[:, ::spread], direction[:, ::spread] = o, d
    nodes, tris, o, d, t_in = (torch.from_numpy(x).to(cuda) for x in (
        nodes, tris, origin, direction, np.full(n, 1e5, np.float32)))
    got = trace_wide.wide_trace(nodes, tris, o, d, t_in)
    *counted, _, rec = trace_wide.wide_trace(
        nodes, tris, o, d, t_in, stats=True, anatomy=True)
    plain = trace_wide.wide_trace_plain(nodes, tris, o, d, t_in)
    for k, c, p in zip(got, counted, plain):
        assert torch.equal(k, p) and torch.equal(c, p)
    face = got[1].cpu().numpy()
    for lo, hi in pairs.items():
        assert (face == lo).sum() > 1000 and not (face == hi).any()
    if spread > 1:
        assert (face.reshape(-1, spread)[:, 1:] < 0).all()
        assert rec['simt_leaf'] > 4 / 32, rec


def _traversal_kernel(kernel, leaf_fmt, rng, cuda):
    """The wrapper of one of the three traversal kernels on random
    geometry, taking (o, d, t_in, **keywords); wide_trace's rows hold
    plain positions, whatever `leaf_fmt`."""
    import path_tracer_tpu_torch.scene.bvh8 as bvh8
    import path_tracer_tpu_torch.scene.model as model
    from path_tracer_tpu_torch.ops import trace_inst, trace_packet, trace_wide
    from path_tracer_tpu_torch.scene.compile import compile_scene

    if kernel == 'inst_trace':
        scene, _ = blob_scene(model)
        packed = compile_scene(scene, device=cuda)
        tables = (packed.inst_nodes, packed.inst_tris, packed.inst_rows)
        tlas = packed.host_layout.tlas_rows
        return lambda *a, **k: trace_inst.inst_trace(
            *tables, *a, tlas, leaf_fmt=leaf_fmt, **k)
    soup = _blob_soup(rng)
    if kernel == 'wide_trace':
        wide = bvh8.build_wide_bvh(*soup)
        tables = [torch.from_numpy(x).to(cuda) for x in (wide.nodes, wide.tris)]
        return lambda *a, **k: trace_wide.wide_trace(*tables, *a, **k)
    tables = [torch.from_numpy(x).to(cuda) for x in bvh8.pack_wide_geom(
        bvh8.build_wide_bvh(*soup), *soup)[:2]]
    return lambda *a, **k: trace_packet.wide_trace5(
        *tables, *a, leaf_fmt=leaf_fmt, **k)


@pytest.mark.parametrize('kernel', ['inst_trace', 'wide_trace5', 'wide_trace',
                                    'openpbr_walk'])
def test_kernel_anatomy(cuda, kernel):
    """What the kernels measure of themselves is consistent: efficiencies
    in (0, 1], at least one distinct row a pass, a stack at least one
    deep, the same results with the counters on, and some pops culled.
    The walk counts the lanes it walked and the warps that held one,
    exactly."""
    rng = np.random.default_rng(10)
    if kernel == 'openpbr_walk':
        _walk_anatomy(cuda, rng)
        return
    run = _traversal_kernel(kernel, 'bary', rng, cuda)
    o, d, t_in = _random_rays(rng, 8192, cuda)
    uncounted = run(o, d, t_in)
    *out, counts, rec = run(o, d, t_in, stats=True, anatomy=True)
    for a, b in zip(out, uncounted):
        assert torch.equal(a, b)
    for key in ('simt_loop', 'simt_interior', 'simt_leaf'):
        assert 0.0 < rec[key] <= 1.0, (key, rec[key])
    assert 1.0 <= rec['interior_rows_per_pass'] <= 32.0
    assert 1.0 <= rec['leaf_rows_per_pass'] <= 32.0
    assert 1 <= rec['deepest_stack_max'] <= 128
    assert rec['passes_interior'] * 32 >= int(counts[0].sum())
    assert rec['culled_pops_per_ray'] > 0


@pytest.mark.parametrize('kernel', ['inst_trace', 'wide_trace5', 'wide_trace',
                                    'openpbr_walk'])
def test_kernel_wrapper_rejects_bad_input(cuda, kernel):
    """Each wrapper checks device, dtype and shape before it launches."""
    from path_tracer_tpu_torch.ops import trace_inst, trace_packet, trace_wide

    if kernel == 'openpbr_walk':
        _walk_rejects_bad_input(cuda)
        return
    nodes = torch.zeros((8, 128), device=cuda)
    tris = torch.zeros((2, 128), device=cuda)
    rows = torch.zeros((1, 128), device=cuda)
    o = torch.zeros((3, 64), device=cuda)
    t_in = torch.ones(64, device=cuda)

    def run(nodes=nodes, tris=tris, o=o, d=o, t_in=t_in):
        if kernel == 'inst_trace':
            return trace_inst.inst_trace(nodes, tris, rows, o, d, t_in, 8)
        fn = (trace_packet.wide_trace5 if kernel == 'wide_trace5'
              else trace_wide.wide_trace)
        return fn(nodes, tris, o, d, t_in)

    run()
    for bad in (dict(d=o.double()), dict(nodes=nodes.cpu()), dict(d=o[:2]),
                dict(tris=tris[:, :64]), dict(t_in=t_in[:32]),
                dict(nodes=torch.zeros((128, 16), device=cuda).T)):
        with pytest.raises(ValueError):
            run(**bad)


# The walk kernel's inputs: base -> (base_metalness, transmission_weight).
WALK_BASES = {'metal': (1.0, 0.0), 'dielectric': (0.0, 0.0),
              'translucent': (0.0, 1.0)}
WALK_LANES = {'all': 8192, 'clusters': 2 ** 18}


def walk_inputs(rng, n, limit, coat=None, base=None, roughness=None,
                mix='all'):
    """numpy inputs of the OpenPBR walk over n lanes: (ctx, view, [u1, u2,
    u3]). `coat` (True / False) and `base` (a key of WALK_BASES) fix every
    lane's layer composition (None: openpbr_ctx's random weights);
    mix='clusters' gives 0.5% of the lanes the OpenPBR type, in runs of 1
    to 64 lanes at random places, and the others a basic model's type.
    Views come from outside the surface, from both sides where the base
    is translucent (only a translucent base is hit from inside)."""
    ctx = openpbr_ctx(rng, n, 'mixed', limit, roughness)
    if coat is not None:
        ctx['coat_weight'][:] = float(coat)
    if base is not None:
        ctx['base_metalness'][:], ctx['transmission_weight'][:] = WALK_BASES[base]
    if mix == 'clusters':
        walks = np.zeros(n, bool)
        while walks.sum() < n // 200:
            start = rng.integers(0, n - 64)
            walks[start:start + rng.integers(1, 65)] = True
        ctx['type'] = np.where(walks, MATERIAL_TYPE_OPENPBR,
                               rng.integers(0, 3, n)).astype(np.int32)
    view = unit_directions(rng, n, 1)
    if base in ('translucent', None):
        view = view * np.where(rng.uniform(0, 1, n) < 0.5, 1, -1).astype(np.float32)
    u = [rng.uniform(0, 1, n).astype(np.float32) for _ in range(3)]
    return ctx, view, u


def _on(device, ctx, view, u):
    return ({k: torch.from_numpy(v).to(device) for k, v in ctx.items()},
            torch.from_numpy(view).to(device),
            [torch.from_numpy(x).to(device) for x in u])


def _off(a, b, lanes):
    """(share of the elements of `lanes` at which a and b differ by more
    than 1e-5 relative and 1e-6 absolute, largest relative difference
    there); NaN matches NaN."""
    a = a.cpu()[..., lanes].double()
    b = b.cpu()[..., lanes].double()
    diff = (a - b).abs()
    same = (diff <= 1e-6 + 1e-5 * b.abs()) | (a.isnan() & b.isnan())
    rel = torch.where(same, 0.0, diff / (b.abs() + 1e-6))
    return 1.0 - same.double().mean().item(), rel.max().item()


@pytest.mark.parametrize('mix', ['clusters', 'all'])
@pytest.mark.parametrize('limit', [1, 3, 8])
@pytest.mark.parametrize('roughness', ['rough', 'smooth'])
@pytest.mark.parametrize('base', ['metal', 'dielectric', 'translucent'])
@pytest.mark.parametrize('coat', [True, False], ids=['coat', 'no_coat'])
def test_openpbr_walk_kernel_matches_plain_version(cuda, coat, base,
                                                   roughness, limit, mix):
    """csrc/openpbr_walk.cu (through openpbr.sample_bsdf on the card)
    against sample_bsdf_plain on the same tensors moved to the CPU, with
    0.5% of the lanes OpenPBR in clusters and with every lane OpenPBR.

    Every lane draws the walk's 24 uniforms, so the advanced RNG state is
    equal to the bit on every lane. On the OpenPBR lanes `valid` agrees
    on at least 99.9% (a walk ends where a sign of z or a Fresnel choice
    flips on a last-bit difference of a transcendental). The samples:
    the card's sinf/cosf/powf differ from the CPU's in the last bit on a
    few values in a hundred, and sqrt(1 - x^2) near x = 1 (a grazing
    visible normal, a half vector at the lobe's edge) or a coat's
    absorption at a grazing path multiplies such a difference many times
    over on a few elements in a thousand, more so through 8 bounces; the
    plain walk run in PyTorch on the card differs from the CPU's alike.
    So the kernel is held to the plain walk on the card, with the same
    transcendentals, within 1e-5 relative on at least 99.9% of the
    elements and 2e-3 on all (tests/test_torch_metal.py::_close), and to
    the CPU's within 1e-5 relative on at least 99.9% of the elements, or
    on as many as the plain walk on the card reaches where its own
    transcendentals keep it further off. The other lanes' samples are not
    valid, with zero throughput and density."""
    from path_tracer_tpu_torch.core.sampling import Rng
    from path_tracer_tpu_torch.models import openpbr

    n = WALK_LANES[mix]
    rng = np.random.default_rng(50 + limit)
    ctx, view, u = _on(cuda, *walk_inputs(rng, n, limit, coat, base,
                                          roughness, mix))
    stream = Rng.seed(torch.arange(n, device=cuda), 1000 + limit)
    start = stream.state.clone()
    before = launches('openpbr_walk')
    out = openpbr.sample_bsdf(ctx, view, *u, stream)
    torch.cuda.synchronize()
    assert launches('openpbr_walk') == before + 1
    card = openpbr.sample_bsdf_plain(ctx, view, *u, Rng(start))
    cpu_stream = Rng(start.cpu())
    cpu = openpbr.sample_bsdf_plain(
        {k: v.cpu() for k, v in ctx.items()}, view.cpu(),
        *[x.cpu() for x in u], cpu_stream)
    assert torch.equal(stream.state.cpu(), cpu_stream.state)
    walks = ctx['type'].cpu() == MATERIAL_TYPE_OPENPBR
    assert int(walks.sum()) >= (n // 200 if mix == 'clusters' else n)
    valid = out[3].cpu()
    assert (valid[walks] == cpu[3][walks]).float().mean() >= 0.999
    for name, k, c, p in zip(('in_dir', 'throughput', 'density'), out, card,
                             cpu):
        share, rel = _off(k, c, walks)
        assert share <= 1e-3 and rel <= 2e-3, (name, 'card', share, rel)
        share, _ = _off(k, p, walks)
        assert share <= max(1e-3, _off(c, p, walks)[0]), (name, 'cpu', share)
    others = ~walks
    assert not bool(valid[others].any())
    assert not bool(out[1].cpu()[:, others].any())
    assert not bool(out[2].cpu()[:, others].any())


def _walk_anatomy(cuda, rng):
    """The walk's two counters on lanes 0.5% OpenPBR in clusters: the
    OpenPBR lanes, and the warps of 32 lanes that hold one; its samples
    and stream are the same with the counters on. With a lane mask only
    the OpenPBR lanes in it walk and count, their samples are those of
    the launch without the mask, and the others' are not valid."""
    from path_tracer_tpu_torch.core.sampling import Rng
    from path_tracer_tpu_torch.models import openpbr

    n = 2 ** 16 + 17      # a last warp that is not full
    ctx, view, u = _on(cuda, *walk_inputs(rng, n, 8, mix='clusters'))
    state = Rng.seed(torch.arange(n, device=cuda), 3).state
    cols = {k: ctx[k] for k in openpbr.CTX_INPUTS}
    every = openpbr.openpbr_walk(cols, view, *u, state)
    typed = (ctx['type'] == MATERIAL_TYPE_OPENPBR).cpu()
    mask = torch.from_numpy(rng.uniform(0, 1, n) < 0.7)
    for where in (None, mask):
        stats = torch.zeros(2, dtype=torch.int64, device=cuda)
        counted = openpbr.openpbr_walk(
            cols, view, *u, state, stats=stats,
            where=None if where is None else where.to(cuda))
        walks = typed if where is None else typed & where
        assert torch.equal(counted[4], every[4])
        for a, b in zip(counted[:4], every[:4]):
            assert torch.equal(a.cpu()[..., walks], b.cpu()[..., walks])
        in_dir, throughput, density, valid = (x.cpu()[..., ~walks]
                                              for x in counted[:4])
        assert bool((in_dir[:2] == 0).all() and (in_dir[2] == 1).all())
        assert not (throughput.any() or density.any() or valid.any())
        padded = torch.zeros(-(-n // 32) * 32, dtype=torch.bool)
        padded[:n] = walks
        lanes, warps = stats.tolist()
        assert lanes == int(walks.sum()) > 0
        assert warps == int(padded.reshape(-1, 32).any(1).sum())
        assert 0 < warps < -(-n // 32)


def _walk_rejects_bad_input(cuda):
    """openpbr_walk raises on a tensor of another dtype, device, shape or
    layout, on a missing column and on a stats buffer of another shape."""
    from path_tracer_tpu_torch.models import openpbr

    n = 64
    ctx, view, u = _on(cuda, *walk_inputs(np.random.default_rng(11), n, 8))
    cols = {k: ctx[k] for k in openpbr.CTX_INPUTS}
    state = torch.zeros(n, dtype=torch.int64, device=cuda)

    def run(view=view, u1=u[0], state=state, stats=None, **columns):
        return openpbr.openpbr_walk(dict(cols, **columns), view, u1, u[1],
                                    u[2], state, stats=stats)

    run()
    wide = torch.zeros((n, 4), device=cuda)
    for bad in (dict(view=view.double()), dict(view=view.cpu()),
                dict(view=view[:2]), dict(u1=u[0][:32]),
                dict(state=state.int()), dict(type=cols['type'].long()),
                dict(lam=wide.T), dict(coat_spectrum=cols['lam']),
                dict(stats=torch.zeros(3, dtype=torch.int64, device=cuda))):
        with pytest.raises(ValueError):
            run(**bad)
    with pytest.raises(ValueError):
        openpbr.openpbr_walk({k: v for k, v in cols.items() if k != 'coat_ior'},
                             view, *u, state)


def test_openpbr_walk_on_the_main_path(cuda, monkeypatch):
    """One round of the OpenPBR scene on the card with tracing on goes
    through the walk kernel: one launch, at most 3 kernels launched inside
    `pt.model.openpbr.sample` (the walk and the one-time zeroing of its
    counters), `pt.model.openpbr.lanes` equal to the OpenPBR-typed lanes
    of the round's surface events (a ray that left the scene carries the
    fallback OpenPBR material but does not walk), and no more walking
    warps than warps launched."""
    import path_tracer_tpu_torch as tpkg
    import path_tracer_tpu_torch.scene.model as model
    import path_tracer_tpu_torch.scene.procedural as proc
    from path_tracer_tpu_torch.integrator import wavefront
    from path_tracer_tpu_torch.models import openpbr
    from path_tracer_tpu_torch.ops.intersect import SceneLayout

    packed = tpkg.compile_scene(openpbr_scene(model, proc), aspect_ratio=2.0,
                                device=cuda)
    layout = SceneLayout.from_packed(packed)
    config = wavefront.RenderConfig(width=96, height=48)
    state = wavefront.reset(packed, config, seed=7)
    wavefront.render_round(packed, layout, config, state, 0.05)
    seen = []
    walk = openpbr.sample_bsdf

    def seen_walk(ctx, view, u1, u2, u3, rng, where):
        seen.append((ctx['type'], where))    # counted after the round
        return walk(ctx, view, u1, u2, u3, rng, where)

    monkeypatch.setattr(openpbr, 'sample_bsdf', seen_walk)
    activities = [torch.profiler.ProfilerActivity.CPU,
                  torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof, \
            profiling.tracing():
        wavefront.render_round(packed, layout, config, state, 0.05)
        torch.cuda.synchronize()
        counted = profiling.counters()
    assert counted['kernel.openpbr_walk'] == len(seen) == 1
    typed = int(((seen[0][0] == MATERIAL_TYPE_OPENPBR) & seen[0][1]).sum())
    assert counted['pt.model.openpbr.lanes'] == typed > 0
    by_type = counted['pt.scatter.surface_lanes_by_type']
    assert counted['pt.model.openpbr.lanes'] == by_type['openpbr']
    assert 0 < counted['pt.model.openpbr.walk_warps'] \
        <= counted['pt.model.openpbr.warps'] == -(-96 * 48 // 32)
    events = prof.events()
    spans = [e.time_range for e in events
             if e.name == 'pt.model.openpbr.sample' and e.device_type ==
             torch.autograd.DeviceType.CPU]
    launched = [e.time_range.start for e in events
                if 'LaunchKernel' in e.name and any(
                    s.start <= e.time_range.start <= s.end for s in spans)]
    assert len(spans) == 1
    assert 1 <= len(launched) <= 3, [e.name for e in events if 'Launch' in e.name]


@pytest.mark.parametrize('scene_name', ['textured_inst', 'metal_flat'])
def test_render_scene_on_card_matches_cpu(cuda, scene_name):
    """render_scene at 64x32, 4 rounds, seed 3 on the card against the
    same call on the CPU (the plain traversal), for the textured scene
    through inst_trace and the diffuse + metal scene through wide_trace5:
    the random streams are the same, so the frames differ only where a
    last-bit difference of a transcendental sends a path elsewhere. Held
    to bench.py's Monte-Carlo bands at their floor, 2% of the mean."""
    import path_tracer_tpu_torch as tpkg
    import path_tracer_tpu_torch.scene.compile as tcompile
    import path_tracer_tpu_torch.scene.model as model
    import path_tracer_tpu_torch.scene.procedural as proc

    def frame(device):
        if scene_name == 'textured_inst':
            return tpkg.render_scene(textured_scene(model, proc), 64, 32,
                                     spp_rounds=4, seed=3, device=device)
        with flat_mode(tcompile):
            return tpkg.render_scene(two_instance_scene(model, proc), 64, 32,
                                     spp_rounds=4, seed=3, device=device)

    ref = frame('cpu').numpy()
    img = frame(cuda).cpu().numpy()
    assert img.shape == ref.shape == (32, 64, 3)
    assert np.isfinite(img).all()
    rel = np.abs(img - ref).mean() / (ref.mean() + 1e-3)
    bias = abs(img.mean() - ref.mean()) / (ref.mean() + 1e-3)
    assert rel < 0.02 and bias < 0.02, (rel, bias)


def test_openpbr_scene_on_card_matches_cpu(cuda):
    """The OpenPBR scene (coat, metal and translucent bases, emitters, the
    fallback material, nested glass, fog), 96x48, 16 rounds, seed 7, on
    the card against the CPU: the same random streams, so only last-bit
    differences of transcendentals separate the frames. Within 2% mean
    absolute error and 2% bias."""
    import path_tracer_tpu_torch as tpkg
    import path_tracer_tpu_torch.scene.model as model
    import path_tracer_tpu_torch.scene.procedural as proc

    def frame(device):
        return tpkg.render_scene(openpbr_scene(model, proc), 96, 48,
                                 spp_rounds=16, seed=7, device=device)

    ref = frame('cpu').numpy()
    img = frame(cuda).cpu().numpy()
    assert img.shape == ref.shape == (48, 96, 3)
    assert np.isfinite(img).all() and img.mean() > 0.01
    rel = np.abs(img - ref).mean() / (ref.mean() + 1e-3)
    bias = abs(img.mean() - ref.mean()) / (ref.mean() + 1e-3)
    assert rel < 0.02 and bias < 0.02, (rel, bias)


def test_waves_render_on_card_matches_cpu(cuda):
    """A waves=4 render of the textured scene at 32x16, 4 rounds, seed 3,
    on the card against the CPU: the same streams, so within bench.py's
    band floor (2%); inst_trace launched once a round."""
    import path_tracer_tpu_torch as tpkg
    import path_tracer_tpu_torch.scene.model as model
    import path_tracer_tpu_torch.scene.procedural as proc

    def frame(device):
        packed = tpkg.compile_scene(textured_scene(model, proc),
                                    aspect_ratio=2.0, device=device)
        state = tpkg.render(packed, tpkg.RenderConfig(width=32, height=16,
                                                      waves=4), 4, seed=3)
        return tpkg.resolve(state['accum'], 32, 16, lane=state['lane'])

    ref = frame('cpu').numpy()
    profiling.reset()
    img = frame(cuda).cpu().numpy()
    assert launches('inst_trace') == 4
    rel = np.abs(img - ref).mean() / (ref.mean() + 1e-3)
    bias = abs(img.mean() - ref.mean()) / (ref.mean() + 1e-3)
    assert rel < 0.02 and bias < 0.02, (rel, bias)


def test_render_resilient_on_card(cuda, tmp_path):
    """render_resilient on the card with one injected failure equals the
    uninterrupted render bit for bit, stays on the card, and its
    checkpoint loads on the CPU to the same tensors."""
    import path_tracer_tpu_torch.scene.model as model
    import path_tracer_tpu_torch.scene.procedural as proc
    from path_tracer_tpu_torch.integrator.checkpoint import load_render_state
    from path_tracer_tpu_torch.utils.resilience import render_resilient

    ckpt = str(tmp_path / 'c.npz')
    clean = render_resilient(textured_scene(model, proc), 64, 32, 6, seed=3,
                             checkpoint_every=2, device=cuda)
    fired = []

    def inject(done):
        if done == 2 and not fired:
            fired.append(done)
            raise RuntimeError('injected')

    state = render_resilient(textured_scene(model, proc), 64, 32, 6, seed=3,
                             checkpoint_path=ckpt, checkpoint_every=2,
                             device=cuda, _inject_failure=inject)
    assert fired and state['accum']['xyz'].is_cuda
    for key in ('origin', 'direction', 'rng_state', 'lane'):
        assert torch.equal(clean[key], state[key]), key
    assert torch.equal(clean['accum']['xyz'], state['accum']['xyz'])
    like = {k: ({kk: vv.cpu() for kk, vv in v.items()} if isinstance(v, dict)
                else v.cpu()) for k, v in state.items()}
    on_cpu = load_render_state(ckpt, like, device='cpu')
    assert torch.equal(on_cpu['accum']['xyz'], like['accum']['xyz'])
    assert torch.equal(on_cpu['rng_state'], like['rng_state'])


def test_session_preview_and_heatmap_on_card(cuda):
    """A Session on the card: frames (inst_trace once a round), all seven
    preview modes, a pick, an incremental material edit equal to a full
    compile in every field, and the heatmap's kernel counters equal to
    the plain version's."""
    import path_tracer_tpu_torch.scene.compile as tcompile
    import path_tracer_tpu_torch.scene.model as model
    import path_tracer_tpu_torch.scene.procedural as proc
    from path_tracer_tpu_torch.app import Session
    from path_tracer_tpu_torch.ops import trace_inst
    from path_tracer_tpu_torch.viewer import preview

    session = Session(textured_scene(model, proc), 64, 32, device=cuda)
    profiling.reset()
    for _ in range(3):
        img = session.frame()
    assert launches('inst_trace') == 3 and img.is_cuda
    for mode in range(7):
        frame = session.preview(mode=mode)
        assert tuple(frame.shape) == (32, 64, 3)
        assert bool(torch.isfinite(frame).all()) and float(frame.max()) > 0.0
    assert session.pick(32, 16) >= -1

    session.scene.materials[0].base_color = np.asarray([0.2, 0.5, 0.9],
                                                       np.float32)
    session.scene.mark_dirty(model.SCENE_DIRTY_MATERIALS)
    session.frame()
    fresh = textured_scene(model, proc)
    fresh.compile_generic = session.generic_programs
    fresh.materials[0].base_color = np.asarray([0.2, 0.5, 0.9], np.float32)
    full = tcompile.compile_scene(fresh, aspect_ratio=2.0, device=cuda)
    for f in dataclasses.fields(full):
        a, b = getattr(session.packed, f.name), getattr(full, f.name)
        if f.name == 'materials':
            for g in dataclasses.fields(a):
                assert torch.equal(getattr(a, g.name), getattr(b, g.name)), g.name
        elif isinstance(a, dict):
            assert all(torch.equal(a[k], b[k]) for k in a), f.name
        else:
            assert torch.equal(a, b), f.name
    with pytest.raises(ValueError):
        tcompile.compile_scene(fresh, full, device='cpu')

    world = torch.as_tensor(session.camera_world(), device=cuda)
    origin, direction = preview._preview_rays(64, 32, world)
    t_in = torch.full((64 * 32,), 1e30, device=cuda)
    tables = (session.packed.inst_nodes, session.packed.inst_tris,
              session.packed.inst_rows)
    *_, stats = trace_inst.inst_trace(*tables, origin, direction, t_in,
                                      session.layout.tlas_rows, stats=True)
    *_, plain = trace_inst.inst_trace_plain(*tables, origin, direction, t_in,
                                            session.layout.tlas_rows, stats=True)
    assert torch.equal(stats, plain)
    heat = session.preview(mode=preview.PREVIEW_RENDER_MODE_MESH_COMPLEXITY)
    assert float(heat[..., 1].max()) > 0.0 and float(heat[..., 0].max()) == 0.0


def test_cli_demo_on_card(cuda, tmp_path):
    """`python -m path_tracer_tpu_torch demo viking` on the card (its
    default device) writes a PNG."""
    import os
    import subprocess
    import sys
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = str(tmp_path / 'v.png')
    subprocess.run([sys.executable, '-m', 'path_tracer_tpu_torch', 'demo',
                    'viking', out, '--width', '64', '--height', '32',
                    '--rounds', '4'], cwd=repo, check=True, timeout=600)
    assert os.path.getsize(out) > 100


def test_resolve_is_bit_stable_on_the_card(cuda):
    """resolve of a waves=4 accumulator, on the reset layout and with the
    slots shuffled, gives the same frame on every call (the fold adds a
    pixel's slots in slot order, not through atomics), equal to the CPU
    fold of the same slots."""
    from path_tracer_tpu_torch.integrator.resolve import resolve
    rng = np.random.default_rng(4)
    w, h, waves = 256, 128, 4
    n = waves * w * h
    xyz = torch.from_numpy(rng.uniform(0, 3, (3, n)).astype(np.float32))
    count = torch.from_numpy(rng.integers(0, 5, n).astype(np.float32))
    lane = torch.arange(n, dtype=torch.int32) % (w * h)
    perm = torch.from_numpy(rng.permutation(n))
    for args in ((xyz, count, lane), (xyz[:, perm], count[perm], lane[perm])):
        cpu = resolve(dict(xyz=args[0], count=args[1]), w, h, lane=args[2])
        frames = [resolve(dict(xyz=args[0].to(cuda), count=args[1].to(cuda)),
                          w, h, lane=args[2].to(cuda)) for _ in range(4)]
        for frame in frames:
            assert torch.equal(frame, frames[0])
        np.testing.assert_allclose(frames[0].cpu().numpy(), cpu.numpy(),
                                   rtol=2e-5, atol=2e-6)


def test_viewer_server_frame_on_card(cuda):
    """viewer/server.py over a Session on the card: a /frame.png poll
    launches inst_trace once and serves a PNG; a material edit over HTTP
    reaches the next frame."""
    import json
    import urllib.request
    import path_tracer_tpu_torch.scene.model as model
    import path_tracer_tpu_torch.scene.procedural as proc
    from path_tracer_tpu_torch.app import Session
    from path_tracer_tpu_torch.viewer.server import ViewerServer

    session = Session(textured_scene(model, proc), 64, 32, device=cuda)
    server = ViewerServer(session, port=0)
    server.serve_background()
    base = f'http://127.0.0.1:{server.port}'
    try:
        profiling.reset()
        png = urllib.request.urlopen(base + '/frame.png?mode=render').read()
        assert png[:8] == b'\x89PNG\r\n\x1a\n' and launches('inst_trace') == 1
        req = urllib.request.Request(base + '/material/update', data=json.dumps(
            {'index': 0, 'field': 'base_color', 'value': [0.9, 0.1, 0.1]}
        ).encode(), method='POST')
        urllib.request.urlopen(req).read()
        after = urllib.request.urlopen(base + '/frame.png?mode=render').read()
        assert after != png and launches('inst_trace') == 3
        assert session.state['accum']['xyz'].is_cuda
    finally:
        server.shutdown()


def test_sharded_render_world_of_one_on_card(cuda):
    """parallel/render.py at world size 1 over NCCL: the merged
    accumulator equals wavefront.render's bit for bit, at 1 and 2
    waves."""
    import torch.distributed as dist
    import path_tracer_tpu_torch.scene.compile as tcompile
    import path_tracer_tpu_torch.scene.model as model
    import path_tracer_tpu_torch.scene.procedural as proc
    from path_tracer_tpu_torch.integrator import wavefront
    from path_tracer_tpu_torch.parallel import render as parallel

    mesh = parallel.make_mesh(device='cuda')
    try:
        assert dist.get_backend() == 'nccl' and mesh.shape == {
            'batch': 1, 'pixels': 1}
        packed = tcompile.compile_scene(textured_scene(model, proc),
                                        aspect_ratio=2.0, device=cuda)
        for waves in (1, 2):
            config = wavefront.RenderConfig(width=64, height=32, waves=waves)
            merged = parallel.render_sharded(packed, config, 4, mesh, seed=2)
            single = wavefront.render(packed, config, 4, seed=2)
            order = torch.argsort(single['lane'], stable=True)
            assert torch.equal(merged['xyz'], single['accum']['xyz'][:, order])
            assert torch.equal(merged['count'], single['accum']['count'][order])
    finally:
        dist.destroy_process_group()


def cell_scene(name):
    """The scene of the benchmark cell `name`, built by the port from its
    configuration file."""
    import types

    from benchmark.harness.cell import load_cell
    from path_tracer_tpu_torch.core import constants
    from path_tracer_tpu_torch.scene import model

    cell = load_cell(name)
    api = types.SimpleNamespace(**{k: v for m in (constants, model)
                                   for k, v in vars(m).items()
                                   if not k.startswith('_')})
    return cell.maker.make_scene(api, cell.config)


def one_weekend_scene():
    """The benchmark's one_weekend_final scene (484 spheres, thin lens,
    sky)."""
    return cell_scene('one_weekend_final.offline_1200x675_w8')


def _shape_rays(case, packed, cuda, n=65536):
    """(camera or random rays, bounce rays) of a shape-trace case, n each."""
    from path_tracer_tpu_torch.core.constants import (
        RENDER_FLAG_ACCUMULATE, RENDER_FLAG_SAMPLE_JITTER)
    from path_tracer_tpu_torch.integrator import wavefront
    from path_tracer_tpu_torch.ops.intersect import SceneLayout

    rng = np.random.default_rng(17)
    if case != 'one_weekend':
        o = rng.uniform(-7, 7, (3, n)).astype(np.float32)
        d = rng.normal(size=(3, n)).astype(np.float32)
        d /= np.linalg.norm(d, axis=0)
        first = (torch.from_numpy(o).to(cuda), torch.from_numpy(d).to(cuda))
        hit = wavefront.trace(packed, SceneLayout.from_packed(packed), *first)
        hits = hit['shape'] != SHAPE_INDEX_NONE
        d = rng.normal(size=(3, n)).astype(np.float32)
        d /= np.linalg.norm(d, axis=0)
        return first, (torch.where(hits, hit['position'], first[0]),
                       torch.from_numpy(d).to(cuda))
    config = wavefront.RenderConfig(
        width=1200, height=675, waves=1,
        flags=RENDER_FLAG_ACCUMULATE | RENDER_FLAG_SAMPLE_JITTER,
        camera_model=packed.host_camera_models[0])
    state = wavefront.reset(packed, config, 2 ** 31 + 5)
    idx = torch.as_tensor(np.sort(rng.choice(1200 * 675, n, replace=False)),
                          device=cuda)
    first = (state['origin'][:, idx].contiguous(),
             state['direction'][:, idx].contiguous())
    wavefront.render(packed, config, 2, state=state,
                     layout=SceneLayout.from_packed(packed),
                     termination_probability=0.05)
    return first, (state['origin'][:, idx].contiguous(),
                   state['direction'][:, idx].contiguous())


@pytest.mark.parametrize('case', ['seeded', 'seeded_generic', 'one_weekend'])
def test_shape_trace_kernel_matches_dense_path(cuda, case):
    """csrc/shape_trace.cu through intersect_analytic on the card against
    the dense path on the card, bit for bit in every field but
    complexity, on 65,536 camera (or random) rays and 65,536 bounce rays;
    its complexity equals traverse_shape_bvh's nodes and tests."""
    import path_tracer_tpu_torch.scene.compile as tcompile
    from path_tracer_tpu_torch.core.constants import HIT_TIME_LIMIT
    from path_tracer_tpu_torch.ops import intersect
    from test_torch_trace_shapes import shapes_scene

    scene = (one_weekend_scene() if case == 'one_weekend'
             else shapes_scene(11, n=200, generic=case == 'seeded_generic'))
    packed = tcompile.compile_scene(scene, aspect_ratio=1200 / 675,
                                    device=cuda)
    layout = intersect.SceneLayout.from_packed(packed)
    for o, d in _shape_rays(case, packed, cuda):
        hit = intersect.make_hit(o.shape[1], HIT_TIME_LIMIT, cuda)
        profiling.reset()
        got = intersect.intersect_analytic(packed, layout, o, d, hit)
        assert launches('shape_trace') == 1
        want = intersect.intersect_analytic_dense(packed, layout, o, d, hit)
        walk = intersect.traverse_shape_bvh(packed, o, d, hit)
        for key in ('time', 'shape', 'shape_type', 'primitive', 'coords'):
            assert torch.equal(got[key], want[key]), (
                key, int((got[key] != want[key]).sum()))
            assert torch.equal(walk[key], want[key]), key
        assert torch.equal(got['complexity'], walk['complexity'])
        assert float((got['shape'] != SHAPE_INDEX_NONE).float().mean()) > 0.2


def test_shape_trace_on_the_main_path(cuda):
    """A render of the one_weekend scene launches the kernel once a
    round through `trace` with no option set, and while tracing is on
    the kernel's own counters equal the plain walk's nodes and tests."""
    import path_tracer_tpu_torch as tpkg
    import path_tracer_tpu_torch.scene.compile as tcompile
    from path_tracer_tpu_torch.ops import intersect

    scene = one_weekend_scene()
    profiling.reset()
    img = tpkg.render_scene(scene, 96, 54, spp_rounds=5, device=cuda)
    assert launches('shape_trace') == 5
    assert bool(torch.isfinite(img).all()) and float(img.mean()) > 0.0
    packed = tcompile.compile_scene(scene, aspect_ratio=96 / 54, device=cuda)
    layout = intersect.SceneLayout.from_packed(packed)
    (o, d), _ = _shape_rays('one_weekend', packed, cuda, n=4096)
    hit = intersect.make_hit(o.shape[1], 1048576.0, cuda)
    _, counts = intersect.traverse_shape_bvh(packed, o, d, hit, stats=True)
    with profiling.tracing():
        intersect.trace(packed, layout, o, d)
        names = [r[0] for r in profiling.records()]
        got = profiling.counters()
    assert 'pt.trace.analytic' in names and got['kernel.shape_trace'] == 1
    assert got[intersect.ANALYTIC_NODES] == int(counts[0].sum())
    assert got[intersect.ANALYTIC_TESTS] == int(counts[1].sum())


def test_inst_trace_counters_on_the_main_path(cuda):
    """`trace` in 'inst' mode on the instanced blob scene: with tracing
    off it launches the timed instantiation of csrc/trace_inst.cu (no
    counters) and counts nothing; with tracing on the counting one, and
    the device counters equal the sums of an inst_trace(stats=True)
    launch on the same rays."""
    import re

    import path_tracer_tpu_torch.scene.model as model
    from path_tracer_tpu_torch.core.constants import HIT_TIME_LIMIT
    from path_tracer_tpu_torch.ops import intersect, trace_inst
    from path_tracer_tpu_torch.scene.compile import compile_scene

    scene, rng = blob_scene(model)
    packed = compile_scene(scene, device=cuda)
    layout = intersect.SceneLayout.from_packed(packed)
    assert layout.packet_mode == 'inst'
    o, d, _ = _random_rays(rng, 8192, cuda)
    activities = [torch.profiler.ProfilerActivity.CPU,
                  torch.profiler.ProfilerActivity.CUDA]

    def instantiations(traced):
        profiling.reset()
        with torch.profiler.profile(activities=activities) as prof, \
                (profiling.tracing() if traced else contextlib.nullcontext()):
            hit = intersect.trace(packed, layout, o, d)
            torch.cuda.synchronize()
            got = profiling.counters()
        names = [re.search(r'inst_trace_kernel<\d+, (true|false)>', e.name)
                 for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA
                 and 'inst_trace_kernel' in e.name]
        assert got['kernel.inst_trace'] == 1
        return [m.group(1) for m in names], got, hit

    timed, got, hit_off = instantiations(False)
    assert timed == ['false']
    assert not any(name in got for name in intersect.KERNEL_COUNTERS)
    counting, got, hit_on = instantiations(True)
    assert counting == ['true']
    for key in ('time', 'shape', 'primitive', 'normal'):
        assert torch.equal(hit_on[key], hit_off[key]), key

    hit = intersect.intersect_analytic(
        packed, layout, o, d, intersect.make_hit(o.shape[1], HIT_TIME_LIMIT, cuda))
    *_, per_ray = trace_inst.inst_trace(
        packed.inst_nodes, packed.inst_tris, packed.inst_rows, o, d,
        hit['time'], layout.tlas_rows, stats=True)
    want = {name: int(per_ray[row].sum())
            for name, row in intersect.KERNEL_COUNTERS.items()}
    assert {name: got[name] for name in want} == want
    hits = int((hit_on['shape'] != SHAPE_INDEX_NONE).sum())
    assert hits > 30
    assert want['pt.trace.kernel.tests'] >= hits
    assert want['pt.trace.kernel.instances'] >= hits


def mixed_scene():
    """test_torch_trace_shapes.shapes_scene's planes, spheres and cubes
    (60 shapes, ties included) beside three instances of a random
    48-triangle mesh under rotations and non-uniform scales."""
    import path_tracer_tpu_torch.scene.model as model
    from test_torch_trace_shapes import shapes_scene

    scene = shapes_scene(11, n=60)
    rng = np.random.default_rng(5)
    nrm = rng.normal(0, 1, (40, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    mesh = scene.create_mesh(
        name='blob', positions=rng.normal(0, 1, (40, 3)).astype(np.float32),
        normals=nrm, uvs=rng.uniform(0, 1, (40, 2)).astype(np.float32),
        faces=rng.integers(0, 40, (48, 3)).astype(np.int32))
    material = scene.create_material(model.MATERIAL_TYPE_BASIC_DIFFUSE)
    for _ in range(3):
        e = scene.create_entity(model.ENTITY_TYPE_MESH_INSTANCE, mesh=mesh,
                                material=material)
        e.transform.position = rng.uniform(-4, 4, 3).astype(np.float32)
        e.transform.rotation = rng.uniform(0, 6.28, 3).astype(np.float32)
        e.transform.scale = rng.uniform(0.5, 2.0, 3).astype(np.float32)
        e.transform.scale_is_uniform = False
    return scene


# The layouts the hit-attribute kernel is held to its plain chain in:
# 'inst' with one instance and with several, 'flat', analytic shapes alone
# (no instance slot), every shape type beside mesh instances, and that
# scene through the portable traversal (mesh hits with barycentrics).
ATTRIBUTE_CASES = ('inst_one', 'inst_several', 'flat', 'one_weekend', 'mixed',
                   'portable')


def attribute_case(case, device):
    """The compiled scene of an ATTRIBUTE_CASES case on `device`."""
    import path_tracer_tpu_torch.scene.compile as tcompile
    import path_tracer_tpu_torch.scene.model as model

    if case == 'flat':
        with flat_mode(tcompile):
            return tcompile.compile_scene(blob_scene(model)[0], device=device)
    scene = {'inst_one': lambda: blob_scene(model, n_instances=1)[0],
             'inst_several': lambda: blob_scene(model)[0],
             'one_weekend': one_weekend_scene, 'mixed': mixed_scene,
             'portable': mixed_scene}[case]()
    return tcompile.compile_scene(scene, aspect_ratio=1200 / 675, device=device)


def attribute_trace_options(case):
    """The options of `trace` in an ATTRIBUTE_CASES case, and whether
    its attributes are resolved without the mesh kernel's winners."""
    if case == 'portable':
        return dict(use_packet=False), True
    return {}, case == 'one_weekend'


def same_bits(a, b):
    """Equal to the bit: float32 compared as their int32 words, so that
    NaNs and the sign of zero count."""
    if a.dtype == torch.float32:
        return torch.equal(a.view(torch.int32), b.view(torch.int32))
    return torch.equal(a, b)


def attribute_bins(record):
    """The ATTRIBUTE_BINS counts of a resolved hit record: misses, then
    mesh, plane, sphere and cube hits."""
    from path_tracer_tpu_torch.ops import intersect

    hits = record['shape'] != SHAPE_INDEX_NONE
    lanes = torch.where(hits, record['shape_type'] + 1, 0)
    counts = torch.bincount(lanes, minlength=5).tolist()
    return dict(zip(intersect.ATTRIBUTE_BINS, counts))


@pytest.mark.parametrize('case', ATTRIBUTE_CASES)
def test_hit_attributes_kernel_matches_plain_chain(cuda, case, monkeypatch):
    """csrc/hit_attributes.cu, as `trace` launches it, against the plain
    chain (resolve_attributes_plain) on the card on the same inputs, bit
    for bit in every field on every lane, misses included, on 65,536
    camera (or random) rays and 65,536 bounce rays, with tracing off and
    on (the kernel's two instantiations of each mode); one launch a trace,
    and while tracing its lane bins equal those of the plain record and
    sum to N."""
    from path_tracer_tpu_torch.ops import hit_attributes, intersect

    packed = attribute_case(case, cuda)
    layout = intersect.SceneLayout.from_packed(packed)
    captured = []
    launch = hit_attributes.hit_attributes

    def capture(*args, **kwargs):
        captured.append(args)
        return launch(*args, **kwargs)

    rays = _shape_rays('one_weekend' if case == 'one_weekend' else 'seeded',
                       packed, cuda)
    monkeypatch.setattr(hit_attributes, 'hit_attributes', capture)
    options, no_winners = attribute_trace_options(case)
    seen = dict.fromkeys(intersect.ATTRIBUTE_BINS, 0)
    for (o, d), traced in itertools.product(rays, (False, True)):
        n = o.shape[1]
        profiling.reset()
        with profiling.tracing() if traced else contextlib.nullcontext():
            got = intersect.trace(packed, layout, o, d, **options)
            counted = profiling.counters()
        assert counted['kernel.hit_attributes'] == 1
        _, _, _, _, hit, winners = captured.pop()
        assert (winners is None) == no_winners
        want = intersect.resolve_attributes_plain(packed, layout, o, d, hit,
                                                  winners)
        assert list(got) == list(want)
        for key in want:
            assert same_bits(got[key], want[key]), (
                key, traced, int((got[key] != want[key]).sum()))
        if not traced:
            assert intersect.ATTRIBUTE_LANES not in counted
            continue
        bins = counted[intersect.ATTRIBUTE_LANES]
        assert bins == attribute_bins(want) and sum(bins.values()) == n
        for k, v in bins.items():
            seen[k] += v
    assert seen['miss'] > 0
    expect = {'inst_one': ('mesh',), 'inst_several': ('mesh',),
              'flat': ('mesh',), 'one_weekend': ('sphere',),
              'mixed': ('mesh', 'plane', 'sphere', 'cube'),
              'portable': ('mesh', 'plane', 'sphere', 'cube')}[case]
    assert all(seen[k] > 0 for k in expect), seen


def test_hit_attributes_on_the_main_path(cuda):
    """A render launches the kernel once a round through `trace` with no
    option set, and a trace through the portable traversal launches it
    once too."""
    import path_tracer_tpu_torch as tpkg
    import path_tracer_tpu_torch.scene.model as model
    from path_tracer_tpu_torch.ops import intersect

    scene, rng = blob_scene(model)
    profiling.reset()
    img = tpkg.render_scene(scene, 96, 54, spp_rounds=4, device=cuda)
    assert launches('hit_attributes') == 4
    assert bool(torch.isfinite(img).all())
    packed = attribute_case('mixed', cuda)
    layout = intersect.SceneLayout.from_packed(packed)
    o, d, _ = _random_rays(rng, 4096, cuda)
    profiling.reset()
    portable = intersect.trace(packed, layout, o, d, use_packet=False)
    assert launches('hit_attributes') == 1
    kernel = intersect.trace(packed, layout, o, d)
    assert launches('hit_attributes') == 2
    # The two traversals agree on what each lane hit.
    assert float((portable['shape'] == kernel['shape']).float().mean()) > 0.99


def test_hit_attributes_wrapper_rejects_bad_input(cuda):
    """The wrapper checks device, dtype and shape of every tensor it
    hands the kernel before it launches."""
    import path_tracer_tpu_torch.scene.model as model
    from path_tracer_tpu_torch.core.constants import HIT_TIME_LIMIT
    from path_tracer_tpu_torch.ops import hit_attributes, intersect, trace_inst

    packed = attribute_case('inst_several', cuda)
    layout = intersect.SceneLayout.from_packed(packed)
    o, d, _ = _random_rays(np.random.default_rng(3), 256, cuda)
    hit = intersect.make_hit(256, HIT_TIME_LIMIT, cuda)
    winners = trace_inst.inst_trace(packed.inst_nodes, packed.inst_tris,
                                    packed.inst_rows, o, d, hit['time'],
                                    tlas_rows=layout.tlas_rows)

    def run(o=o, d=d, hit=hit, winners=winners, **kwargs):
        return hit_attributes.hit_attributes(packed, layout, o, d, hit,
                                             winners, **kwargs)

    run()
    bad_fields = (dict(time=hit['time'].double()),
                  dict(shape=hit['shape'].float()),
                  dict(coords=hit['coords'][:2]),
                  dict(primitive=hit['primitive'][:128]),
                  dict(coords=torch.zeros((256, 3), device=cuda).T))
    for bad in (dict(o=o.double()), dict(o=o.cpu()), dict(d=d[:2]),
                dict(winners=winners[:4]),
                dict(winners=(winners[0], winners[1].float(), *winners[2:])),
                dict(winners=(winners[0][:64], *winners[1:])),
                dict(stats=torch.zeros(4, dtype=torch.int64, device=cuda)),
                *(dict(hit=dict(hit, **f)) for f in bad_fields)):
        with pytest.raises(ValueError):
            run(**bad)


def medium_lanes(n, seed=5, inner=(1,), outer=(2,), device='cpu'):
    """Inputs of the medium event for n random lanes (ops/medium_event.py's
    LANE_INPUTS): active-shape lists holding one of the shapes `inner` in
    slot 0 on about half the lanes and one of `outer` in slot 2 on about a
    fifth, wavelengths, weights, rays and a hit record."""
    rng = np.random.default_rng(seed)
    shapes = np.full((4, n), SHAPE_INDEX_NONE, np.int32)
    shapes[0] = np.where(rng.random(n) < 0.5, rng.choice(inner, n),
                         SHAPE_INDEX_NONE)
    shapes[2] = np.where(rng.random(n) < 0.2, rng.choice(outer, n),
                         SHAPE_INDEX_NONE)
    d = rng.normal(size=(3, n)).astype(np.float32)
    nrm = rng.normal(size=(3, n)).astype(np.float32)
    arrays = dict(
        active_shapes=shapes,
        lam=rng.uniform(380, 720, (4, n)).astype(np.float32),
        throughput=rng.uniform(0, 1, (4, n)).astype(np.float32),
        probability=rng.uniform(0.1, 1, (4, n)).astype(np.float32),
        time=rng.uniform(0, 10, n).astype(np.float32),
        shape=rng.choice(list(inner) + list(outer), n).astype(np.int32),
        normal=nrm / np.linalg.norm(nrm, axis=0),
        origin=rng.uniform(-3, 3, (3, n)).astype(np.float32),
        direction=d / np.linalg.norm(d, axis=0),
        rng_state=rng.integers(0, 2 ** 32, n, dtype=np.int64))
    return {k: torch.from_numpy(v).to(device) for k, v in arrays.items()}


def medium_event_plain_of(packed, types, lanes):
    """integrator/scatter.py's medium_event_plain on the LANE_INPUTS of
    `lanes`, with the random state it leaves as `rng_state`."""
    from path_tracer_tpu_torch.core.sampling import Rng
    from path_tracer_tpu_torch.integrator import scatter

    rng = Rng(lanes['rng_state'].clone())
    hit = {k: lanes[k] for k in ('time', 'shape', 'normal')}
    out = scatter.medium_event_plain(
        packed, types, lanes['active_shapes'], lanes['lam'],
        lanes['throughput'], lanes['probability'], hit, lanes['origin'],
        lanes['direction'], rng)
    out['rng_state'] = rng.state
    return out


def medium_bin_counts(event):
    """The MEDIUM_BINS counts of a medium event's outputs."""
    from path_tracer_tpu_torch.integrator import scatter

    counts = torch.bincount(scatter.medium_bins(event), minlength=3)
    return dict(zip(scatter.MEDIUM_BINS, counts.tolist()))


# The scenes whose rounds the medium-event kernel is held to: the
# benchmark's Cornell box (every lane in the ambient medium), its
# one_weekend_final scene (glass interiors) and the OpenPBR scene (fog,
# translucent and OpenPBR media, nested shapes); with a film size each.
MEDIUM_CASES = {
    'cornell': (lambda: cell_scene('cornell_box.offline_1440x1440'), 128, 128),
    'one_weekend': (one_weekend_scene, 160, 90),
    'openpbr': (lambda: openpbr_scene(*_scene_modules()), 64, 32),
}


def _scene_modules():
    import path_tracer_tpu_torch.scene.model as model
    import path_tracer_tpu_torch.scene.procedural as proc
    return model, proc


@pytest.mark.parametrize('case', sorted(MEDIUM_CASES))
def test_medium_event_kernel_matches_plain_version(cuda, case, monkeypatch):
    """csrc/medium_event.cu, as `scatter` launches it in a render round,
    against medium_event_plain on the card on the same inputs, bit for bit
    in every output of every lane and in the random state it leaves, with
    tracing off and on (the kernel's two instantiations); one launch a
    round, and while tracing its lane bins equal those of the plain
    outputs and sum to the lanes. The Cornell box's lanes are all in the
    ambient medium, one_weekend's glass puts some inside a shape, and the
    OpenPBR scene's fog scatters some in a volume and nests shapes."""
    from path_tracer_tpu_torch.integrator import scatter, wavefront
    from path_tracer_tpu_torch.ops import medium_event
    from path_tracer_tpu_torch.ops.intersect import SceneLayout
    from path_tracer_tpu_torch.scene.compile import compile_scene

    make, width, height = MEDIUM_CASES[case]
    packed = compile_scene(make(), aspect_ratio=width / height, device=cuda)
    layout = SceneLayout.from_packed(packed)
    config = wavefront.RenderConfig(width=width, height=height)
    state = wavefront.reset(packed, config, seed=4)
    for _ in range(3):
        wavefront.render_round(packed, layout, config, state, 0.05)
    captured = []
    launch = medium_event.medium_event

    def capture(packed, types, lanes, stats=None):
        inputs = {k: v.clone() for k, v in lanes.items()}
        out = launch(packed, types, lanes, stats=stats)
        captured.append((types, inputs, dict(out)))
        return out

    monkeypatch.setattr(medium_event, 'medium_event', capture)
    seen = dict.fromkeys(scatter.MEDIUM_BINS, 0)
    nested = 0
    for traced in (False, True):
        profiling.reset()
        with profiling.tracing() if traced else contextlib.nullcontext():
            wavefront.render_round(packed, layout, config, state, 0.05)
            counted = profiling.counters()
        assert counted['kernel.medium_event'] == 1
        types, lanes, got = captured.pop()
        want = medium_event_plain_of(packed, types, lanes)
        assert set(got) == set(want)
        for key in want:
            assert same_bits(got[key], want[key]), (
                key, traced, int((got[key] != want[key]).sum()))
        bins = medium_bin_counts(want)
        assert sum(bins.values()) == width * height
        if traced:
            assert counted[scatter.MEDIUM_LANES] == bins
        else:
            assert scatter.MEDIUM_LANES not in counted
        for k, v in bins.items():
            seen[k] += v
        filled = (lanes['active_shapes'] != SHAPE_INDEX_NONE).sum(0)
        nested += int((filled >= 2).sum())
    assert seen['ambient'] > 0
    if case == 'cornell':
        assert seen['interior'] == seen['volume'] == 0, seen
    elif case == 'one_weekend':
        assert seen['interior'] > 0 and seen['volume'] == 0, seen
    else:
        assert seen['interior'] > 0 and seen['volume'] > 0 and nested > 0, (
            seen, nested)


def random_medium_tables(n, seed, device):
    """The tables the medium event reads, made up: n shapes, each with a
    material slot of its own of a random type, IOR, Abbe number,
    transmission depth (zero on a quarter), spectra and anisotropy, and a
    scatter rate for the ambient medium."""
    import types

    rng = np.random.default_rng(seed)

    def col(*shape, lo=0.0, hi=1.0):
        return torch.from_numpy(rng.uniform(lo, hi, shape + (n,)).astype(
            np.float32)).to(device)

    depth = col(lo=0.05, hi=2.0)
    depth[torch.from_numpy(rng.random(n) < 0.25).to(device)] = 0.0
    materials = types.SimpleNamespace(
        type=torch.from_numpy(rng.integers(0, 4, n).astype(np.int32)).to(device),
        ior=col(lo=1.2, hi=2.4), abbe_number=col(lo=15.0, hi=80.0),
        transmission_spectrum=col(3, lo=-3.0, hi=3.0),
        transmission_depth=depth,
        scattering_spectrum=col(3, lo=-3.0, hi=3.0),
        scattering_anisotropy=col(lo=-0.9, hi=0.9),
        specular_ior=col(lo=1.2, hi=2.4),
        transmission_dispersion_abbe=col(lo=15.0, hi=80.0),
        transmission_scatter_spectrum=col(3, lo=-3.0, hi=3.0),
        transmission_scatter_anisotropy=col(lo=-0.9, hi=0.9))
    return types.SimpleNamespace(
        shape_material=torch.arange(n, dtype=torch.int32, device=device),
        scene_scatter_rate=torch.tensor(0.05, device=device),
        materials=materials)


@pytest.mark.parametrize('tables', ['scene', 'generic', 'random'])
def test_medium_event_kernel_matches_plain_version_on_random_lanes(cuda,
                                                                   tables):
    """The kernel against medium_event_plain on 65,536 random lanes, bit
    for bit, and its counters against the plain outputs' bins: inside the
    OpenPBR scene's translucent and OpenPBR shapes with the scene's type
    set and with the generic one (every model), and inside 4,096 made-up
    shapes of all four types, each with its own IOR, dispersion, depth,
    spectra and anisotropy, in fog."""
    from path_tracer_tpu_torch.ops import medium_event
    from path_tracer_tpu_torch.ops.intersect import SceneLayout
    from path_tracer_tpu_torch.scene.compile import compile_scene

    if tables == 'random':
        packed, type_set = random_medium_tables(4096, 12, cuda), ()
        inner = outer = tuple(range(4096))
    else:
        packed = compile_scene(openpbr_scene(*_scene_modules()), device=cuda)
        type_set = (SceneLayout.from_packed(packed).material_types
                    if tables == 'scene' else ())
        # Shapes 2, 4 and 5: the translucent OpenPBR sphere, the glass mesh
        # ball and the rough glass sphere; 7 the emissive OpenPBR ceiling.
        inner, outer = (2, 4, 5), (4, 5, 7)
    lanes = medium_lanes(65536, seed=8, inner=inner, outer=outer, device=cuda)
    stats = torch.zeros(3, dtype=torch.int64, device=cuda)
    got = medium_event.medium_event(packed, type_set, lanes, stats=stats)
    want = medium_event_plain_of(packed, type_set, lanes)
    for key in want:
        assert same_bits(got[key], want[key]), (
            key, int((got[key] != want[key]).sum()))
    bins = medium_bin_counts(want)
    assert dict(zip(bins, stats.tolist())) == bins
    assert all(v > 0 for v in bins.values()), bins


def test_medium_event_on_the_main_path(cuda):
    """A render launches the kernel once a round where the scene has a
    medium, and never where it has none."""
    import path_tracer_tpu_torch as tpkg

    profiling.reset()
    img = tpkg.render_scene(openpbr_scene(*_scene_modules()), 64, 32,
                            spp_rounds=4, device=cuda)
    assert launches('medium_event') == 4
    assert bool(torch.isfinite(img).all())
    profiling.reset()
    tpkg.render_scene(blob_scene(_scene_modules()[0])[0], 64, 32,
                      spp_rounds=2, device=cuda)
    assert launches('medium_event') == 0


def test_medium_event_wrapper_rejects_bad_input(cuda):
    """The wrapper checks device, dtype, shape and layout of every tensor
    it hands the kernel before it launches."""
    from path_tracer_tpu_torch.ops import medium_event
    from path_tracer_tpu_torch.scene.compile import compile_scene

    packed = compile_scene(openpbr_scene(*_scene_modules()), device=cuda)
    lanes = medium_lanes(256, inner=(4,), outer=(5,), device=cuda)
    medium_event.medium_event(packed, (), lanes)
    bad = (dict(time=lanes['time'].double()),
           dict(shape=lanes['shape'].float()),
           dict(origin=lanes['origin'].cpu()),
           dict(normal=lanes['normal'][:2]),
           dict(lam=lanes['lam'][:, :128]),
           dict(direction=lanes['direction'].T.contiguous().T),
           dict(rng_state=lanes['rng_state'].to(torch.int32)))
    for fields in bad:
        with pytest.raises(ValueError):
            medium_event.medium_event(packed, (), dict(lanes, **fields))
    with pytest.raises(ValueError):
        medium_event.medium_event(
            packed, (), lanes,
            stats=torch.zeros(4, dtype=torch.int64, device=cuda))


BASIC_NAMES = ('basic_diffuse', 'basic_metal', 'basic_translucent')


def basic_lanes(n, seed, device):
    """Material contexts of n made-up lanes for the basic models' sample,
    with OpenPBR's columns too (openpbr_ctx): every lane a random type of
    the four, a quarter of the lanes smooth (roughness 0 or 5e-4, Dirac
    metal and glass), the others rough, isotropic or not, a third of the
    glass lanes under water (exterior IOR 1.33); views from both sides
    (entering and leaving glass), with the axis directions and a view in
    the surface's plane among them; and the three uniforms."""
    rng = np.random.default_rng(seed)
    ctx = openpbr_ctx(rng, n)
    ctx['type'] = rng.integers(0, 4, n).astype(np.int32)
    rough = rng.uniform(0.02, 1.0, n)
    rough[rng.random(n) < 0.15] = 0.0
    rough[rng.random(n) < 0.1] = 5e-4
    ctx['roughness'] = rough.astype(np.float32)
    ctx['roughness_anisotropy'] = np.where(
        rng.random(n) < 0.5, 0.0, rng.uniform(0, 0.9, n)).astype(np.float32)
    ctx['exterior_ior'] = np.repeat(np.where(
        rng.random(n) < 0.67, 1.0, 1.33).astype(np.float32)[None], 4, 0)
    ctx['ior'] = rng.uniform(1.2, 2.4, n).astype(np.float32)
    ctx['abbe_number'] = rng.uniform(15, 80, n).astype(np.float32)
    view = unit_directions(rng, n)
    view[:, :6] = np.array([[0, 0, 1], [0, 0, -1], [1, 0, 0], [0, 1, 0],
                            [0.6, 0, 0.8], [0, 0.6, -0.8]], np.float32).T
    u = [rng.uniform(0, 1, n).astype(np.float32) for _ in range(3)]
    return _on(device, ctx, view, u)


def basic_models(ctx_type, types, where):
    """The basic model each lane samples on the card, -1 for none: its own
    type where the set holds it, the set's first model for a type outside
    the set, none on the walk's OpenPBR lanes or outside `where`."""
    from path_tracer_tpu_torch.models import dispatch

    act = dispatch.active_types(types)
    t = ctx_type.long()
    in_set = torch.zeros_like(t, dtype=torch.bool)
    for a in act:
        in_set |= t == a
    model = torch.where(in_set, t, act[0])
    model = torch.where(model == MATERIAL_TYPE_OPENPBR, -1, model)
    return model if where is None else torch.where(where, model, -1)


def basic_plain(ctx, view, rng_state, types, where):
    """models/dispatch.py's sample_bsdf_plain on the card from a stream's
    state: its three draws, and the OpenPBR walk's after them."""
    from path_tracer_tpu_torch.core.sampling import Rng
    from path_tracer_tpu_torch.models import dispatch

    rng = Rng(rng_state.clone())
    u = [rng.uniform() for _ in range(3)]
    return dispatch.sample_bsdf_plain(ctx, view, *u, rng, types, where)


def assert_basic_sample(got, want, models):
    """The kernel's sample equal to the plain one to the bit on every lane
    that samples a basic model, in all four outputs."""
    lanes = models >= 0
    for name, g, w in zip(('scattered', 'throughput', 'probability', 'valid'),
                          got, want):
        g, w = g[..., lanes], w[..., lanes]
        assert same_bits(g, w), (name, int((g != w).sum()))


# The scenes whose rounds the basic-sample kernel is held to: the glass
# ball (diffuse, smooth glass, rough metal), one_weekend_final (diffuse,
# metal of four fuzz levels, smooth glass), the OpenPBR scene (OpenPBR
# beside smooth and rough glass) and the Cornell box (diffuse beside the
# OpenPBR light); with a film size each.
BASIC_CASES = {
    'glass_ball': (lambda: glass_ball_scene(*_scene_modules()), 96, 48),
    'one_weekend': (one_weekend_scene, 160, 90),
    'openpbr': (lambda: openpbr_scene(*_scene_modules()), 64, 32),
    'cornell': (lambda: cell_scene('cornell_box.offline_1440x1440'), 128, 128),
}


@pytest.mark.parametrize('case', sorted(BASIC_CASES))
def test_basic_sample_kernel_matches_plain_version(cuda, case, monkeypatch):
    """csrc/basic_sample.cu, as `scatter` launches it in a render round,
    against sample_bsdf_plain on the card on the same inputs, bit for bit
    in every output of every lane it samples, with tracing off and on (the
    kernel's two instantiations): one launch a round, no sample valid
    outside the surface events, and while tracing its lane counters equal
    the lanes of each model among the surface events."""
    from path_tracer_tpu_torch.integrator import wavefront
    from path_tracer_tpu_torch.models import dispatch
    from path_tracer_tpu_torch.ops.intersect import SceneLayout
    from path_tracer_tpu_torch.scene.compile import compile_scene

    make, width, height = BASIC_CASES[case]
    packed = compile_scene(make(), aspect_ratio=width / height, device=cuda)
    layout = SceneLayout.from_packed(packed)
    config = wavefront.RenderConfig(width=width, height=height)
    state = wavefront.reset(packed, config, seed=4)
    for _ in range(3):
        wavefront.render_round(packed, layout, config, state, 0.05)
    captured = []
    sample = dispatch.sample_bsdf

    def capture(ctx, view, rng, types=(), where=None):
        start = rng.state.clone()
        out = sample(ctx, view, rng, types, where)
        captured.append(({k: v.clone() for k, v in ctx.items()}, view.clone(),
                         start, types, where.clone(),
                         tuple(x.clone() for x in out)))
        return out

    monkeypatch.setattr(dispatch, 'sample_bsdf', capture)
    seen = dict.fromkeys(BASIC_NAMES, 0)
    for traced in (False, True):
        profiling.reset()
        with profiling.tracing() if traced else contextlib.nullcontext():
            wavefront.render_round(packed, layout, config, state, 0.05)
            counted = profiling.counters()
        assert counted['kernel.basic_sample'] == 1
        ctx, view, start, types, where, got = captured.pop()
        want = basic_plain(ctx, view, start, types, where)
        models = basic_models(ctx['type'], types, where)
        assert_basic_sample(got, want, models)
        if MATERIAL_TYPE_OPENPBR not in dispatch.active_types(types):
            assert not bool(got[3][~where].any())
        for m, name in enumerate(BASIC_NAMES):
            lanes = int((models == m).sum())
            seen[name] += lanes
            key = f'pt.model.{name}.lanes'
            assert counted.get(key) == (lanes if traced else None), (
                key, counted.get(key), lanes)
    present = [BASIC_NAMES[t] for t in layout.material_types
               if t != MATERIAL_TYPE_OPENPBR]
    assert present and all(seen[name] > 0 for name in present), seen
    if case in ('glass_ball', 'one_weekend'):
        assert len(present) == 3


BASIC_SETS = {
    'all': (),
    'basic': (MATERIAL_TYPE_BASIC_DIFFUSE, MATERIAL_TYPE_BASIC_METAL,
              MATERIAL_TYPE_BASIC_TRANSLUCENT),
    'metal_glass': (MATERIAL_TYPE_BASIC_METAL, MATERIAL_TYPE_BASIC_TRANSLUCENT),
    'diffuse': (MATERIAL_TYPE_BASIC_DIFFUSE,),
    'metal': (MATERIAL_TYPE_BASIC_METAL,),
    'glass': (MATERIAL_TYPE_BASIC_TRANSLUCENT,),
    'metal_openpbr': (MATERIAL_TYPE_BASIC_METAL, MATERIAL_TYPE_OPENPBR),
}


@pytest.mark.parametrize('where', ['every_lane', 'some_lanes'])
@pytest.mark.parametrize('types', sorted(BASIC_SETS))
def test_basic_sample_kernel_matches_plain_version_on_random_lanes(
        cuda, types, where):
    """`dispatch.sample_bsdf` on the card (the OpenPBR walk where the set
    holds it, then the basic kernel) against sample_bsdf_plain on the card
    on 65,536 made-up lanes of all four types, bit for bit in every output
    of every lane that samples: rough and smooth metal and glass, entering
    and leaving glass, types outside the set (they take the set's first
    model), with a mask and without; with tracing off and on, and while
    tracing the lane counters equal the lanes of each model."""
    from path_tracer_tpu_torch.core.sampling import Rng
    from path_tracer_tpu_torch.models import dispatch

    type_set = BASIC_SETS[types]
    n = 65536
    ctx, view, _ = basic_lanes(n, 70 + len(type_set), cuda)
    mask = (None if where == 'every_lane' else
            torch.from_numpy(np.random.default_rng(71).random(n) < 0.6)
            .to(cuda))
    models = basic_models(ctx['type'], type_set, mask)
    for traced in (False, True):
        rng = Rng.seed(torch.arange(n, device=cuda), 9)
        start = rng.state.clone()
        profiling.reset()
        with profiling.tracing() if traced else contextlib.nullcontext():
            got = dispatch.sample_bsdf(ctx, view, rng, type_set, mask)
            counted = profiling.counters()
        assert counted['kernel.basic_sample'] == 1
        want = basic_plain(ctx, view, start, type_set, mask)
        assert_basic_sample(got, want, models)
        if mask is not None and MATERIAL_TYPE_OPENPBR not in \
                dispatch.active_types(type_set):
            assert not bool(got[3][~mask].any())
            assert not bool(got[1][:, ~mask].any())
        for m, name in enumerate(BASIC_NAMES):
            key = f'pt.model.{name}.lanes'
            lanes = int((models == m).sum())
            assert counted.get(key) == (lanes if traced else None), key
    act = dispatch.active_types(type_set)
    for t in act:
        if t != MATERIAL_TYPE_OPENPBR:
            assert int((models == t).sum()) > n // 8
    if MATERIAL_TYPE_BASIC_TRANSLUCENT in act:
        glass = models == MATERIAL_TYPE_BASIC_TRANSLUCENT
        smooth = ctx['roughness'] < 1e-3
        for side in (view[2] >= 0, view[2] < 0):
            assert int((glass & side & smooth).sum()) > 100
            assert int((glass & side & ~smooth).sum()) > 100


def test_basic_sample_on_the_main_path(cuda, monkeypatch):
    """A render of the glass ball (no sky sampling, so nothing else
    selects by type) launches the basic kernel once a round and never
    selects by type on the card; so does a scene of one model (the blob's
    metal); one round with tracing on runs at most 2 kernels inside
    `pt.model.basic.sample` (the sample and the one-time zeroing of its
    counters) and opens no per-model span of a basic model."""
    import path_tracer_tpu_torch as tpkg
    from path_tracer_tpu_torch.integrator import wavefront
    from path_tracer_tpu_torch.models import dispatch
    from path_tracer_tpu_torch.ops.intersect import SceneLayout

    def refuse(*args):
        raise AssertionError('dispatch._select ran on the card sample path')

    monkeypatch.setattr(dispatch, '_select', refuse)
    profiling.reset()
    img = tpkg.render_scene(glass_ball_scene(*_scene_modules()), 64, 32,
                            spp_rounds=4, device=cuda)
    assert launches('basic_sample') == 4
    assert bool(torch.isfinite(img).all())
    profiling.reset()
    tpkg.render_scene(blob_scene(_scene_modules()[0])[0], 64, 32,
                      spp_rounds=2, device=cuda)
    assert launches('basic_sample') == 2

    packed = tpkg.compile_scene(glass_ball_scene(*_scene_modules()),
                                aspect_ratio=2.0, device=cuda)
    layout = SceneLayout.from_packed(packed)
    config = wavefront.RenderConfig(width=96, height=48)
    state = wavefront.reset(packed, config, seed=7)
    wavefront.render_round(packed, layout, config, state, 0.05)
    activities = [torch.profiler.ProfilerActivity.CPU,
                  torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof, \
            profiling.tracing():
        wavefront.render_round(packed, layout, config, state, 0.05)
        torch.cuda.synchronize()
        spans = {r[0] for r in profiling.records()}
    assert dispatch.BASIC_SPAN in spans
    assert not any(f'pt.model.{name}.sample' in spans for name in BASIC_NAMES)
    events = prof.events()
    ranges = [e.time_range for e in events
              if e.name == dispatch.BASIC_SPAN and e.device_type ==
              torch.autograd.DeviceType.CPU]
    launched = [e.name for e in events if 'LaunchKernel' in e.name and any(
        s.start <= e.time_range.start <= s.end for s in ranges)]
    assert len(ranges) == 1
    assert 1 <= len(launched) <= 2, launched


def test_basic_sample_wrapper_rejects_bad_input_on_the_card(cuda):
    """On the card too the wrapper checks every tensor before it launches:
    a column on the CPU, of another dtype or lane count, a mask on the
    CPU, outputs of another device."""
    from path_tracer_tpu_torch.ops import basic_sample

    ctx, view, u = basic_lanes(256, 72, cuda)
    types = (MATERIAL_TYPE_BASIC_DIFFUSE, MATERIAL_TYPE_BASIC_METAL,
             MATERIAL_TYPE_BASIC_TRANSLUCENT)
    basic_sample.basic_sample(ctx, view, *u, types)
    bad = (dict(ctx=dict(ctx, lam=ctx['lam'].cpu())),
           dict(ctx=dict(ctx, roughness=ctx['roughness'].double())),
           dict(ctx=dict(ctx, ior=ctx['ior'][:128])),
           dict(view=view.T.contiguous().T),
           dict(where=torch.ones(256, dtype=torch.bool)),
           dict(out=[torch.empty(3, 256), torch.empty(4, 256),
                     torch.empty(4, 256), torch.empty(256, dtype=torch.bool)]))
    for fields in bad:
        args = dict(ctx=ctx, view=view, where=None, out=None) | fields
        with pytest.raises(ValueError):
            basic_sample.basic_sample(args['ctx'], args['view'], *u, types,
                                      where=args['where'], out=args['out'])


def _clone(tree):
    """A copy of a nest of dicts, tuples and lists with every tensor cloned."""
    if isinstance(tree, torch.Tensor):
        return tree.clone()
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_clone(v) for v in tree)
    return tree


TAIL_ARGS = ('packed', 'layout', 'state', 'ray_origin', 'ray_direction', 'hit',
             'event', 'lam', 'view', 'ctx', 'ghost', 'integrand', 'rng',
             'termination_probability')


def capture_tail(packed, layout, config, state, term=0.05):
    """The arguments `scatter` hands `scatter_tail` in one render round of
    `state` (which the round advances), by name, every tensor cloned and
    the random state as `rng`."""
    from path_tracer_tpu_torch.integrator import scatter, wavefront

    captured = []
    tail = scatter.scatter_tail

    def capture(*args):
        named = dict(zip(TAIL_ARGS, args))
        named['rng'] = named['rng'].state
        captured.append({k: v if k in ('packed', 'layout') else _clone(v)
                         for k, v in named.items()})
        return tail(*args)

    scatter.scatter_tail = capture
    try:
        wavefront.render_round(packed, layout, config, state, term)
    finally:
        scatter.scatter_tail = tail
    (args,), = [captured]
    return args


def tail_outputs(fn, args, layout=None):
    """`fn` (scatter_tail or scatter_tail_plain) on captured arguments, with
    another layout where given: the new state, ray, alive mask and the
    random state it leaves, by name."""
    from path_tracer_tpu_torch.core.sampling import Rng

    named = dict(args, rng=Rng(args['rng'].clone()))
    if layout is not None:
        named['layout'] = layout
    path, origin, direction, alive = fn(*(named[k] for k in TAIL_ARGS))
    return dict(path, origin=origin, direction=direction, alive=alive,
                rng_state=named['rng'].state)


def assert_tail_equal(got, want, what):
    assert set(got) == set(want), what
    for key in want:
        assert same_bits(got[key], want[key]), (
            what, key, int((got[key] != want[key]).sum()))


def tail_bin_counts(args):
    """The TAIL_BINS counts of captured arguments."""
    from path_tracer_tpu_torch.integrator import scatter

    counts = torch.bincount(scatter.tail_bins(args['event'], args['hit'],
                                              args['ghost']), minlength=4)
    return dict(zip(scatter.TAIL_BINS, counts.tolist()))


def tail_case(make, width, height, cuda, rounds=2, seed=6):
    """A scene compiled on the card and its render state after `rounds`
    rounds, with its layout and render configuration."""
    from path_tracer_tpu_torch.integrator import wavefront
    from path_tracer_tpu_torch.ops.intersect import SceneLayout
    from path_tracer_tpu_torch.scene.compile import compile_scene

    packed = compile_scene(make(), aspect_ratio=width / height, device=cuda)
    layout = SceneLayout.from_packed(packed)
    config = wavefront.RenderConfig(width=width, height=height)
    state = wavefront.reset(packed, config, seed=seed)
    for _ in range(rounds):
        wavefront.render_round(packed, layout, config, state, 0.05)
    return packed, layout, config, state


def _generic(make):
    def generic():
        scene = make()
        scene.compile_generic = True
        return scene
    return generic


# The scenes whose rounds the tail kernel is held to: each benchmark cell's
# (the Cornell box: medium, OpenPBR emission, bookkeeping, no sky texture;
# one_weekend: a sky texture and glass; next_week: volume lanes and
# emission; spd_tetra: medium-free under a uniform sky), the OpenPBR scene
# (fog, nested shapes, emitters), the glass ball (whose medium scatters),
# the textured scene (sky sampling through the quad table), the opacity
# scene (ghosts, a sky filtered nearest) and the generic layout with sky
# sampling.
TAIL_CASES = {
    'cornell': (lambda: cell_scene('cornell_box.offline_1440x1440'), 96, 96),
    'one_weekend': (one_weekend_scene, 120, 68),
    'next_week': (lambda: cell_scene('next_week_final.offline_800x800_w10'),
                  96, 96),
    'spd_tetra': (lambda: cell_scene('spd_tetra.offline_1440x1440_w4'), 96, 96),
    'openpbr': (lambda: openpbr_scene(*_scene_modules()), 64, 32),
    'glass_ball': (lambda: glass_ball_scene(*_scene_modules()), 64, 32),
    'textured': (lambda: textured_scene(*_scene_modules()), 64, 32),
    'opacity': (lambda: opacity_scene(*_scene_modules()), 64, 32),
    'generic': (_generic(lambda: textured_scene(*_scene_modules())), 64, 32),
}


@pytest.mark.parametrize('case', sorted(TAIL_CASES))
def test_scatter_tail_kernel_matches_plain_version(cuda, case):
    """csrc/scatter_tail.cu, as `scatter` launches it in a render round,
    against scatter_tail_plain on the card on the same inputs, bit for bit
    in every output of every lane and in the random state it leaves, with
    tracing off and on (the kernel's two instantiations); one launch a
    round, and while tracing its lane bins equal those of the inputs and
    sum to the lanes."""
    from path_tracer_tpu_torch.integrator import scatter

    make, width, height = TAIL_CASES[case]
    packed, layout, config, state = tail_case(make, width, height, cuda)
    seen = dict.fromkeys(scatter.TAIL_BINS, 0)
    for traced in (False, True):
        args = capture_tail(packed, layout, config, state)
        want = tail_outputs(scatter.scatter_tail_plain, args)
        profiling.reset()
        with profiling.tracing() if traced else contextlib.nullcontext():
            got = tail_outputs(scatter.scatter_tail, args)
            counted = profiling.counters()
        assert counted['kernel.scatter_tail'] == 1
        assert_tail_equal(got, want, (case, traced))
        bins = tail_bin_counts(args)
        assert sum(bins.values()) == width * height
        if traced:
            assert counted[scatter.TAIL_LANES] == bins
        else:
            assert scatter.TAIL_LANES not in counted
        for k, v in bins.items():
            seen[k] += v
    assert seen['surface'] > 0
    assert (seen['volume'] > 0) == (
        case in ('openpbr', 'next_week', 'glass_ball')), seen
    assert (seen['ghost'] > 0) == (case == 'opacity'), seen
    if case in ('one_weekend', 'spd_tetra', 'textured', 'opacity'):
        assert seen['sky'] > 0, seen


# The sky's tables and filters: (atlas_quad_fit, texture_filter_modes).
SKY_LOOKUPS = list(itertools.product(
    ('quad', 'pair', False), ((True, False), (False, True), (True, True))))


@pytest.mark.parametrize('nearest', [False, True])
def test_scatter_tail_kernel_matches_plain_version_in_every_sky_lookup(
        cuda, nearest):
    """The kernel against scatter_tail_plain on the opacity scene's round
    (ghosts, a sky texture that hits most lanes), its layout given each
    atlas table and each set of filter modes, with the sky texture's own
    flag nearest or bilinear; and without the texture (the default
    spectrum), without opacity on the lanes that are no ghosts' and with
    transmissive bookkeeping forced on."""
    from path_tracer_tpu_torch.integrator import scatter

    packed, layout, config, state = tail_case(
        lambda: opacity_scene(*_scene_modules(), nearest=nearest), 64, 32,
        cuda)
    args = capture_tail(packed, layout, config, state)
    assert tail_bin_counts(args)['sky'] > 0
    variants = [dataclasses.replace(layout, atlas_quad_fit=mode,
                                    texture_filter_modes=filters)
                for mode, filters in SKY_LOOKUPS]
    variants += [dataclasses.replace(layout, has_skybox_texture=False),
                 dataclasses.replace(layout, has_transmissive=True)]
    for variant in variants:
        got = tail_outputs(scatter.scatter_tail, args, variant)
        want = tail_outputs(scatter.scatter_tail_plain, args, variant)
        assert_tail_equal(got, want, (variant.atlas_quad_fit,
                                      variant.texture_filter_modes,
                                      variant.has_skybox_texture))


def test_scatter_tail_on_the_main_path(cuda, monkeypatch):
    """A 4-round render on the card launches the kernel once a round and
    equals, bit for bit, the same render with the tail in plain PyTorch;
    while tracing, the kernel's lane bins over the rounds sum to the
    lanes times the rounds."""
    from path_tracer_tpu_torch.integrator import scatter, wavefront

    packed, layout, config, _ = tail_case(
        lambda: openpbr_scene(*_scene_modules()), 64, 32, cuda, rounds=0)

    def render(traced=False):
        state = wavefront.reset(packed, config, seed=9)
        profiling.reset()
        with profiling.tracing() if traced else contextlib.nullcontext():
            for _ in range(4):
                wavefront.render_round(packed, layout, config, state, 0.05)
            counted = profiling.counters()
        return state, counted

    kernel, counted = render(traced=True)
    assert counted['kernel.scatter_tail'] == 4
    assert sum(counted[scatter.TAIL_LANES].values()) == 4 * 64 * 32
    monkeypatch.setattr(scatter, 'scatter_tail', scatter.scatter_tail_plain)
    plain, counted = render()
    assert 'kernel.scatter_tail' not in counted
    for key in ('origin', 'direction', 'rng_state'):
        assert same_bits(kernel[key], plain[key]), key
    for part in ('path', 'accum'):
        for key in plain[part]:
            assert same_bits(kernel[part][key], plain[part][key]), (part, key)


def test_scatter_tail_wrapper_rejects_bad_input(cuda):
    """The wrapper checks device, dtype, shape and layout of every tensor
    it hands the kernel before it launches."""
    from path_tracer_tpu_torch.integrator import scatter
    from path_tracer_tpu_torch.ops import scatter_tail

    packed, layout, config, state = tail_case(
        lambda: glass_ball_scene(*_scene_modules()), 32, 16, cuda, rounds=1)
    args = capture_tail(packed, layout, config, state)
    lanes = {}

    def capture(packed, layout, given, term, stats=None):
        lanes.update(given)
        return launch(packed, layout, given, term, stats=stats)

    launch = scatter_tail.scatter_tail
    scatter_tail.scatter_tail = capture
    try:
        tail_outputs(scatter.scatter_tail, args)
    finally:
        scatter_tail.scatter_tail = launch
    launch(packed, layout, lanes, 0.05)
    bad = (dict(time=lanes['time'].double()),
           dict(shape=lanes['shape'].float()),
           dict(origin=lanes['origin'].cpu()),
           dict(normal=lanes['normal'][:2]),
           dict(probability=lanes['probability'][:, :128]),
           dict(direction=lanes['direction'].T.contiguous().T),
           dict(s_valid=lanes['s_valid'].to(torch.int32)),
           dict(vol_dir=lanes['vol_dir'][:, :-1]),
           dict(rng_state=lanes['rng_state'].to(torch.int32)))
    for fields in bad:
        with pytest.raises(ValueError):
            launch(packed, layout, dict(lanes, **fields), 0.05)
    with pytest.raises(ValueError):
        launch(packed, layout, lanes, 0.05,
               stats=torch.zeros(3, dtype=torch.int64, device=cuda))
