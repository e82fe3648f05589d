"""Scenes shared by the port's tests, and the port's tests that need a card.

`blob_scene` and `textured_scene` take the scene-model module (and the
procedural module) of either package, so the JAX package and the port
build the same scene from the same numbers.

The tests here launch the hand-written CUDA kernels and compare them
with their plain PyTorch versions on the card. They carry the `cuda`
marker and skip on a machine without one; on the GPU machine run them
with `python -m pytest tests/test_torch_cuda.py -m cuda`.
"""

import numpy as np
import pytest
import torch

from path_tracer_tpu_torch.core.constants import (
    MATERIAL_TYPE_BASIC_DIFFUSE, TEXTURE_TYPE_RADIANCE,
    TEXTURE_TYPE_REFLECTANCE_WITH_ALPHA)


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


@pytest.mark.parametrize('leaf_fmt', ['mt', 'bary'])
def test_kernel_matches_plain_version(cuda, leaf_fmt, monkeypatch):
    """csrc/trace_inst.cu against inst_trace_plain, both on the card, on
    the instanced blob scene. Both traverse each ray in the same order
    with the same float32 operations (the kernel is built without FMA
    contraction), so every output and every per-ray counter is equal to
    the bit."""
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
    before = trace_inst.launches
    kernel = trace_inst.inst_trace(*tables, o, d, t_in, tlas, stats=True)
    torch.cuda.synchronize()
    assert trace_inst.launches == before + 1
    plain = trace_inst.inst_trace_plain(*tables, o, d, t_in, tlas,
                                        leaf_fmt=leaf_fmt, stats=True)
    assert int((plain[1] >= 0).sum()) > 30
    for name, k, p in zip(('t', 'face', 'fu', 'fv', 'inst', 'counts'),
                          kernel, plain):
        assert torch.equal(k, p), name
    assert bool((kernel[4][kernel[1] < 0] == -1).all())


def test_kernel_wrapper_rejects_bad_input(cuda):
    """The wrapper checks device, dtype and shape before it launches."""
    from path_tracer_tpu_torch.ops import trace_inst

    nodes = torch.zeros((8, 128), device=cuda)
    tris = torch.zeros((2, 128), device=cuda)
    rows = torch.zeros((1, 128), device=cuda)
    o = torch.zeros((3, 64), device=cuda)
    t_in = torch.ones(64, device=cuda)
    with pytest.raises(ValueError):
        trace_inst.inst_trace(nodes, tris, rows, o, o.double(), t_in, 8)
    with pytest.raises(ValueError):
        trace_inst.inst_trace(nodes.cpu(), tris, rows, o, o, t_in, 8)
    with pytest.raises(ValueError):
        trace_inst.inst_trace(nodes, tris, rows, o, o[:2], t_in, 8)


def test_render_scene_on_card_matches_cpu(cuda):
    """render_scene at 64x32, 4 rounds, seed 3 on the card against the
    same call on the CPU (the plain traversal): the random streams are
    the same, so the frames differ only where a last-bit difference of a
    transcendental sends a path elsewhere. Held to bench.py's Monte-Carlo
    bands at their floor, 2% of the mean."""
    import path_tracer_tpu_torch as tpkg
    import path_tracer_tpu_torch.scene.model as model
    import path_tracer_tpu_torch.scene.procedural as proc

    ref = tpkg.render_scene(textured_scene(model, proc), 64, 32,
                            spp_rounds=4, seed=3, device='cpu').numpy()
    img = tpkg.render_scene(textured_scene(model, proc), 64, 32,
                            spp_rounds=4, seed=3, device=cuda).cpu().numpy()
    assert img.shape == ref.shape == (32, 64, 3)
    assert np.isfinite(img).all()
    rel = np.abs(img - ref).mean() / (ref.mean() + 1e-3)
    bias = abs(img.mean() - ref.mean()) / (ref.mean() + 1e-3)
    assert rel < 0.02 and bias < 0.02, (rel, bias)
