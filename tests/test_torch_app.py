"""The port's editor loop (app.Session), incremental compile, preview and
picking, and the traversal-cost counter `complexity`, against the JAX
package on the CPU.

Mirrors tests/test_app.py's `test_session_progressive_and_restart`,
`test_incremental_recompile_matches_full` and
`test_empty_mesh_instance_packs_no_shape`, and tests/test_io.py's
`test_preview_modes_and_picking` and
`test_default_scene_and_complexity_heatmap`.
"""

import dataclasses

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import path_tracer_tpu.scene.compile as jcompile
import path_tracer_tpu.scene.model as jmodel
import path_tracer_tpu.scene.procedural as jproc
import path_tracer_tpu.viewer.preview as jpreview
import path_tracer_tpu_torch.scene.compile as tcompile
import path_tracer_tpu_torch.scene.model as tmodel
import path_tracer_tpu_torch.scene.procedural as tproc
import path_tracer_tpu_torch.viewer.preview as tpreview
from path_tracer_tpu.ops import intersect as jintersect
from path_tracer_tpu_torch.app import Session
from path_tracer_tpu_torch.core.constants import SHAPE_INDEX_NONE
from path_tracer_tpu_torch.ops import intersect as tintersect
from path_tracer_tpu_torch.ops import trace_inst

from test_torch_compile import assert_fields_equal, jax_fields, port_fields
from test_torch_cuda import textured_scene, two_instance_scene


def camera_world(m, scene):
    cam = [e for e in scene.walk_entities()
           if e.type == m.ENTITY_TYPE_CAMERA][0]
    return m.make_transform_matrix(cam.transform.position,
                                   cam.transform.rotation)


def test_session_progressive_and_restart():
    session = Session(tproc.make_cornell_scene(), width=32, height=16,
                      device='cpu')
    img1 = session.frame()
    assert tuple(img1.shape) == (16, 32, 3)
    spp1 = session.samples_per_pixel()
    session.frame()
    session.frame()
    spp2 = session.samples_per_pixel()
    assert spp2 > spp1

    # Camera move -> dirty -> accumulation restarts.
    session.move_camera(delta=(0.0, 0.0, -0.5))
    session.frame()
    spp3 = session.samples_per_pixel()
    assert spp3 < spp2

    pimg = session.preview()
    assert tuple(pimg.shape) == (16, 32, 3) and bool(torch.isfinite(pimg).all())
    assert session.pick(16, 8) >= -1
    assert session.packed.camera_model.device.type == 'cpu'
    # Specialized programs by default: the Cornell box's own shape types
    # and material models only. generic_programs=True lays out every
    # analytic type and material model, as the JAX package's editor does.
    assert not session.scene.compile_generic
    assert session.layout.material_types != (0, 1, 2, 3)
    generic = Session(tproc.make_cornell_scene(), width=32, height=16,
                      generic_programs=True, device='cpu')
    assert [t for t, _ in generic.layout.analytic_buckets] == [1, 2, 3]
    assert generic.layout.material_types == (0, 1, 2, 3)


def test_session_default_frames_match_generic():
    """The default (specialized) Session against Session(generic_programs=
    True) over a restart frame and two steady frames. Not the same bits:
    the generic type set runs the OpenPBR layer walk, whose 24 draws a
    lane are taken whenever OpenPBR is in the set (as in the JAX
    package), so the two RNG streams part after the first round. The
    frames are two samples of one estimator: their first rounds are the
    same sample, and after 49 and 97 rounds their means agree within 2%
    (0.6% here)."""
    sessions = [Session(tproc.make_cornell_scene(), width=64, height=32,
                        generic_programs=generic, device='cpu')
                for generic in (False, True)]
    assert sessions[0].layout.material_types != (0, 1, 2, 3)
    assert sessions[1].layout.material_types == (0, 1, 2, 3)
    first = [s.frame(rounds=1) for s in sessions]
    assert torch.equal(*first)
    frames = [[s.frame(rounds=48) for _ in range(2)] for s in sessions]
    for a, b in zip(*frames):
        assert bool(torch.isfinite(a).all()) and float(a.mean()) > 0.01
        assert abs(float(a.mean() - b.mean())) < 0.02 * float(b.mean())



EDITS = {
    'material': lambda m, s: (
        setattr(s.materials[0], 'base_color',
                np.asarray([0.2, 0.2, 0.9], np.float32)),
        s.mark_dirty(m.SCENE_DIRTY_MATERIALS)),
    'camera': lambda m, s: (
        setattr(_camera(m, s).transform, 'position',
                np.asarray([0.1, -1.0, 0.6], np.float32)),
        s.mark_dirty(m.SCENE_DIRTY_CAMERAS)),
    'shape': lambda m, s: (
        setattr(s.root.children[0].transform, 'position',
                np.asarray([0.3, 0.2, 0.1], np.float32)),
        s.mark_dirty(m.SCENE_DIRTY_SHAPES)),
    'sky': lambda m, s: (
        setattr(s.root, 'skybox_brightness', 3.0),
        s.mark_dirty(m.SCENE_DIRTY_GLOBALS)),
}


def _camera(m, scene):
    return [e for e in scene.walk_entities()
            if e.type == m.ENTITY_TYPE_CAMERA][0]


@pytest.mark.parametrize('edit', sorted(EDITS))
def test_incremental_recompile_matches_full(edit):
    """An edit recompiled from the previous PackedScene equals a full
    compile of the edited scene in every field (and in the layout), and
    the stages the edit leaves clean keep the previous tensors; the JAX
    package's incremental compile gives the same fields."""
    scene = textured_scene(tmodel, tproc)
    scene.compile_generic = True
    packed1 = tcompile.compile_scene(scene, device='cpu')
    EDITS[edit](tmodel, scene)
    packed2 = tcompile.compile_scene(scene, packed1, device='cpu')

    scene2 = textured_scene(tmodel, tproc)
    scene2.compile_generic = True
    EDITS[edit](tmodel, scene2)
    packed3 = tcompile.compile_scene(scene2, device='cpu')
    assert_fields_equal(port_fields(packed2), port_fields(packed3))
    assert packed2.host_layout == packed3.host_layout
    assert packed2.face_positions is packed1.face_positions
    assert packed2.atlas is packed1.atlas
    reused = {'material': ('camera_model',),
              'camera': ('materials', 'inst_nodes', 'shape_type'),
              'shape': ('materials', 'camera_model'),
              'sky': ('materials', 'inst_nodes', 'camera_model')}[edit]
    for name in reused:
        assert getattr(packed2, name) is getattr(packed1, name), name

    jscene = textured_scene(jmodel, jproc)
    jscene.compile_generic = True
    jp1 = jcompile.compile_scene(jscene)
    EDITS[edit](jmodel, jscene)
    jp2 = jcompile.compile_scene(jscene, jp1)
    assert_fields_equal(port_fields(packed2), jax_fields(jp2))


def test_incremental_recompile_keeps_its_device():
    """A previous compile on another device is not reused."""
    scene = tproc.make_cornell_scene()
    packed = tcompile.compile_scene(scene, device='cpu')
    scene.mark_dirty(tmodel.SCENE_DIRTY_MATERIALS)
    with pytest.raises(ValueError, match='prev lives on cpu'):
        tcompile.compile_scene(scene, packed, device='meta')


def test_empty_mesh_instance_packs_no_shape():
    """A mesh instance whose mesh has no faces compiles to a scene without
    that shape slot, and rays still hit the remaining geometry."""
    scene = tmodel.Scene()
    scene.create_entity(tmodel.ENTITY_TYPE_CAMERA)
    empty = scene.create_mesh(name='empty', faces=np.zeros(0, np.int32))
    assert empty.faces.shape == (0, 3)
    scene.create_entity(tmodel.ENTITY_TYPE_MESH_INSTANCE, mesh=empty,
                        material=scene.create_material(1))
    scene.create_entity(tmodel.ENTITY_TYPE_SPHERE,
                        material=scene.create_material(1))
    packed = tcompile.compile_scene(scene, device='cpu')
    layout = tintersect.SceneLayout.from_packed(packed)
    assert layout.instance_slots == 0
    assert len(list(tpreview.shape_entities(scene))) == 1

    n = 128
    o = torch.zeros((3, n))
    o[1] = -4.0
    d = torch.zeros((3, n))
    d[1] = 1.0
    for use_packet in (False, True):
        h = tintersect.trace(packed, layout, o, d, use_packet=use_packet)
        assert bool((h['shape'] != SHAPE_INDEX_NONE).all())


def _close_share(a, b, tol=1e-5):
    return float((np.abs(a - b) <= tol).all(axis=-1).mean())


def test_preview_modes_and_picking():
    """All seven modes at 64x32 on the Cornell box, the selection tint and
    a pick; the five modes of tests/test_io.py's test, the tint and the
    pick against the JAX package's preview on the CPU (the heatmaps are
    compared in the next test). Both trace the analytic box alike except
    where two walls meet: there a last-bit difference of XLA's fused
    arithmetic may pick the other wall, on under 1% of the pixels;
    everywhere else the frames agree to 1e-5."""
    jscene, tscene = jproc.make_cornell_scene(), tproc.make_cornell_scene()
    jp = jcompile.compile_scene(jscene)
    tp = tcompile.compile_scene(tscene, device='cpu')
    jl = jintersect.SceneLayout.from_packed(jp)
    tl = tintersect.SceneLayout.from_packed(tp)
    world = camera_world(tmodel, tscene)
    jworld = jnp.asarray(camera_world(jmodel, jscene))

    for mode in range(7):
        img = tpreview.render_preview(tp, tl, 64, 32, world, mode=mode,
                                      device='cpu').numpy()
        assert img.shape == (32, 64, 3)
        assert np.isfinite(img).all()
        assert img.max() > 0.01, mode
        if mode >= tpreview.PREVIEW_RENDER_MODE_MESH_COMPLEXITY:
            # Off the card the heat is hit['complexity'] alone: here the
            # analytic groups' slots.
            slots = sum(k for _, k in tl.analytic_buckets)
            np.testing.assert_array_equal(
                img[..., 1], np.full((32, 64), slots / 256, np.float32))
            continue
        ref = np.asarray(jpreview.render_preview(jp, jl, 64, 32, jworld,
                                                 mode=mode))
        assert _close_share(img, ref) > 0.99, mode

    shape = tpreview.pick(tp, tl, 64, 32, world, 32, 16, device='cpu')
    assert shape >= 0
    assert shape == jpreview.pick(jp, jl, 64, 32, jworld, 32, 16)
    img = tpreview.render_preview(tp, tl, 64, 32, world, selected_shape=shape,
                                  device='cpu').numpy()
    ref = np.asarray(jpreview.render_preview(jp, jl, 64, 32, jworld,
                                             selected_shape=shape))
    assert np.isfinite(img).all() and _close_share(img, ref) > 0.99
    with pytest.raises(ValueError):
        tpreview.render_preview(tp, tl, 8, 4, world, mode=7, device='cpu')
    with pytest.raises(ValueError, match='lives on cpu'):
        tpreview.render_preview(tp, tl, 8, 4, world)


def test_default_scene_and_complexity_heatmap():
    """The reference's startup scene renders with a checkered floor; the
    mesh heatmap of the viking hall equals the JAX package's on the CPU
    exactly (both count the portable traversal's iterations there), and
    off the card the scene heatmap is the same frame."""
    img = tproc_render(tproc.make_default_scene())
    assert np.isfinite(img).all()
    assert img[12:, :, :].mean(axis=-1).std() > 0.01

    # The hall's geometry without its textures and sky, which the
    # heatmaps do not read and whose compile takes most of the time.
    jscene, tscene = (jproc.make_viking_hall_scene(with_sky=False, textured=False),
                      tproc.make_viking_hall_scene(with_sky=False, textured=False))
    jp = jcompile.compile_scene(jscene)
    tp = tcompile.compile_scene(tscene, device='cpu')
    jl = jintersect.SceneLayout.from_packed(jp)
    tl = tintersect.SceneLayout.from_packed(tp)
    heat = {mode: tpreview.render_preview(
        tp, tl, 32, 16, camera_world(tmodel, tscene), mode=mode,
        device='cpu').numpy()
        for mode in (tpreview.PREVIEW_RENDER_MODE_MESH_COMPLEXITY,
                     tpreview.PREVIEW_RENDER_MODE_SCENE_COMPLEXITY)}
    mesh = heat[tpreview.PREVIEW_RENDER_MODE_MESH_COMPLEXITY]
    assert mesh[..., 1].max() > 0.02
    assert mesh[..., 0].max() == 0.0
    ref = np.asarray(jpreview.render_preview(
        jp, jl, 32, 16, jnp.asarray(camera_world(jmodel, jscene)),
        mode=jpreview.PREVIEW_RENDER_MODE_MESH_COMPLEXITY))
    np.testing.assert_array_equal(mesh, ref)
    np.testing.assert_array_equal(
        heat[tpreview.PREVIEW_RENDER_MODE_SCENE_COMPLEXITY], mesh)


def tproc_render(scene):
    from path_tracer_tpu_torch import render_scene
    return render_scene(scene, width=32, height=16, spp_rounds=20, seed=1,
                        device='cpu').numpy()


@pytest.fixture(scope='module')
def mixed_scene():
    """two_instance_scene (two mesh instances, a plane, a sphere) in both
    packages, and 2,048 rays from a seed."""
    rng = np.random.default_rng(5)
    o = rng.uniform(-5, 5, (3, 2048)).astype(np.float32)
    d = rng.normal(0, 1, (3, 2048)).astype(np.float32)
    d /= np.linalg.norm(d, axis=0, keepdims=True)
    jp = jcompile.compile_scene(two_instance_scene(jmodel, jproc))
    tp = tcompile.compile_scene(two_instance_scene(tmodel, tproc), device='cpu')
    return jp, tp, o, d


@pytest.mark.parametrize('use_packet', [False, True])
def test_trace_complexity_matches_jax(mixed_scene, use_packet):
    """hit['complexity'] equals the JAX trace's exactly (int32): the
    analytic groups' slots on every ray, plus, through the portable
    traversal, the nodes each ray visited; the packet path carries the
    analytic count unchanged (the JAX Pallas kernel in interpret mode)."""
    jp, tp, o, d = mixed_scene
    ref = jintersect.trace(jp, jintersect.SceneLayout.from_packed(jp),
                           jnp.asarray(o), jnp.asarray(d),
                           use_packet=use_packet, interpret=True)
    hit = tintersect.trace(tp, tintersect.SceneLayout.from_packed(tp),
                           torch.from_numpy(o), torch.from_numpy(d),
                           use_packet=use_packet)
    assert hit['complexity'].dtype == torch.int32
    np.testing.assert_array_equal(hit['complexity'].numpy(),
                                  np.asarray(ref['complexity']))
    analytic = sum(k for _, k in tp.host_layout.analytic_buckets)
    if use_packet:
        assert bool((hit['complexity'] == analytic).all())
    else:
        assert int(hit['complexity'].max()) > analytic


def test_card_heatmap_arithmetic(mixed_scene):
    """The heat the card adds, computed on the CPU from the plain
    version's stats=True counters: mesh complexity adds the interior and
    leaf pops (rows 0 and 1), scene complexity the instance entries (row
    3) too. On the CPU render_preview adds no counters, as the JAX
    package adds none off the TPU."""
    _, tp, o, d = mixed_scene
    layout = tintersect.SceneLayout.from_packed(tp)
    o, d = torch.from_numpy(o), torch.from_numpy(d)
    hit = tintersect.trace(tp, layout, o, d)
    *_, stats = trace_inst.inst_trace(
        tp.inst_nodes, tp.inst_tris, tp.inst_rows, o, d,
        torch.full((o.shape[1],), 1e30), layout.tlas_rows, stats=True)
    assert tuple(stats.shape) == (5, o.shape[1])
    mesh = tpreview.complexity_heat(
        hit['complexity'], tpreview.PREVIEW_RENDER_MODE_MESH_COMPLEXITY, stats)
    whole = tpreview.complexity_heat(
        hit['complexity'], tpreview.PREVIEW_RENDER_MODE_SCENE_COMPLEXITY, stats)
    np.testing.assert_array_equal(
        mesh.numpy(), (hit['complexity'] + stats[0] + stats[1]).float().numpy())
    np.testing.assert_array_equal(
        (whole - mesh).numpy(), stats[3].float().numpy())
    assert float(stats[3].sum()) > 0 and float((mesh - hit['complexity']).max()) > 0
    assert not tpreview.kernel_counters_apply(layout, o)
    np.testing.assert_array_equal(
        tpreview.complexity_heat(hit['complexity'],
                                 tpreview.PREVIEW_RENDER_MODE_SCENE_COMPLEXITY).numpy(),
        hit['complexity'].float().numpy())


def test_generic_compile_matches_jax():
    """With scene.compile_generic (Session's default), the port packs and
    lays out the scene as the JAX package does."""
    jscene, tscene = (textured_scene(jmodel, jproc),
                      textured_scene(tmodel, tproc))
    jscene.compile_generic = tscene.compile_generic = True
    jp = jcompile.compile_scene(jscene)
    tp = tcompile.compile_scene(tscene, device='cpu')
    assert_fields_equal(port_fields(tp), jax_fields(jp))
    jl = jintersect.SceneLayout.from_packed(jp)
    for f in dataclasses.fields(tp.host_layout):
        assert getattr(tp.host_layout, f.name) == getattr(jl, f.name), f.name


def test_ray_throughput_timer_and_trace(tmp_path):
    """utils/profiling.device_trace: a torch.profiler trace written where
    asked, with the program's tracing on inside it, so that the Chrome
    trace holds each program span as an event around the operators
    launched in it, and the span records and counts stay readable after
    it."""
    import json
    import os
    from path_tracer_tpu_torch.utils import profiling

    with profiling.device_trace(str(tmp_path / 'trace')) as log_dir:
        assert profiling.enabled()
        with profiling.span('pt.round'):
            with profiling.span('pt.scatter'):
                torch.ones(8).sum()
            profiling.count('pt.respawn.lanes', torch.ones(8, dtype=torch.bool))
    assert not profiling.enabled()
    with open(os.path.join(log_dir, 'trace.json')) as f:
        events = json.load(f)['traceEvents']
    spans = {e['name']: e for e in events if e.get('name', '').startswith('pt.')}
    assert {'pt.round', 'pt.scatter'} <= set(spans)
    outer, inner = spans['pt.round'], spans['pt.scatter']
    assert outer['ts'] <= inner['ts'] <= inner['ts'] + inner['dur'] <= (
        outer['ts'] + outer['dur'])
    assert any(e.get('name') == 'aten::sum'
               and inner['ts'] <= e['ts'] <= inner['ts'] + inner['dur']
               for e in events)
    assert [r[0] for r in profiling.records()] == ['pt.round', 'pt.scatter']
    assert profiling.counters() == {'pt.respawn.lanes': 8}
    profiling.reset()
