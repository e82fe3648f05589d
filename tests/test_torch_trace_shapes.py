"""The analytic shapes' BVH (scene/compile.py::pack_shape_tables) and its
walk in plain PyTorch (ops/intersect.py::traverse_shape_bvh), which is
csrc/shape_trace.cu's twin, against the dense `intersect_analytic`, the
card kernel's oracle: bit for bit in time, shape, shape type, primitive
and coords, ties included. The kernel itself is held to the same on the
card in tests/test_torch_cuda.py."""

import types

import numpy as np
import pytest
import torch

import path_tracer_tpu_torch.scene.compile as tcompile
import path_tracer_tpu_torch.scene.model as tmodel
from path_tracer_tpu_torch.core import constants
from path_tracer_tpu_torch.core.constants import (
    HIT_TIME_LIMIT, SHAPE_INDEX_NONE, SHAPE_TYPE_CUBE, SHAPE_TYPE_PLANE,
    SHAPE_TYPE_SPHERE)
from path_tracer_tpu_torch.ops import intersect
from path_tracer_tpu_torch.ops.trace_inst import INST_BASE
from path_tracer_tpu_torch.scene import bvh8
from path_tracer_tpu_torch.utils import profiling

FIELDS = ('time', 'shape', 'shape_type', 'primitive', 'coords')
ENTITY = {SHAPE_TYPE_PLANE: tmodel.ENTITY_TYPE_PLANE,
          SHAPE_TYPE_SPHERE: tmodel.ENTITY_TYPE_SPHERE,
          SHAPE_TYPE_CUBE: tmodel.ENTITY_TYPE_CUBE}


def shapes_scene(seed, n=40, planes=2, ties=3, generic=False):
    """Spheres and cubes under random rotations and non-uniform scales,
    overlapping, planes tilted, and `ties` shapes repeated with the same
    transform (every ray that hits one ties exactly on the pair)."""
    rng = np.random.default_rng(seed)
    scene = tmodel.Scene()
    material = scene.create_material(tmodel.MATERIAL_TYPE_BASIC_DIFFUSE)
    scene.create_entity(tmodel.ENTITY_TYPE_CAMERA)
    made = []
    for k in range(n):
        stype = (SHAPE_TYPE_SPHERE, SHAPE_TYPE_CUBE)[int(rng.integers(2))]
        transform = tmodel.Transform(
            position=rng.uniform(-3, 3, 3), rotation=rng.uniform(-3, 3, 3),
            scale=rng.uniform(0.2, 1.5, 3), scale_is_uniform=False)
        made.append((stype, transform))
    for k in range(planes):
        made.append((SHAPE_TYPE_PLANE, tmodel.Transform(
            position=rng.uniform(-4, 4, 3), rotation=rng.uniform(-1, 1, 3))))
    made.append(made[n])           # a plane repeated
    for k in range(ties):
        made.append(made[k * 3])
    order = rng.permutation(len(made))
    for i in order:
        stype, transform = made[i]
        scene.create_entity(ENTITY[stype], material=material,
                            transform=tmodel.Transform(
                                position=transform.position.copy(),
                                rotation=transform.rotation.copy(),
                                scale=transform.scale.copy(),
                                scale_is_uniform=False))
    scene.compile_generic = generic
    return scene


def rays(seed, n, prev=None, hit=None):
    """Random rays from a box around the shapes; given the previous rays
    (o, d) and their dense hit record, rays from the hit points instead
    (as bounce rays start), in random directions."""
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(3, n)).astype(np.float32)
    d = torch.from_numpy(d / np.linalg.norm(d, axis=0))
    if hit is None:
        o = torch.from_numpy(rng.uniform(-7, 7, (3, n)).astype(np.float32))
    else:
        o_prev, d_prev = prev
        t = torch.where(hit['shape'] != SHAPE_INDEX_NONE, hit['time'],
                        torch.zeros_like(hit['time']))
        o = o_prev + d_prev * t
    return o, d


def compiled(scene):
    packed = tcompile.compile_scene(scene, device='cpu')
    return packed, intersect.SceneLayout.from_packed(packed)


def assert_agree(packed, layout, o, d):
    hit = intersect.make_hit(o.shape[1], HIT_TIME_LIMIT, 'cpu')
    dense = intersect.intersect_analytic(packed, layout, o, d, hit)
    walk, counts = intersect.traverse_shape_bvh(packed, o, d, hit, stats=True)
    for key in FIELDS:
        assert torch.equal(dense[key], walk[key]), (
            key, int((dense[key] != walk[key]).sum()))
    assert torch.equal(walk['complexity'], counts.sum(0).to(torch.int32))
    return dense, counts


@pytest.mark.parametrize('seed', [1, 2])
def test_every_shape_sits_in_one_leaf_whose_box_holds_it(seed):
    packed, _ = compiled(shapes_scene(seed))
    rows, nodes = packed.shape_rows.numpy(), packed.shape_nodes.numpy()
    metas = np.rint(nodes[:, bvh8.META_LANE:bvh8.META_LANE + 8]).astype(np.int64)
    leaves = metas[metas >= INST_BASE] - INST_BASE
    assert sorted(leaves.tolist()) == list(range(len(rows)))
    # Every valid sphere and cube slot has one row, planes theirs.
    valid = {int(t): packed.analytic_valid[t].numpy() > 0 for t in packed.analytic_idx}
    assert len(rows) == valid[SHAPE_TYPE_SPHERE].sum() + valid[SHAPE_TYPE_CUBE].sum()
    assert len(packed.plane_rows) == valid[SHAPE_TYPE_PLANE].sum()
    rng = np.random.default_rng(seed)
    for w, c in zip(*np.nonzero(metas >= INST_BASE)):
        row = rows[metas[w, c] - INST_BASE]
        lo = nodes[w, [c, 8 + c, 16 + c]]
        hi = nodes[w, [24 + c, 32 + c, 40 + c]]
        # Points of the surface: the unit sphere, or the unit cube's faces.
        p = rng.normal(size=(256, 3))
        if row[tcompile.SHAPE_LANE_TYPE] == SHAPE_TYPE_SPHERE:
            p /= np.linalg.norm(p, axis=1, keepdims=True)
        else:
            p = np.clip(p, -1, 1)
            axis = np.argmax(np.abs(p), axis=1)
            p[np.arange(256), axis] = np.sign(p[np.arange(256), axis])
            p = np.concatenate([p, np.asarray([[x, y, z] for x in (-1, 1)
                                               for y in (-1, 1) for z in (-1, 1)])])
        m = np.eye(4)
        m[:3] = row[:12].reshape(3, 4)
        world = (np.c_[p, np.ones(len(p))] @ np.linalg.inv(m).T)[:, :3]
        assert (world >= lo).all() and (world <= hi).all()


@pytest.mark.parametrize('generic', [False, True], ids=['exact', 'generic'])
@pytest.mark.parametrize('seed', [3, 4])
def test_walk_equals_the_dense_path(seed, generic):
    packed, layout = compiled(shapes_scene(seed, generic=generic))
    if generic:
        assert any((v == 0).any() for v in packed.analytic_valid.values())
    o, d = rays(seed, 3000)
    dense, counts = assert_agree(packed, layout, o, d)
    hits = dense['shape'] != SHAPE_INDEX_NONE
    assert 0.3 < float(hits.float().mean()) < 0.95
    # Each type wins somewhere, and the walk tests fewer shapes than the
    # dense path's every slot.
    for t in (SHAPE_TYPE_PLANE, SHAPE_TYPE_SPHERE, SHAPE_TYPE_CUBE):
        assert bool((hits & (dense['shape_type'] == t)).any()), t
    assert float(counts[1].float().mean()) < 0.5 * sum(
        k for _, k in layout.analytic_buckets)
    # Bounce rays: from the hit points, in new directions.
    o2, d2 = rays(seed + 100, 3000, prev=(o, d), hit=dense)
    assert_agree(packed, layout, o2, d2)


def test_exact_ties_go_to_the_first_group_and_the_lowest_slot():
    """Repeated shapes tie on every ray that hits them; the dense path's
    rule picks the lower slot, and the walk does the same."""
    packed, layout = compiled(shapes_scene(5, n=12, planes=1, ties=4))
    o, d = rays(5, 4000)
    dense, _ = assert_agree(packed, layout, o, d)
    by_slot = {}
    for t in packed.analytic_idx:
        idx = packed.analytic_idx[t].tolist()
        rows = packed.shape_object_from_world[:, :, idx].reshape(16, -1).T
        for slot, key in enumerate(map(lambda r: tuple(r.tolist()), rows)):
            by_slot.setdefault((t, key), []).append(idx[slot])
    tied = {max(v) for v in by_slot.values() if len(v) > 1}
    winners = set(dense['shape'][dense['shape'] != SHAPE_INDEX_NONE].tolist())
    assert len(tied) == 5 and not (tied & winners)
    assert {min(v) for v in by_slot.values() if len(v) > 1} & winners


def test_the_one_weekend_scene_agrees():
    """The benchmark's configuration: 484 spheres, camera-like rays and
    their bounce rays."""
    from benchmark.harness.cell import load_cell
    cell = load_cell('one_weekend_final.offline_1200x675_w8')
    api = types.SimpleNamespace(**{k: v for m in (constants, tmodel)
                                   for k, v in vars(m).items()
                                   if not k.startswith('_')})
    scene = cell.maker.make_scene(api, cell.config)
    packed, layout = compiled(scene)
    assert layout.analytic_buckets == ((SHAPE_TYPE_SPHERE, 484),)
    n = 2048
    rng = np.random.default_rng(9)
    o = torch.tensor([13.0, 2.0, 3.0])[:, None] + torch.from_numpy(
        rng.normal(0, 0.05, (3, n)).astype(np.float32))
    d = torch.from_numpy(rng.normal(0, 0.12, (3, n)).astype(np.float32)) \
        - o / o.norm(dim=0)
    d = d / d.norm(dim=0)
    dense, counts = assert_agree(packed, layout, o, d)
    assert float((dense['shape'] != SHAPE_INDEX_NONE).float().mean()) > 0.5
    o2, d2 = rays(10, n, prev=(o, d), hit=dense)
    assert_agree(packed, layout, o2, d2)
    assert float(counts.sum(0).float().mean()) < 100


def test_moving_a_sphere_rebuilds_the_tree():
    """An incremental compile after one sphere moved (the editor's path)
    repacks the shape tables as a full compile does, and still agrees."""
    scene = shapes_scene(6)
    packed, layout = compiled(scene)
    sphere = next(e for e in scene.walk_entities()
                  if e.type == tmodel.ENTITY_TYPE_SPHERE)
    sphere.transform.position = np.asarray([0.5, -0.25, 0.75], np.float32)
    scene.mark_dirty(tmodel.SCENE_DIRTY_SHAPES)
    moved = tcompile.compile_scene(scene, packed, device='cpu')
    full = tcompile.compile_scene(scene, device='cpu')
    assert not torch.equal(moved.shape_rows, packed.shape_rows)
    for name in ('plane_rows', 'shape_rows', 'shape_nodes'):
        assert torch.equal(getattr(moved, name), getattr(full, name)), name
    o, d = rays(6, 2000)
    assert_agree(moved, intersect.SceneLayout.from_packed(moved), o, d)


def test_jax_fields_without_shape_tables_get_them():
    """packed_from_numpy builds the shape tables from the shape transforms
    and groups when the fields (the JAX PackedScene's) have none."""
    packed, _ = compiled(shapes_scene(7, generic=True))
    fields = {}
    for name in tcompile.PackedScene.__dataclass_fields__:
        v = getattr(packed, name)
        if name == 'materials':
            fields[name] = {k: getattr(v, k).numpy()
                            for k in type(v).__dataclass_fields__}
        elif isinstance(v, dict):
            fields[name] = {k: x.numpy() for k, x in v.items()}
        else:
            fields[name] = v.float().numpy() if v.dtype == torch.bfloat16 else v.numpy()
    for name in ('plane_rows', 'shape_rows', 'shape_nodes'):
        del fields[name]
    carried = tcompile.packed_from_numpy(fields, device='cpu')
    for name in ('plane_rows', 'shape_rows', 'shape_nodes'):
        assert torch.equal(getattr(carried, name), getattr(packed, name)), name


def test_tracing_counts_the_analytic_tests():
    packed, layout = compiled(shapes_scene(8))
    o, d = rays(8, 500)
    k = sum(k for _, k in layout.analytic_buckets)
    with profiling.tracing():
        intersect.trace(packed, layout, o, d)
        names = [r[0] for r in profiling.records()]
        counts = profiling.counters()
    assert 'pt.trace.analytic' in names
    assert counts[intersect.ANALYTIC_TESTS] == 500 * k
    assert counts[intersect.ANALYTIC_NODES] == 0
    profiling.reset()
    intersect.trace(packed, layout, o, d)
    assert intersect.ANALYTIC_TESTS not in profiling.counters()
