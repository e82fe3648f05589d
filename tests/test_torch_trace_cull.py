"""The pop cull of the plain traversals, their stack depth and counters,
and the traversal wrappers on CPU tensors.

The pop cull drops a popped node whose box the ray enters later than its
current t by more than the slab test's rounding (t * CULL_SLACK). A
child's box lies inside its parent's, so no closer hit is lost and t is
equal with and without it on every ray, exactly; without the slack, the
rounded entry of a leaf box could lie one ulp beyond a hit inside it
(`test_cull_keeps_the_hit_at_the_rounded_box_entry`). The face
may differ where the BVH build's spatial splits refer to one triangle from
two leaves and the hit lies outside one of the two leaf boxes: the cull
then skips that leaf and the other reference wins (face agreement > 0.999
asserted; it is the same triangle, so fu and fv are equal too).
"""

import contextlib

import numpy as np
import pytest
import torch

import path_tracer_tpu.scene.bvh8 as jbvh8
import path_tracer_tpu.scene.compile as jcompile
import path_tracer_tpu.scene.model as jmodel
import path_tracer_tpu.scene.procedural as jproc
import path_tracer_tpu_torch.scene.bvh8 as tbvh8
import path_tracer_tpu_torch.scene.compile as tcompile
import path_tracer_tpu_torch.scene.model as tmodel
import path_tracer_tpu_torch.scene.procedural as tproc
from path_tracer_tpu.ops.intersect import SceneLayout as JLayout
from path_tracer_tpu_torch.ops.intersect import SceneLayout as TLayout
from path_tracer_tpu_torch.ops import trace_inst, trace_packet, trace_wide

from test_torch_compile import jax_fields, layout_fields
from test_torch_cuda import blob_scene, flat_mode, two_instance_scene

LEAF_FMTS = ['mt', 'bary', 'woop']

# Viking hall rays whose hit lies one ulp before the rounded entry
# distance of the one leaf box that holds its triangle, so a cull without
# slack lost the hit (t one ulp longer, another face): found among the
# 2,073,600 primary and bounce rays of chip_smoke.py's `pop_cull` phase on
# an NVIDIA H100 (the kernels and the plain versions lose it alike).
# (leaf format, origin, direction, t_in, the kernels that lost it)
LOST_RAYS = [
    ('bary', ('0x0.0p+0', '-0x1.ap+2', '0x1.333334p+1'),
     ('-0x1.b33b9cp-2', '0x1.be3c0cp-1', '-0x1.f496fp-3'), '0x1.0p+20',
     ('inst_trace', 'wide_trace5')),
    ('mt', ('0x0.0p+0', '-0x1.ap+2', '0x1.333334p+1'),
     ('0x1.a77b46p-4', '0x1.e7fc92p-1', '-0x1.234796p-2'), '0x1.0p+20',
     ('inst_trace',)),
]


@pytest.fixture
def leaf_fmt(request, monkeypatch):
    """Set the leaf geometry format in BOTH packages' bvh8."""
    monkeypatch.setattr(jbvh8, 'LEAF_FMT', request.param)
    monkeypatch.setattr(tbvh8, 'LEAF_FMT', request.param)
    return request.param


def _compiled(mode, source):
    """The port's PackedScene of a multi-instance scene in `mode` ('wide':
    the 'flat' compile, whose attribute tables `wide_trace` reads), from
    the port's own compile or carried across from the JAX compile."""
    mode = 'inst' if mode == 'inst' else 'flat'

    def scene(m, p):
        return blob_scene(m)[0] if mode == 'inst' else two_instance_scene(m, p)

    if source == 'port':
        with flat_mode(tcompile) if mode == 'flat' else contextlib.nullcontext():
            return tcompile.compile_scene(scene(tmodel, tproc), device='cpu')
    with flat_mode(jcompile) if mode == 'flat' else contextlib.nullcontext():
        jp = jcompile.compile_scene(scene(jmodel, jproc))
    return tcompile.packed_from_numpy(
        jax_fields(jp), layout_fields(JLayout.from_packed(jp)), device='cpu')


def _rays(rng, n, lo, hi):
    o = rng.uniform(lo, hi, (3, n)).astype(np.float32)
    d = rng.normal(0, 1, (3, n)).astype(np.float32)
    d /= np.linalg.norm(d, axis=0, keepdims=True)
    return torch.from_numpy(o), torch.from_numpy(d)


def _plain(mode, packed):
    """(plain traversal taking rays and keywords, number of pop counters)"""
    if mode == 'inst':
        tlas = packed.host_layout.tlas_rows
        return lambda o, d, t_in, **kw: trace_inst.inst_trace_plain(
            packed.inst_nodes, packed.inst_tris, packed.inst_rows, o, d, t_in,
            tlas, stats=True, **kw)
    if mode == 'wide':
        return lambda o, d, t_in, **kw: trace_wide.wide_trace_plain(
            packed.wide_nodes, packed.wide_tris, o, d, t_in, stats=True, **kw)
    return lambda o, d, t_in, **kw: trace_packet.wide_trace5_plain(
        packed.wide_nodes_g, packed.wide_tris_g, o, d, t_in, stats=True, **kw)


@pytest.mark.parametrize('mode', ['inst', 'flat', 'wide'])
@pytest.mark.parametrize('leaf_fmt', LEAF_FMTS, indirect=True)
def test_pop_cull_keeps_every_hit(leaf_fmt, mode):
    """The plain traversal with the pop cull against the one without, on
    a scene of several mesh instances: t equal exactly on every ray, the
    same hit mask, face agreement > 0.999 with the other outputs (fu/fv;
    for wide_trace normal, uv and shape) equal there, and no ray pops
    more with the cull than without."""
    packed = _compiled(mode, 'port')
    plain = _plain(mode, packed)
    rng = np.random.default_rng(11)
    n = 1536
    o, d = _rays(rng, n, -6, 6) if mode == 'inst' else _rays(rng, n, -3, 3)
    t_in = torch.full((n,), 1e6)
    *with_cull, counts_cull = plain(o, d, t_in, cull=True)
    *without, counts_all = plain(o, d, t_in, cull=False)
    assert int((without[1] >= 0).sum()) > 30
    assert torch.equal(with_cull[0], without[0])
    assert torch.equal(with_cull[1] >= 0, without[1] >= 0)
    same = with_cull[1] == without[1]
    assert same.float().mean() > 0.999, same.float().mean()
    for a, b in zip(with_cull[2:], without[2:]):
        assert torch.equal(a[..., same], b[..., same])
    assert bool((counts_cull <= counts_all).all())
    assert int(counts_cull.sum()) < int(counts_all.sum())


@pytest.mark.parametrize('source', ['port', 'jax'])
@pytest.mark.parametrize('kernel', ['inst_trace', 'wide_trace5', 'wide_trace'])
@pytest.mark.parametrize('leaf_fmt', ['bary'], indirect=True)
def test_plain_counters_count_the_leaf_triangles(leaf_fmt, kernel, source):
    """The last per-ray counter of the plain versions is the number of
    triangles in the leaf rows the ray tested: every leaf the ray popped
    adds its count. A leaf's rows are full but for the last, which is not empty;
    the pop cull never raises the count. Tables of the port's compile and of the JAX
    compile give the same counts."""
    mode = 'inst' if kernel == 'inst_trace' else 'flat'
    packed = _compiled(mode, source)
    rng = np.random.default_rng(14)
    n = 768
    o, d = _rays(rng, n, -6, 6) if mode == 'inst' else _rays(rng, n, -3, 3)
    t_in = torch.full((n,), 1e6)
    if kernel == 'wide_trace':
        slots = tbvh8.TRIS_PER_ROW
        counts = trace_wide.wide_trace_plain(
            packed.wide_nodes, packed.wide_tris, o, d, t_in, stats=True)[-1]
        assert counts.shape == (4, n)
    else:
        slots = 8
        plain = _plain(mode, packed)
        counts = plain(o, d, t_in)[-1]
        assert counts.shape == ((5, n) if mode == 'inst' else (4, n))
        assert bool((counts[-1] <= plain(o, d, t_in, cull=False)[-1][-1]).all())
    leaf_pops, rows, triangles = counts[1], counts[2], counts[-1]
    assert int(triangles.sum()) > 100
    # A leaf's rows are full but for its last one, which holds a triangle.
    assert bool((triangles >= slots * (rows - leaf_pops) + leaf_pops).all())
    assert bool((triangles <= slots * rows).all())
    want = _compiled(mode, 'port' if source == 'jax' else 'jax')
    if kernel == 'wide_trace':
        other = trace_wide.wide_trace_plain(
            want.wide_nodes, want.wide_tris, o, d, t_in, stats=True)[-1]
    else:
        other = _plain(mode, want)(o, d, t_in)[-1]
    assert torch.equal(counts, other)


@pytest.mark.parametrize('cull', [True, False])
@pytest.mark.parametrize('mode', ['inst', 'flat', 'wide'])
def test_shallow_stack_drops_pushes(mode, cull):
    """Pushes past the stack's depth are dropped: with a depth of 3 the
    traversal still ends, finds no hit that the full depth does not beat
    or equal, and loses some; with the depth the rays need (16 here) it
    equals the default depth."""
    packed = _compiled(mode, 'port')
    plain = _plain(mode, packed)
    rng = np.random.default_rng(12)
    n = 1024
    o, d = _rays(rng, n, -6, 6) if mode == 'inst' else _rays(rng, n, -3, 3)
    t_in = torch.full((n,), 1e6)
    full = plain(o, d, t_in, cull=cull)
    enough = plain(o, d, t_in, cull=cull, stack_depth=16)
    for a, b in zip(full, enough):
        assert torch.equal(a, b)
    shallow = plain(o, d, t_in, cull=cull, stack_depth=3)
    assert bool((shallow[0] >= full[0]).all())
    lost = shallow[0] > full[0]
    assert 0 < int(lost.sum()) < n
    kept = (shallow[1] >= 0) & ~lost
    assert int(kept.sum()) > 30
    assert torch.equal(shallow[1][kept], full[1][kept])


def _wrapper(mode, packed):
    """The traversal wrapper of `mode`, taking rays and keywords (the
    counterpart of `_plain`)."""
    if mode == 'inst':
        tables = (packed.inst_nodes, packed.inst_tris, packed.inst_rows)
        tlas = packed.host_layout.tlas_rows
        return lambda o, d, t_in, **kw: trace_inst.inst_trace(
            *tables, o, d, t_in, tlas, **kw)
    if mode == 'wide':
        return lambda *a, **kw: trace_wide.wide_trace(
            packed.wide_nodes, packed.wide_tris, *a, **kw)
    return lambda *a, **kw: trace_packet.wide_trace5(
        packed.wide_nodes_g, packed.wide_tris_g, *a, **kw)


@pytest.mark.parametrize('kernel', ['inst_trace', 'wide_trace5', 'wide_trace'])
def test_cpu_wrapper_is_the_plain_version_with_cull(kernel):
    """On CPU tensors each traversal wrapper runs its plain version with
    the pop cull: every output and counter equal to the bit, with and
    without `stats`; an anatomy request raises, since only the CUDA
    kernels measure their anatomy."""
    mode = {'inst_trace': 'inst', 'wide_trace5': 'flat',
            'wide_trace': 'wide'}[kernel]
    packed = _compiled(mode, 'port')
    wrapper = _wrapper(mode, packed)
    n = 512
    o, d = (_rays(np.random.default_rng(13), n, -6, 6) if mode == 'inst'
            else _rays(np.random.default_rng(15), n, -3, 3))
    t_in = torch.full((n,), 1e6)
    want = _plain(mode, packed)(o, d, t_in, cull=True)
    assert int((want[1] >= 0).sum()) > 30
    got = wrapper(o, d, t_in, stats=True)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    for a, b in zip(wrapper(o, d, t_in), want[:-1]):
        assert torch.equal(a, b)
    with pytest.raises(ValueError):
        wrapper(o, d, t_in, anatomy=True)


@pytest.fixture(scope='module')
def viking_tables():
    """The viking hall's tables in both modes and the three leaf formats
    (the geometry only: its texture and sky change no table)."""
    tables = {}
    for fmt in LEAF_FMTS:
        for mode in ('inst', 'flat'):
            with contextlib.ExitStack() as stack:
                stack.enter_context(_leaf_format(fmt))
                if mode == 'flat':
                    stack.enter_context(flat_mode(tcompile))
                tables[fmt, mode] = tcompile.compile_scene(
                    tproc.make_viking_hall_scene(detail=1, with_sky=False,
                                                 textured=False),
                    aspect_ratio=16 / 9, device='cpu')
    return tables


@contextlib.contextmanager
def _leaf_format(fmt):
    saved = tbvh8.LEAF_FMT
    tbvh8.LEAF_FMT = fmt
    try:
        yield
    finally:
        tbvh8.LEAF_FMT = saved


@pytest.mark.parametrize('case', range(len(LOST_RAYS)))
def test_cull_keeps_the_hit_at_the_rounded_box_entry(viking_tables, case):
    """The rays that the cull without slack lost on the card: with the
    cull, inst_trace_plain and wide_trace5_plain give the same t, face,
    fu and fv as without it, bit for bit, and the ray hits."""
    fmt, origin, direction, t_in, _ = LOST_RAYS[case]

    def column(values):
        return torch.tensor([[float.fromhex(v)] for v in values])

    rays = (column(origin), column(direction),
            torch.tensor([float.fromhex(t_in)]))
    inst = viking_tables[fmt, 'inst']
    flat = viking_tables[fmt, 'flat']
    tlas_rows = TLayout.from_packed(inst).tlas_rows
    plains = {
        'inst_trace': lambda cull: trace_inst.inst_trace_plain(
            inst.inst_nodes, inst.inst_tris, inst.inst_rows, *rays,
            tlas_rows, leaf_fmt=fmt, cull=cull),
        'wide_trace5': lambda cull: trace_packet.wide_trace5_plain(
            flat.wide_nodes_g, flat.wide_tris_g, *rays, leaf_fmt=fmt,
            cull=cull)}
    for name, plain in plains.items():
        culled, full = plain(True), plain(False)
        assert int(full[1][0]) >= 0, name
        for a, b in zip(culled, full):
            assert torch.equal(a, b), (name, float(culled[0][0]),
                                       float(full[0][0]))
