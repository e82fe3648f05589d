"""The port's world-flattened ('flat') trace path against the JAX package:
the flat tables, the plain versions of the v5 and v3 kernels
(`wide_trace5`, `wide_trace`), the attribute resolve, and `trace` in
'flat' mode and through the portable BVH2 traversal.

Mirrors tests/test_trace_wide.py case by case, on inputs made with numpy
from a seed. The JAX side runs its Pallas kernels in interpret mode.
Tolerances are that file's: the port traverses per ray where the JAX
kernels traverse 1024-ray packets, so children are visited in other
orders and a ray on an edge shared by two triangles may report either
face (face agreement > 0.99 against brute force, > 0.995 against the
kernels); hit masks are equal; t agrees to rtol 2e-4 / atol 2e-5 with
brute force and 5e-4 with the kernels (float32 rounding of the same
triangle test in another order), fu/fv to 1e-3, lerped normals and uvs
to rtol 1e-3 / atol 1e-4 on rays that chose the same face.
"""

import numpy as np
import jax.numpy as jnp
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
from path_tracer_tpu.core.constants import SHAPE_INDEX_NONE
from path_tracer_tpu.ops import intersect as jintersect
from path_tracer_tpu.ops import trace_packet as jtrace_packet
from path_tracer_tpu.ops import trace_wide as jtrace_wide
from path_tracer_tpu_torch.ops import intersect as tintersect
from path_tracer_tpu_torch.ops import trace_packet as ttrace_packet
from path_tracer_tpu_torch.ops import trace_wide as ttrace_wide

from test_torch_compile import (
    assert_fields_equal, jax_fields, layout_fields, port_fields)
from test_torch_cuda import flat_mode, tied_leaf, two_instance_scene

LEAF_FMTS = ['mt', 'bary', 'woop']
WIDE_FIELDS = ('wide_nodes', 'wide_tris', 'wide_nodes_g', 'wide_tris_g',
               'wide_attrs', 'wide_face_map')


def _random_geometry(rng, faces, spread=0.06):
    base = rng.uniform(0, 1, (faces, 1, 3)).astype(np.float32)
    tri = (base + rng.uniform(-spread, spread, (faces, 3, 3))).astype(np.float32)
    nrm = rng.normal(size=(faces, 3, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    uv = rng.uniform(0, 1, (faces, 3, 2)).astype(np.float32)
    shp = rng.integers(0, 5, faces).astype(np.float32)
    return tri, nrm, uv, shp


def _random_rays(rng, n, lo=-0.5, hi=1.5):
    o = rng.uniform(lo, hi, (3, n)).astype(np.float32)
    d = rng.normal(size=(3, n)).astype(np.float32)
    d /= np.linalg.norm(d, axis=0, keepdims=True)
    return o, d


def _brute_force(tri, o, d, t_in):
    """Moller-Trumbore of every ray against every triangle
    (tests/test_trace_wide.py)."""
    p0 = tri[:, 0][:, :, None]
    e1, e2 = tri[:, 1][:, :, None] - p0, tri[:, 2][:, :, None] - p0
    pv = np.cross(d[None], e2, axis=1)
    det = (e1 * pv).sum(1)
    ok = np.abs(det) >= 1e-9
    inv = 1.0 / np.where(ok, det, 1.0)
    s = o[None] - p0
    u = inv * (s * pv).sum(1)
    q = np.cross(s, e1, axis=1)
    v = inv * (d[None] * q).sum(1)
    t = inv * (e2 * q).sum(1)
    ok &= (u >= 0) & (u <= 1) & (v >= 0) & (u + v <= 1)
    ok &= (t >= 0) & (t < t_in[None])
    t = np.where(ok, t, np.inf)
    best, bt = t.argmin(0), t.min(0)
    hit = np.isfinite(bt)
    return np.where(hit, bt, t_in), np.where(hit, best, -1)


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _check_against_brute_force(t, face, face_map, tri, o, d, t_in):
    bt, bface = _brute_force(tri, o, d, t_in)
    np.testing.assert_array_equal(face >= 0, bface >= 0)
    m = face >= 0
    assert m.sum() > 30
    np.testing.assert_allclose(t[m], bt[m], rtol=2e-4, atol=2e-5)
    np.testing.assert_array_equal(t[~m], t_in[~m])
    got = face_map[face[m]]
    assert (got == bface[m]).mean() > 0.99  # exact t-ties may reorder
    return m, got


def _same_face(face, ref_face, face_map):
    """Rays whose two traversals chose the same input triangle; both
    hit masks must be equal and > 99.5% of the faces."""
    np.testing.assert_array_equal(face >= 0, ref_face >= 0)
    m = face >= 0
    same = m & (face_map[face] == face_map[ref_face])
    assert same[m].mean() > 0.995, same[m].mean()
    return same


@pytest.fixture
def leaf_fmt(request, monkeypatch):
    """Set the leaf geometry format in BOTH packages' bvh8."""
    monkeypatch.setattr(jbvh8, 'LEAF_FMT', request.param)
    monkeypatch.setattr(tbvh8, 'LEAF_FMT', request.param)
    return request.param


def _flat_compiled():
    with flat_mode(jcompile, tcompile):
        jp = jcompile.compile_scene(two_instance_scene(jmodel, jproc),
                                    aspect_ratio=2.0)
        tp = tcompile.compile_scene(two_instance_scene(tmodel, tproc),
                                    aspect_ratio=2.0, device='cpu')
    return jp, tp


@pytest.mark.parametrize('leaf_fmt', LEAF_FMTS, indirect=True)
def test_flat_compile_matches_jax(leaf_fmt):
    """In 'flat' mode every PackedScene field of the port, the six
    `wide_*` tables among them, equals the JAX compile's exactly, and so
    does every SceneLayout field the port keeps."""
    jp, tp = _flat_compiled()
    assert tp.host_layout.packet_mode == 'flat'
    assert tp.wide_tris_g.shape[0] > 1 and tp.inst_tris.shape[0] == 1
    assert_fields_equal(port_fields(tp), jax_fields(jp))
    jl = layout_fields(jintersect.SceneLayout.from_packed(jp))
    for key, value in layout_fields(tp.host_layout).items():
        assert value == jl[key], key
    assert tp.host_layout.wide_face_slots == tp.wide_tris_g.shape[0] * 8


def test_packed_from_numpy_carries_flat_tables():
    """The JAX compile's `wide_*` leaves cross into the port's
    PackedScene unchanged, with the layout."""
    jp, tp = _flat_compiled()
    fields = jax_fields(jp)
    carried = tcompile.packed_from_numpy(
        fields, layout_fields(jintersect.SceneLayout.from_packed(jp)),
        device='cpu')
    for name in WIDE_FIELDS:
        got = getattr(carried, name).numpy()
        assert got.dtype == fields[name].dtype and got.shape[0] > 8, name
        np.testing.assert_array_equal(got, fields[name], err_msg=name)
    assert carried.host_layout == tp.host_layout


@pytest.mark.parametrize('leaf_fmt', LEAF_FMTS, indirect=True)
def test_wide_trace5_plain_matches_brute_force_and_pallas(leaf_fmt):
    """wide_trace5 on CPU tensors (the v5 kernel's plain version) on 300
    random triangles and 2048 rays: against brute force, against the
    Pallas kernel in interpret mode on the same tables, and its counters."""
    rng = np.random.default_rng(5)
    tri, nrm, uv, shp = _random_geometry(rng, 300)
    wide = tbvh8.build_wide_bvh(tri, nrm, uv, shp)
    nodes_g, tris_g, attrs, face_map = tbvh8.pack_wide_geom(wide, tri, nrm, uv, shp)
    n = 2048
    o, d = _random_rays(rng, n)
    t_in = np.full(n, 1e5, np.float32)

    t, face, fu, fv, counts = (x.numpy() for x in ttrace_packet.wide_trace5(
        *_t(nodes_g, tris_g, o, d, t_in), stats=True))
    m, got = _check_against_brute_force(t, face, face_map, tri, o, d, t_in)
    _, _, s5 = ttrace_packet.resolve_wide_attributes(*_t(attrs, face, fu, fv))
    assert (s5.numpy()[m] == shp[got].astype(np.int32)).all()

    jt, jf, jfu, jfv = (np.asarray(x) for x in jtrace_packet.wide_trace5(
        jnp.asarray(nodes_g), jnp.asarray(tris_g), jnp.asarray(o),
        jnp.asarray(d), jnp.asarray(t_in), interpret=True, leaf_fmt=leaf_fmt))
    same = _same_face(face, jf, face_map)
    np.testing.assert_allclose(t[same], jt[same], rtol=5e-4, atol=5e-4)
    np.testing.assert_allclose(fu[same], jfu[same], atol=1e-3)
    np.testing.assert_allclose(fv[same], jfv[same], atol=1e-3)
    # Every ray pops the root; a leaf is popped from an interior node
    # and tests one or two rows.
    assert (counts[0] >= 1).all() and (counts[1] <= 8 * counts[0]).all()
    assert (counts[1] <= counts[2]).all() and (counts[2] <= 2 * counts[1]).all()


def test_wide_trace_plain_matches_brute_force_and_pallas():
    """wide_trace on CPU tensors (the v3 kernel's plain version, with the
    pop cull) on 300 random triangles and 1024 rays: against brute force,
    and all eight
    outputs against the Pallas kernel in interpret mode; on a miss the
    normal, uv and shape are 0."""
    rng = np.random.default_rng(0)
    tri, nrm, uv, shp = _random_geometry(rng, 300)
    wide = tbvh8.build_wide_bvh(tri, nrm, uv, shp)
    n = 1024
    o, d = _random_rays(rng, n)
    t_in = np.full(n, 1e5, np.float32)

    t, face, normal, uvr, shape, counts = (
        x.numpy() for x in ttrace_wide.wide_trace(
            *_t(wide.nodes, wide.tris, o, d, t_in), stats=True))
    assert normal.shape == (3, n) and uvr.shape == (2, n)
    m, got = _check_against_brute_force(t, face, wide.face_map, tri, o, d, t_in)
    assert (shape[m] == shp[got].astype(np.int32)).all()
    assert (shape[~m] == 0).all() and not normal[:, ~m].any() and not uvr[:, ~m].any()

    jt, jf, jn, juv, js = (np.asarray(x) for x in jtrace_wide.wide_trace(
        jnp.asarray(wide.nodes), jnp.asarray(wide.tris), jnp.asarray(o),
        jnp.asarray(d), jnp.asarray(t_in), interpret=True))
    same = _same_face(face, jf, wide.face_map)
    np.testing.assert_allclose(t[same], jt[same], rtol=5e-4, atol=5e-4)
    np.testing.assert_allclose(normal[:, same], jn[:, same], rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(uvr[:, same], juv[:, same], rtol=1e-3, atol=1e-4)
    np.testing.assert_array_equal(shape[same], js[same])
    assert (counts[1] <= counts[2]).all() and (counts[2] <= 4 * counts[1]).all()


@pytest.mark.parametrize('cull', [True, False])
def test_wide_trace_tie_goes_to_the_lower_slot(cull):
    """A leaf that holds one triangle in two slots, in two rows or in one:
    the lower slot wins, with and without the pop cull, as the kernel's
    sequential leaf loop decides and the warp-wide leaf test must order
    its reduction. Every output equals
    that of the tables with the upper copy taken out; with the lower one
    taken out instead the upper slot is hit at the same t to the bit, so
    the tie was real."""
    nodes, tris, o, d, t_in, pairs = tied_leaf(tbvh8, np.random.default_rng(16))

    def run(table):
        return [x.numpy() for x in ttrace_wide.wide_trace_plain(
            *_t(nodes, table, o, d, t_in), cull=cull)]

    def without(slots):
        table = tris.copy()
        table.reshape(-1, tbvh8.TRI_STRIDE)[list(slots), 0:9] = 0.0
        return run(table)

    got = run(tris)
    face = got[1]
    for lo, hi in pairs.items():
        assert (face == lo).sum() > 1000 and not (face == hi).any()
    for a, b in zip(got, without(pairs.values())):
        np.testing.assert_array_equal(a, b)
    upper = without(pairs)
    for lo, hi in pairs.items():
        won = face == lo
        assert (upper[1][won] == hi).all()
        np.testing.assert_array_equal(upper[0][won], got[0][won])


def test_v5_resolve_matches_v3_lerp():
    """The v5 path's gathered-attribute resolve equals the v3 kernel's
    in-kernel lerp on rays that chose the same triangle
    (tests/test_trace_wide.py:278-284)."""
    rng = np.random.default_rng(5)
    tri, nrm, uv, shp = _random_geometry(rng, 300)
    wide = tbvh8.build_wide_bvh(tri, nrm, uv, shp)
    nodes_g, tris_g, attrs, face_map = tbvh8.pack_wide_geom(wide, tri, nrm, uv, shp)
    o, d = _random_rays(rng, 1024)
    t_in = np.full(1024, 1e5, np.float32)
    _, f3, n3, uv3, s3 = ttrace_wide.wide_trace(*_t(wide.nodes, wide.tris, o, d, t_in))
    _, f5, fu5, fv5 = ttrace_packet.wide_trace5(*_t(nodes_g, tris_g, o, d, t_in))
    n5, uv5, s5 = ttrace_packet.resolve_wide_attributes(torch.from_numpy(attrs),
                                                        f5, fu5, fv5)
    m = f5.numpy() >= 0
    same = m & (wide.face_map[f3.numpy()] == face_map[f5.numpy()])
    assert same[m].mean() > 0.98
    np.testing.assert_allclose(n5.numpy()[:, same], n3.numpy()[:, same],
                               rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(uv5.numpy()[:, same], uv3.numpy()[:, same],
                               rtol=1e-3, atol=1e-4)
    np.testing.assert_array_equal(s5.numpy()[same], s3.numpy()[same])


@pytest.mark.parametrize('kernel', ['v5', 'v3'])
def test_wide_traces_respect_t_in(kernel):
    """With the reach shrunk below each found hit nothing may be found,
    and t comes back as it went in (tests/test_trace_wide.py:103-122)."""
    rng = np.random.default_rng(1)
    tri, nrm, uv, shp = _random_geometry(rng, 64, spread=0.2)
    wide = tbvh8.build_wide_bvh(tri, nrm, uv, shp)
    if kernel == 'v5':
        nodes, tris = tbvh8.pack_wide_geom(wide, tri, nrm, uv, shp)[:2]
        run = ttrace_packet.wide_trace5
    else:
        nodes, tris, run = wide.nodes, wide.tris, ttrace_wide.wide_trace
    o, d = _random_rays(rng, 1024)
    t, face, *_ = run(*_t(nodes, tris, o, d, np.full(1024, 1e5, np.float32)))
    hit = face.numpy() >= 0
    assert hit.any()
    t_small = np.where(hit, t.numpy() * 0.5, 1e-6).astype(np.float32)
    t2, face2, *_ = run(*_t(nodes, tris, o, d, t_small))
    assert (face2.numpy() == -1).all()
    np.testing.assert_array_equal(t2.numpy(), t_small)


def test_resolve_wide_attributes():
    """Against the JAX function on random rows; float32 multiply-adds in
    the same order, so 1e-6."""
    rng = np.random.default_rng(2)
    n, slots = 2048, 512
    attrs = rng.normal(0, 1, (slots, 16)).astype(np.float32)
    attrs[:, 15] = rng.integers(0, 9, slots)
    face = rng.integers(-1, slots, n).astype(np.int32)
    fu = rng.uniform(0, 0.5, n).astype(np.float32)
    fv = rng.uniform(0, 0.5, n).astype(np.float32)
    ref = jtrace_packet.resolve_wide_attributes(
        jnp.asarray(attrs), jnp.asarray(face), jnp.asarray(fu), jnp.asarray(fv))
    out = ttrace_packet.resolve_wide_attributes(*_t(attrs, face, fu, fv))
    assert (face < 0).any() and (out[2].numpy()[face < 0] == -1).all()
    for a, b in zip(out, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-6)


def _agree_hits(ht, hj, min_hits=300):
    """tests/test_trace_wide.py:181-197's bounds between two resolved
    hit records of the two-instance scene."""
    ht = {k: v.numpy() for k, v in ht.items()}
    hj = {k: np.asarray(v) for k, v in hj.items()}
    np.testing.assert_allclose(ht['time'], hj['time'], rtol=5e-4, atol=5e-4)
    agree = (ht['shape'] == hj['shape']).mean()
    assert agree > 0.995, agree  # near-coincident surfaces may tie
    same = (ht['shape'] == hj['shape']) & (hj['shape'] != SHAPE_INDEX_NONE)
    assert same.sum() > min_hits
    for key, tol in (('normal', 2e-2), ('uv', 2e-2), ('position', 1e-3)):
        frac = (np.abs(ht[key][..., same] - hj[key][..., same]) <= tol).mean()
        assert frac >= 0.995, (key, frac)
    assert (ht['material'] == hj['material'])[same].all()


@pytest.fixture(scope='module')
def flat_traces():
    """The two-instance scene in 'flat' mode in both packages, 1024 rays,
    and the JAX package's two traces of them."""
    jp, tp = _flat_compiled()
    jl = jintersect.SceneLayout.from_packed(jp)
    assert jl.packet_mode == 'flat' and jl.instance_slots >= 2
    o, d = _random_rays(np.random.default_rng(7), 1024, -4, 4)
    packet = jintersect.trace(jp, jl, jnp.asarray(o), jnp.asarray(d),
                              use_packet=True, interpret=True)
    portable = jintersect.trace(jp, jl, jnp.asarray(o), jnp.asarray(d),
                                use_packet=False)
    return tp, torch.from_numpy(o), torch.from_numpy(d), packet, portable


@pytest.mark.parametrize('mode', ['kernel', 'portable'])
@pytest.mark.parametrize('reference', ['packet', 'portable'])
def test_flat_trace_matches_jax(flat_traces, mode, reference):
    """The port's `trace` in 'flat' mode (through wide_trace5) and
    through the portable BVH2 traversal, each against JAX
    trace(use_packet=True, interpret=True) (the v5 kernel) and JAX
    trace(use_packet=False)."""
    tp, o, d, packet, portable = flat_traces
    ht = tintersect.trace(tp, tp.host_layout, o, d,
                          use_packet=mode == 'kernel')
    _agree_hits(ht, packet if reference == 'packet' else portable)
