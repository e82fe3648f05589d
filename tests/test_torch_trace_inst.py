"""The port's instanced BVH8 traversal against the JAX package's Pallas
kernel (interpret mode) and full trace, for both leaf formats.

Tolerances are tests/test_trace_inst.py's: the per-ray traversal and the
3072-ray packet kernel visit children in different orders, so rays that
hit a shared edge or vertex of two triangles may report either one
(shape agreement > 0.995); where both report the same shape, t agrees
to float32 rounding of the same plane test (5e-4), and normals, uvs and
positions agree on >= 99.5% of lanes.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import path_tracer_tpu.scene.bvh8 as jbvh8
import path_tracer_tpu.scene.compile as jcompile
import path_tracer_tpu.scene.model as jmodel
import path_tracer_tpu_torch.scene.bvh8 as tbvh8
import path_tracer_tpu_torch.scene.compile as tcompile
import path_tracer_tpu_torch.scene.model as tmodel
from path_tracer_tpu.core.constants import SHAPE_INDEX_NONE
from path_tracer_tpu.ops import intersect as jintersect
from path_tracer_tpu.ops import trace_inst as jtrace_inst
from path_tracer_tpu_torch.ops import intersect as tintersect
from path_tracer_tpu_torch.ops import trace_inst as ttrace_inst

from test_torch_cuda import blob_scene


def _rays(rng, n):
    o = rng.uniform(-6, 6, (3, n)).astype(np.float32)
    d = rng.normal(0, 1, (3, n)).astype(np.float32)
    d /= np.linalg.norm(d, axis=0, keepdims=True)
    return o, d


@pytest.fixture
def leaf_fmt(request, monkeypatch):
    """Set the leaf geometry format in BOTH packages' bvh8."""
    monkeypatch.setattr(jbvh8, 'LEAF_FMT', request.param)
    monkeypatch.setattr(tbvh8, 'LEAF_FMT', request.param)
    return request.param


def _compiled(n_instances=6):
    jscene, rng = blob_scene(jmodel, n_instances)
    tscene, _ = blob_scene(tmodel, n_instances)
    jp = jcompile.compile_scene(jscene)
    tp = tcompile.compile_scene(tscene, device='cpu')
    for name in ('inst_nodes', 'inst_tris', 'inst_rows'):
        np.testing.assert_array_equal(getattr(tp, name).numpy(),
                                      np.asarray(getattr(jp, name)))
    return jp, tp, rng


def _agree(t_port, f_port, t_ref, f_ref):
    same = f_port == f_ref
    assert same.mean() > 0.995, same.mean()
    hit = same & (f_ref >= 0)
    assert hit.sum() > 30
    np.testing.assert_allclose(t_port[hit], t_ref[hit], rtol=5e-4, atol=5e-4)
    return hit


@pytest.mark.parametrize('leaf_fmt', ['mt', 'bary'], indirect=True)
def test_plain_traversal_matches_pallas_kernel(leaf_fmt):
    """inst_trace_plain (the kernel's plain version) against the JAX
    inst_trace kernel in interpret mode, on the same tables and rays."""
    jp, tp, rng = _compiled()
    o, d = _rays(rng, 1024)
    t_in = np.full(1024, 1e6, np.float32)
    tlas = tp.host_layout.tlas_rows
    jt, jf, jfu, jfv, ji = (np.asarray(x) for x in jtrace_inst.inst_trace(
        jp.inst_nodes, jp.inst_tris, jp.inst_rows, jnp.asarray(o),
        jnp.asarray(d), jnp.asarray(t_in), tlas_rows=tlas, interpret=True))
    tt, tf, tfu, tfv, ti, counts = (x.numpy() for x in ttrace_inst.inst_trace(
        tp.inst_nodes, tp.inst_tris, tp.inst_rows, torch.from_numpy(o),
        torch.from_numpy(d), torch.from_numpy(t_in), tlas_rows=tlas, stats=True))
    hit = _agree(tt, tf, jt, jf)
    np.testing.assert_array_equal(ti[hit], ji[hit])
    np.testing.assert_allclose(tfu[hit], jfu[hit], atol=1e-3)
    np.testing.assert_allclose(tfv[hit], jfv[hit], atol=1e-3)
    assert (ti[tf < 0] == -1).all() and (tt[tf < 0] == 1e6).all()
    # Counters: every ray pops the TLAS root; leaf pops and instance
    # entries only after an interior pop; a leaf tests one or two rows.
    assert (counts[0] >= 1).all()
    assert (counts[1] <= 16 * counts[0]).all() and counts[3].sum() > 0
    assert (counts[1] <= counts[2]).all() and (counts[2] <= 2 * counts[1]).all()


@pytest.mark.parametrize('leaf_fmt', ['mt', 'bary'], indirect=True)
def test_trace_matches_jax_trace(leaf_fmt):
    """The port's full trace (analytic shapes, instanced traversal, ray
    sort, attribute resolve) against JAX trace(use_packet=True,
    interpret=True) on a multi-instance transformed scene."""
    jp, tp, rng = _compiled()
    o, d = _rays(rng, 1024)
    hj = jintersect.trace(jp, jintersect.SceneLayout.from_packed(jp),
                          jnp.asarray(o), jnp.asarray(d), use_packet=True,
                          interpret=True)
    for sort_rays in (False, True):
        ht = tintersect.trace(tp, tp.host_layout, torch.from_numpy(o),
                              torch.from_numpy(d), sort_rays=sort_rays)
        same = ht['shape'].numpy() == np.asarray(hj['shape'])
        assert same.mean() > 0.995
        m = same & (np.asarray(hj['shape']) != SHAPE_INDEX_NONE)
        assert m.sum() > 30
        np.testing.assert_allclose(ht['time'].numpy()[m], np.asarray(hj['time'])[m],
                                   rtol=5e-4, atol=5e-4)
        for key, tol in (('normal', 2e-2), ('uv', 2e-2), ('position', 1e-3)):
            frac = (np.abs(ht[key].numpy()[..., m] - np.asarray(hj[key])[..., m])
                    <= tol).mean()
            assert frac >= 0.995, (key, frac)
        assert (ht['material'].numpy() == np.asarray(hj['material']))[m].all()


@pytest.mark.parametrize('n_instances', [1, 4])
def test_resolve_inst_attributes(n_instances):
    rng = np.random.default_rng(n_instances)
    n, slots = 2048, 512
    attrs = rng.normal(0, 1, (slots, 16)).astype(np.float32)
    aux = rng.normal(0, 1, (n_instances, 16)).astype(np.float32)
    aux[:, 9] = np.arange(n_instances) + 3
    face = rng.integers(-1, slots, n).astype(np.int32)
    inst = np.where(face >= 0, rng.integers(0, n_instances, n), -1).astype(np.int32)
    fu = rng.uniform(0, 0.5, n).astype(np.float32)
    fv = rng.uniform(0, 0.5, n).astype(np.float32)
    ref = jtrace_inst.resolve_inst_attributes(
        jnp.asarray(attrs), jnp.asarray(aux), jnp.asarray(face), jnp.asarray(fu),
        jnp.asarray(fv), jnp.asarray(inst), n_instances=n_instances)
    out = ttrace_inst.resolve_inst_attributes(
        *(torch.from_numpy(x) for x in (attrs, aux, face, fu, fv, inst)),
        n_instances=n_instances)
    for a, b in zip(out, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-6)

