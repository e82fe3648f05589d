"""path_tracer_tpu_torch's scene compile against the JAX package's, field
by field, and the carry-across of JAX-compiled tables into the port."""

import dataclasses

import numpy as np
import pytest
import torch

import path_tracer_tpu.scene.compile as jcompile
import path_tracer_tpu.scene.model as jmodel
import path_tracer_tpu.scene.procedural as jproc
import path_tracer_tpu_torch.scene.compile as tcompile
import path_tracer_tpu_torch.scene.model as tmodel
import path_tracer_tpu_torch.scene.procedural as tproc
from path_tracer_tpu.ops.intersect import SceneLayout as JLayout
from path_tracer_tpu_torch.ops.intersect import SceneLayout as TLayout

from test_torch_cuda import blob_scene, textured_scene


def jax_fields(packed):
    """The JAX PackedScene's leaves as numpy (bf16 atlas as float32), and
    the port's analytic shape tables built from them."""
    out = {}
    for f in dataclasses.fields(packed):
        v = getattr(packed, f.name)
        if f.name == 'materials':
            out[f.name] = {g.name: np.asarray(getattr(v, g.name))
                           for g in dataclasses.fields(v)}
        elif isinstance(v, dict):
            out[f.name] = {k: np.asarray(x) for k, x in v.items()}
        else:
            out[f.name] = np.asarray(v)
    out['atlas_pair'] = out['atlas_pair'].astype(np.float32)
    # The analytic shapes' tables of ops/trace_shapes.py, which the JAX
    # PackedScene lacks, built from its shape transforms and groups.
    out.update(tcompile.pack_shape_tables(
        out['shape_object_from_world'], out['analytic_idx'],
        out['analytic_valid']))
    return out


def port_fields(packed):
    out = {}
    for f in dataclasses.fields(packed):
        v = getattr(packed, f.name)
        if f.name == 'materials':
            out[f.name] = {g.name: getattr(v, g.name).numpy()
                           for g in dataclasses.fields(v)}
        elif isinstance(v, dict):
            out[f.name] = {k: x.numpy() for k, x in v.items()}
        else:
            out[f.name] = v.float().numpy() if v.dtype == torch.bfloat16 else v.numpy()
    return out


def layout_fields(layout):
    return {f.name: getattr(layout, f.name) for f in dataclasses.fields(layout)}


def assert_fields_equal(port, ref):
    for name, value in port.items():
        if isinstance(value, dict):
            assert value.keys() == ref[name].keys(), name
            for k in value:
                np.testing.assert_array_equal(value[k], ref[name][k], err_msg=f'{name}.{k}')
        else:
            assert value.dtype == ref[name].dtype, (name, value.dtype, ref[name].dtype)
            np.testing.assert_array_equal(value, ref[name], err_msg=name)


SCENES = {
    'instanced_blobs': lambda m, p: blob_scene(m)[0],
    'cornell': lambda m, p: p.make_cornell_scene(),
    'textured_mesh': textured_scene,
}


@pytest.mark.parametrize('name', sorted(SCENES))
def test_compile_matches_jax(name):
    """Every PackedScene field of the port equals the JAX compile's
    exactly (the port leaves out only the v5/v3 `wide_*` tables; its
    analytic shape tables equal those built from the JAX compile's shape
    transforms and groups), and so
    does every SceneLayout field the port keeps."""
    jp = jcompile.compile_scene(SCENES[name](jmodel, jproc), aspect_ratio=2.0)
    tp = tcompile.compile_scene(SCENES[name](tmodel, tproc), aspect_ratio=2.0,
                                device='cpu')
    assert_fields_equal(port_fields(tp), jax_fields(jp))
    jl, tl = layout_fields(JLayout.from_packed(jp)), layout_fields(TLayout.from_packed(tp))
    for key, value in tl.items():
        assert value == jl[key], key
    assert tp.host_camera_models == jp.host_camera_models


def test_packed_from_numpy_round_trip():
    """The JAX compile's leaves, carried across with packed_from_numpy,
    give the same tables and layout as the port's own compile."""
    jp = jcompile.compile_scene(textured_scene(jmodel, jproc))
    tp = tcompile.compile_scene(textured_scene(tmodel, tproc), device='cpu')
    carried = tcompile.packed_from_numpy(
        jax_fields(jp), layout_fields(JLayout.from_packed(jp)), device='cpu')
    assert carried.atlas_pair.dtype == torch.bfloat16
    assert_fields_equal(port_fields(carried), port_fields(tp))
    assert carried.host_layout == tp.host_layout
    moved = carried.to('cpu')
    assert moved.host_layout == carried.host_layout
    assert_fields_equal(port_fields(moved), port_fields(carried))
