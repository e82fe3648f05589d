"""One scatter step of the port against the JAX package's, from the same
render state and hit record, and the atlas taps behind it."""

from types import SimpleNamespace

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import path_tracer_tpu.scene.compile as jcompile
import path_tracer_tpu.scene.model as jmodel
import path_tracer_tpu.scene.procedural as jproc
import path_tracer_tpu_torch.scene.compile as tcompile
from path_tracer_tpu.core.sampling import Rng as JRng
from path_tracer_tpu.integrator import scatter as jscatter
from path_tracer_tpu.integrator import wavefront as jwavefront
from path_tracer_tpu.models import common as jcommon
from path_tracer_tpu.ops import intersect as jintersect
from path_tracer_tpu_torch.core.sampling import Rng as TRng
from path_tracer_tpu_torch.integrator import scatter as tscatter
from path_tracer_tpu_torch.models import common as tcommon

from test_torch_compile import jax_fields, layout_fields
from test_torch_cuda import textured_scene


def _t(x):
    a = np.asarray(x)
    return torch.from_numpy(a.astype(np.int64) if a.dtype == np.uint32 else a.copy())


def test_scatter_step_matches_jax():
    """From a mid-render JAX state (bounce and fresh rays) and the JAX
    hit record, carried across as numpy: the RNG state after the step is
    bit-exact (same draw count and arithmetic), the alive masks agree on
    >= 99.9% of lanes (a lane may differ only where a last-bit difference
    of a transcendental flips a comparison), and the new samples, rays
    and weights agree within float32 rounding of those transcendentals."""
    jp = jcompile.compile_scene(textured_scene(jmodel, jproc), aspect_ratio=2.0)
    jl = jintersect.SceneLayout.from_packed(jp)
    tp = tcompile.packed_from_numpy(jax_fields(jp), layout_fields(jl), device='cpu')
    config = jwavefront.RenderConfig(width=64, height=32)
    state = jwavefront.render(jp, config, 2, seed=7, layout=jl)
    hit = jintersect.trace(jp, jl, state['origin'], state['direction'])

    jrng = JRng(state['rng_state'])
    j_path, j_o, j_d, j_alive = jscatter.scatter(
        jp, state['path'], state['origin'], state['direction'], hit, jrng,
        jnp.float32(0.05), jl)

    trng = TRng(_t(state['rng_state']))
    t_hit = {k: _t(v) for k, v in hit.items() if k != 'complexity'}
    t_path, t_o, t_d, t_alive = tscatter.scatter(
        tp, {k: _t(v) for k, v in state['path'].items()}, _t(state['origin']),
        _t(state['direction']), t_hit, trng, 0.05, tp.host_layout)

    np.testing.assert_array_equal(trng.state.numpy(),
                                  np.asarray(jrng.state).astype(np.int64))
    same = t_alive.numpy() == np.asarray(j_alive)
    assert same.mean() >= 0.999, same.mean()
    assert 0.05 < same.mean() and np.asarray(j_alive).any()
    np.testing.assert_allclose(t_path['sample'].numpy(), np.asarray(j_path['sample']),
                               rtol=1e-4, atol=1e-5)
    for key in ('throughput', 'probability'):
        np.testing.assert_allclose(t_path[key].numpy()[:, same],
                                   np.asarray(j_path[key])[:, same],
                                   rtol=1e-3, atol=1e-5)
    np.testing.assert_allclose(t_o.numpy()[:, same], np.asarray(j_o)[:, same],
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(t_d.numpy()[:, same], np.asarray(j_d)[:, same],
                               atol=1e-4)


@pytest.mark.parametrize('use_quad', ['pair', 'quad', False])
def test_sample_texture_matches_jax(use_quad):
    """Atlas taps through each table a layout can select: 'pair' (the
    textured viking hall's 2048^2 atlas: bf16 texel pairs), 'quad' and
    the four-corner fallback; bilinear and nearest textures mixed."""
    rng = np.random.default_rng(11)
    layers, size, n = 2, 32, 4096
    atlas = rng.uniform(-2, 2, (layers, size, size, 4)).astype(np.float32)
    meta = np.zeros((3, 8), np.float32)
    meta[:, 0:2] = rng.uniform(0, 0.3, (3, 2))
    meta[:, 2:4] = rng.uniform(0.6, 1.0, (3, 2))
    meta[:, 4] = [0, 1, 1]
    meta[:, 5] = [0, 1, 0]
    fields = dict(texture_meta=meta, atlas=atlas.reshape(-1, 4),
                  atlas_quad=jcompile._build_atlas_quad(atlas))
    jpair = jcompile._build_atlas_pair(atlas)
    idx = rng.integers(0, 3, n).astype(np.int32)
    uv = rng.uniform(-2, 2, (2, n)).astype(np.float32)
    ref = jcommon.sample_texture(
        SimpleNamespace(atlas_pair=jnp.asarray(jpair),
                        **{k: jnp.asarray(v) for k, v in fields.items()}),
        jnp.asarray(idx), jnp.asarray(uv), size, (True, True), use_quad)
    out = tcommon.sample_texture(
        SimpleNamespace(atlas_pair=torch.from_numpy(jpair.astype(np.float32)).to(torch.bfloat16),
                        **{k: torch.from_numpy(v) for k, v in fields.items()}),
        torch.from_numpy(idx), torch.from_numpy(uv), size, (True, True), use_quad)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-6)
