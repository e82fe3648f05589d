"""The port's main path end to end against the JAX package: reset state,
and a small textured mesh frame under an HDR sky at the same seed."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import path_tracer_tpu as jpkg
import path_tracer_tpu.scene.model as jmodel
import path_tracer_tpu.scene.procedural as jproc
import path_tracer_tpu_torch as tpkg
import path_tracer_tpu_torch.scene.model as tmodel
import path_tracer_tpu_torch.scene.procedural as tproc

from test_torch_cuda import textured_scene

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_reset_state_matches_jax():
    """Fresh paths at 64x32: camera rays, wavelengths and RNG streams."""
    jp = jpkg.compile_scene(textured_scene(jmodel, jproc), aspect_ratio=2.0)
    tp = tpkg.compile_scene(textured_scene(tmodel, tproc), aspect_ratio=2.0,
                            device='cpu')
    js = jpkg.reset(jp, jpkg.RenderConfig(width=64, height=32), 5)
    ts = tpkg.reset(tp, tpkg.RenderConfig(width=64, height=32), 5)
    np.testing.assert_array_equal(ts['rng_state'].numpy(),
                                  np.asarray(js['rng_state']).astype(np.int64))
    np.testing.assert_array_equal(ts['lane'].numpy(), np.asarray(js['lane']))
    np.testing.assert_array_equal(ts['path']['lambda0'].numpy(),
                                  np.asarray(js['path']['lambda0']))
    for key in ('origin', 'direction'):
        np.testing.assert_allclose(ts[key].numpy(), np.asarray(js[key]),
                                   rtol=2e-5, atol=2e-6)


def test_render_scene_matches_jax_in_mc_bands():
    """render_scene at 64x32, 4 rounds, seed 3. The two packages draw the
    same random numbers, so the frames differ only where a traversal
    tie-break or a transcendental's last bit sends a path elsewhere.
    Held to bench.py's Monte-Carlo bands at their floor: mean absolute
    error and mean bias each under 2% of the mean."""
    ref = np.asarray(jpkg.render_scene(textured_scene(jmodel, jproc), 64, 32,
                                       spp_rounds=4, seed=3))
    img = tpkg.render_scene(textured_scene(tmodel, tproc), 64, 32,
                            spp_rounds=4, seed=3, device='cpu').numpy()
    assert img.shape == ref.shape == (32, 64, 3)
    assert np.isfinite(img).all() and img.mean() > 0.01
    rel = np.abs(img - ref).mean() / (ref.mean() + 1e-3)
    bias = abs(img.mean() - ref.mean()) / (ref.mean() + 1e-3)
    assert rel < 0.02 and bias < 0.02, (rel, bias)


def test_port_imports_no_jax():
    """Importing the port (and driving its CPU path) loads neither JAX
    nor the JAX package."""
    code = ('import sys, torch, path_tracer_tpu_torch as p\n'
            'from path_tracer_tpu_torch.integrator import scatter, wavefront\n'
            'from path_tracer_tpu_torch.ops import trace_inst, build\n'
            'bad = [m for m in sys.modules if m == "jax" or m.startswith("jax.")'
            ' or m == "path_tracer_tpu" or m.startswith("path_tracer_tpu.")]\n'
            'assert not bad, bad\n')
    env = dict(os.environ, PYTHONPATH=REPO)
    subprocess.run([sys.executable, '-c', code], check=True, cwd=REPO, env=env)


def test_port_sources_name_no_jax():
    for root, _, files in os.walk(os.path.join(REPO, 'path_tracer_tpu_torch')):
        for name in files:
            if name.endswith('.py'):
                with open(os.path.join(root, name)) as f:
                    for line in f:
                        words = line.split()
                        if words[:1] in (['import'], ['from']):
                            assert 'jax' not in words[1], (name, line)
                            assert not words[1].startswith('path_tracer_tpu.'), (name, line)
                            assert words[1] != 'path_tracer_tpu', (name, line)


def test_cuda_entry_point_has_no_cpu_fallback():
    """The entry point defaults to the card: on a machine without one it
    fails, and never runs the plain version instead."""
    if torch.cuda.is_available():
        pytest.skip('this machine has a CUDA device')
    with pytest.raises((RuntimeError, AssertionError), match='(?i)cuda'):
        tpkg.render_scene(textured_scene(tmodel, tproc), 32, 16, spp_rounds=1)
