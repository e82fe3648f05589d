"""The port's checkpoint/resume, failure recovery and CLI on the CPU, and
checkpoints carried between the port and the JAX package.

Mirrors tests/test_checkpoint_cli.py and tests/test_resilience.py. The
port's `render(state=...)` updates the state dict in place (the JAX
package's is pure), so a state that is rendered on after a save is
reloaded from the file, never reused.
"""

import json
import os

import numpy as np
import pytest
import torch

import path_tracer_tpu as jpkg
import path_tracer_tpu.integrator.checkpoint as jckpt
from path_tracer_tpu.scene.procedural import make_cornell_scene as jcornell
from path_tracer_tpu_torch import RenderConfig, SceneLayout, compile_scene
from path_tracer_tpu_torch.integrator.checkpoint import (
    load_render_state, save_render_state)
from path_tracer_tpu_torch.integrator.resolve import resolve
from path_tracer_tpu_torch.integrator.wavefront import render, reset
from path_tracer_tpu_torch.scene.procedural import make_cornell_scene
from path_tracer_tpu_torch.utils import log
from path_tracer_tpu_torch.utils.resilience import RenderFailure, render_resilient

W, H = 16, 8


def _leaves(tree):
    if isinstance(tree, dict):
        return [leaf for key in sorted(tree) for leaf in _leaves(tree[key])]
    return [tree]


def test_checkpoint_resume_bitwise(tmp_path):
    scene = make_cornell_scene()
    packed = compile_scene(scene, aspect_ratio=2.0, device='cpu')
    layout = SceneLayout.from_packed(packed)
    config = RenderConfig(width=W, height=H)

    st = render(packed, config, 10, seed=2, layout=layout)
    path = os.path.join(tmp_path, 'ckpt.npz')
    save_render_state(path, st)

    # Continue 10 more rounds directly (this updates `st` in place)...
    st_direct = render(packed, config, 10, layout=layout, state=st)

    # ...vs reload from disk and continue.
    fresh = reset(packed, config, 0)
    st_loaded = load_render_state(path, fresh, device='cpu')
    assert st_loaded['rng_state'].dtype == torch.int64
    st_resumed = render(packed, config, 10, layout=layout, state=st_loaded)
    for a, b in zip(_leaves(st_direct), _leaves(st_resumed)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_cli_demo_render(tmp_path):
    from path_tracer_tpu_torch.__main__ import main
    out = os.path.join(tmp_path, 'demo.png')
    code = main(['demo', 'cornell', out, '--width', '32', '--height', '16',
                 '--rounds', '8', '--tonemap', 'aces', '--device', 'cpu'])
    assert code == 0
    assert os.path.getsize(out) > 100


def test_cli_scene_file_render(tmp_path):
    from path_tracer_tpu_torch.__main__ import main
    from path_tracer_tpu_torch.scene.serializer import save_scene
    scene_path = os.path.join(tmp_path, 's', 'scene.json')
    save_scene(scene_path, make_cornell_scene())
    out = os.path.join(tmp_path, 'render.png')
    code = main(['render', scene_path, out, '--width', '32', '--height', '16',
                 '--rounds', '4', '--device', 'cpu'])
    assert code == 0
    assert os.path.exists(out)


def test_cli_checkpoint_and_resume(tmp_path):
    """--checkpoint saves progress and its round count; --resume goes on
    from it to the new --rounds, and the frame equals an uninterrupted
    12-round render with checkpoints."""
    from path_tracer_tpu_torch.__main__ import main
    ckpt = os.path.join(tmp_path, 'c.npz')
    args = ['demo', 'cornell', os.path.join(tmp_path, 'a.png'), '--width',
            '32', '--height', '16', '--checkpoint-every', '4', '--device', 'cpu']
    assert main(args + ['--rounds', '8', '--checkpoint', ckpt]) == 0
    with open(ckpt + '.rounds') as f:
        assert f.read() == '8'
    assert main(args + ['--rounds', '12', '--checkpoint', ckpt,
                        '--resume']) == 0
    with open(ckpt + '.rounds') as f:
        assert f.read() == '12'
    whole = os.path.join(tmp_path, 'whole.npz')
    args[2] = os.path.join(tmp_path, 'b.png')
    assert main(args + ['--rounds', '12', '--checkpoint', whole]) == 0
    with open(os.path.join(tmp_path, 'a.png'), 'rb') as a, \
            open(os.path.join(tmp_path, 'b.png'), 'rb') as b:
        assert a.read() == b.read()


def test_recovery_matches_uninterrupted(tmp_path):
    """A failure mid-render recovers from the checkpoint on the device it
    was given and gives bit for bit the accumulator of an uninterrupted
    run."""
    ckpt = os.path.join(tmp_path, 'r.npz')
    clean = render_resilient(make_cornell_scene(), W, H, 12, seed=3,
                             checkpoint_path=None, checkpoint_every=4,
                             device='cpu')
    boom = {'armed': True}

    def inject(done):
        if done == 8 and boom['armed']:
            boom['armed'] = False
            raise RuntimeError('CUDA error: an illegal memory access')

    recovered = render_resilient(make_cornell_scene(), W, H, 12, seed=3,
                                 checkpoint_path=ckpt, checkpoint_every=4,
                                 device='cpu', _inject_failure=inject)
    assert not boom['armed']
    assert recovered['accum']['xyz'].device.type == 'cpu'
    torch.testing.assert_close(clean['accum']['xyz'],
                               recovered['accum']['xyz'], rtol=0, atol=0)
    assert os.path.exists(ckpt)
    with open(ckpt + '.rounds') as f:
        assert int(f.read()) == 12


def test_resume_across_processes(tmp_path):
    """resume=True continues a checkpointed render identically to one
    uninterrupted run (the new-process path)."""
    ckpt = os.path.join(tmp_path, 'r.npz')
    clean = render_resilient(make_cornell_scene(), W, H, 12, seed=3,
                             checkpoint_every=4, device='cpu')
    render_resilient(make_cornell_scene(), W, H, 8, seed=3,
                     checkpoint_path=ckpt, checkpoint_every=4, device='cpu')
    resumed = render_resilient(make_cornell_scene(), W, H, 12, seed=3,
                               checkpoint_path=ckpt, checkpoint_every=4,
                               resume=True, device='cpu')
    torch.testing.assert_close(clean['accum']['xyz'],
                               resumed['accum']['xyz'], rtol=0, atol=0)


def test_persistent_failure_raises(tmp_path):
    def always_fail(done):
        raise RuntimeError('device gone')

    with pytest.raises(RenderFailure):
        render_resilient(make_cornell_scene(), W, H, 8, seed=0,
                         checkpoint_path=os.path.join(tmp_path, 'c.npz'),
                         checkpoint_every=4, max_retries=1, device='cpu',
                         _inject_failure=always_fail)


def test_structured_log_events(tmp_path):
    path = os.path.join(tmp_path, 'events.jsonl')
    log.enable(path)
    try:
        render_resilient(make_cornell_scene(), W, H, 4, seed=0,
                         checkpoint_path=os.path.join(tmp_path, 'c.npz'),
                         checkpoint_every=2, device='cpu')
    finally:
        log.disable()
    with open(path) as f:
        events = [json.loads(line) for line in f]
    kinds = {e['kind'] for e in events}
    assert 'compile.pack' in kinds
    assert 'render.dispatch' in kinds
    assert 'checkpoint.save' in kinds
    assert 'resilience.progress' in kinds
    assert all(isinstance(e['ts'], (int, float)) for e in events)
    disp = [e for e in events if e['kind'] == 'render.dispatch']
    assert disp[0]['lanes'] == W * H and disp[0]['rounds'] == 2


def test_jax_checkpoint_resumes_in_port(tmp_path):
    """The JAX package renders k = 4 rounds and saves; the port loads the
    file on the CPU (every leaf equal, in the JAX dtype's values) and
    renders m = 4 more. Its frame lies within bench.py's band floor (2%)
    of the JAX package's k + m rounds, the tolerance of the render tests,
    and its sample counts equal the JAX package's slot for slot."""
    jp = jpkg.compile_scene(jcornell(), aspect_ratio=2.0)
    jconfig = jpkg.RenderConfig(width=W, height=H)
    js = jpkg.render(jp, jconfig, 4, seed=2)
    path = os.path.join(tmp_path, 'jax.npz')
    jckpt.save_render_state(path, js)
    saved = [np.asarray(leaf) for leaf in _leaves(js)]
    # The JAX render donates the state it is given.
    js8 = jpkg.render(jp, jconfig, 4, state=js)

    packed = compile_scene(make_cornell_scene(), aspect_ratio=2.0,
                           device='cpu')
    config = RenderConfig(width=W, height=H)
    loaded = load_render_state(path, reset(packed, config, 0), device='cpu')
    for mine, theirs in zip(_leaves(loaded), saved):
        np.testing.assert_array_equal(mine.numpy(),
                                      theirs.astype(mine.numpy().dtype))
    ts8 = render(packed, config, 4, state=loaded)
    np.testing.assert_array_equal(ts8['accum']['count'].numpy(),
                                  np.asarray(js8['accum']['count']))
    img = resolve(ts8['accum'], W, H, lane=ts8['lane']).numpy()
    ref = np.asarray(jpkg.resolve(js8['accum'], W, H, lane=js8['lane']))
    rel = np.abs(img - ref).mean() / (ref.mean() + 1e-3)
    bias = abs(img.mean() - ref.mean()) / (ref.mean() + 1e-3)
    assert rel < 0.02 and bias < 0.02, (rel, bias)


def test_port_checkpoint_loads_in_jax(tmp_path):
    """A checkpoint the port writes has the JAX package's layout: the
    same treedef string and leaf dtypes, and the JAX package's
    load_render_state reads every leaf back equal."""
    packed = compile_scene(make_cornell_scene(), aspect_ratio=2.0,
                           device='cpu')
    config = RenderConfig(width=W, height=H)
    state = render(packed, config, 3, seed=2)
    path = os.path.join(tmp_path, 'port.npz')
    save_render_state(path, state)

    jp = jpkg.compile_scene(jcornell(), aspect_ratio=2.0)
    jfresh = jpkg.reset(jp, jpkg.RenderConfig(width=W, height=H), 0)
    jpath = os.path.join(tmp_path, 'jax.npz')
    jckpt.save_render_state(jpath, jfresh)
    mine, theirs = np.load(path), np.load(jpath)
    assert str(mine['treedef']) == str(theirs['treedef'])
    assert sorted(mine.files) == sorted(theirs.files)
    for name in mine.files:
        assert mine[name].dtype == theirs[name].dtype, name
    loaded = jckpt.load_render_state(path, jfresh)
    for a, b in zip(_leaves(loaded), _leaves(state)):
        np.testing.assert_array_equal(np.asarray(a).astype(np.int64)
                                      if b.dtype == torch.int64 else np.asarray(a),
                                      b.numpy())
