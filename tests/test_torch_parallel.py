"""path_tracer_tpu_torch.parallel on the CPU: sharded renders over
torch.distributed with gloo, 2 and 4 ranks in processes of their own.

Mirrors the sharded tests of tests/test_parallel.py and
tests/test_waves.py::test_waves_sharded_matches_single_device. The JAX
package shards over a virtual 8-device mesh in one process; here each
rank is a process, the ranks of one world run every scenario in one
spawn (`_worker`), and each test reads its scenario's results, which
every rank reports (each rank holds the whole merged accumulator). A
slot's path depends on its own slot index and seed only, so a pixel-
sharded render is the single-process render bit for bit, and a batch
row b is the single-process render at seed + b.
"""

import functools
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist

import path_tracer_tpu_torch as tpkg
import path_tracer_tpu_torch.scene.model as tmodel
from path_tracer_tpu_torch.integrator.checkpoint import (
    load_render_state, save_render_state)
from path_tracer_tpu_torch.parallel import render as tparallel
from path_tracer_tpu_torch.scene.procedural import make_cornell_scene

from test_torch_cuda import blob_scene

W, H = 32, 16


def _numpy(accum):
    return {k: v.numpy() for k, v in accum.items()}


def _packed(name):
    scene = make_cornell_scene() if name == 'cornell' else blob_scene(tmodel)[0]
    return tpkg.compile_scene(scene, aspect_ratio=W / H, device='cpu')


def _worker(rank, world, port, tmpdir, results):
    """Every scenario of one world, on this rank: results[name] is the
    merged accumulator (or what the test needs) as numpy."""
    dist.init_process_group('gloo', rank=rank, world_size=world,
                            init_method=f'tcp://127.0.0.1:{port}')
    try:
        out = {}
        packed = _packed('cornell')
        config = tpkg.RenderConfig(width=W, height=H)
        run = tparallel.render_sharded
        if world == 2:
            out['batch'] = _numpy(run(packed, config, 8, tparallel.make_mesh(
                2, 1, device='cpu'), seed=7))
            out['pixel'] = _numpy(run(packed, config, 12, tparallel.make_mesh(
                1, 2, device='cpu'), seed=5))
        else:
            pixels4 = tparallel.make_mesh(1, 4, device='cpu')
            mesh22 = tparallel.make_mesh(2, 2, device='cpu')
            out['pixel'] = _numpy(run(packed, config, 12, pixels4, seed=5))
            out['resume_one_call'] = _numpy(run(packed, config, 8, mesh22,
                                                seed=4))
            first, state = run(packed, config, 4, mesh22, seed=4,
                               return_state=True)
            out['resume_first'] = _numpy(first)
            out['resume_second'] = _numpy(run(packed, config, 4, mesh22,
                                              seed=4, state=state))
            _, state = run(packed, config, 4, pixels4, seed=9,
                           return_state=True)
            path = os.path.join(tmpdir, f'shard_{rank}.npz')
            save_render_state(path, state)
            restored = load_render_state(path, state, device='cpu')
            out['ckpt_direct'] = _numpy(run(packed, config, 4, pixels4,
                                            state=state))
            out['ckpt_restored'] = _numpy(run(packed, config, 4, pixels4,
                                              state=restored))
            out['waves'] = _numpy(run(packed, tpkg.RenderConfig(
                width=W, height=H, waves=2), 8, pixels4, seed=5))
            out['mesh_scene'] = _numpy(run(_packed('blob'), config, 4,
                                           pixels4, seed=2))
            out['batch_rows'] = _numpy(run(packed, config, 10,
                                           tparallel.make_mesh(4, 1, device='cpu'),
                                           seed=9))
            try:
                tparallel.make_mesh(3, device='cpu')
            except ValueError as e:
                out['mesh_error'] = str(e)
        results.put((rank, out))
    finally:
        dist.destroy_process_group()


def _spawn(world, tmpdir, timeout=300):
    ctx = torch.multiprocessing.get_context('spawn')
    results = ctx.Queue()
    port = tparallel.free_port()
    procs = [ctx.Process(target=_worker,
                         args=(rank, world, port, str(tmpdir), results))
             for rank in range(world)]
    for proc in procs:
        proc.start()
    try:
        got = dict(results.get(timeout=timeout) for _ in range(world))
    finally:
        for proc in procs:
            proc.join(60)
            if proc.is_alive():
                proc.kill()
                proc.join()
    assert [proc.exitcode for proc in procs] == [0] * world
    # Every rank ends with the same merged accumulator.
    for rank in range(1, world):
        for name, value in got[0].items():
            if isinstance(value, dict):
                for k in value:
                    np.testing.assert_array_equal(value[k], got[rank][name][k])
    return got[0]


@pytest.fixture(scope='module')
def world2(tmp_path_factory):
    return _spawn(2, tmp_path_factory.mktemp('world2'))


@pytest.fixture(scope='module')
def world4(tmp_path_factory):
    return _spawn(4, tmp_path_factory.mktemp('world4'))


@functools.lru_cache(maxsize=None)
def _single(name, rounds, seed, waves=1):
    state = tpkg.render(_packed(name), tpkg.RenderConfig(
        width=W, height=H, waves=waves), rounds, seed=seed)
    return dict(xyz=state['accum']['xyz'].numpy(),
                count=state['accum']['count'].numpy(),
                lane=state['lane'].numpy())


def _image(accum):
    return tpkg.resolve({k: torch.from_numpy(v) for k, v in accum.items()
                         if k != 'lane'}, W, H,
                        lane=torch.from_numpy(accum['lane'])).numpy()


def _assert_accum_equal(got, want):
    for key in ('xyz', 'count', 'lane'):
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


@pytest.mark.parametrize('world', [2, 4])
def test_pixel_sharded_matches_single_process(world, world2, world4):
    """Pixel sharding is a pure partition: same seeds, same slots -> the
    merged accumulator and its image equal the single process's."""
    got = (world2 if world == 2 else world4)['pixel']
    want = _single('cornell', 12, seed=5)
    _assert_accum_equal(got, want)
    np.testing.assert_array_equal(_image(got), _image(want))


def test_batch_rows_add_the_single_renders_at_seed_and_seed_plus_one(world2):
    """batch=2: row b renders at seed + b; the all-reduce adds the two
    rows' accumulators, and two terms add alike in either order."""
    got = world2['batch']
    rows = [_single('cornell', 8, seed=7 + b) for b in range(2)]
    np.testing.assert_array_equal(got['count'],
                                  rows[0]['count'] + rows[1]['count'])
    np.testing.assert_array_equal(got['xyz'], rows[0]['xyz'] + rows[1]['xyz'])
    np.testing.assert_array_equal(got['lane'], rows[0]['lane'])


def test_batch_sharding_accumulates_more_samples(world4):
    """batch=4: four independent rows, about four times the samples of one
    process, and an image that differs from the one-row image."""
    got = world4['batch_rows']
    single = _single('cornell', 10, seed=9)
    ratio = got['count'].sum() / max(single['count'].sum(), 1.0)
    assert 3.0 < ratio < 5.0, ratio
    np.testing.assert_array_equal(
        got['count'], sum(_single('cornell', 10, seed=9 + b)['count']
                          for b in range(4)))
    img = _image(got)
    assert np.isfinite(img).all() and img.max() > 0.01
    assert np.abs(img - _image(single)).max() > 1e-4


def test_sharded_resume_bitwise(world4):
    """8 rounds in one call equal 4 + 4 through the returned state."""
    one = world4['resume_one_call']
    _assert_accum_equal(world4['resume_second'], one)
    assert world4['resume_first']['count'].sum() < one['count'].sum()


def test_sharded_checkpoint_roundtrip(world4):
    """Each rank saves its shard to a file of its own and loads it: the
    render continued from the loaded state equals the one continued from
    the state in memory."""
    _assert_accum_equal(world4['ckpt_restored'], world4['ckpt_direct'])
    assert world4['ckpt_direct']['count'].sum() > 0


def test_waves_sharded_matches_single_process(world4):
    """waves=2 over 4 pixel shards: the merged accumulator is the single
    process's in lane order (each shard sorted by lane) and the image is
    equal bit for bit."""
    got = world4['waves']
    want = _single('cornell', 8, seed=5, waves=2)
    slots = np.arange(want['lane'].size).reshape(4, -1)
    order = np.concatenate([s[np.argsort(want['lane'][s], kind='stable')]
                            for s in slots])
    _assert_accum_equal(got, {k: v[..., order] for k, v in want.items()})
    np.testing.assert_array_equal(_image(got), _image(want))


def test_mesh_scene_sharded_matches_single(world4):
    """The instanced blob scene through inst_trace_plain, pixel-sharded:
    each slot traces its own ray, so the accumulator is the single
    process's bit for bit."""
    got = world4['mesh_scene']
    want = _single('blob', 4, seed=2)
    _assert_accum_equal(got, want)
    assert got['count'].sum() > 0


def test_make_mesh_errors(world4):
    """batch * pixels must be the world size (the JAX package's
    ValueError); a world of one is set up when no process group exists;
    without a card, device='cuda' raises and starts no CPU group."""
    assert world4['mesh_error'].startswith(
        'mesh wants batch*pixels = 3*1 devices but the process group has '
        '4 ranks')
    if torch.cuda.device_count() < 2:
        with pytest.raises(RuntimeError):
            tparallel.dryrun_multichip(2, device='cuda')
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            tparallel.make_mesh(device='cuda')
        assert not dist.is_initialized()
    try:
        mesh = tparallel.make_mesh(device='cpu')
        assert mesh.shape == {'batch': 1, 'pixels': 1}
        assert mesh.coords == (0, 0) and dist.get_world_size() == 1
        with pytest.raises(ValueError, match=r'mesh wants batch\*pixels'):
            tparallel.make_mesh(batch=2, device='cpu')
        packed = _packed('cornell')
        got = _numpy(tparallel.render_sharded(
            packed, tpkg.RenderConfig(width=W, height=H), 4, mesh, seed=3))
        _assert_accum_equal(got, _single('cornell', 4, seed=3))
    finally:
        dist.destroy_process_group()


def test_dryrun_multichip_cpu():
    """Two gloo ranks, batch 2: one sharded render of the viking hall and
    a resumed round, as __graft_entry__.dryrun_multichip does."""
    report = tparallel.dryrun_multichip(2, device='cpu')
    assert report['ok'] and report['backend'] == 'gloo'
    assert report['mesh'] == {'batch': 2, 'pixels': 1}
    assert report['lanes_per_rank'] == W * H and report['image_mean'] > 0


def test_reset_sharded_matches_jax():
    """The port's reset_sharded shards against the JAX package's
    reset_sharded on the 8-device virtual mesh (batch 2 x pixels 4,
    waves=2): rank (b, p) holds the JAX state's lane block b * 4 + p."""
    import jax
    import path_tracer_tpu as jpkg
    from path_tracer_tpu.parallel import render as jparallel
    from path_tracer_tpu.scene.procedural import make_cornell_scene as jcornell

    jmesh = jparallel.make_mesh(jax.devices()[:8], batch=2, pixels=4)
    jconfig = jpkg.RenderConfig(width=W, height=H, waves=2)
    jstate = jparallel.reset_sharded(
        jpkg.compile_scene(jcornell(), aspect_ratio=W / H), jconfig, jmesh,
        seed=3)
    packed = _packed('cornell')
    config = tpkg.RenderConfig(width=W, height=H, waves=2)
    per = 2 * W * H // 4
    for b in range(2):
        for p in range(4):
            mesh = tparallel.Mesh(shape={'batch': 2, 'pixels': 4},
                                  coords=(b, p), device=torch.device('cpu'))
            state = tparallel.reset_sharded(packed, config, mesh, seed=3)
            block = slice((b * 4 + p) * per, (b * 4 + p + 1) * per)
            np.testing.assert_array_equal(state['lane'].numpy(),
                                          np.asarray(jstate['lane'])[block])
            np.testing.assert_array_equal(
                state['rng_state'].numpy(),
                np.asarray(jstate['rng_state'])[block].astype(np.int64))
            for key in ('origin', 'direction'):
                np.testing.assert_allclose(
                    state[key].numpy(), np.asarray(jstate[key])[..., block],
                    rtol=2e-5, atol=2e-6)
            np.testing.assert_array_equal(
                state['path']['lambda0'].numpy(),
                np.asarray(jstate['path']['lambda0'])[block])
