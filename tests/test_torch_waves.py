"""RenderConfig.waves > 1 in the port against the JAX package: the slot
layout of `reset`, the per-pixel fold of `resolve`, and a waves=4 render.

Mirrors the single-device tests of tests/test_waves.py. A state holds
waves * width * height slots, slot -> pixel lane is slot % n_pixels and
the RNG stream id is the slot itself; resolve adds XYZ and counts per
pixel before the divide.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import path_tracer_tpu as jpkg
import path_tracer_tpu_torch as tpkg
from path_tracer_tpu.scene.procedural import make_cornell_scene as jcornell
from path_tracer_tpu_torch.scene.procedural import make_cornell_scene as tcornell

W, H = 32, 16


@pytest.fixture(scope='module')
def packed():
    return tpkg.compile_scene(tcornell(), aspect_ratio=W / H, device='cpu')


def test_reset_waves_slots_and_streams(packed):
    """Slots, lanes and RNG streams of a waves=3 state, equal to the JAX
    package's; wave 0 is bit for bit the waves=1 state."""
    config = tpkg.RenderConfig(width=W, height=H, waves=3)
    state = tpkg.reset(packed, config, seed=7)
    n_pix = W * H
    lane = state['lane'].numpy()
    assert lane.shape == (3 * n_pix,)
    np.testing.assert_array_equal(lane, np.tile(np.arange(n_pix), 3))
    rng = state['rng_state'].numpy()
    assert len(np.unique(rng)) == 3 * n_pix
    base = tpkg.reset(packed, tpkg.RenderConfig(width=W, height=H), seed=7)
    np.testing.assert_array_equal(state['origin'][:, :n_pix].numpy(),
                                  base['origin'].numpy())
    np.testing.assert_array_equal(rng[:n_pix], base['rng_state'].numpy())

    jp = jpkg.compile_scene(jcornell(), aspect_ratio=W / H)
    js = jpkg.reset(jp, jpkg.RenderConfig(width=W, height=H, waves=3), 7)
    np.testing.assert_array_equal(lane, np.asarray(js['lane']))
    np.testing.assert_array_equal(rng, np.asarray(js['rng_state']).astype(np.int64))
    np.testing.assert_array_equal(state['path']['lambda0'].numpy(),
                                  np.asarray(js['path']['lambda0']))
    for key in ('origin', 'direction'):
        np.testing.assert_allclose(state[key].numpy(), np.asarray(js[key]),
                                   rtol=2e-5, atol=2e-6)


def test_resolve_folds_repeated_lanes_exactly():
    """Two slots of one pixel fold to sum(xyz) / sum(count), as a single
    slot with that ratio resolves, and as the JAX package folds them."""
    n_pix = W * H
    lane = torch.cat([torch.arange(n_pix, dtype=torch.int32)] * 2)
    xyz = torch.cat([torch.full((3, n_pix), 0.2), torch.full((3, n_pix), 0.6)], 1)
    count = torch.cat([torch.full((n_pix,), 1.0), torch.full((n_pix,), 3.0)])
    img = tpkg.resolve(dict(xyz=xyz, count=count), W, H, lane=lane).numpy()
    ref = tpkg.resolve(dict(xyz=torch.full((3, n_pix), 0.2),
                            count=torch.ones(n_pix)), W, H).numpy()
    np.testing.assert_allclose(img, ref, atol=1e-6)
    jimg = np.asarray(jpkg.resolve(
        dict(xyz=jnp.asarray(xyz.numpy()), count=jnp.asarray(count.numpy())),
        W, H, lane=jnp.asarray(lane.numpy())))
    np.testing.assert_allclose(img, jimg, atol=1e-6)


def test_waves_render_accumulates_and_agrees(packed):
    """24 rounds at 1 and at 4 waves: four times the samples, the same
    estimate within noise, not the same bits; and the waves=4 state's
    first 4 rounds equal the JAX package's slot for slot in the sample
    counts, and its frame lies within bench.py's band floor (2%) of
    the JAX package's."""
    rounds = 24
    base = tpkg.render(packed, tpkg.RenderConfig(width=W, height=H), rounds,
                       seed=3)
    multi = tpkg.render(packed, tpkg.RenderConfig(width=W, height=H, waves=4),
                        rounds, seed=3)
    c1 = float(base['accum']['count'].sum())
    c4 = float(multi['accum']['count'].sum())
    assert 3.5 < c4 / c1 < 4.5, (c1, c4)
    img1 = tpkg.resolve(base['accum'], W, H, lane=base['lane']).numpy()
    img4 = tpkg.resolve(multi['accum'], W, H, lane=multi['lane']).numpy()
    assert np.isfinite(img4).all()
    assert np.abs(img4.mean() - img1.mean()) / (img1.mean() + 1e-3) < 0.1
    assert np.abs(img4 - img1).max() > 1e-4

    config = dict(width=W, height=H, waves=4)
    jp = jpkg.compile_scene(jcornell(), aspect_ratio=W / H)
    js = jpkg.render(jp, jpkg.RenderConfig(**config), 4, seed=3)
    ts = tpkg.render(packed, tpkg.RenderConfig(**config), 4, seed=3)
    np.testing.assert_array_equal(ts['accum']['count'].numpy(),
                                  np.asarray(js['accum']['count']))
    ref = np.asarray(jpkg.resolve(js['accum'], W, H, lane=js['lane']))
    img = tpkg.resolve(ts['accum'], W, H, lane=ts['lane']).numpy()
    rel = np.abs(img - ref).mean() / (ref.mean() + 1e-3)
    bias = abs(img.mean() - ref.mean()) / (ref.mean() + 1e-3)
    assert rel < 0.02 and bias < 0.02, (rel, bias)


@pytest.mark.parametrize('waves', [1, 4])
@pytest.mark.parametrize('shuffled', [False, True])
def test_resolve_fold_matches_jax(waves, shuffled):
    """The fixed-order fold of `resolve` against the JAX package's
    scatter-add, on random accumulators of the reset layout (the waves
    summed per lane) and with the slots shuffled (sorted by pixel, then
    added rank by rank); counts include empty slots and a frame that is
    not a whole number of 32x8 tiles takes the unswizzled lane map too."""
    for w, h in ((W, H), (20, 6)):
        n = waves * w * h
        rng = np.random.default_rng(waves + 10 * shuffled + w)
        xyz = rng.uniform(0.0, 3.0, (3, n)).astype(np.float32)
        count = rng.integers(0, 5, n).astype(np.float32)
        lane = (np.arange(n) % (w * h)).astype(np.int32)
        if shuffled:
            perm = rng.permutation(n)
            xyz, count, lane = xyz[:, perm], count[perm], lane[perm]
        got = tpkg.resolve(dict(xyz=torch.from_numpy(xyz),
                                count=torch.from_numpy(count)), w, h,
                           brightness=1.5, lane=torch.from_numpy(lane))
        want = jpkg.resolve(dict(xyz=jnp.asarray(xyz),
                                 count=jnp.asarray(count)), w, h,
                            brightness=1.5, lane=jnp.asarray(lane))
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=2e-5, atol=2e-6)
        _, pix_count = tpkg.integrator.resolve.fold(
            torch.from_numpy(xyz), torch.from_numpy(count),
            torch.from_numpy(lane), w, h)
        assert float(pix_count.sum()) == float(count.sum())
