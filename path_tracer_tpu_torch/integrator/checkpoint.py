"""Render-state checkpoint/resume.

Port of path_tracer_tpu/integrator/checkpoint.py, with the same file
layout: one npz holding `leaf_{i}` per leaf of the state dict, in the
order in which the JAX package's pytree flattening visits a dict (keys
sorted, recursively), each leaf in the JAX package's dtype, and a
`treedef` string that spells the structure. A checkpoint written by
either package therefore loads in the other, and one written on the
card loads on the CPU.

The RNG state rides in an int64 tensor here (core/sampling.py) and is
stored as the uint32 the JAX package keeps it in.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils import log


def _leaves(tree):
    """The leaves of a nested dict in the JAX package's flattening order."""
    if isinstance(tree, dict):
        return [leaf for key in sorted(tree) for leaf in _leaves(tree[key])]
    return [tree]


def _treedef(tree):
    """The repr the JAX package writes for the state's pytree structure."""
    if isinstance(tree, dict):
        return '{%s}' % ', '.join(f'{key!r}: {_treedef(tree[key])}'
                                  for key in sorted(tree))
    return '*'


def _unflatten(like, leaves):
    if isinstance(like, dict):
        return {key: _unflatten(like[key], leaves) for key in sorted(like)}
    return next(leaves)


def _stored(leaf):
    """A leaf as the JAX package stores it: int64 (the RNG state) as uint32."""
    arr = leaf.detach().cpu().numpy()
    return arr.astype(np.uint32) if arr.dtype == np.int64 else arr


def save_render_state(path, state):
    """Write the render state (wavefront.reset/render output) to npz."""
    with log.timer('checkpoint.save', path=str(path)):
        arrays = {f'leaf_{i}': _stored(leaf)
                  for i, leaf in enumerate(_leaves(state))}
        np.savez_compressed(path, treedef=f'PyTreeDef({_treedef(state)})',
                            **arrays)


def load_render_state(path, like_state, device='cuda'):
    """Load a checkpoint into the structure of `like_state` (e.g. a fresh
    wavefront.reset output of the same config), which gives the
    structure, shapes and dtypes; the tensors are placed on `device`."""
    z = np.load(path, allow_pickle=False)
    loaded = []
    for i, leaf in enumerate(_leaves(like_state)):
        arr = z[f'leaf_{i}']
        if arr.shape != tuple(leaf.shape):
            raise ValueError(f'checkpoint leaf {i} shape {arr.shape} != '
                             f'expected {tuple(leaf.shape)}')
        dtype = torch.empty((), dtype=leaf.dtype).numpy().dtype
        loaded.append(torch.from_numpy(arr.astype(dtype)).to(device))
    return _unflatten(like_state, iter(loaded))
