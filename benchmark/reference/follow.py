"""What the reference works out at the sampled lanes: the reset state,
one round (trace, scatter, accumulate, respawn) from the state the
program hands over, and the resolved pixels of an accumulator.

The program's round loop cannot be replayed from the seed at the timed
sizes (hundreds of rounds over millions of lanes), so the reference
follows one round from the program's own state, and checks the reset
and the resolve by themselves. Lanes are independent within a round,
so a sample of lanes is followed exactly.

`dtype=torch.bfloat16` gives the control: every floating input (the
state and the scene tables) is rounded to bfloat16, the triangle tests
run in bfloat16, and the hit records and the results are rounded to
bfloat16 as they are produced.
"""

from __future__ import annotations

import dataclasses

import torch

from .plain.core.constants import RENDER_FLAG_ACCUMULATE
from .plain.core.sampling import Rng
from .plain.core.spectrum import xyz_to_srgb
from .plain.core.tonemap import tonemap
from .plain.integrator.scatter import scatter
from .plain.integrator.state import merge_paths, new_paths
from .trace import trace


def rounded(x, dtype):
    """x with its floating tensors rounded to `dtype` and back (nested
    dicts, lists and dataclasses too); other values as they are."""
    if dtype == torch.float32:
        return x
    if isinstance(x, torch.Tensor):
        return x.to(dtype).to(x.dtype) if x.is_floating_point() else x
    if isinstance(x, dict):
        return {k: rounded(v, dtype) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(rounded(v, dtype) for v in x)
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        out = dataclasses.replace(x, **{f.name: rounded(getattr(x, f.name), dtype)
                                        for f in dataclasses.fields(x)})
        for attr in ('host_layout', 'host_camera_models'):
            if hasattr(x, attr):
                setattr(out, attr, getattr(x, attr))
        return out
    return x


def reset(packed, camera, width, height, seed, slot, flags):
    """The reset state of the slots `slot` ((K,) int): fresh paths from
    the camera, the RNG seeded per slot, an empty accumulator."""
    lane = slot % (width * height)
    rng = Rng.seed(slot, seed)
    path, origin, direction = new_paths(packed, camera[0], camera[1], width,
                                        height, rng, flags, lane)
    k = slot.shape[0]
    accum = dict(xyz=torch.zeros((3, k), dtype=torch.float32, device=slot.device),
                 count=torch.zeros((k,), dtype=torch.float32, device=slot.device))
    return dict(path=path, origin=origin, direction=direction, accum=accum,
                rng_state=rng.state, lane=lane)


def round_(packed, layout, instances, camera, width, height, flags, state,
           termination_probability, dtype=torch.float32):
    """One round from `state` (the sampled lanes' state before it).
    Returns (state after, hit records)."""
    packed = rounded(packed, dtype)
    state = rounded(state, dtype)
    origin, direction = state['origin'], state['direction']
    hit = rounded(trace(packed, layout, instances, origin, direction, dtype),
                  dtype)
    rng = Rng(state['rng_state'])
    path, new_origin, new_direction, alive = scatter(
        packed, state['path'], origin, direction, hit, rng,
        termination_probability, layout)
    dead = ~alive
    accum = state['accum']
    if flags & RENDER_FLAG_ACCUMULATE:
        xyz = accum['xyz'] + torch.where(dead, path['sample'],
                                         torch.zeros_like(path['sample']))
        count = accum['count'] + dead.to(torch.float32)
    else:
        xyz = torch.where(dead, path['sample'], accum['xyz'])
        count = torch.where(dead, torch.ones_like(accum['count']), accum['count'])
    fresh, cam_origin, cam_direction = new_paths(
        packed, camera[0], camera[1], width, height, rng, flags, state['lane'])
    after = dict(
        path=merge_paths(path, fresh, dead),
        origin=torch.where(dead, cam_origin, new_origin),
        direction=torch.where(dead, cam_direction, new_direction),
        accum=dict(xyz=xyz, count=count),
        rng_state=rng.state,
        lane=state['lane'],
    )
    return rounded(after, dtype), hit


def resolve_pixels(xyz, count, brightness, mode, dtype=torch.float32):
    """Display values (3, K) of K pixels from their accumulated (3, K, W)
    XYZ and (K, W) counts over their W slots (added in slot order)."""
    xyz, count = rounded((xyz, count), dtype)
    sum_xyz, sum_count = xyz[:, :, 0], count[:, 0]
    for w in range(1, xyz.shape[2]):
        sum_xyz = sum_xyz + xyz[:, :, w]
        sum_count = sum_count + count[:, w]
    color = xyz_to_srgb(sum_xyz * (float(brightness)
                                   / torch.clamp(sum_count, min=1.0)))
    color = torch.where(sum_count > 0, color, torch.zeros_like(color))
    color = rounded(tonemap(rounded(color, dtype), mode), dtype)
    return torch.clamp(color, 0.0, 1.0)
