# Frozen copy of path_tracer_tpu_torch/integrator/state.py, part of the benchmark's
# plain reference: not kept in step with the program.
"""Wavefront path state: channels-first SoA tensors, one lane per slot.

Port of path_tracer_tpu/integrator/state.py. A terminated path deposits
its sample and respawns at the same pixel, so occupancy stays full and
the accumulator needs no scatter until resolve. Lanes map to pixels
through a 32x8 tile swizzle when the frame divides into tiles, so
neighbouring lanes are neighbouring pixels.
"""

from __future__ import annotations

import torch

from ..core.constants import (
    ACTIVE_SHAPE_LIMIT,
    RENDER_FLAG_SAMPLE_JITTER,
    SHAPE_INDEX_NONE,
)
from ..core.sampling import Rng
from ..ops.camera import generate_camera_rays

TILE_W = 32
TILE_H = 8


def use_tile_swizzle(width, height):
    return width % TILE_W == 0 and height % TILE_H == 0


def lane_to_pixel(lane, width, height):
    """Map lane index -> (px, py) with tile swizzling when divisible."""
    if use_tile_swizzle(width, height):
        tile = TILE_W * TILE_H
        tiles_x = width // TILE_W
        t = lane // tile
        w = lane % tile
        px = (t % tiles_x) * TILE_W + w % TILE_W
        py = (t // tiles_x) * TILE_H + w // TILE_W
        return px, py
    return lane % width, lane // width


def pixel_ndc(width, height, rng: Rng, flags, lane):
    """Normalized sample positions (2, N) (basic_scatter.glsl:7-21)."""
    pxi, pyi = lane_to_pixel(lane, width, height)
    px = pxi.to(torch.float32)
    py = pyi.to(torch.float32)
    if flags & RENDER_FLAG_SAMPLE_JITTER:
        jx = rng.uniform()
        jy = rng.uniform()
    else:
        jx = jy = 0.5
    return torch.stack([(px + jx) / width, (py + jy) / height], dim=0)


def new_paths(packed, camera_index, camera_model, width, height, rng: Rng,
              flags, lane):
    """GenerateNewPath for every lane (basic_scatter.glsl:7-42).

    Returns (path_state dict, ray_origin (3, N), ray_direction (3, N)).
    """
    n = lane.shape[0]
    dev = lane.device
    ndc = pixel_ndc(width, height, rng, flags, lane)
    origin, direction = generate_camera_rays(packed, camera_index, camera_model,
                                             ndc, rng)
    state = dict(
        lambda0=rng.uniform(),
        throughput=torch.ones((4, n), dtype=torch.float32, device=dev),
        probability=torch.ones((4, n), dtype=torch.float32, device=dev),
        sample=torch.zeros((3, n), dtype=torch.float32, device=dev),
        active_shapes=torch.full((ACTIVE_SHAPE_LIMIT, n), SHAPE_INDEX_NONE,
                                 dtype=torch.int32, device=dev),
    )
    return state, origin, direction


def merge_paths(old, new, respawn):
    """Select respawned lanes' state (respawn: (N,) bool broadcasts over
    the leading channel axes)."""
    return {key: torch.where(respawn, new[key], old[key]) for key in old}
