# Frozen copy of path_tracer_tpu_torch/integrator/resolve.py, part of the benchmark's
# plain reference: not kept in step with the program.
"""Resolve pass: accumulator -> tone-mapped sRGB image.

Port of path_tracer_tpu/integrator/resolve.py
(reference src/integrator/resolve.glsl): fold the slots per
pixel, divide XYZ by the sample count, apply brightness, convert to
linear sRGB and tone map.
"""

from __future__ import annotations

import torch

from ..core.spectrum import xyz_to_srgb
from ..core.tonemap import tonemap
from .state import lane_to_pixel


def fold(xyz, count, lane, width, height):
    """Per-pixel sums of the (3, N) XYZ and (N,) counts of the slots,
    each pixel's slots added in slot order, so that the result is the
    same on every run (`index_add_` adds through float atomics on the
    card, in no fixed order).

    The layout that `wavefront.reset` gives (slot s on lane s % (W*H),
    `lane` None or equal to it) sums the wave axis of a (waves, W*H) view
    wave by wave and writes each lane's sum to its pixel: lanes map to
    pixels one to one, so no two writes meet. Any other `lane` (a
    checkpoint's, a merged sharded accumulator's) sorts the slots by
    pixel (stably, so slot order within a pixel), numbers each slot
    within its pixel, and adds the k-th slots of all pixels in the k-th
    step. Returns (pix_xyz (3, W*H), pix_count (W*H,)).
    """
    dev = xyz.device
    n_pix = width * height
    n = xyz.shape[1]
    reset_layout = n % n_pix == 0 and (lane is None or torch.equal(
        lane, torch.arange(n, dtype=lane.dtype, device=dev) % n_pix))
    if reset_layout:
        px, py = lane_to_pixel(torch.arange(n_pix, device=dev), width, height)
        flat = py * width + px
        waves_xyz = xyz.reshape(3, n // n_pix, n_pix)
        waves_count = count.reshape(n // n_pix, n_pix)
        sum_xyz, sum_count = waves_xyz[:, 0], waves_count[0]
        for w in range(1, n // n_pix):
            sum_xyz = sum_xyz + waves_xyz[:, w]
            sum_count = sum_count + waves_count[w]
        pix_xyz = torch.empty((3, n_pix), dtype=torch.float32, device=dev)
        pix_count = torch.empty((n_pix,), dtype=torch.float32, device=dev)
        pix_xyz[:, flat] = sum_xyz
        pix_count[flat] = sum_count
        return pix_xyz, pix_count
    px, py = lane_to_pixel(lane.long(), width, height)
    flat = py * width + px
    order = torch.argsort(flat, stable=True)
    grouped = flat[order]
    rank = (torch.arange(n, device=dev)
            - torch.searchsorted(grouped, grouped))
    by_rank = order[torch.argsort(rank, stable=True)]
    pix_xyz = torch.zeros((3, n_pix), dtype=torch.float32, device=dev)
    pix_count = torch.zeros((n_pix,), dtype=torch.float32, device=dev)
    start = 0
    for size in torch.bincount(rank).tolist():
        slots = by_rank[start:start + size]
        pixels = flat[slots]
        pix_xyz[:, pixels] = pix_xyz[:, pixels] + xyz[:, slots]
        pix_count[pixels] = pix_count[pixels] + count[slots]
        start += size
    return pix_xyz, pix_count


def resolve(accum, width, height, brightness=1.0, mode=0, white_level=1.0,
            lane=None):
    """Resolve the (3, N) + (N,) accumulator into an (H, W, 3) image.

    `lane` is each slot's pixel lane (default: slot % (width * height)).
    Slots that share a pixel (RenderConfig.waves > 1) are added per
    pixel before the divide, the Monte-Carlo estimator over all of the
    pixel's samples, in slot order (`fold`).
    """
    pix_xyz, pix_count = fold(accum['xyz'], accum['count'], lane, width,
                              height)
    color = xyz_to_srgb(pix_xyz * (float(brightness) / torch.clamp(pix_count, min=1.0)))
    color = torch.where(pix_count > 0, color, torch.zeros_like(color))
    color = tonemap(color, mode, white_level)
    # The reference writes to a UNORM swapchain image, which clamps.
    color = torch.clamp(color, 0.0, 1.0)
    return color.reshape(3, height, width).permute(1, 2, 0)
