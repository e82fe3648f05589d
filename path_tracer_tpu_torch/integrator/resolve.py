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


def resolve(accum, width, height, brightness=1.0, mode=0, white_level=1.0,
            lane=None):
    """Resolve the (3, N) + (N,) accumulator into an (H, W, 3) image.

    `lane` is each slot's pixel lane (default: slot % (width * height)).
    Slots that share a pixel (RenderConfig.waves > 1) are added per
    pixel before the divide, the Monte-Carlo estimator over all of the
    pixel's samples.
    """
    xyz = accum['xyz']
    count = accum['count']
    n = xyz.shape[1]
    if lane is None:
        lane = torch.arange(n, dtype=torch.int32, device=xyz.device) % (width * height)
    px, py = lane_to_pixel(lane, width, height)
    flat = (py * width + px).long()
    pix_xyz = torch.zeros((3, width * height), dtype=torch.float32,
                          device=xyz.device).index_add_(1, flat, xyz)
    pix_count = torch.zeros((width * height,), dtype=torch.float32,
                            device=xyz.device).index_add_(0, flat, count)
    color = xyz_to_srgb(pix_xyz * (float(brightness) / torch.clamp(pix_count, min=1.0)))
    color = torch.where(pix_count > 0, color, torch.zeros_like(color))
    color = tonemap(color, mode, white_level)
    # The reference writes to a UNORM swapchain image, which clamps.
    color = torch.clamp(color, 0.0, 1.0)
    return color.reshape(3, height, width).permute(1, 2, 0)
