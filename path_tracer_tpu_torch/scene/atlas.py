# Copied from path_tracer_tpu/scene/atlas.py (numpy-only host code shared with the JAX package).
"""Texture atlas packing into fixed-size float32 array layers.

Equivalent of the reference's stb_rect_pack-based atlas
(reference src/scene/scene.cpp:1119-1233): textures are packed into
square RGBA32F layers; reflectance/radiance texels are uplifted to
parametric-spectrum coefficients at pack time so the device only ever
samples (beta.xyz, intensity/alpha) texels. Uses a simple skyline/shelf
packer (sufficient and deterministic; packing quality only affects
memory, not correctness).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np

from ..core.constants import (
    TEXTURE_FLAG_FILTER_NEAREST,
    TEXTURE_TYPE_RADIANCE,
    TEXTURE_TYPE_RAW,
    TEXTURE_TYPE_REFLECTANCE_WITH_ALPHA,
)
from ..core import uplift


@dataclass
class PackedTextureMeta:
    placement_min: np.ndarray  # (2,) normalized atlas UV of texel centers
    placement_max: np.ndarray
    layer: int
    type: int
    flags: int


def _shelf_pack(sizes, atlas_size):
    """Shelf-pack rects (w, h) into layers of atlas_size^2.

    Returns list of (layer, x, y) per rect, packed in descending height.
    """
    order = sorted(range(len(sizes)), key=lambda i: -sizes[i][1])
    placements = [None] * len(sizes)
    layers = [{'shelves': [], 'cursor_y': 0}]

    for i in order:
        w, h = sizes[i]
        if w > atlas_size or h > atlas_size:
            raise ValueError(f'texture {i} ({w}x{h}) exceeds atlas size {atlas_size}')
        placed = False
        for layer_idx, layer in enumerate(layers):
            for shelf in layer['shelves']:
                if h <= shelf['height'] and shelf['cursor_x'] + w <= atlas_size:
                    placements[i] = (layer_idx, shelf['cursor_x'], shelf['y'])
                    shelf['cursor_x'] += w
                    placed = True
                    break
            if placed:
                break
            if layer['cursor_y'] + h <= atlas_size:
                shelf = {'y': layer['cursor_y'], 'height': h, 'cursor_x': w}
                layer['shelves'].append(shelf)
                layer['cursor_y'] += h
                placements[i] = (layer_idx, 0, shelf['y'])
                placed = True
                break
        if not placed:
            layers.append({'shelves': [{'y': 0, 'height': h, 'cursor_x': w}],
                           'cursor_y': h})
            placements[i] = (len(layers) - 1, 0, 0)

    return placements, len(layers)


def choose_atlas_size(textures, max_size=4096):
    """Smallest power-of-two square that can hold the largest texture and
    roughly the total area."""
    if not textures:
        return 8
    max_dim = max(max(t.width, t.height) for t in textures)
    total_area = sum(t.width * t.height for t in textures)
    size = 8
    while size < max_size and (size < max_dim or size * size < total_area):
        size *= 2
    return min(size, max_size)


def pack_textures(textures, spectrum_table=None, atlas_size=None):
    """Pack texture assets into atlas layers with spectral uplift.

    Returns (atlas: (L, S, S, 4) float32, metas: List[PackedTextureMeta]).
    Texel transforms match scene.cpp:1183-1212: RAW is copied verbatim;
    REFLECTANCE_WITH_ALPHA stores (beta, alpha); RADIANCE stores
    (beta, intensity) with intensity = 2 * max(rgb).
    """
    if not textures:
        return np.zeros((1, 8, 8, 4), np.float32), []

    size = atlas_size or choose_atlas_size(textures)
    placements, num_layers = _shelf_pack(
        [(t.width, t.height) for t in textures], size)

    atlas = np.zeros((num_layers, size, size, 4), np.float32)
    metas: List[PackedTextureMeta] = []

    for texture, (layer, x, y) in zip(textures, placements):
        pixels = np.asarray(texture.pixels, np.float32)
        h, w = pixels.shape[:2]
        if pixels.shape[-1] == 3:
            pixels = np.concatenate([pixels, np.ones((h, w, 1), np.float32)], -1)

        if texture.type == TEXTURE_TYPE_RAW:
            out = pixels
        elif texture.type == TEXTURE_TYPE_REFLECTANCE_WITH_ALPHA:
            beta = uplift.rgb_to_coefficients(pixels[..., :3], spectrum_table)
            out = np.concatenate([beta, pixels[..., 3:4]], -1)
        elif texture.type == TEXTURE_TYPE_RADIANCE:
            intensity = 2.0 * pixels[..., :3].max(axis=-1, keepdims=True)
            safe = np.maximum(intensity, 1e-6)
            beta = uplift.rgb_to_coefficients(pixels[..., :3] / safe, spectrum_table)
            out = np.where(intensity > 1e-6,
                           np.concatenate([beta, intensity], -1),
                           np.zeros_like(pixels))
        else:
            raise ValueError(f'unknown texture type {texture.type}')

        atlas[layer, y:y + h, x:x + w] = out

        # Placement in normalized coordinates at half-texel centers
        # (scene.cpp:1168-1177). V axis follows the reference's image-row
        # convention: min = bottom row center, max = top row center.
        metas.append(PackedTextureMeta(
            placement_min=np.array([(x + 0.5) / size, (y + h - 0.5) / size], np.float32),
            placement_max=np.array([(x + w - 0.5) / size, (y + 0.5) / size], np.float32),
            layer=layer,
            type=texture.type,
            flags=TEXTURE_FLAG_FILTER_NEAREST if texture.enable_nearest_filtering else 0,
        ))

    return atlas, metas
