"""Tone mapping operators: Clamp, Reinhard-extended, Hable filmic, ACES.

Port of path_tracer_tpu/core/tonemap.py (resolve.glsl:60-110). All
operate on channels-first linear-sRGB colors of shape (3, ...).
"""

from __future__ import annotations

import numpy as np
import torch

from .constants import (
    TONE_MAPPING_MODE_ACES,
    TONE_MAPPING_MODE_CLAMP,
    TONE_MAPPING_MODE_HABLE,
    TONE_MAPPING_MODE_REINHARD,
)

_LUMA = np.array([0.2126, 0.7152, 0.0722], dtype=np.float32)

# ACES fitted matrices (resolve.glsl:90-102), row-major.
_ACES_INPUT = np.array(
    [
        [0.59719, 0.35458, 0.04823],
        [0.07600, 0.90834, 0.01566],
        [0.02840, 0.13383, 0.83777],
    ],
    dtype=np.float32,
)
_ACES_OUTPUT = np.array(
    [
        [1.60475, -0.53108, -0.07367],
        [-0.10208, 1.10813, -0.00605],
        [-0.00327, -0.07276, 1.07602],
    ],
    dtype=np.float32,
)


def _apply(matrix, color):
    m = torch.as_tensor(matrix, device=color.device)
    return torch.tensordot(m, color, dims=([1], [0]))


def luminance(color):
    """color: (3, ...) -> (...)."""
    luma = torch.as_tensor(_LUMA, device=color.device)
    return torch.tensordot(luma, color, dims=([0], [0]))


def tonemap_clamp(color):
    return torch.clamp(color, 0.0, 1.0)


def tonemap_reinhard(color, white_level=1.0):
    old_l = torch.clamp(luminance(color), min=1e-12)
    max_l = float(white_level)
    n = old_l * (1.0 + old_l / (max_l * max_l))
    new_l = n / (1.0 + old_l)
    return color * (new_l / old_l)


def _hable_partial(x):
    a, b, c, d, e, f = 0.15, 0.50, 0.10, 0.20, 0.02, 0.30
    return (x * (a * x + c * b) + d * e) / (x * (a * x + b) + d * f) - e / f


def tonemap_hable(color):
    exposure_bias = 2.0
    current = _hable_partial(color * exposure_bias)
    white = torch.tensor(11.2, dtype=torch.float32, device=color.device)
    return current * (1.0 / _hable_partial(white))


def tonemap_aces(color):
    v = _apply(_ACES_INPUT, color)
    a = v * (v + 0.0245786) - 0.000090537
    b = v * (0.983729 * v + 0.4329510) + 0.238081
    return _apply(_ACES_OUTPUT, a / b)


def tonemap(color, mode, white_level=1.0):
    """Apply the tone mapping operator selected by the int `mode`."""
    if mode == TONE_MAPPING_MODE_CLAMP:
        return tonemap_clamp(color)
    if mode == TONE_MAPPING_MODE_REINHARD:
        return tonemap_reinhard(color, white_level)
    if mode == TONE_MAPPING_MODE_HABLE:
        return tonemap_hable(color)
    if mode == TONE_MAPPING_MODE_ACES:
        return tonemap_aces(color)
    raise ValueError(f'unknown tone mapping mode {mode}')
