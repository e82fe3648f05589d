# Frozen copy of path_tracer_tpu_torch/core/uplift.py, part of the benchmark's
# plain reference: not kept in step with the program.
"""RGB -> reflectance-spectrum uplift (Jakob-Hanika parametric spectra):
the lookup of the sRGB -> sigmoid-polynomial coefficient table
(data/srgb_spectrum_table.npz, 3 max-channel slices x 64 scale bins x
64x64 color bins). The program's fit that builds the table is not
copied: the reference reads the table as an input."""

from __future__ import annotations

import os
import threading

import numpy as np

COLOR_BINS = 64
SCALE_BINS = 64


def index_to_scale(k):
    """Smoothstep^2-warped scale for bin k (spectrum.cpp:306-313)."""
    r = np.asarray(k, np.float64) / (SCALE_BINS - 1)
    s = r * r * (3.0 - 2.0 * r)
    return s * s * (3.0 - 2.0 * s)


_SCALES = index_to_scale(np.arange(SCALE_BINS))


# The table is a data file of the repository, read as an input (the
# program reads the same file); the reference never builds or writes it.
_DEFAULT_CACHE = os.path.join(os.path.dirname(__file__), '..', '..', '..',
                              '..', 'data', 'srgb_spectrum_table.npz')
_TABLE_LOCK = threading.Lock()
_TABLE = None


def get_table(cache_path=None):
    """Load the sRGB spectrum table."""
    global _TABLE
    with _TABLE_LOCK:
        if _TABLE is not None:
            return _TABLE
        path = os.path.abspath(cache_path or _DEFAULT_CACHE)
        _TABLE = np.load(path)['coefficients']
        return _TABLE


def rgb_to_coefficients(rgb, table=None):
    """Vectorized trilinear lookup of spectrum coefficients for sRGB colors.

    rgb: (..., 3) in [0, 1]. Returns (..., 3) denormalized coefficients.
    Matches GetParametricSpectrumCoefficients (spectrum.cpp:439-479).
    """
    if table is None:
        table = get_table()
    n, m = COLOR_BINS, SCALE_BINS
    rgb = np.clip(np.asarray(rgb, np.float64), 0.0, 1.0)
    shape = rgb.shape[:-1]
    c = rgb.reshape(-1, 3)

    # Max channel, later channel winning ties (spectrum.cpp:342-346).
    rows = np.arange(len(c))
    l = np.zeros(len(c), np.int64)
    l = np.where(c[:, 1] >= c[rows, l], 1, l)
    l = np.where(c[:, 2] >= c[rows, l], 2, l)

    scale = np.maximum(c[np.arange(len(c)), l], 1e-6)
    x = (n - 1) * c[np.arange(len(c)), (l + 1) % 3] / scale
    y = (n - 1) * c[np.arange(len(c)), (l + 2) % 3] / scale

    i = np.minimum(x.astype(np.int64), n - 2)
    j = np.minimum(y.astype(np.int64), n - 2)
    k = np.minimum(np.searchsorted(_SCALES, scale, side='left') - 1, m - 2)
    k = np.maximum(k, 0)

    s0 = _SCALES[k]
    s1 = _SCALES[k + 1]
    ax = (x - i)[:, None]
    ay = (y - j)[:, None]
    az = ((scale - s0) / (s1 - s0))[:, None]

    def t(dk, dj, di):
        return table[l, k + dk, j + dj, i + di].astype(np.float64)

    b00 = t(0, 0, 0) * (1 - ax) + t(0, 0, 1) * ax
    b01 = t(0, 1, 0) * (1 - ax) + t(0, 1, 1) * ax
    b10 = t(1, 0, 0) * (1 - ax) + t(1, 0, 1) * ax
    b11 = t(1, 1, 0) * (1 - ax) + t(1, 1, 1) * ax
    b0 = b00 * (1 - ay) + b01 * ay
    b1 = b10 * (1 - ay) + b11 * ay
    beta = b0 * (1 - az) + b1 * az
    return beta.reshape(*shape, 3).astype(np.float32)
