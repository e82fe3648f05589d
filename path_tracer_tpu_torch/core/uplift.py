# Copied from path_tracer_tpu/core/uplift.py (numpy-only host code shared with the JAX package).
"""RGB -> reflectance-spectrum uplift (Jakob-Hanika parametric spectra).

Builds and queries the sRGB -> sigmoid-polynomial coefficient table used
to uplift RGB colors and texels into smooth reflectance spectra.
Behavioral reference: reference src/core/spectrum.cpp (table layout
3 max-channel slices x 64 scale bins x 64x64 color bins of vec3
coefficients; Gauss-Newton fit of CIELAB residuals under D65 with
warm-started scale walks). Re-implemented as *batched* numpy float64:
instead of the reference's serial per-bin loops (spectrum.cpp:365-411) we
fit all 3*64*64 = 12288 color bins of one scale step simultaneously,
which turns a minutes-long build into seconds and is the idiomatic
array-programming equivalent.

The fitted table is cached on disk (data/srgb_spectrum_table.npz) and is
bit-stable across runs.
"""

from __future__ import annotations

import os
import threading

import numpy as np

from .constants import CIE_LAMBDA_MIN, CIE_LAMBDA_MAX
from ._d65_data import CIE_ILLUMINANT_D65
from .spectrum import D65_NORMALIZATION

COLOR_BINS = 64
SCALE_BINS = 64

_SAMPLE_COUNT = 471
_DELTA_LAMBDA = (CIE_LAMBDA_MAX - CIE_LAMBDA_MIN + 1) / _SAMPLE_COUNT

_SRGB_TO_XYZ = np.array(
    [
        [+0.4124, +0.3576, +0.1805],
        [+0.2126, +0.7152, +0.0722],
        [+0.0193, +0.1192, +0.9505],
    ],
    dtype=np.float64,
)


def _observer_matrix():
    """(S, 3) matrix of D65-weighted observer responses over normalized lambda."""
    nl = np.arange(_SAMPLE_COUNT, dtype=np.float64) / (_SAMPLE_COUNT - 1)
    lam = CIE_LAMBDA_MIN + (CIE_LAMBDA_MAX - CIE_LAMBDA_MIN) * nl

    def lobe(scale, center, slope_lo, slope_hi):
        t = (lam - center) * np.where(lam < center, slope_lo, slope_hi)
        return scale * np.exp(-0.5 * t * t)

    x = lobe(0.362, 442.0, 0.0624, 0.0374) + lobe(1.056, 599.8, 0.0264, 0.0323) \
        - lobe(0.065, 501.1, 0.0490, 0.0382)
    y = lobe(0.821, 568.8, 0.0213, 0.0247) + lobe(0.286, 530.9, 0.0613, 0.0322)
    z = lobe(1.217, 437.0, 0.0845, 0.0278) + lobe(0.681, 459.0, 0.0385, 0.0725)
    obs = np.stack([x, y, z], axis=-1)

    d65_table = np.asarray(CIE_ILLUMINANT_D65, dtype=np.float64)
    offset = nl * 470.0
    idx = np.clip(offset.astype(np.int64), 0, 469)
    frac = offset - idx
    d65 = d65_table[idx] * (1 - frac) + d65_table[idx + 1] * frac
    weight = d65 / D65_NORMALIZATION * _DELTA_LAMBDA
    return obs * weight[:, None], nl


_OBS_MATRIX, _NORM_LAMBDA = _observer_matrix()


def observe_spectra_under_d65(nbeta):
    """XYZ of batched normalized-coefficient spectra. nbeta: (B, 3) -> (B, 3)."""
    nl = _NORM_LAMBDA
    x = (nbeta[:, 0:1] * nl + nbeta[:, 1:2]) * nl + nbeta[:, 2:3]  # (B, S)
    refl = 0.5 + x / (2.0 * np.sqrt(1.0 + x * x))
    return refl @ _OBS_MATRIX


def xyz_to_lab(xyz):
    """CIEXYZ -> CIELAB (spectrum.cpp:213-233). xyz: (..., 3)."""
    delta = 6.0 / 29.0

    def f(t):
        return np.where(t > delta**3, np.cbrt(np.maximum(t, 0)),
                        t / (3 * delta * delta) + 4.0 / 29.0)

    fx = f(xyz[..., 0] / 0.950489)
    fy = f(xyz[..., 1])
    fz = f(xyz[..., 2] / 1.088840)
    return np.stack([116.0 * fx - 16.0, 500.0 * (fx - fy), 200.0 * (fy - fz)], axis=-1)


def optimize_spectra(nbeta, target_xyz, iterations=15):
    """Batched Gauss-Newton fit of normalized spectrum coefficients.

    nbeta, target_xyz: (B, 3). Residuals in CIELAB; numerical Jacobian by
    central differences; per-lane convergence/degeneracy freezing, matching
    the serial OptimizeSpectrum (spectrum.cpp:240-304).
    """
    nbeta = nbeta.copy()
    target_lab = xyz_to_lab(target_xyz)
    eps = 1e-5
    active = np.ones(len(nbeta), dtype=bool)

    for _ in range(iterations):
        residual = xyz_to_lab(observe_spectra_under_d65(nbeta)) - target_lab
        err = np.linalg.norm(residual, axis=-1)
        active &= err >= 1e-3
        if not active.any():
            break

        jac = np.empty((len(nbeta), 3, 3))
        for i in range(3):
            b0 = nbeta.copy()
            b0[:, i] -= eps
            b1 = nbeta.copy()
            b1[:, i] += eps
            lab0 = xyz_to_lab(observe_spectra_under_d65(b0))
            lab1 = xyz_to_lab(observe_spectra_under_d65(b1))
            # Column i of the Jacobian: d(Lab)/d(beta_i).
            jac[:, :, i] = (lab1 - lab0) / (2 * eps)

        det = np.linalg.det(jac)
        solvable = active & (np.abs(det) >= 1e-15)
        if solvable.any():
            step = np.linalg.solve(jac[solvable], residual[solvable][..., None])[..., 0]
            nbeta[solvable] -= step
        active &= solvable

        mx = nbeta.max(axis=-1)
        over = mx > 200.0
        if over.any():
            nbeta[over] *= (200.0 / mx[over])[:, None]

    return nbeta


def index_to_scale(k):
    """Smoothstep^2-warped scale for bin k (spectrum.cpp:306-313)."""
    r = np.asarray(k, np.float64) / (SCALE_BINS - 1)
    s = r * r * (3.0 - 2.0 * r)
    return s * s * (3.0 - 2.0 * s)


_SCALES = index_to_scale(np.arange(SCALE_BINS))


def denormalize_beta(nbeta):
    """Rebase coefficients from normalized-lambda to physical-nm domain
    (spectrum.cpp:370-381)."""
    c0 = CIE_LAMBDA_MIN
    c1 = 1.0 / (CIE_LAMBDA_MAX - CIE_LAMBDA_MIN)
    b0, b1, b2 = nbeta[..., 0], nbeta[..., 1], nbeta[..., 2]
    return np.stack(
        [
            b0 * c1 * c1,
            b1 * c1 - 2 * b0 * c0 * c1 * c1,
            b2 - b1 * c0 * c1 + b0 * c0 * c0 * c1 * c1,
        ],
        axis=-1,
    )


def _bin_colors(k):
    """sRGB colors of every (L, J, I) bin at scale bin k -> (3*N*N, 3)."""
    n = COLOR_BINS
    grid = np.arange(n, dtype=np.float64) / (n - 1)
    # [J, I] layout: jj varies along rows (J), ii along columns (I), so the
    # flattened batch reshapes back to table[..., J, I, :].
    jj, ii = np.meshgrid(grid, grid, indexing='ij')
    colors = []
    for l in range(3):
        c = np.zeros((n, n, 3))
        c[..., l] = 1.0
        c[..., (l + 1) % 3] = ii
        c[..., (l + 2) % 3] = jj
        colors.append(c.reshape(-1, 3))
    return np.concatenate(colors, axis=0) * index_to_scale(k)


def build_table(progress=False):
    """Fit the full (3, SCALE, N, N, 3) coefficient table.

    Walks scale bins outward from M/5 with warm starts in both directions
    as the reference does (spectrum.cpp:383-410), but fits every color bin
    of a scale step as one batch.
    """
    n, m = COLOR_BINS, SCALE_BINS
    table = np.zeros((3, m, n, n, 3), dtype=np.float32)
    b = 3 * n * n

    def fit_walk(ks):
        nbeta = np.zeros((b, 3))
        for k in ks:
            target = (_bin_colors(k) @ _SRGB_TO_XYZ.T)
            nbeta = optimize_spectra(nbeta, target, 15)
            table[:, k] = denormalize_beta(nbeta).reshape(3, n, n, 3).astype(np.float32)
            if progress:
                print(f'  scale bin {k} done', flush=True)

    fit_walk(range(m // 5, m))        # light colors, walking up
    fit_walk(range(m // 5, -1, -1))   # dark colors, walking down
    return table


_DEFAULT_CACHE = os.path.join(os.path.dirname(__file__), '..', '..', 'data',
                              'srgb_spectrum_table.npz')
_TABLE_LOCK = threading.Lock()
_TABLE = None


def get_table(cache_path=None):
    """Load (or build + cache) the sRGB spectrum table."""
    global _TABLE
    with _TABLE_LOCK:
        if _TABLE is not None:
            return _TABLE
        path = os.path.abspath(cache_path or _DEFAULT_CACHE)
        if os.path.exists(path):
            _TABLE = np.load(path)['coefficients']
        else:
            _TABLE = build_table()
            os.makedirs(os.path.dirname(path), exist_ok=True)
            np.savez_compressed(path, coefficients=_TABLE)
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
