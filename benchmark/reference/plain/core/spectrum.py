# Frozen copy of path_tracer_tpu_torch/core/spectrum.py, part of the benchmark's
# plain reference: not kept in step with the program.
"""Spectral core: CIE observer, illuminant D65, parametric spectra, color.

Port of path_tracer_tpu/core/spectrum.py. Channels-first: colors are
(3, ...), spectrum coefficients (3, ...), wavelength clusters (4, ...);
trailing axes are lane axes.
"""

from __future__ import annotations

import numpy as np
import torch

from .constants import CIE_LAMBDA_MIN, CIE_LAMBDA_MAX
from ._d65_data import CIE_ILLUMINANT_D65

# Normalization constant for D65 luminance used by the reference when
# observing spectra under D65 (spectrum.glsl.inc:205, spectrum.cpp:202).
D65_NORMALIZATION = 10566.864005

_D65_TABLE = np.asarray(CIE_ILLUMINANT_D65, dtype=np.float32)

# CIE XYZ <-> linear sRGB (spectrum.glsl.inc:50-55), row-major: out = M @ in.
XYZ_TO_SRGB = np.array(
    [
        [+3.2406, -1.5372, -0.4986],
        [-0.9689, +1.8758, +0.0415],
        [+0.0557, -0.2040, +1.0570],
    ],
    dtype=np.float32,
)

SRGB_TO_XYZ = np.array(
    [
        [+0.4124, +0.3576, +0.1805],
        [+0.2126, +0.7152, +0.0722],
        [+0.0193, +0.1192, +0.9505],
    ],
    dtype=np.float32,
)


def sample_standard_observer(lam):
    """CIE 1931 observer (Wyman et al. multi-lobe fit) at wavelengths
    `lam` (nm), identical to SampleStandardObserver
    (spectrum.glsl.inc:10-34). Returns (3,) + lam.shape."""

    def lobe(scale, center, slope_lo, slope_hi):
        t = (lam - center) * torch.where(
            lam < center, torch.full_like(lam, slope_lo),
            torch.full_like(lam, slope_hi))
        return scale * torch.exp(-0.5 * t * t)

    x = lobe(0.362, 442.0, 0.0624, 0.0374) \
        + lobe(1.056, 599.8, 0.0264, 0.0323) \
        - lobe(0.065, 501.1, 0.0490, 0.0382)
    y = lobe(0.821, 568.8, 0.0213, 0.0247) \
        + lobe(0.286, 530.9, 0.0613, 0.0322)
    z = lobe(1.217, 437.0, 0.0845, 0.0278) \
        + lobe(0.681, 459.0, 0.0385, 0.0725)
    return torch.stack([x, y, z], dim=0)


def sample_illuminant_d65(normalized_lambda):
    """Interpolated D65 power at normalized wavelength(s) in [0, 1]
    (SampleIlluminantD65, spectrum.glsl.inc:159-164)."""
    nl = torch.as_tensor(normalized_lambda, dtype=torch.float32)
    offset = nl * 470.0
    idx = torch.clamp(offset.to(torch.int32), 0, 469).long()
    frac = offset - idx.to(torch.float32)
    table = torch.as_tensor(_D65_TABLE, device=nl.device)
    return table[idx] * (1.0 - frac) + table[idx + 1] * frac


def sample_parametric_spectrum(beta, lam):
    """Sigmoid-polynomial reflectance spectrum (Jakob-Hanika).

    beta: (3, ...) coefficients; lam broadcasts against beta[i]
    (e.g. beta (3, N) against lam (4, N)). Matches
    SampleParametricSpectrum (spectrum.glsl.inc:169-180)."""
    x = (beta[0] * lam + beta[1]) * lam + beta[2]
    return 0.5 + x / (2.0 * torch.sqrt(1.0 + x * x))


def sample_parametric_spectrum_scaled(beta_and_intensity, lam):
    """As above with a 4th intensity channel (spectrum.glsl.inc:183-192)."""
    b = beta_and_intensity
    return b[3] * sample_parametric_spectrum(b[:3], lam)


def observe_parametric_spectrum_under_d65(beta_and_intensity, sample_count=16):
    """XYZ response of a parametric spectrum under D65, with the
    reference's quadrature of `sample_count` samples
    (ObserveParametricSpectrumUnderD65, spectrum.glsl.inc:197-210).
    beta_and_intensity: (3, ...) or (4, ...) with an intensity last.
    Returns (3, ...) XYZ."""
    b = torch.as_tensor(beta_and_intensity, dtype=torch.float32)
    if b.shape[0] == 4:
        intensity, beta = b[3], b[:3]
    else:
        intensity, beta = torch.ones(b.shape[1:], device=b.device), b
    nl = torch.linspace(0.0, 1.0, sample_count, dtype=torch.float32,
                        device=b.device)
    delta = (CIE_LAMBDA_MAX - CIE_LAMBDA_MIN) / sample_count
    lam = CIE_LAMBDA_MIN + (CIE_LAMBDA_MAX - CIE_LAMBDA_MIN) * nl
    d65 = sample_illuminant_d65(nl) / D65_NORMALIZATION          # (S,)
    obs = sample_standard_observer(lam)                          # (3, S)
    extra = (1,) * (beta.ndim - 1)
    lam_b = lam.reshape((sample_count,) + extra)                 # (S, 1...)
    refl = sample_parametric_spectrum(beta[:, None], lam_b)      # (S, ...)
    weight = (d65 * delta).reshape((sample_count,) + extra)
    xyz = torch.tensordot(obs, refl * weight, dims=([1], [0]))   # (3, ...)
    return xyz * intensity


def xyz_to_srgb(xyz):
    """CIE XYZ -> linear sRGB; xyz: (3, ...)."""
    m = torch.as_tensor(XYZ_TO_SRGB, device=xyz.device)
    return torch.tensordot(m, xyz, dims=([1], [0]))


def srgb_to_xyz(rgb):
    """Linear sRGB -> CIE XYZ; rgb: (3, ...)."""
    m = torch.as_tensor(SRGB_TO_XYZ, device=rgb.device)
    return torch.tensordot(m, rgb, dims=([1], [0]))


def hero_wavelength_cluster(normalized_lambda0):
    """Expand a primary normalized wavelength into the 4-hero cluster,
    rotated by 0.25 steps with wrap-around (basic_scatter.glsl:116-122).
    (N,) -> (4, N) wavelengths in nm."""
    nl0 = normalized_lambda0
    offsets = torch.tensor([0.0, 0.25, 0.5, 0.75], dtype=torch.float32,
                           device=nl0.device)
    nl = torch.remainder(nl0[None] + offsets.reshape((4,) + (1,) * nl0.ndim),
                         1.0)
    nl[0] = nl0
    return CIE_LAMBDA_MIN + (CIE_LAMBDA_MAX - CIE_LAMBDA_MIN) * nl
