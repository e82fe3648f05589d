# Frozen copy of path_tracer_tpu_torch/core/optics.py, part of the benchmark's
# plain reference: not kept in step with the program.
"""Reflection/refraction optics: Fresnel, dispersion, metal F82-tint.

Port of path_tracer_tpu/core/optics.py (common.glsl.inc:356-436). All
functions broadcast over arbitrary batch shapes; spectral quantities put
the 4 wavelengths of a hero cluster on the leading axis.
"""

from __future__ import annotations

import torch


def cauchy_empirical_ior(base_ior, abbe_number, lam):
    """Wavelength-dependent IOR via the Cauchy empirical formula
    (CauchyEmpiricalIOR, common.glsl.inc:360-371). base_ior and
    abbe_number broadcast against lam (nm)."""
    lc, ld, lf = 656.3, 587.6, 486.1
    b = (base_ior - 1.0) / (abbe_number * (1.0 / (lf * lf) - 1.0 / (lc * lc)))
    a = base_ior - b / (ld * ld)
    return a + b / (lam * lam)


def cos_theta_refracted(eta, cos_theta):
    """Cosine of the refraction angle; 0 on total internal reflection
    (ComputeCosThetaRefracted, common.glsl.inc:379-390). The result is
    measured against the same normal as cos_theta, with the opposite
    sign."""
    cos2 = 1.0 - eta * eta * (1.0 - cos_theta * cos_theta)
    return -torch.sign(cos_theta) * torch.sqrt(torch.clamp(cos2, min=0.0))


def fresnel_dielectric(eta, cos_theta1, cos_theta2=None):
    """Unpolarized dielectric Fresnel reflectance (common.glsl.inc:396-420).
    cos_theta2 is derived from eta and cos_theta1 when omitted."""
    if cos_theta2 is None:
        cos_theta2 = cos_theta_refracted(eta, cos_theta1)
    ks = eta * cos_theta1
    sqrt_rs = (ks + cos_theta2) / (ks - cos_theta2)
    kp = eta * cos_theta2
    sqrt_rp = (kp + cos_theta1) / (kp - cos_theta1)
    return 0.5 * (sqrt_rs * sqrt_rs + sqrt_rp * sqrt_rp)


def schlick_fresnel_metal(base, specular, cos_theta):
    """F82-tint spectral metal Fresnel (Kutz et al.).

    base/specular: (4, N) spectral reflectances; cos_theta (N,)
    broadcasts over the leading spectral axis.
    """
    cos_theta_max = 1.0 / 7.0
    one_minus = torch.clamp(1.0 - cos_theta, min=0.0)
    f_schlick = base + (1.0 - base) * one_minus ** 5
    f_schlick_max = base + (1.0 - base) * (1.0 - cos_theta_max) ** 5
    f_max = specular * f_schlick_max
    denominator = cos_theta_max * (1.0 - cos_theta_max) ** 6
    nominator = cos_theta * one_minus ** 6
    return f_schlick - (nominator / denominator) * (f_schlick_max - f_max)
