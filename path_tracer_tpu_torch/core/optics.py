"""Reflection optics: the metal F82-tint Fresnel.

Port of the part of path_tracer_tpu/core/optics.py that the ported
material models use (common.glsl.inc:425-436). The dielectric Fresnel,
refraction and Cauchy dispersion belong to the translucent and OpenPBR
models and come with them (ROADMAP.md).
"""

from __future__ import annotations

import torch


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
