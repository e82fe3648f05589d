# Frozen copy of path_tracer_tpu_torch/models/basic_metal.py, part of the benchmark's
# plain reference: not kept in step with the program.
"""Basic Metal material: GGX VNDF with F82-tint spectral Fresnel.

Port of path_tracer_tpu/models/basic_metal.py
(reference src/scene/basic_metal.glsl.inc). Channels-first:
`view`/`scattered` (3, N) in the hit tangent frame, spectra (4, N).
`view` points toward the viewer, `scattered` is the sampled or evaluated
light direction.
"""

from __future__ import annotations

import torch

from ..core.constants import EPSILON
from ..core.optics import schlick_fresnel_metal
from ..core.sampling import (
    ggx_distribution,
    ggx_roughness_alpha,
    ggx_smith_g1,
    ggx_visible_normal,
)
from ..core.vec import dot, safe_normalize


def _params(ctx):
    alpha = ggx_roughness_alpha(ctx['roughness'], ctx['roughness_anisotropy'])
    rough = alpha[0] * alpha[1] > EPSILON
    return alpha, rough


def has_dirac_bsdf(ctx):
    return ctx['roughness'] < 1e-3


def _vndf_pdf(view, normal, alpha):
    """G1(view) D(normal) / (4 cos(view)): the pdf of a VNDF sample."""
    return (ggx_smith_g1(view, alpha) * ggx_distribution(normal, alpha)
            / (4.0 * torch.clamp(view[2], min=1e-8)))


def evaluate_bsdf(ctx, view, scattered):
    """basic_metal.glsl.inc:44-83: probability is the VNDF pdf of the
    half vector, throughput = probability * G1(scattered) * F(view.h)."""
    n = view.shape[1]
    alpha, rough = _params(ctx)
    valid = (view[2] > 0.0) & (scattered[2] > 0.0) & rough
    half = safe_normalize(view + scattered)
    probability = _vndf_pdf(view, half, alpha).expand(4, n)
    f = schlick_fresnel_metal(ctx['base_reflectance'],
                              ctx['specular_reflectance'], dot(view, half))
    throughput = probability * ggx_smith_g1(scattered, alpha) * f
    return throughput, probability, valid


def sample_bsdf(ctx, view, u1, u2, u3):
    """basic_metal.glsl.inc:86-141: VNDF half-vector sample + mirror
    reflection; Dirac surfaces (roughness < 1e-3) report probability 1
    as the coefficient of an implied delta distribution."""
    n = view.shape[1]
    alpha, rough = _params(ctx)
    normal = ggx_visible_normal(view, alpha, u1, u2)
    cos_theta = torch.clamp(dot(normal, view), max=1.0)
    scattered = 2.0 * cos_theta * normal - view
    valid = (view[2] > 0.0) & (scattered[2] > 0.0)
    rough_pdf = _vndf_pdf(view, normal, alpha)
    probability = torch.where(rough, rough_pdf,
                              torch.ones_like(rough_pdf)).expand(4, n)
    f = schlick_fresnel_metal(ctx['base_reflectance'],
                              ctx['specular_reflectance'], cos_theta)
    throughput = probability * ggx_smith_g1(scattered, alpha) * f
    return scattered, throughput, probability, valid
