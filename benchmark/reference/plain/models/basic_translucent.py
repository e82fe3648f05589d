# Frozen copy of path_tracer_tpu_torch/models/basic_translucent.py, part of the benchmark's
# plain reference: not kept in step with the program.
"""Basic Translucent material: rough dispersive dielectric + interior medium.

Port of path_tracer_tpu/models/basic_translucent.py (reference
src/scene/basic_translucent.glsl.inc): GGX reflect/refract with Cauchy
dispersion over the 4-wavelength hero cluster, per-wavelength refraction
half vectors (the secondary wavelengths' densities for the same
refraction event), the collapse to the primary wavelength on smooth
refraction, and a Beer-Lambert / Henyey-Greenstein interior medium
derived from transmission color and depth.

Channels-first: `view`/`scattered` (3, N); spectral quantities (4, N).
`view` points toward the viewer (the reference BSDF's "In"), `scattered`
is the sampled light direction (its "Out").
"""

from __future__ import annotations

import torch

from ..core.constants import EPSILON
from ..core.optics import cauchy_empirical_ior, cos_theta_refracted, fresnel_dielectric
from ..core.sampling import (
    ggx_distribution,
    ggx_roughness_alpha,
    ggx_smith_g1,
    ggx_visible_normal,
)
from ..core.spectrum import sample_parametric_spectrum
from ..core.vec import dot, safe_normalize


def _params(ctx, view):
    """Relative IOR per wavelength + roughness (basic_translucent.glsl.inc:10-48)."""
    interior = cauchy_empirical_ior(ctx['ior'], ctx['abbe_number'], ctx['lam'])
    exterior = ctx['exterior_ior']
    entering = view[2] >= 0.0
    relative = torch.where(entering, exterior / interior, interior / exterior)
    alpha = ggx_roughness_alpha(ctx['roughness'], ctx['roughness_anisotropy'])
    rough = alpha[0] * alpha[1] > EPSILON
    return relative, alpha, rough


def has_dirac_bsdf(ctx):
    return ctx['roughness'] < 1e-3


def load_medium(ctx):
    """Interior participating medium (basic_translucent.glsl.inc:55-82).

    Returns dict(ior (4, N), absorption (4, N), scattering (4, N),
    anisotropy (N,), has_medium (N,) bool).
    """
    lam = ctx['lam']
    ior = cauchy_empirical_ior(ctx['ior'], ctx['abbe_number'], lam)
    depth = ctx['transmission_depth']
    has_depth = depth > 0.0
    safe_depth = torch.where(has_depth, depth, 1.0)
    transmission = sample_parametric_spectrum(ctx['transmission_spectrum'], lam)
    extinction = -torch.log(torch.clamp(transmission, min=1e-9)) / safe_depth
    scattering = sample_parametric_spectrum(ctx['scattering_spectrum'], lam) / safe_depth
    absorption = torch.clamp(extinction - scattering, min=0.0)
    return dict(
        ior=ior,
        absorption=torch.where(has_depth, absorption, 0.0),
        scattering=torch.where(has_depth, scattering, 0.0),
        anisotropy=torch.where(has_depth, ctx['scattering_anisotropy'], 0.0),
        has_medium=torch.ones(lam.shape[1], dtype=torch.bool, device=lam.device),
    )


def _unit_z_like(h):
    """+Z in the layout of the (4, 3, N) half vectors."""
    zero = torch.zeros_like(h[:, :1])
    return torch.cat([zero, zero, torch.ones_like(zero)], dim=1)


def _refraction_halves(scattered, view, relative_ior):
    """Per-wavelength refraction half vectors: (4, 3, N) stacked over the
    spectral axis (basic_translucent.glsl.inc:133-139)."""
    # scattered + view * eta_k, per wavelength k.
    h = scattered[None, :, :] + view[None, :, :] * relative_ior[:, None, :]
    lsq = torch.sum(h * h, dim=1, keepdim=True)
    bad = lsq < 1e-12
    inv = 1.0 / torch.sqrt(torch.where(bad, 1.0, lsq))
    return torch.where(bad, _unit_z_like(h), h * inv)


def _with_primary(first, rest):
    """`rest` with its wavelength-0 entry replaced by `first` (a new tensor)."""
    return torch.cat([first[None], rest[1:]], dim=0)


def evaluate_bsdf(ctx, view, scattered):
    """basic_translucent.glsl.inc:90-169. Rough surfaces only; smooth
    surfaces return zero (their lobes are Dirac deltas)."""
    n = view.shape[1]
    relative_ior, alpha, rough = _params(ctx, view)

    gm = ggx_smith_g1(view, alpha)
    gs = ggx_smith_g1(scattered, alpha)

    same_side = view[2] * scattered[2] > 0.0

    # Reflection.
    half_r = safe_normalize(scattered + view)
    cos_in_r = dot(half_r, view)
    f_r = fresnel_dielectric(relative_ior, cos_in_r)
    d_r = ggx_distribution(half_r, alpha)
    prob_reflect = f_r * (gm * d_r / (4.0 * torch.clamp(torch.abs(view[2]), min=1e-8)))

    # Refraction, with a half vector per wavelength.
    halves = _refraction_halves(scattered, view, relative_ior)    # (4, 3, N)
    cos_in = torch.sum(view[None] * halves, dim=1)                # (4, N)
    cos_out = torch.sum(scattered[None] * halves, dim=1)          # (4, N)
    f_t = fresnel_dielectric(relative_ior, cos_in, cos_out)
    d_each = ggx_distribution(torch.movedim(halves, 1, 0), alpha[:, None, :])
    d_t = torch.where(cos_in * cos_out < 0.0, d_each, 0.0)
    j = torch.abs(cos_out) / torch.square(cos_in * relative_ior + cos_out)
    vz_safe = torch.where(torch.abs(view[2]) < 1e-8, 1e-8, view[2])
    prob_refract = d_t * (1.0 - f_t) * gm * j * torch.abs(cos_in / vz_safe)

    probability = torch.where(same_side, prob_reflect, prob_refract)
    probability = torch.where(rough, probability, 0.0)
    throughput = probability * gs
    valid = torch.ones(n, dtype=torch.bool, device=view.device)
    return throughput, probability, valid


def sample_bsdf(ctx, view, u1, u2, u3):
    """basic_translucent.glsl.inc:172-339.

    u1/u2 drive the VNDF normal, u3 the reflect/refract choice at the
    primary wavelength's Fresnel coefficient.
    """
    relative_ior, alpha, rough = _params(ctx, view)
    eta0 = relative_ior[0]

    sign_z = torch.sign(torch.where(view[2] == 0.0, 1.0, view[2]))
    normal = ggx_visible_normal(view * sign_z, alpha, u1, u2)

    cos_in = torch.clamp(dot(normal, view), -1.0, 1.0)
    cos_refracted = cos_theta_refracted(eta0, cos_in)
    reflectance0 = fresnel_dielectric(eta0, cos_in, cos_refracted)

    reflect = u3 < reflectance0

    # Reflection.
    out_reflect = 2.0 * cos_in * normal - view
    reflect_ok = out_reflect[2] * view[2] > 0.0
    f = fresnel_dielectric(relative_ior, cos_in)
    gm = ggx_smith_g1(view, alpha)
    d = ggx_distribution(normal, alpha)
    rough_factor = gm * d / (4.0 * torch.clamp(torch.abs(view[2]), min=1e-8))
    prob_reflect = f * torch.where(rough, rough_factor, 1.0)

    # Refraction.
    out_refract = (cos_refracted + eta0 * cos_in) * normal - eta0 * view
    refract_ok = out_refract[2] * view[2] < 0.0

    # Secondary-wavelength half vectors for the same refraction; the
    # primary wavelength keeps the sampled normal.
    halves = _with_primary(normal, _refraction_halves(out_refract, view,
                                                      relative_ior))
    cos_in4 = _with_primary(cos_in, torch.sum(view[None] * halves, dim=1))
    cos_out4 = _with_primary(cos_refracted,
                             torch.sum(out_refract[None] * halves, dim=1))

    f4 = fresnel_dielectric(relative_ior, cos_in4, cos_out4)
    d4 = ggx_distribution(torch.movedim(halves, 1, 0), alpha[:, None, :])
    plausible = cos_in4 * cos_out4 < 0.0
    d4 = torch.where(plausible, d4, 0.0)
    d4 = _with_primary(ggx_distribution(normal, alpha), d4)
    j4 = torch.abs(cos_out4) / torch.square(cos_in4 * relative_ior + cos_out4)
    vz_safe = torch.where(torch.abs(view[2]) < 1e-8, 1e-8, view[2])
    prob_refract_rough = d4 * (1.0 - f4) * gm * j4 * torch.abs(cos_in4 / vz_safe)
    # Smooth surface: spectral collapse to the primary wavelength
    # (basic_translucent.glsl.inc:327-332).
    zero = torch.zeros_like(reflectance0)
    prob_refract_smooth = torch.stack(
        [1.0 - reflectance0, zero, zero, zero], dim=0)
    prob_refract = torch.where(rough, prob_refract_rough, prob_refract_smooth)

    scattered = torch.where(reflect, out_reflect, out_refract)
    probability = torch.where(reflect, prob_reflect, prob_refract)
    valid = torch.where(reflect, reflect_ok, refract_ok)

    gs = ggx_smith_g1(scattered, alpha)
    throughput = probability * gs
    return scattered, throughput, probability, valid
