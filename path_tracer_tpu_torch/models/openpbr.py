"""OpenPBR layered surface model: stochastic slab walk.

Port of path_tracer_tpu/models/openpbr.py (reference
src/scene/openpbr.glsl.inc): a per-evaluation stochastic layer
composition (coat present? metal base? translucent base?), a dielectric
coat with path-length absorption, a metal (F82) or dielectric
(specular-weight IOR-remapped) base specular slab, an Oren-Nayar
glossy-diffuse base, and a layer state machine random walk up to the
material's bounce limit (openpbr.glsl.inc:463-515). As in the JAX
package, base emission is wired into the integrator.

The BSDF is sample-only (no closed-form evaluate), so it reports Dirac
to the MIS machinery: skybox light sampling is off on OpenPBR surfaces.

`sample_bsdf` launches the hand-written kernel csrc/openpbr_walk.cu for
CUDA tensors: one thread a lane, walking only the lanes whose material is
OpenPBR (and whose sample the caller uses), each through the one layer
it is in at each bounce. For CPU tensors it runs `sample_bsdf_plain`,
the same walk in PyTorch over every lane, computing all three layers'
samples at each bounce and selecting. There is no fallback from one to
the other.

Channels-first: directions (3, N), spectra (4, N). `view` points toward
the viewer; `scattered` is the sampled light direction.
"""

from __future__ import annotations

import torch

from ..core.constants import EPSILON, PI
from ..core.optics import (
    cauchy_empirical_ior,
    cos_theta_refracted,
    fresnel_dielectric,
    schlick_fresnel_metal,
)
from ..core.sampling import (
    ggx_distribution,
    ggx_roughness_alpha,
    ggx_smith_g1,
    ggx_visible_normal,
)
from ..core.spectrum import sample_parametric_spectrum
from ..core.vec import dot, max4, safe_normalize, vec3
from ..ops.trace_inst import check_tensor
from ..utils import profiling

# Static unroll bound for the layer walk; per-lane material limits mask
# further bounces (the reference default is 16, openpbr.hpp:37).
MAX_LAYER_BOUNCES = 8

LAYER_EXTERNAL = -1
LAYER_COAT = 0
LAYER_BASE_SPECULAR = 1
LAYER_BASE_DIFFUSE = 2

# The kernel's tensors, in the order of csrc/openpbr_walk.h's
# OpenpbrWalkArgs: (name, dtype, rows; 0 for an (N,) column). The inputs
# are the ctx columns the walk reads, then the sample's own inputs.
KERNEL_INPUTS = (
    ('type', torch.int32, 0),
    ('lam', torch.float32, 4),
    ('exterior_ior', torch.float32, 4),
    ('base_weight', torch.float32, 0),
    ('base_reflectance', torch.float32, 4),
    ('base_metalness', torch.float32, 0),
    ('base_diffuse_roughness', torch.float32, 0),
    ('specular_weight', torch.float32, 0),
    ('specular_reflectance', torch.float32, 4),
    ('specular_ior', torch.float32, 0),
    ('roughness', torch.float32, 0),
    ('roughness_anisotropy', torch.float32, 0),
    ('transmission_weight', torch.float32, 0),
    ('transmission_dispersion_abbe', torch.float32, 0),
    ('coat_weight', torch.float32, 0),
    ('coat_spectrum', torch.float32, 3),
    ('coat_ior', torch.float32, 0),
    ('coat_roughness', torch.float32, 0),
    ('coat_roughness_anisotropy', torch.float32, 0),
    ('layer_bounce_limit', torch.int32, 0),
    ('view', torch.float32, 3),
    ('u1', torch.float32, 0),
    ('u2', torch.float32, 0),
    ('u3', torch.float32, 0),
    ('rng_state', torch.int64, 0),
)
CTX_INPUTS = tuple(name for name, _, _ in KERNEL_INPUTS[:-5])
KERNEL_OUTPUTS = (
    ('in_dir', torch.float32, 3),
    ('throughput', torch.float32, 4),
    ('density', torch.float32, 4),
    ('valid', torch.bool, 0),
    ('rng_state', torch.int64, 0),
)
# Counters (utils/profiling.py): lanes the walk ran on and warps that held
# one of them (on the card device counts, kept while tracing is on; on the
# CPU every lane and every 32 lanes), and the warps launched (host).
LANES = 'pt.model.openpbr.lanes'
WALK_WARPS = 'pt.model.openpbr.walk_warps'
WARPS = 'pt.model.openpbr.warps'


def has_dirac_bsdf(ctx):
    return torch.ones_like(ctx['type'], dtype=torch.bool)


def emission(ctx):
    """Base emission radiance (4, N) (packed per openpbr.hpp:127-133); the
    emission color is texturable (fetch_ctx samples its texture into
    emission_reflectance)."""
    return ctx['emission_reflectance'] * ctx['emission_luminance']


def load_medium(ctx):
    """Interior medium (openpbr.glsl.inc:160-191)."""
    lam = ctx['lam']
    ior = cauchy_empirical_ior(
        ctx['specular_ior'], ctx['transmission_dispersion_abbe'], lam)
    depth = ctx['transmission_depth']
    has_depth = depth > 0.0
    safe_depth = torch.where(has_depth, depth, 1.0)
    transmission = sample_parametric_spectrum(ctx['transmission_spectrum'], lam)
    extinction = -torch.log(torch.clamp(transmission, min=1e-9)) / safe_depth
    scattering = sample_parametric_spectrum(
        ctx['transmission_scatter_spectrum'], lam) / safe_depth
    absorption = torch.clamp(extinction - scattering, min=0.0)
    return dict(
        ior=ior,
        absorption=torch.where(has_depth, absorption, 0.0),
        scattering=torch.where(has_depth, scattering, 0.0),
        anisotropy=torch.where(has_depth, ctx['transmission_scatter_anisotropy'],
                               0.0),
        has_medium=torch.ones(lam.shape[1], dtype=torch.bool, device=lam.device),
    )


def _compose_parameters(ctx, rng_u):
    """openpbr_parameters (openpbr.glsl.inc:66-158): stochastic layer
    composition + spectral parameter evaluation. rng_u: 3 uniforms."""
    u_coat, u_metal, u_trans = rng_u
    coat_present = u_coat < ctx['coat_weight']
    base_is_metal = u_metal < ctx['base_metalness']
    base_is_translucent = (~base_is_metal) & (u_trans < ctx['transmission_weight'])

    base_reflectance = ctx['base_weight'] * ctx['base_reflectance']

    coat_relative_ior = ctx['exterior_ior'] / ctx['coat_ior']
    coat_transmittance = sample_parametric_spectrum(ctx['coat_spectrum'], ctx['lam'])
    coat_alpha = ggx_roughness_alpha(ctx['coat_roughness'],
                                     ctx['coat_roughness_anisotropy'])

    specular_ior = cauchy_empirical_ior(
        ctx['specular_ior'], ctx['transmission_dispersion_abbe'], ctx['lam'])
    specular_relative_ior = torch.where(
        coat_present, ctx['coat_ior'] / specular_ior,
        ctx['exterior_ior'] / specular_ior)
    spec_alpha = ggx_roughness_alpha(ctx['roughness'],
                                     ctx['roughness_anisotropy'])

    return dict(
        coat_present=coat_present,
        base_is_metal=base_is_metal,
        base_is_translucent=base_is_translucent,
        base_reflectance=base_reflectance,
        base_diffuse_roughness=ctx['base_diffuse_roughness'],
        coat_relative_ior=coat_relative_ior,
        coat_transmittance=coat_transmittance,
        coat_alpha=coat_alpha,
        specular_weight=ctx['specular_weight'],
        specular_relative_ior=specular_relative_ior,
        specular_reflectance=ctx['specular_reflectance'],
        spec_alpha=spec_alpha,
        layer_bounce_limit=ctx['layer_bounce_limit'],
    )


def _ones4(out_dir):
    return torch.ones((4, out_dir.shape[1]), dtype=out_dir.dtype,
                      device=out_dir.device)


def _coat_sample(p, out_dir, u1, u2, u_choice):
    """OpenPBR_CoatSample (openpbr.glsl.inc:194-283). Returns
    (in_dir, throughput_mul (4,N), density_mul (4,N), dead (N,))."""
    n = out_dir.shape[1]
    sign_z = torch.sign(torch.where(out_dir[2] == 0.0, 1.0, out_dir[2]))
    normal = ggx_visible_normal(out_dir * sign_z, p['coat_alpha'], u1, u2)
    cosine = dot(normal, out_dir)

    rel = torch.where(out_dir[2] < 0, 1.0 / p['coat_relative_ior'],
                      p['coat_relative_ior'])
    eta0 = rel[0]
    refr_cos = cos_theta_refracted(eta0, cosine)
    reflectance = fresnel_dielectric(eta0, cosine, refr_cos)

    reflect = u_choice < reflectance

    in_reflect = 2.0 * cosine * normal - out_dir
    reflect_bad = in_reflect[2] * out_dir[2] <= 0.0
    in_refract = (eta0 * cosine + refr_cos) * normal - eta0 * out_dir
    refract_bad = in_refract[2] * out_dir[2] > 0.0

    in_dir = torch.where(reflect, in_reflect, in_refract)
    dead = torch.where(reflect, reflect_bad, refract_bad)

    g1 = ggx_smith_g1(in_dir, p['coat_alpha'])
    thr = g1.expand(4, n)

    # Coat absorption by in-coat path length (openpbr.glsl.inc:246-281).
    oz = torch.where(torch.abs(out_dir[2]) < 1e-6,
                     1e-6 * torch.sign(out_dir[2] + 1e-30), out_dir[2])
    iz = torch.where(torch.abs(in_dir[2]) < 1e-6,
                     1e-6 * torch.sign(in_dir[2] + 1e-30), in_dir[2])
    exp_reflect = -(0.5 / oz + 0.5 / iz)
    exp_refract = torch.where(out_dir[2] < 0, -0.5 / oz, -0.5 / iz)
    exponent = torch.where(reflect, torch.where(out_dir[2] < 0, exp_reflect, 0.0),
                           exp_refract)
    absorb = torch.pow(torch.clamp(p['coat_transmittance'], min=1e-9), exponent)
    thr = thr * absorb

    # Coat absent: pass straight through (openpbr.glsl.inc:202-206).
    passthrough = ~p['coat_present']
    in_dir = torch.where(passthrough, -out_dir, in_dir)
    thr = torch.where(passthrough, 1.0, thr)
    dead = dead & ~passthrough
    return in_dir, thr, _ones4(out_dir), dead


def _base_specular_sample(p, out_dir, u1, u2, u_choice):
    """OpenPBR_BaseSpecularSample (openpbr.glsl.inc:286-435)."""
    sign_z = torch.sign(torch.where(out_dir[2] == 0.0, 1.0, out_dir[2]))
    normal = ggx_visible_normal(out_dir * sign_z, p['spec_alpha'], u1, u2)
    cosine = dot(normal, out_dir)

    # Metal branch.
    in_metal = 2.0 * cosine * normal - out_dir
    metal_bad = out_dir[2] * in_metal[2] <= 0.0
    shadow_metal = ggx_smith_g1(out_dir, p['spec_alpha'])
    fresnel_metal = p['specular_weight'] * schlick_fresnel_metal(
        p['base_reflectance'], p['specular_reflectance'], torch.abs(cosine))
    thr_metal = fresnel_metal * shadow_metal

    # Dielectric branch.
    rel = torch.where(out_dir[2] < 0, 1.0 / p['specular_relative_ior'],
                      p['specular_relative_ior'])
    # Specular-weight IOR remap (openpbr.glsl.inc:338-342).
    w = p['specular_weight']
    r = torch.sqrt(torch.clamp(w, 0.0, 1.0)) * (1.0 - rel) / (1.0 + rel)
    rel = torch.where(w < 1.0, (1.0 - r) / (1.0 + r), rel)

    eta0 = rel[0]
    refr_cos = cos_theta_refracted(eta0, cosine)
    reflectance = fresnel_dielectric(eta0, cosine, refr_cos)
    reflect = u_choice < reflectance

    in_reflect = 2.0 * cosine * normal - out_dir
    reflect_bad = in_reflect[2] * out_dir[2] <= 0.0
    thr_reflect = torch.where(out_dir[2] > 0, p['specular_reflectance'], 1.0)
    thr_reflect = thr_reflect * ggx_smith_g1(in_reflect, p['spec_alpha'])

    in_refract = (eta0 * cosine + refr_cos) * normal - eta0 * out_dir
    refract_bad = in_refract[2] * out_dir[2] > 0.0
    shadow_refract = ggx_smith_g1(in_refract, p['spec_alpha'])
    rough = p['spec_alpha'][0] * p['spec_alpha'][1] > EPSILON
    # Per-wavelength refraction densities. The reference's spectral
    # Fresnel here is marked broken and zeroed (openpbr.glsl.inc:390-391);
    # as in the JAX package the plausible-density bookkeeping stays and
    # the primary wavelength's Fresnel serves every wavelength.
    halves = in_refract[None, :, :] + out_dir[None, :, :] * rel[:, None, :]
    lsq = torch.sum(halves * halves, dim=1, keepdim=True)
    bad_h = lsq < 1e-12
    zero_h = torch.zeros_like(halves[:, :1])
    unit_z = torch.cat([zero_h, zero_h, torch.ones_like(zero_h)], dim=1)
    halves = torch.where(bad_h, unit_z,
                         halves / torch.sqrt(torch.where(bad_h, 1.0, lsq)))
    cos_i = torch.sum(out_dir[None] * halves, dim=1)
    cos_o = torch.sum(in_refract[None] * halves, dim=1)
    dens = ggx_distribution(torch.movedim(halves, 1, 0),
                            p['spec_alpha'][:, None, :])
    dens = torch.where(cos_i * cos_o < 0.0, dens, 0.0)
    dens = torch.cat([ggx_distribution(normal, p['spec_alpha'])[None], dens[1:]],
                     dim=0)
    dens = dens / torch.clamp(max4(dens), min=EPSILON)
    fres_t = 1.0 - reflectance
    thr_refract_rough = dens * fres_t * shadow_refract
    den_refract_rough = dens * fres_t
    zero = torch.zeros_like(shadow_refract)
    one = torch.ones_like(shadow_refract)
    thr_refract_smooth = torch.stack([shadow_refract, zero, zero, zero], 0)
    den_refract_smooth = torch.stack([one, zero, zero, zero], 0)
    thr_refract = torch.where(rough, thr_refract_rough, thr_refract_smooth)
    den_refract = torch.where(rough, den_refract_rough, den_refract_smooth)

    ones = _ones4(out_dir)
    in_diel = torch.where(reflect, in_reflect, in_refract)
    diel_bad = torch.where(reflect, reflect_bad, refract_bad)
    thr_diel = torch.where(reflect, thr_reflect, thr_refract)
    den_diel = torch.where(reflect, ones, den_refract)

    metal = p['base_is_metal']
    in_dir = torch.where(metal, in_metal, in_diel)
    dead = torch.where(metal, metal_bad, diel_bad)
    thr = torch.where(metal, thr_metal, thr_diel)
    den = torch.where(metal, ones, den_diel)
    return in_dir, thr, den, dead


def _base_diffuse_sample(p, out_dir, u1, u2):
    """OpenPBR_BaseDiffuseSample (openpbr.glsl.inc:438-461): Oren-Nayar
    glossy-diffuse; translucent bases pass through."""
    z = 2.0 * u1 - 1.0
    rr = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
    phi = 2.0 * PI * u2
    in_dir = safe_normalize(vec3(rr * torch.cos(phi), rr * torch.sin(phi), z + 1.0))

    s = dot(in_dir, out_dir) - in_dir[2] * out_dir[2]
    t = torch.where(s > 0, torch.maximum(in_dir[2], out_dir[2]), 1.0)
    sigma_sq = p['base_diffuse_roughness'] * p['base_diffuse_roughness']
    a = (1.0 - 0.5 * sigma_sq / (sigma_sq + 0.33)
         + 0.17 * p['base_reflectance'] * sigma_sq / (sigma_sq + 0.13))
    b = 0.45 * sigma_sq / (sigma_sq + 0.09)
    thr = p['base_reflectance'] * (a + b * s / t)

    passthrough = p['base_is_translucent']
    in_dir = torch.where(passthrough, -out_dir, in_dir)
    thr = torch.where(passthrough, 1.0, thr)
    return (in_dir, thr, _ones4(out_dir),
            torch.zeros_like(passthrough))


def openpbr_walk(ctx, view, u1, u2, u3, rng_state, where=None, stats=None):
    """Launch csrc/openpbr_walk.cu on CUDA tensors, counted as
    `kernel.openpbr_walk`: the walk of `sample_bsdf_plain` on the lanes
    whose ctx['type'] is OpenPBR and, when `where` (an (N,) bool tensor)
    is given, that lie in it; every other lane's stream steps past the
    walk's draws and its sample is not valid (zero throughput and
    density). Every tensor of KERNEL_INPUTS must be contiguous, of its
    dtype and shape, on one card; `stats`, when given, is a (2,) int64
    tensor to which the kernel adds the lanes it walked and the warps that
    held one. Returns (in_dir, throughput, density, valid, rng_state)."""
    dev = view.device
    if dev.type != 'cuda':
        raise ValueError(f'openpbr_walk runs on a CUDA device, not {dev}')
    n = view.shape[-1]
    given = dict(ctx, view=view, u1=u1, u2=u2, u3=u3, rng_state=rng_state)
    inputs = []
    for name, dtype, rows in KERNEL_INPUTS:
        if name not in given:
            raise ValueError(f'openpbr_walk needs ctx[{name!r}]')
        check_tensor(name, given[name], dev, (rows, n) if rows else (n,), dtype)
        inputs.append(given[name])
    empty = torch.empty((0,), dtype=torch.int64, device=dev)
    if where is None:
        where = empty
    else:
        check_tensor('where', where, dev, (n,), torch.bool)
    if stats is None:
        stats = empty
    else:
        check_tensor('stats', stats, dev, (2,), torch.int64)
    outputs = [torch.empty((rows, n) if rows else (n,), dtype=dtype, device=dev)
               for _, dtype, rows in KERNEL_OUTPUTS]
    from ..ops.build import load
    load().openpbr_walk(inputs, outputs, where, stats,
                        torch.cuda.current_stream(dev).cuda_stream)
    profiling.count('kernel.openpbr_walk')
    return tuple(outputs)


def sample_bsdf(ctx, view, u1, u2, u3, rng, where=None):
    """OpenPBR_Sample (openpbr.glsl.inc:463-515): the layer walk of
    `sample_bsdf_plain`, through csrc/openpbr_walk.cu on CUDA tensors and
    through `sample_bsdf_plain` on CPU tensors. Either way every lane
    draws the same 24 uniforms from `rng`. `where` ((N,) bool, or None
    for every lane) holds the lanes whose sample the caller uses: on the
    card only the OpenPBR lanes in it walk, and the others' samples are
    not valid; the plain walk computes every lane. Counts WARPS, and LANES
    and WALK_WARPS as the constants above say."""
    n = view.shape[1]
    warps = (n + 31) // 32
    profiling.count(WARPS, warps)
    if view.device.type == 'cuda':
        # fetch_ctx's columns come from gathers, texture taps and selects;
        # the kernel reads each as contiguous rows (a copy only where one
        # is not).
        columns = {name: ctx[name].contiguous() for name in CTX_INPUTS}
        *sample, rng.state = openpbr_walk(
            columns, view, u1, u2, u3, rng.state, where=where,
            stats=profiling.kernel_counts((LANES, WALK_WARPS), view.device))
        return tuple(sample)
    if view.device.type == 'cpu':
        profiling.count(LANES, n)
        profiling.count(WALK_WARPS, warps)
        return sample_bsdf_plain(ctx, view, u1, u2, u3, rng)
    raise ValueError(f'openpbr.sample_bsdf: unsupported device {view.device}')


def sample_bsdf_plain(ctx, view, u1, u2, u3, rng):
    """OpenPBR_Sample (openpbr.glsl.inc:463-515): layer random walk over
    every lane, in PyTorch.

    u1/u2/u3 seed the per-evaluation parameter composition; the walk
    draws three fresh uniforms from `rng` in each of the
    MAX_LAYER_BOUNCES bounces whatever the lane's limit, so every lane's
    stream stays aligned.
    """
    p = _compose_parameters(ctx, (u1, u2, u3))

    layer = torch.where((view[2] > 0) & p['coat_present'], LAYER_COAT,
                        LAYER_BASE_SPECULAR)

    throughput = _ones4(view)
    density = _ones4(view)
    out_dir = view
    in_dir = -view
    dead = torch.zeros_like(p['coat_present'])

    for i in range(MAX_LAYER_BOUNCES):
        b1, b2, b3 = rng.uniform(), rng.uniform(), rng.uniform()
        active = (layer != LAYER_EXTERNAL) & (i < ctx['layer_bounce_limit']) & ~dead

        ci, cthr, cden, cdead = _coat_sample(p, out_dir, b1, b2, b3)
        si, sthr, sden, sdead = _base_specular_sample(p, out_dir, b1, b2, b3)
        di, dthr, dden, ddead = _base_diffuse_sample(p, out_dir, b1, b2)

        is_coat = layer == LAYER_COAT
        is_spec = layer == LAYER_BASE_SPECULAR
        new_in = torch.where(is_coat, ci, torch.where(is_spec, si, di))
        mul_thr = torch.where(is_coat, cthr, torch.where(is_spec, sthr, dthr))
        mul_den = torch.where(is_coat, cden, torch.where(is_spec, sden, dden))
        step_dead = torch.where(is_coat, cdead, torch.where(is_spec, sdead, ddead))

        in_dir = torch.where(active, new_in, in_dir)
        throughput = torch.where(active, throughput * mul_thr, throughput)
        density = torch.where(active, density * mul_den, density)
        dead = dead | (active & step_dead)

        up = new_in[2] >= 0
        next_layer = torch.where(
            is_coat, torch.where(up, LAYER_EXTERNAL, LAYER_BASE_SPECULAR),
            torch.where(is_spec, torch.where(up, LAYER_COAT, LAYER_BASE_DIFFUSE),
                        torch.where(up, LAYER_BASE_SPECULAR, LAYER_EXTERNAL)))
        layer = torch.where(active, next_layer, layer)
        out_dir = torch.where(active, -new_in, out_dir)

    # A walk still inside the stack at the limit is terminated.
    valid = ~dead & (max4(density) > EPSILON)
    return in_dir, throughput, density, valid


def evaluate_bsdf(ctx, view, scattered):
    """No closed-form evaluate for the stochastic slab; OpenPBR reports
    Dirac, so MIS never uses this result."""
    zeros = torch.zeros((4, view.shape[1]), dtype=view.dtype, device=view.device)
    return zeros, zeros, torch.zeros_like(ctx['type'], dtype=torch.bool)
