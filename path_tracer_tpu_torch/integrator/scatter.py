"""The scatter stage: skybox emission, MIS surface shading, path bookkeeping.

Port of the surface path of path_tracer_tpu/integrator/scatter.py
(reference src/integrator/basic_scatter.glsl:44-310). Every lane
computes the skybox and surface branches and selects by mask.

Participating media and nested dielectrics are not ported in this slice
(ROADMAP.md): a layout with `scene_has_medium` or `has_transmissive`
raises. Without them the JAX package's own specialization applies --
the medium branch never fires and the active-shape lists never change --
and the RNG draws of the dropped branches are still consumed, so each
lane's random stream matches the JAX package's draw for draw.
"""

from __future__ import annotations

import torch

from ..core.constants import EPSILON, HIT_TIME_LIMIT, PI, TAU
from ..core.sampling import (
    Rng,
    random_von_mises_fisher,
    von_mises_fisher_pdf,
)
from ..core.spectrum import (
    hero_wavelength_cluster,
    sample_parametric_spectrum_scaled,
    sample_standard_observer,
)
from ..core.vec import dot, max4, normalize, sum4, vec3
from ..models import dispatch
from ..models.common import fetch_ctx, sample_texture


def sample_skybox_radiance(packed, direction, lam, has_texture=True,
                           atlas_size=8, filter_modes=(True, True),
                           use_quad=False):
    """SampleSkyboxRadiance (scene.glsl.inc:209-229): equirect lookup of
    the parametric emission spectrum, or the default (0,0,100,1)
    spectrum. direction: (3, N), lam: (4, N) -> (4, N)."""
    if not has_texture:
        default = torch.tensor([0.0, 0.0, 100.0, 1.0], dtype=torch.float32,
                               device=lam.device)[:, None]
        return (sample_parametric_spectrum_scaled(default, lam)
                * packed.skybox_brightness)
    phi = torch.atan2(direction[1], direction[0])
    theta = torch.asin(torch.clamp(direction[2], -1.0, 1.0))
    uv = torch.stack([0.5 + phi / TAU, 0.5 + theta / PI], dim=0)
    # One texture: its metadata row is fetched once and broadcast.
    meta = packed.texture_meta.index_select(
        0, packed.skybox_texture_index.reshape(1).long()).T
    spectrum = sample_texture(packed, None, uv, atlas_size, filter_modes,
                              use_quad, meta=meta)
    return (sample_parametric_spectrum_scaled(spectrum, lam)
            * packed.skybox_brightness)


def _observe(observer, weighted):
    """sum_k observer[:, k] * weighted[k]: (3, 4, N) x (4, N) -> (3, N)."""
    return (observer[:, 0] * weighted[0] + observer[:, 1] * weighted[1]
            + observer[:, 2] * weighted[2] + observer[:, 3] * weighted[3])


def _sample_surface_integrand(packed, ctx, hit, view, rng: Rng, types,
                              sky_sampling=True):
    """SampleSurfaceIntegrand (basic_scatter.glsl:66-109): one-sample MIS
    between BSDF importance sampling and vMF skybox light sampling.
    view: (3, N) toward the viewer in tangent space. Returns (scattered
    (3, N), throughput (4, N), probability (4, N), valid (N,)).
    Without sky sampling the light-branch draws are still consumed."""
    if sky_sampling:
        has_dirac = dispatch.has_dirac_bsdf(ctx, types)
        light_probability = torch.where(
            has_dirac, torch.zeros_like(view[0]),
            packed.skybox_sampling_probability.expand_as(view[0]))
    mean = packed.skybox_mean_direction
    mean_local = vec3(
        mean[0] * hit['tangent'][0] + mean[1] * hit['tangent'][1] + mean[2] * hit['tangent'][2],
        mean[0] * hit['bitangent'][0] + mean[1] * hit['bitangent'][1] + mean[2] * hit['bitangent'][2],
        mean[0] * hit['normal'][0] + mean[1] * hit['normal'][1] + mean[2] * hit['normal'][2],
    )
    u_choice = rng.uniform()
    light_dir = random_von_mises_fisher(rng, packed.skybox_concentration,
                                        mean_local)
    bsdf_dir, bsdf_thr, bsdf_pdf, bsdf_ok = dispatch.sample_bsdf(
        ctx, view, rng, types)
    if not sky_sampling:
        return bsdf_dir, bsdf_thr, bsdf_pdf, bsdf_ok
    eval_thr, eval_pdf, eval_ok = dispatch.evaluate_bsdf(ctx, view, light_dir,
                                                         types)
    use_light = u_choice < light_probability
    scattered = torch.where(use_light, light_dir, bsdf_dir)
    throughput = torch.where(use_light, eval_thr, bsdf_thr)
    material_pdf = torch.where(use_light, eval_pdf, bsdf_pdf)
    valid = torch.where(use_light, eval_ok & (light_dir[2] >= 0.0), bsdf_ok)
    skybox_pdf = von_mises_fisher_pdf(packed.skybox_concentration,
                                      mean_local, scattered)
    probability = (light_probability * skybox_pdf
                   + (1.0 - light_probability) * material_pdf)
    return scattered, throughput, probability, valid


def scatter(packed, state, ray_origin, ray_direction, hit, rng: Rng,
            termination_probability, layout):
    """One scatter round for all lanes (basic_scatter.glsl:114-310).

    ray_origin/ray_direction: (3, N). Returns (new_state, new_origin,
    new_direction, alive (N,)); dead lanes carry their final `sample`.
    `layout` gives the static scene flags.
    """
    if layout.scene_has_medium or layout.has_transmissive:
        raise NotImplementedError(
            'participating media and nested dielectrics are not ported '
            'yet (ROADMAP.md Queue 1)')
    types = layout.material_types
    dispatch.check_types(types)
    term = torch.tensor(termination_probability, dtype=torch.float32,
                        device=ray_origin.device)
    lam = hero_wavelength_cluster(state['lambda0'])
    throughput = state['throughput']
    probability = state['probability']
    sample = state['sample']

    # No medium: the scattering time is the horizon, so a lane's event
    # is the skybox when it hit nothing and the surface otherwise. The
    # free-flight draw and the two phase-function draws are consumed.
    rng.uniform()
    sky_hit = hit['time'] >= HIT_TIME_LIMIT
    surface_event = ~sky_hit
    rng.uniform()
    rng.uniform()

    emission = sample_skybox_radiance(packed, ray_direction, lam,
                                      layout.has_skybox_texture,
                                      layout.atlas_size,
                                      layout.texture_filter_modes,
                                      layout.atlas_quad_fit)
    cluster_pdf = torch.clamp(sum4(probability), min=1e-20)
    observer = sample_standard_observer(lam)  # (3, 4, N)
    sky_sample = sample + _observe(observer, emission * throughput) / cluster_pdf

    view = -vec3(dot(ray_direction, hit['tangent']),
                 dot(ray_direction, hit['bitangent']),
                 dot(ray_direction, hit['normal']))
    hit_exterior = view[2] > 0.0
    # Empty active-shape lists: the medium priority is the NONE sentinel.
    priority = torch.amin(state['active_shapes'], dim=0)
    is_real = torch.where(hit_exterior, priority > hit['shape'],
                          priority == hit['shape'])

    exterior_ior = torch.ones((4,) + view[0].shape, device=view.device)
    ctx = fetch_ctx(packed, hit['material'], lam, hit['uv'], exterior_ior,
                    layout.materials_textured, layout.atlas_size,
                    layout.texture_filter_modes, layout.textured_attrs,
                    layout.atlas_quad_fit)

    # Stochastic transparency: with probability (1 - opacity) the ray
    # passes straight through the surface.
    if layout.has_opacity:
        opacity = packed.materials.opacity[hit['material']]
        ghost = surface_event & (rng.uniform() >= opacity)
    else:
        ghost = torch.zeros_like(sky_hit)

    scattered, s_throughput, s_probability, s_valid = _sample_surface_integrand(
        packed, ctx, hit, view, rng, types,
        sky_sampling=layout.has_skybox_sampling)

    scale = 1.0 / torch.clamp(max4(s_probability), min=EPSILON)
    surf_throughput = torch.where(is_real, throughput * s_throughput * scale,
                                  throughput)
    surf_probability = torch.where(is_real, probability * s_probability * scale,
                                   probability)
    in_dir = torch.where(is_real, scattered, -view)
    surf_valid = torch.where(is_real, s_valid, torch.ones_like(s_valid))

    # Russian roulette (basic_scatter.glsl:294-298).
    u_rr = rng.uniform()
    rr_survive = u_rr >= term
    surf_probability = surf_probability * (1.0 - term)

    surf_dir = normalize(in_dir[0] * hit['tangent'] + in_dir[1] * hit['bitangent']
                         + in_dir[2] * hit['normal'])
    # Self-intersection offset scaled with the hit distance.
    surf_eps = torch.clamp(1e-4 * hit['time'], min=1e-3)
    surf_origin = hit['position'] + surf_eps * surf_dir

    new_throughput = torch.where(sky_hit, throughput, surf_throughput)
    new_probability = torch.where(sky_hit, torch.zeros_like(probability),
                                  surf_probability)
    new_sample = torch.where(sky_hit, sky_sample, sample)
    new_origin = torch.where(sky_hit, ray_origin, surf_origin)
    new_direction = torch.where(sky_hit, ray_direction, surf_dir)

    if layout.has_opacity:
        new_direction = torch.where(ghost, ray_direction, new_direction)
        new_origin = torch.where(ghost, hit['position'] + surf_eps * ray_direction,
                                 new_origin)
        new_throughput = torch.where(ghost, throughput, new_throughput)
        new_probability = torch.where(ghost, probability, new_probability)

    alive = max4(new_probability) > EPSILON
    alive &= torch.where(surface_event & ~ghost, surf_valid & rr_survive,
                         torch.ones_like(alive))
    alive &= ~sky_hit

    new_state = dict(
        lambda0=state['lambda0'],
        throughput=new_throughput,
        probability=new_probability,
        sample=new_sample,
        active_shapes=state['active_shapes'],
    )
    return new_state, new_origin, new_direction, alive
