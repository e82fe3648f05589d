"""The scatter stage: medium events, MIS surface shading, path bookkeeping.

Port of path_tracer_tpu/integrator/scatter.py (reference
src/integrator/basic_scatter.glsl:44-310). Every lane computes the
volumetric, skybox and surface branches and selects by mask; material
dispatch is compute-all-and-select over the four models
(models/dispatch.py). Channels-first: rays (3, N), spectra (4, N); (N,)
masks broadcast against channel-leading values. Nested dielectrics keep
an (ACTIVE_SHAPE_LIMIT, N) list of the shapes a path is inside, with the
int32 sentinel SHAPE_INDEX_NONE, so min-reductions express the
reference's priority rules directly.

The JAX package's static specializations are kept: a layout without
`scene_has_medium` skips the medium gathers and the volumetric branch,
one without `has_transmissive` the active-shape list bookkeeping, one
without `has_skybox_sampling` the light sample. The RNG draws of a
dropped branch are still consumed, so each lane's random stream matches
the JAX package's draw for draw, and the frame is bitwise the same as
the general path's.

On the card the medium event, the basic models' BSDF samples and the
round's rest after the sample (`scatter_tail`: the sky, the emission,
roulette, the new ray and the merge) are each one hand-written kernel;
on the CPU their plain versions run (`medium_event_plain`,
`dispatch.sample_bsdf_plain`, `scatter_tail_plain`).
"""

from __future__ import annotations

import torch

from ..core.constants import (
    ACTIVE_SHAPE_LIMIT,
    EPSILON,
    HIT_TIME_LIMIT,
    PI,
    SHAPE_INDEX_NONE,
    TAU,
)
from ..core.sampling import (
    Rng,
    coordinate_frame,
    random_von_mises_fisher,
    sample_direction_hg,
    von_mises_fisher_pdf,
)
from ..core.spectrum import (
    hero_wavelength_cluster,
    sample_parametric_spectrum_scaled,
    sample_standard_observer,
)
from ..core.vec import dot, max4, normalize, sum4, vec3
from ..models import dispatch
from ..models.common import fetch_ctx, fetch_medium_ctx, sample_texture
from ..ops import medium_event as medium_event_kernel
from ..ops import scatter_tail as scatter_tail_kernel
from ..utils import profiling

# The lanes of a medium event by what they are in: no active shape (the
# ambient medium), a shape's medium, and a scattering event in a volume,
# whatever the medium (a device count while tracing).
MEDIUM_LANES = 'pt.scatter.medium.lanes'
MEDIUM_BINS = ('ambient', 'interior', 'volume')
# The span of the round's rest after the BSDF sample, and its lanes by
# branch: those that hit the sky, scatter in a volume, scatter off a
# surface, or pass through one (a ghost); they partition the round's lanes
# (a device count while tracing).
TAIL_SPAN = 'pt.scatter.tail'
TAIL_LANES = 'pt.scatter.tail.lanes'
TAIL_BINS = ('sky', 'volume', 'surface', 'ghost')


def fetch_medium(packed, shape_index, lam, types=()):
    """ResolveMedium (basic_scatter.glsl:44-64) for (N,) shape indices.

    Returns dict(priority (N,) int32, ior (4, N), absorption (4, N),
    scattering (4, N), anisotropy (N,)). SHAPE_INDEX_NONE lanes get the
    ambient medium: unit IOR, the scene's scatter rate.
    """
    n = shape_index.shape[0]
    is_none = shape_index == SHAPE_INDEX_NONE
    safe_shape = torch.where(is_none, 0, shape_index)
    material = packed.shape_material[safe_shape]
    # Media never sample textures: the slim medium-column fetch.
    medium = dispatch.load_medium(
        fetch_medium_ctx(packed, material, lam, types), types)

    ambient_scatter = packed.scene_scatter_rate.expand(4, n)
    return dict(
        priority=shape_index,          # SHAPE_INDEX_NONE where there is none
        ior=torch.where(is_none, 1.0, medium['ior']),
        absorption=torch.where(is_none, 0.0, medium['absorption']),
        scattering=torch.where(is_none, ambient_scatter, medium['scattering']),
        anisotropy=torch.where(is_none, 0.0, medium['anisotropy']),
    )


def medium_event(packed, types, active_shapes, lam, throughput, probability,
                 hit, ray_origin, ray_direction, rng: Rng):
    """The medium event of a scatter round (basic_scatter.glsl:123-164 and
    the medium lookups of :177-200), as `medium_event_plain` computes it
    and with its draws from `rng`: on a CUDA device one launch of
    csrc/medium_event.cu (ops/medium_event.py), which adds the MEDIUM_LANES
    counter itself while tracing is on; on the CPU the plain version."""
    dev = ray_origin.device
    if dev.type == 'cuda':
        # The kernel reads each input as contiguous rows (a copy only where
        # one is not).
        lanes = dict(active_shapes=active_shapes, lam=lam,
                     throughput=throughput, probability=probability,
                     time=hit['time'], shape=hit['shape'],
                     normal=hit['normal'], origin=ray_origin,
                     direction=ray_direction, rng_state=rng.state)
        out = medium_event_kernel.medium_event(
            packed, types, {k: v.contiguous() for k, v in lanes.items()},
            stats=profiling.kernel_counts(MEDIUM_LANES, dev, bins=MEDIUM_BINS))
        rng.state = out.pop('rng_state')
        return out
    if dev.type != 'cpu':
        raise ValueError(f'medium_event: unsupported device {dev}')
    out = medium_event_plain(packed, types, active_shapes, lam, throughput,
                             probability, hit, ray_origin, ray_direction, rng)
    if profiling.enabled():
        profiling.count(MEDIUM_LANES, medium_bins(out), bins=MEDIUM_BINS)
    return out


def medium_bins(event):
    """Each lane's MEDIUM_BINS index from a medium event's outputs."""
    inside = (event['priority'] != SHAPE_INDEX_NONE).to(torch.int32)
    return torch.where(event['vol_scatter'], 2, inside)


def medium_event_plain(packed, types, active_shapes, lam, throughput,
                       probability, hit, ray_origin, ray_direction, rng: Rng):
    """The medium event in plain PyTorch, on any device.

    From the state's (LIMIT, N) active-shape lists, the (4, N) hero
    wavelengths, throughput and probability, the hit's time, shape and
    normal and the (3, N) ray: the innermost shape's medium (fetch_medium)
    and the absorption along the segment, then three draws from `rng`
    (the free flight, and the Henyey-Greenstein sample's two), the event
    masks, the volumetric branch for every lane, and the IOR on the other
    side of the surface hit (the current medium's where the ray enters
    it, the exterior shape's where it leaves it, 1 off a real interface).
    Returns dict(priority (N,) int32, throughput (4, N), medium_event,
    vol_scatter, sky_hit (N,) bool, vol_origin, vol_dir (3, N),
    vol_throughput, vol_probability, exterior_ior (4, N))."""
    active_shape = torch.amin(active_shapes, dim=0)
    medium = fetch_medium(packed, active_shape, lam, types)
    throughput = throughput * torch.exp(-medium['absorption'] * hit['time'])

    # Scattering event time at the primary wavelength.
    u_scatter = rng.uniform()
    rate0 = medium['scattering'][0]
    scattering_time = torch.where(
        rate0 > 0.0,
        -torch.log(torch.clamp(u_scatter, min=1e-12))
        / torch.clamp(rate0, min=1e-12),
        HIT_TIME_LIMIT)
    medium_event = hit['time'] >= scattering_time
    vol_scatter = medium_event & (scattering_time < HIT_TIME_LIMIT)

    # Volumetric scattering (basic_scatter.glsl:142-164).
    u1 = rng.uniform()
    u2 = rng.uniform()
    hg_local = sample_direction_hg(medium['anisotropy'], u1, u2)
    vx, vy = coordinate_frame(ray_direction)
    vol_dir = normalize(hg_local[0] * vx + hg_local[1] * vy
                        + hg_local[2] * ray_direction)
    density = medium['scattering'] * torch.exp(
        -medium['scattering'] * scattering_time)
    density = density / torch.clamp(max4(density), min=EPSILON)

    # Exterior IOR on the other side of the interface: the first shape of
    # the list after the innermost.
    hit_exterior = -dot(ray_direction, hit['normal']) > 0.0
    is_real = torch.where(hit_exterior, active_shape > hit['shape'],
                          active_shape == hit['shape'])
    exclude = torch.where(active_shapes == active_shape, SHAPE_INDEX_NONE,
                          active_shapes)
    exterior_medium = fetch_medium(packed, torch.amin(exclude, dim=0), lam,
                                   types)
    exterior_ior = torch.where(
        hit_exterior, medium['ior'],
        torch.where(is_real, exterior_medium['ior'], 1.0))
    return dict(
        priority=active_shape,
        throughput=throughput,
        medium_event=medium_event,
        vol_scatter=vol_scatter,
        sky_hit=medium_event & ~vol_scatter,
        vol_origin=ray_origin + ray_direction * scattering_time,
        vol_dir=vol_dir,
        vol_throughput=throughput * density,
        vol_probability=probability * density,
        exterior_ior=torch.where(is_real, exterior_ior, 1.0),
    )


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
                              sky_sampling=True, where=None):
    """SampleSurfaceIntegrand (basic_scatter.glsl:66-109): one-sample MIS
    between BSDF importance sampling and vMF skybox light sampling.
    view: (3, N) toward the viewer in tangent space. Returns (scattered
    (3, N), throughput (4, N), probability (4, N), valid (N,)).
    Without sky sampling the light branch's draws are still consumed, in one
    step of the stream, and its arithmetic is skipped.
    `where`: the lanes whose result is used (dispatch.sample_bsdf)."""
    if not sky_sampling:
        # The light branch's three draws (the choice and the vMF sample's
        # two), whose values nobody reads: one step of the stream.
        rng.skip(3)
        with profiling.span('pt.scatter.bsdf_sample'):
            return dispatch.sample_bsdf(ctx, view, rng, types, where)
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
    with profiling.span('pt.scatter.bsdf_sample'):
        bsdf_dir, bsdf_thr, bsdf_pdf, bsdf_ok = dispatch.sample_bsdf(
            ctx, view, rng, types, where)
    with profiling.span('pt.scatter.bsdf_eval'):
        eval_thr, eval_pdf, eval_ok = dispatch.evaluate_bsdf(ctx, view,
                                                             light_dir, types)
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
    `layout` gives the static scene flags. The medium event, the material
    fetch and the BSDF sample come first; the rest is `scatter_tail`.
    """
    with profiling.span('pt.scatter'):
        types = layout.material_types
        lam = hero_wavelength_cluster(state['lambda0'])  # (4, N)
        n_lanes = lam.shape[1]

        # The medium event: the lane's medium, the absorption, the free
        # flight at the primary wavelength, the volumetric branch and the
        # exterior IOR (medium_event). Statically medium-free scenes (no
        # translucent or OpenPBR material and no ambient scatter rate) skip
        # it: the priority is the raw shape index, the event time the
        # horizon, so no lane scatters in a volume (the JAX package's
        # vol_scatter is a constant False there, which its compiler folds
        # away, as the merges of the tail do), and a lane's event is the
        # skybox where it hit nothing. The three draws are still consumed.
        if layout.scene_has_medium:
            with profiling.span('pt.scatter.medium'):
                event = medium_event(packed, types, state['active_shapes'],
                                     lam, state['throughput'],
                                     state['probability'], hit, ray_origin,
                                     ray_direction, rng)
            surface_event = ~event['medium_event']
            # Exterior IOR on the other side of the interface.
            exterior_ior = event['exterior_ior']
        else:
            event = None
            rng.skip(3)
            surface_event = ~(hit['time'] >= HIT_TIME_LIMIT)
            exterior_ior = torch.ones((4, n_lanes), device=lam.device)

        # The view toward the viewer in tangent space.
        view = -vec3(dot(ray_direction, hit['tangent']),
                     dot(ray_direction, hit['bitangent']),
                     dot(ray_direction, hit['normal']))

        with profiling.span('pt.scatter.material'):
            ctx = fetch_ctx(packed, hit['material'], lam, hit['uv'], exterior_ior,
                            layout.materials_textured, layout.atlas_size, types,
                            layout.texture_filter_modes, layout.textured_attrs,
                            layout.atlas_quad_fit)
        profiling.count('pt.scatter.surface_lanes_by_type', ctx['type'],
                        bins=dispatch.TYPE_NAMES, where=surface_event)

        # Stochastic transparency: with probability (1 - opacity) the ray
        # passes straight through the surface, with no BSDF event, emission,
        # medium bookkeeping or roulette.
        ghost = None
        if layout.has_opacity:
            opacity = packed.materials.opacity[hit['material']]
            ghost = surface_event & (rng.uniform() >= opacity)

        # Only the surface events use the sample.
        integrand = _sample_surface_integrand(
            packed, ctx, hit, view, rng, types,
            sky_sampling=layout.has_skybox_sampling, where=surface_event)

        with profiling.span(TAIL_SPAN):
            return scatter_tail(packed, layout, state, ray_origin,
                                ray_direction, hit, event, lam, view, ctx,
                                ghost, integrand, rng, termination_probability)


def scatter_tail(packed, layout, state, ray_origin, ray_direction, hit, event,
                 lam, view, ctx, ghost, integrand, rng: Rng,
                 termination_probability):
    """The rest of a scatter round after the BSDF sample, as
    `scatter_tail_plain` computes it and with its draw from `rng`: on a
    CUDA device one launch of csrc/scatter_tail.cu (ops/scatter_tail.py),
    which adds the TAIL_LANES counter itself while tracing is on; on the
    CPU the plain version."""
    dev = ray_origin.device
    if dev.type == 'cuda':
        out = scatter_tail_kernel.scatter_tail(
            packed, layout,
            tail_lanes(state, ray_origin, ray_direction, hit, event, ctx,
                       ghost, integrand, rng),
            termination_probability,
            stats=profiling.kernel_counts(TAIL_LANES, dev, bins=TAIL_BINS))
        rng.state = out['rng_state']
        new_state = dict(
            lambda0=state['lambda0'],
            throughput=out['throughput'],
            probability=out['probability'],
            sample=out['sample'],
            active_shapes=out.get('active_shapes', state['active_shapes']),
        )
        return new_state, out['origin'], out['direction'], out['alive']
    if dev.type != 'cpu':
        raise ValueError(f'scatter_tail: unsupported device {dev}')
    out = scatter_tail_plain(packed, layout, state, ray_origin, ray_direction,
                             hit, event, lam, view, ctx, ghost, integrand, rng,
                             termination_probability)
    if profiling.enabled():
        profiling.count(TAIL_LANES, tail_bins(event, hit, ghost),
                        bins=TAIL_BINS)
    return out


def tail_lanes(state, ray_origin, ray_direction, hit, event, ctx, ghost,
               integrand, rng: Rng):
    """The tail kernel's lane inputs (ops/scatter_tail.py's LANE_INPUTS) by
    name from scatter's values, each as contiguous rows (a copy only where
    it is not): the medium event's throughput where there is an event,
    else the state's; the emission columns where fetch_ctx gathered them
    (OpenPBR in the type set)."""
    lanes = dict(lambda0=state['lambda0'], probability=state['probability'],
                 sample=state['sample'], active_shapes=state['active_shapes'],
                 origin=ray_origin, direction=ray_direction,
                 rng_state=rng.state,
                 **{k: hit[k] for k in ('time', 'shape', 'position', 'normal',
                                        'tangent', 'bitangent')})
    lanes.update(zip(('scattered', 's_throughput', 's_probability', 's_valid'),
                     integrand))
    if event is None:
        lanes['throughput'] = state['throughput']
    else:
        lanes.update((k, event[k]) for k in (
            'throughput', 'priority', 'vol_scatter', 'sky_hit', 'vol_origin',
            'vol_dir', 'vol_throughput', 'vol_probability'))
    if ghost is not None:
        lanes['ghost'] = ghost
    if 'emission_reflectance' in ctx:
        lanes.update((k, ctx[k]) for k in (
            'type', 'emission_reflectance', 'emission_luminance'))
    return {k: v.contiguous() for k, v in lanes.items()}


def tail_bins(event, hit, ghost):
    """Each lane's TAIL_BINS index from the medium event's outputs (None
    in a medium-free scene), the hit record and the ghost mask (None
    without opacity)."""
    if event is None:
        sky_hit = hit['time'] >= HIT_TIME_LIMIT
        bins = torch.where(sky_hit, 0, 2)
    else:
        bins = torch.where(event['sky_hit'], 0,
                           torch.where(event['vol_scatter'], 1, 2))
    if ghost is not None:
        bins = torch.where(ghost, 3, bins)
    return bins


def scatter_tail_plain(packed, layout, state, ray_origin, ray_direction, hit,
                       event, lam, view, ctx, ghost, integrand, rng: Rng,
                       termination_probability):
    """Scatter's own code after the BSDF sample in plain PyTorch, on any
    device (basic_scatter.glsl:165-310).

    From the path state, the (3, N) ray, the hit record, the medium event's
    outputs (`event`, None in a medium-free layout), the (4, N) hero
    wavelengths `lam`, the tangent-space `view`, the material context, the
    ghost mask (None without opacity) and the surface integrand (scattered,
    throughput, probability, valid): the sky's radiance, the observer and
    the emission into the sample, the surface branch, the active-shape
    bookkeeping, one draw from `rng` for Russian roulette, the new ray and
    the three-way merge. Returns (new_state, new_origin, new_direction,
    alive (N,))."""
    types = layout.material_types
    term = torch.tensor(termination_probability, dtype=torch.float32,
                        device=ray_origin.device)
    active_shapes = state['active_shapes']           # (LIMIT, N)
    probability = state['probability']
    sample = state['sample']                         # (3, N)

    scene_has_medium = layout.scene_has_medium
    if scene_has_medium:
        priority = event['priority']
        throughput = event['throughput']
        medium_event_mask = event['medium_event']
        vol_scatter = event['vol_scatter']
        sky_hit = event['sky_hit']
    else:
        priority = torch.amin(active_shapes, dim=0)
        throughput = state['throughput']
        medium_event_mask = sky_hit = hit['time'] >= HIT_TIME_LIMIT
    surface_event = ~medium_event_mask

    # Skybox emission (basic_scatter.glsl:165-172).
    emission = sample_skybox_radiance(packed, ray_direction, lam,
                                      layout.has_skybox_texture,
                                      layout.atlas_size,
                                      layout.texture_filter_modes,
                                      layout.atlas_quad_fit)
    cluster_pdf = torch.clamp(sum4(probability), min=1e-20)
    observer = sample_standard_observer(lam)  # (3, 4, N)
    sky_sample = sample + _observe(observer, emission * throughput) / cluster_pdf

    # Surface interaction (basic_scatter.glsl:177-309).
    hit_exterior = view[2] > 0.0
    shape_priority = hit['shape']
    is_real = torch.where(hit_exterior, priority > shape_priority,
                          priority == shape_priority)
    if ghost is None:
        ghost = torch.zeros_like(sky_hit)

    # Surface emission (OpenPBR area lights) on real exterior hits,
    # before the BSDF extends the path.
    emission_spec = dispatch.surface_emission(ctx, types)
    emissive_hit = surface_event & is_real & hit_exterior & ~ghost
    emit_contrib = _observe(observer, emission_spec * throughput) / cluster_pdf
    sample = torch.where(emissive_hit, sample + emit_contrib, sample)

    scattered, s_throughput, s_probability, s_valid = integrand

    scale = 1.0 / torch.clamp(max4(s_probability), min=EPSILON)
    surf_throughput = torch.where(is_real, throughput * s_throughput * scale,
                                  throughput)
    surf_probability = torch.where(is_real, probability * s_probability * scale,
                                   probability)
    in_dir = torch.where(is_real, scattered, -view)
    surf_valid = torch.where(is_real, s_valid, torch.ones_like(s_valid))

    # Active-shape list bookkeeping on boundary crossings
    # (basic_scatter.glsl:266-292). Where no material of the scene can
    # refract (not has_transmissive) nothing is ever inserted or removed,
    # so the block is dropped. The first free slot and the first match
    # are the smallest slot index under the mask; LIMIT where there is
    # none, which equals no slot (a full list takes no insert).
    if not layout.has_transmissive:
        new_active = active_shapes
    else:
        crossing = in_dir[2] * view[2] < 0.0
        entering = crossing & hit_exterior & surface_event
        leaving = crossing & ~hit_exterior & surface_event

        slots = torch.arange(ACTIVE_SHAPE_LIMIT, dtype=torch.int32,
                             device=view.device)[:, None]
        first_none = torch.amin(torch.where(active_shapes == SHAPE_INDEX_NONE,
                                            slots, ACTIVE_SHAPE_LIMIT), dim=0)
        new_active = torch.where(entering & (slots == first_none),
                                 hit['shape'], active_shapes)

        first_match = torch.amin(torch.where(new_active == hit['shape'], slots,
                                             ACTIVE_SHAPE_LIMIT), dim=0)
        new_active = torch.where(leaving & (slots == first_match),
                                 SHAPE_INDEX_NONE, new_active)
        new_active = torch.where(surface_event & ~ghost, new_active,
                                 active_shapes)

    # Russian roulette (basic_scatter.glsl:294-298).
    u_rr = rng.uniform()
    rr_survive = u_rr >= term
    surf_probability = surf_probability * (1.0 - term)

    surf_dir = normalize(in_dir[0] * hit['tangent'] + in_dir[1] * hit['bitangent']
                         + in_dir[2] * hit['normal'])
    # Self-intersection offset scaled with the hit distance.
    surf_eps = torch.clamp(1e-4 * hit['time'], min=1e-3)
    surf_origin = hit['position'] + surf_eps * surf_dir

    # Merge the three branches.
    def merge(vol, sky, surf):
        out = torch.where(sky_hit, sky, surf)
        return (torch.where(vol_scatter, event[vol], out)
                if scene_has_medium else out)

    new_throughput = merge('vol_throughput', throughput, surf_throughput)
    new_probability = merge('vol_probability', torch.zeros_like(probability),
                            surf_probability)
    new_sample = torch.where(sky_hit, sky_sample, sample)
    new_origin = merge('vol_origin', ray_origin, surf_origin)
    new_direction = merge('vol_dir', ray_direction, surf_dir)

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
        active_shapes=new_active,
    )
    return new_state, new_origin, new_direction, alive
