"""Scatter's tail as a function of its own, on the CPU.

`scatter` now runs the medium event, the material fetch and the BSDF
sample, then `scatter_tail`: on the card csrc/scatter_tail.cu, on the CPU
`scatter_tail_plain`, which is the code that followed the sample before,
moved into a function. Here the composed `scatter` is held, bit for bit in
every output and in the random state it leaves, to `scatter_seed`: the
function as it was written before the split, kept below as the reference,
with its light-branch draws computed in full where no layout reads them.
Then the stream's jump past unread draws against the draws themselves,
and the `pt.scatter.tail.lanes` counter against the round's branches.
"""

import numpy as np
import pytest
import torch

import path_tracer_tpu_torch.scene.model as model
import path_tracer_tpu_torch.scene.procedural as proc
from path_tracer_tpu_torch.core.constants import (
    ACTIVE_SHAPE_LIMIT, EPSILON, HIT_TIME_LIMIT, SHAPE_INDEX_NONE)
from path_tracer_tpu_torch.core.sampling import (
    Rng, random_von_mises_fisher, von_mises_fisher_pdf)
from path_tracer_tpu_torch.core.spectrum import (
    hero_wavelength_cluster, sample_standard_observer)
from path_tracer_tpu_torch.core.vec import dot, max4, normalize, sum4, vec3
from path_tracer_tpu_torch.integrator import scatter as tscatter
from path_tracer_tpu_torch.integrator import wavefront
from path_tracer_tpu_torch.integrator.scatter import (
    _observe, medium_event, sample_skybox_radiance)
from path_tracer_tpu_torch.models import dispatch
from path_tracer_tpu_torch.models.common import fetch_ctx
from path_tracer_tpu_torch.ops import intersect
from path_tracer_tpu_torch.scene.compile import compile_scene
from path_tracer_tpu_torch.utils import profiling

from test_torch_cuda import (
    blob_scene, glass_ball_scene, opacity_scene, openpbr_scene, same_bits,
    textured_scene)


# ---- the reference: scatter as it was before its tail became a function ----

def _seed_sample_surface_integrand(packed, ctx, hit, view, rng: Rng, types,
                              sky_sampling=True, where=None):
    """SampleSurfaceIntegrand (basic_scatter.glsl:66-109): one-sample MIS
    between BSDF importance sampling and vMF skybox light sampling.
    view: (3, N) toward the viewer in tangent space. Returns (scattered
    (3, N), throughput (4, N), probability (4, N), valid (N,)).
    Without sky sampling the light-branch draws are still consumed.
    `where`: the lanes whose result is used (dispatch.sample_bsdf)."""
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
    with profiling.span('pt.scatter.bsdf_sample'):
        bsdf_dir, bsdf_thr, bsdf_pdf, bsdf_ok = dispatch.sample_bsdf(
            ctx, view, rng, types, where)
    if not sky_sampling:
        return bsdf_dir, bsdf_thr, bsdf_pdf, bsdf_ok
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


def scatter_seed(packed, state, ray_origin, ray_direction, hit, rng: Rng,
            termination_probability, layout):
    """One scatter round for all lanes (basic_scatter.glsl:114-310).

    ray_origin/ray_direction: (3, N). Returns (new_state, new_origin,
    new_direction, alive (N,)); dead lanes carry their final `sample`.
    `layout` gives the static scene flags.
    """
    with profiling.span('pt.scatter'):
        types = layout.material_types
        term = torch.tensor(termination_probability, dtype=torch.float32,
                            device=ray_origin.device)
        lam = hero_wavelength_cluster(state['lambda0'])  # (4, N)

        active_shapes = state['active_shapes']           # (LIMIT, N)
        probability = state['probability']
        sample = state['sample']                         # (3, N)
        n_lanes = active_shapes.shape[1]

        # The medium event: the lane's medium, the absorption, the free
        # flight at the primary wavelength, the volumetric branch and the
        # exterior IOR (medium_event). Statically medium-free scenes (no
        # translucent or OpenPBR material and no ambient scatter rate) skip
        # it: the priority is the raw shape index, the event time the
        # horizon, so no lane scatters in a volume (the JAX package's
        # vol_scatter is a constant False there, which its compiler folds
        # away, as the merges below do), and a lane's event is the skybox
        # where it hit nothing. The three draws are still consumed.
        scene_has_medium = layout.scene_has_medium
        if scene_has_medium:
            with profiling.span('pt.scatter.medium'):
                event = medium_event(packed, types, active_shapes, lam,
                                     state['throughput'], probability, hit,
                                     ray_origin, ray_direction, rng)
            priority = event['priority']
            throughput = event['throughput']
            medium_event_mask = event['medium_event']
            vol_scatter = event['vol_scatter']
            sky_hit = event['sky_hit']
        else:
            priority = torch.amin(active_shapes, dim=0)
            throughput = state['throughput']
            for _ in range(3):
                rng.uniform()
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
        view = -vec3(dot(ray_direction, hit['tangent']),
                     dot(ray_direction, hit['bitangent']),
                     dot(ray_direction, hit['normal']))
        hit_exterior = view[2] > 0.0
        shape_priority = hit['shape']
        is_real = torch.where(hit_exterior, priority > shape_priority,
                              priority == shape_priority)
        # Exterior IOR on the other side of the interface.
        exterior_ior = (event['exterior_ior'] if scene_has_medium
                        else torch.ones((4, n_lanes), device=view.device))

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
        if layout.has_opacity:
            opacity = packed.materials.opacity[hit['material']]
            ghost = surface_event & (rng.uniform() >= opacity)
        else:
            ghost = torch.zeros_like(sky_hit)

        # Surface emission (OpenPBR area lights) on real exterior hits,
        # before the BSDF extends the path.
        emission_spec = dispatch.surface_emission(ctx, types)
        emissive_hit = surface_event & is_real & hit_exterior & ~ghost
        emit_contrib = _observe(observer, emission_spec * throughput) / cluster_pdf
        sample = torch.where(emissive_hit, sample + emit_contrib, sample)

        # Only the surface events use the sample.
        scattered, s_throughput, s_probability, s_valid = _seed_sample_surface_integrand(
            packed, ctx, hit, view, rng, types,
            sky_sampling=layout.has_skybox_sampling, where=surface_event)

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


# ---- the tests ---------------------------------------------------------------

def generic_scene(m, p):
    """The textured scene compiled with the generic layout: every model,
    opacity, a medium, transmissive bookkeeping and sky sampling."""
    scene = textured_scene(m, p)
    scene.compile_generic = True
    return scene


# Scenes that between them take every branch of the layout: a sky texture
# with sky sampling (textured), a medium-free metal scene under the default
# sky (blob), glass with its medium and bookkeeping (glass_ball), fog,
# nested glass and OpenPBR emission (openpbr), ghosts (opacity), and the
# generic layout.
SCENES = {
    'textured': lambda: textured_scene(model, proc),
    'blob': lambda: blob_scene(model)[0],
    'glass_ball': lambda: glass_ball_scene(model, proc),
    'openpbr': lambda: openpbr_scene(model, proc),
    'opacity': lambda: opacity_scene(model, proc),
    'generic': lambda: generic_scene(model, proc),
}


def round_inputs(name, width=32, height=16, rounds=2, seed=5):
    """The packed scene, its layout and a render state after `rounds`
    rounds on the CPU, with the hit record of the next round's rays."""
    packed = compile_scene(SCENES[name](), aspect_ratio=width / height,
                           device='cpu')
    layout = intersect.SceneLayout.from_packed(packed)
    config = wavefront.RenderConfig(width=width, height=height)
    state = wavefront.reset(packed, config, seed=seed)
    for _ in range(rounds):
        wavefront.render_round(packed, layout, config, state, 0.05)
    hit = intersect.trace(packed, layout, state['origin'], state['direction'])
    return packed, layout, state, hit


def run_scatter(fn, packed, layout, state, hit, term=0.05):
    rng = Rng(state['rng_state'].clone())
    path, origin, direction, alive = fn(
        packed, state['path'], state['origin'], state['direction'], hit, rng,
        term, layout)
    return dict(path, origin=origin, direction=direction, alive=alive,
                rng_state=rng.state)


@pytest.mark.parametrize('name', sorted(SCENES))
def test_scatter_matches_the_seed_function(name):
    """`scatter` (the medium event, the fetch and the sample, then
    `scatter_tail_plain`) against `scatter_seed` from the same state and
    hit record: equal to the bit in every output and in the random state
    it leaves."""
    packed, layout, state, hit = round_inputs(name)
    got = run_scatter(tscatter.scatter, packed, layout, state, hit)
    want = run_scatter(scatter_seed, packed, layout, state, hit)
    assert set(got) == set(want)
    for key in want:
        assert same_bits(got[key], want[key]), (
            key, int((got[key] != want[key]).sum()))
    assert bool(want['alive'].any()) and not bool(want['alive'].all())


def test_scatter_matches_the_seed_function_with_tracing():
    """The same with the program's tracing on: the tail's counter changes
    no output."""
    packed, layout, state, hit = round_inputs('openpbr')
    with profiling.tracing():
        got = run_scatter(tscatter.scatter, packed, layout, state, hit)
    want = run_scatter(scatter_seed, packed, layout, state, hit)
    for key in want:
        assert same_bits(got[key], want[key]), key


STATES = [0, 1, 2, 12345, 2 ** 31 - 1, 2 ** 31, 2 ** 32 - 3, 2 ** 32 - 2,
          2 ** 32 - 1]


@pytest.mark.parametrize('draws', [0, 1, 2, 3, 6, 7])
def test_skip_equals_the_draws(draws):
    """Rng.skip(k) leaves the state that k draws leave, on states at both
    ends of the 32-bit range (where a multiplier of 2^32 would wrap int64)
    and on random ones."""
    values = STATES + list(np.random.default_rng(3).integers(
        0, 2 ** 32, 4096))
    start = torch.tensor(values, dtype=torch.int64)
    stepped = Rng(start.clone())
    for _ in range(draws):
        stepped.next_u32()
    jumped = Rng(start.clone())
    jumped.skip(draws)
    assert torch.equal(jumped.state, stepped.state)
    assert int(jumped.state.min()) >= 0 and int(jumped.state.max()) < 2 ** 32


TAIL_ARGS = ('packed', 'layout', 'state', 'ray_origin', 'ray_direction', 'hit',
             'event', 'lam', 'view', 'ctx', 'ghost', 'integrand', 'rng',
             'termination_probability')


def traced_tail(name):
    """One scatter of `name`'s round on the CPU with tracing on: the
    arguments `scatter` handed `scatter_tail_plain` by name, and the
    counters."""
    packed, layout, state, hit = round_inputs(name)
    captured = []
    tail = tscatter.scatter_tail_plain

    def capture(*args):
        captured.append(dict(zip(TAIL_ARGS, args)))
        return tail(*args)

    tscatter.scatter_tail_plain = capture
    try:
        with profiling.tracing():
            run_scatter(tscatter.scatter, packed, layout, state, hit)
            counted = profiling.counters()
    finally:
        tscatter.scatter_tail_plain = tail
    (args,), = [captured]
    return args, counted


@pytest.mark.parametrize('name', ['openpbr', 'opacity', 'textured'])
def test_tail_lanes_partition_the_lanes(name):
    """While tracing, `pt.scatter.tail.lanes` counts every lane of a round
    once: sky, volume, surface or ghost, as the medium event and the ghost
    mask say; the fog scene scatters in volumes (and no path reaches its
    sky), the opacity scene has ghosts."""
    args, counted = traced_tail(name)
    bins = counted[tscatter.TAIL_LANES]
    assert tuple(bins) == tscatter.TAIL_BINS
    assert sum(bins.values()) == 32 * 16
    event, hit, ghost = args['event'], args['hit'], args['ghost']
    if event is None:
        sky = hit['time'] >= HIT_TIME_LIMIT
        vol = torch.zeros_like(sky)
    else:
        sky, vol = event['sky_hit'], event['vol_scatter']
    ghost = torch.zeros_like(sky) if ghost is None else ghost
    assert bins == dict(sky=int(sky.sum()), volume=int(vol.sum()),
                        surface=int((~sky & ~vol & ~ghost).sum()),
                        ghost=int(ghost.sum()))
    assert bins['surface'] > 0
    assert (bins['sky'] > 0) == (name != 'openpbr')
    assert (bins['volume'] > 0) == (name == 'openpbr')
    assert (bins['ghost'] > 0) == (name == 'opacity')
    assert counted.get('kernel.scatter_tail', 0) == 0


@pytest.mark.parametrize('name', ['glass_ball', 'opacity', 'openpbr'])
def test_tail_kernel_wrapper_checks_its_inputs(name):
    """The kernel's wrapper takes the lanes `tail_lanes` builds from a
    round's values, every input its layout reads and no other, and on the
    CPU raises ValueError before any launch: for the device, and first
    for a tensor of another dtype, shape or layout."""
    from path_tracer_tpu_torch.ops import scatter_tail

    args, _ = traced_tail(name)
    lanes = tscatter.tail_lanes(*(args[k] for k in (
        'state', 'ray_origin', 'ray_direction', 'hit', 'event', 'ctx',
        'ghost', 'integrand', 'rng')))
    flags = scatter_tail.layout_flags(args['layout'])
    assert set(lanes) == {n for n, _, _, flag in scatter_tail.LANE_INPUTS
                          if not flag or flags & flag}
    packed, layout = args['packed'], args['layout']
    with pytest.raises(ValueError, match='CUDA device'):
        scatter_tail.scatter_tail(packed, layout, lanes, 0.05)
    bad = dict(time=lanes['time'].double(), shape=lanes['shape'].float(),
               normal=lanes['normal'][:2],
               probability=lanes['probability'][:, :100],
               direction=lanes['direction'].T.contiguous().T,
               s_valid=lanes['s_valid'].to(torch.int32),
               rng_state=lanes['rng_state'].to(torch.int32))
    for key, value in bad.items():
        with pytest.raises(ValueError, match=key):
            scatter_tail.scatter_tail(packed, layout, dict(lanes, **{key: value}),
                                      0.05)
    with pytest.raises(ValueError, match='stats'):
        scatter_tail.scatter_tail(packed, layout, lanes, 0.05,
                                  stats=torch.zeros(3, dtype=torch.int64))
