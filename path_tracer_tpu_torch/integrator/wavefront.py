"""Wavefront render loop: rounds of trace + scatter + accumulate + respawn.

Port of path_tracer_tpu/integrator/wavefront.py (RunBasicRenderer /
ResetBasicRenderer, basic.cpp:285-332). The JAX package fuses a
lax.fori_loop of rounds into one program; here a round is one iteration
of a Python loop, and the render state dict is updated IN PLACE (its
tensors are replaced round by round, and `render` returns the same dict
it was given), so a caller holds one state and never two.

The accumulator is (3, N) XYZ + (N,) counts, one slot per state lane;
slots map to pixels many-to-one when RenderConfig.waves > 1 and are
folded per pixel by integrator.resolve.

Not ported: the JAX package's chunked scatter side (it slices the
scatter into ~2M-lane chunks to keep XLA's fusion shape on the TPU) and
`_sort_state` (a whole-state co-sort kept for TPU A/B tools). Both are
TPU workarounds; see ROADMAP.md.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..core.constants import RENDER_FLAG_ACCUMULATE, RENDER_FLAG_SAMPLE_JITTER
from ..core.sampling import Rng
from ..ops.intersect import SceneLayout, trace
from ..utils import log
from .scatter import scatter
from .state import merge_paths, new_paths


@dataclass(frozen=True)
class RenderConfig:
    """Static render configuration."""

    width: int = 2048
    height: int = 1024
    camera_index: int = 0
    camera_model: int = 0
    flags: int = RENDER_FLAG_ACCUMULATE | RENDER_FLAG_SAMPLE_JITTER
    rounds_per_call: int = 1
    # Feed the mesh trace rays sorted by (direction octant, origin
    # Morton cell, direction Morton) every round (ops.intersect.trace
    # sort_rays); the state itself stays in lane order. The sort changes
    # which rays share a warp, not the results.
    sort_rays: bool = True
    # Independent sample waves held in flight: the state carries
    # waves * width * height slots (slot = wave * n_pixels + lane, each
    # slot its own RNG stream of the same pixel grid) and every round
    # advances all of them; resolve folds the waves per pixel. The JAX
    # package also sorts each wave separately and interleaves them to
    # stay under a TPU gather cliff; the port sorts all slots at once.
    waves: int = 1


def wants_sort(config: RenderConfig, layout) -> bool:
    """The per-round coherence sort runs whenever the instanced mesh
    trace does; analytic-only scenes have no traversal to feed."""
    return bool(config.sort_rays and layout is not None
                and layout.instance_slots and layout.packet_mode == 'inst')


def reset(packed, config: RenderConfig, seed, slot=None):
    """ResetBasicRenderer: fresh paths + camera rays + cleared accumulator.

    `slot` optionally restricts the state to a slice of the global slot
    space (a (N,) int tensor); defaults to all config.waves * width *
    height slots. A slot's pixel lane is slot % (width * height) and its
    RNG stream id is the slot itself.
    """
    dev = packed.camera_model.device
    if slot is None:
        slot = torch.arange(config.waves * config.width * config.height,
                            dtype=torch.int32, device=dev)
    n = slot.shape[0]
    lane = slot % (config.width * config.height)
    rng = Rng.seed(slot, seed)
    state, origin, direction = new_paths(
        packed, config.camera_index, config.camera_model,
        config.width, config.height, rng, config.flags, lane)
    accum = dict(xyz=torch.zeros((3, n), dtype=torch.float32, device=dev),
                 count=torch.zeros((n,), dtype=torch.float32, device=dev))
    return dict(path=state, origin=origin, direction=direction,
                accum=accum, rng_state=rng.state, lane=lane)


def render_round(packed, layout: SceneLayout, config: RenderConfig,
                 rs, termination_probability, sort_rays=False):
    """One round, in place on the state dict `rs`: trace, scatter,
    accumulate the samples of terminated paths, respawn them."""
    hit = trace(packed, layout, rs['origin'], rs['direction'],
                sort_rays=sort_rays)
    rng = Rng(rs['rng_state'])
    path, origin, direction, alive = scatter(
        packed, rs['path'], rs['origin'], rs['direction'], hit, rng,
        termination_probability, layout)

    dead = ~alive
    accum = rs['accum']
    if config.flags & RENDER_FLAG_ACCUMULATE:
        accum['xyz'] = accum['xyz'] + torch.where(
            dead, path['sample'], torch.zeros_like(path['sample']))
        accum['count'] = accum['count'] + dead.to(torch.float32)
    else:
        accum['xyz'] = torch.where(dead, path['sample'], accum['xyz'])
        accum['count'] = torch.where(dead, torch.ones_like(accum['count']),
                                     accum['count'])

    fresh, cam_origin, cam_direction = new_paths(
        packed, config.camera_index, config.camera_model,
        config.width, config.height, rng, config.flags, rs['lane'])
    rs['path'] = merge_paths(path, fresh, dead)
    rs['origin'] = torch.where(dead, cam_origin, origin)
    rs['direction'] = torch.where(dead, cam_direction, direction)
    rs['rng_state'] = rng.state
    return rs


def render_rounds(packed, layout: SceneLayout, config: RenderConfig,
                  render_state, termination_probability, rounds=None,
                  sort_each_round=False):
    """Run `rounds` rounds on `render_state` (updated in place and
    returned). One round advances every path by one vertex; terminated
    paths deposit their sample and respawn at their pixel
    (basic_scatter.glsl:344-359)."""
    rounds = config.rounds_per_call if rounds is None else rounds
    for _ in range(int(rounds)):
        render_round(packed, layout, config, render_state,
                     termination_probability, sort_rays=sort_each_round)
    return render_state


def render(packed, config: RenderConfig, spp_rounds, seed=0,
           termination_probability=0.05, layout=None, state=None):
    """Convenience entry point: reset (unless resuming with `state`) + rounds.

    spp_rounds is the number of wavefront rounds. Returns the render
    state (pass it back via `state=` to continue accumulating).
    """
    layout = layout or SceneLayout.from_packed(packed)
    if state is None:
        state = reset(packed, config, seed)
    sorted_ = wants_sort(config, layout)
    with log.timer('render.dispatch', rounds=int(spp_rounds),
                   lanes=config.width * config.height, sorted=sorted_):
        return render_rounds(packed, layout, config, state,
                             termination_probability, int(spp_rounds),
                             sort_each_round=sorted_)
