"""Offline progressive render, as the CLI's `render` runs it.

Set-up: the scene from the configuration, `compile_scene`,
`wavefront.reset` with the seed, `warmup_rounds` rounds and a resolve.
Window: `wavefront.render(..., state=state, layout=layout)` in chunks of
`chunk_rounds` rounds, a synchronise after each to read the clock, until
the window's seconds have passed; then `resolve.resolve` and a
synchronise close it. With --trace 1, `trace_rounds` more rounds follow
under the profiler, with the trace and scatter calls in spans.

Parameters: width, height, waves, termination_probability,
packet_mode (the mode the program must pick), chunk_rounds,
warmup_rounds, trace_rounds, brightness, tonemap.
"""

from __future__ import annotations

import time

from benchmark.harness import check, profile, stats
from benchmark.reference.plain.integrator.state import lane_to_pixel


def run(ctx):
    import torch

    from path_tracer_tpu_torch.core.constants import (
        RENDER_FLAG_ACCUMULATE,
        RENDER_FLAG_SAMPLE_JITTER,
    )
    from path_tracer_tpu_torch.integrator import resolve as resolve_mod
    from path_tracer_tpu_torch.integrator import wavefront
    from path_tracer_tpu_torch.ops.intersect import SceneLayout
    from path_tracer_tpu_torch.scene.compile import compile_scene

    p = ctx.params
    width, height, waves = p['width'], p['height'], p['waves']
    term = p['termination_probability']
    dev = ctx.device
    flags = RENDER_FLAG_ACCUMULATE | RENDER_FLAG_SAMPLE_JITTER
    p['flags'] = flags
    p['seed'] = ctx.seed

    ctx.mark('program imported')
    scene = ctx.program_scene()
    t0 = time.perf_counter()
    packed = compile_scene(scene, aspect_ratio=width / height, device=dev)
    ctx.sync()
    ctx.compile_s = time.perf_counter() - t0
    layout = SceneLayout.from_packed(packed)
    if layout.packet_mode != p['packet_mode']:
        raise RuntimeError(f'the program chose packet mode {layout.packet_mode!r}, '
                           f'the mix states {p["packet_mode"]!r}')
    config = wavefront.RenderConfig(
        width=width, height=height, waves=waves, flags=flags,
        camera_model=packed.host_camera_models[0])
    n = waves * width * height
    ctx.lanes = n
    ctx.mark('scene compiled')
    state = wavefront.reset(packed, config, ctx.seed)
    idx = torch.as_tensor(check.sample_slots(ctx.seed, n), device=dev)
    reset_snap = check.snapshot(state, idx)

    def rounds(count):
        wavefront.render(packed, config, count, state=state, layout=layout,
                         termination_probability=term)

    def resolve():
        return resolve_mod.resolve(state['accum'], width, height,
                                   brightness=p['brightness'],
                                   mode=p['tonemap'], lane=state['lane'])

    ctx.sync()
    ctx.mark('state reset')
    rounds(p['warmup_rounds'])
    resolve()
    ctx.sync()
    ctx.setup_done()

    done = 0
    t_start = time.perf_counter()
    while True:
        rounds(p['chunk_rounds'])
        done += p['chunk_rounds']
        ctx.sync()
        if time.perf_counter() - t_start >= ctx.seconds:
            break
    image = resolve()
    ctx.sync()
    window_s = time.perf_counter() - t_start
    ctx.attempted = done
    ctx.window_s_per_unit = window_s / done
    ctx.end_to_end['mrays_per_s'] = stats.mrays_per_s(n, done, window_s)
    ctx.read_memory_peak()

    # The check, part 1: the window's image at the sampled pixels (placed
    # by the reference's lane-to-pixel map), and the accumulator it was
    # resolved from.
    n_pix = width * height
    pix = torch.unique(idx % n_pix)
    slots = pix[:, None] + n_pix * torch.arange(waves, device=dev)[None, :]
    px, py = lane_to_pixel(pix, width, height)
    cap = dict(params=p, slots=idx, reset=reset_snap,
               pixels=dict(values=image[py, px].t(),
                           xyz=state['accum']['xyz'][:, slots],
                           count=state['accum']['count'][slots]))
    del image

    if ctx.trace:
        spans = profile.Spans()
        spans.wrap(wavefront, 'trace', 'bench.trace')
        spans.wrap(wavefront, 'scatter', 'bench.scatter')
        try:
            ctx.profile(lambda: rounds(p['trace_rounds']), spans,
                        rounds=p['trace_rounds'])
        finally:
            spans.restore()
        ctx.triangles = sum(len(m.faces) for m in scene.meshes)
        ctx.mesh_instances = layout.instance_slots

    # Part 2: one more round of the window's call on the window's state,
    # with the sampled lanes' state before and after it and its hit
    # records captured.
    cap['before'] = check.snapshot(state, idx)
    with check.capture_hits(wavefront, idx) as hits:
        rounds(1)
    cap['hit'] = hits.get('hit')
    cap['after'] = check.snapshot(state, idx)
    return cap
