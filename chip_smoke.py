"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py        (from the repository root)

Drives path_tracer_tpu_torch's trace paths on the card and holds its
hand-written kernels against their plain PyTorch versions:

  1. the card's name and power limit (nvidia-smi);
  2. builds every CUDA kernel from path_tracer_tpu_torch/csrc/ (one
     torch.utils.cpp_extension.load call, nvcc for sm_90a), and reads
     registers, stack frame and spills of every kernel instantiation from
     `nvcc -Xptxas=-v` (a spill fails the run);
  3. compiles the textured viking hall (detail=1) for 1920x1080 in 'inst'
     mode (two-level instanced tables) and in 'flat' mode (one
     world-flattened BVH8), in each of the three leaf formats, with the
     bytes of the tables;
  4. each kernel -- inst_trace, wide_trace5 (v5) and wide_trace (v3) --
     against its plain version on the 2,073,600 primary rays of `reset`
     and on the rays after 2 rounds, in ray_sort_key order, for each leaf
     format, bit for bit (kernel and plain version take the same per-ray
     traversal order): a 65,536-ray subset of every set, and all rays of
     the bounce set in the default format. What is compared and timed is
     the launch the render paths make (for wide_trace, the launch of the
     direct call); the launch with the per-ray counters, another
     instantiation, must give the same. The baseline kernels
     (variant='simple') likewise against the plain versions without the
     pop cull, and the pop cull's effect (`pop_cull`); kernel time warm
     and cold in sorted and in lane order (CUDA events, median of 7; cold
     = a buffer larger than L2 written before each launch), plain time,
     and the kernel's bound from its counted pops and triangles;
     `kernel_anatomy`: what each kernel measured of itself (SIMT
     efficiency of each loop body, distinct rows a warp fetches in a pass,
     deepest stack, culled pops); `kernel_ab`:
     the kernel and its baseline in turns, on rays in sorted and in lane
     order;
  5. the three kernels against one another on the bounce rays (hit masks
     equal on > 99.5% of the rays, t within 5e-4 on > 99.9% of the rays
     all three hit);
  6. the 'inst' path end to end: `render` at 1920x1080, 6 warm-up and 24
     timed rounds, Mrays/s; inst_trace's launch count must equal the
     rounds run and the baseline kernels are never launched; the time of
     `trace` alone with and without the ray sort on steady-state and on
     primary rays (`trace_sort`), and, from a profile of 4 more rounds, the
     device time by kernel;
  7. the same for the 'flat' path: wide_trace5 is launched once a round
     and inst_trace not at all;
  8. `trace(use_packet=False)`, the portable BVH2 traversal, against
     `trace` through wide_trace5 on 65,536 bounce rays (same bounds);
  9. the 192x108, 24-round, seed-123 viking frame through `render_scene`
     in both modes against data/bench_goldens/3_viking_hall.npz within
     bench.py's Monte-Carlo bands;
 10. a diffuse + metal scene of two mesh instances, a plane and a sphere
     at 640x320, 16 rounds, in both modes;
 11. `media_render`: bench config 5 (`make_multi_mesh_scene(detail=1)`: the
     viking hall, a glass mesh ball whose medium scatters, a metal cube) at
     3840x2160 in 'inst' mode, 2 warm-up and 6 timed rounds: Mrays/s,
     round ms, launches (inst_trace once a round, no other kernel), peak
     memory, the share of lanes inside the ball (non-empty active-shape
     list) after the timed rounds, which must be above 0, and a profile of
     2 more rounds;
 12. the golden frames of bench configs 1, 2, 4 and 5 (config 5 in both
     modes) through `render_scene`, 192x108, 24 rounds, seed 123, against
     data/bench_goldens/ within the bands of phase 9;
 13. the OpenPBR scene of tests/test_torch_cuda.py (coat, metal and
     translucent bases, emitters, the fallback material, nested glass, fog)
     at 96x48, 16 rounds, on the card and on the CPU: finite, not black,
     within 2% mean absolute error and 2% bias of each other.

Every phase prints its lines; any failure raises and exits non-zero. The
last three lines are the card's name and power limit, the
{"kernels": [...]} record and {"ok": true, "device": {...}}. Without a
CUDA device it exits 1 and prints no result.
"""

import contextlib
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import time

DEVICE = 'cuda'
WIDTH, HEIGHT = 1920, 1080
WARMUP_ROUNDS, TIMED_ROUNDS = 6, 24
MEDIA_WIDTH, MEDIA_HEIGHT = 3840, 2160     # bench.py's size of config 5
SUBSET = 65536          # rays the plain version checks per ray set
TIMING_REPS = 7
LEAF_FMTS = ('bary', 'mt', 'woop')
# H100 SXM peaks: HBM bytes/s (NVIDIA data sheet) and float32 instructions/s
# outside the tensor cores, 132 SMs x 128 lanes x 1.98 GHz. The data sheet's
# 67e12 counts a fused multiply-add as two; the kernels are built with
# -fmad=false, so each operation counted below is one instruction.
PEAK_BYTES_S = 3.35e12
PEAK_F32_S = 33.5e12
# float32 operations per unit of traversal work, counted from the kernel
# sources (add, mul, min/max, compare and divide count one): a ray's setup
# (3 safe reciprocals, 3 products; trace_inst.cu also takes the octant), an
# instance entry of trace_inst.cu (3x4 transform, reciprocals, products), an
# interior pop (8 children x 6 slab planes x (mul, sub), 6 min/max, 4
# min/max, 4 compares; the same traverse.cuh code in all three kernels) and
# one triangle of a leaf row in each geometry format. trace_wide.cu tests
# 'mt' after forming the two edges (6 subtractions) and lerps normal and uv
# of a winner (2 + 5 x 5); its bound counts one lerp for each ray that hits.
OPS_RAY = 15
OPS_ENTER = 36
OPS_INTERIOR = 8 * (12 + 6 + 4 + 4)
OPS_TRIANGLE = {'bary': 36, 'mt': 55, 'woop': 45}
OPS_TRIANGLE_V3 = OPS_TRIANGLE['mt'] + 6
OPS_LERP_V3 = 27


def log(phase, **fields):
    print(json.dumps(dict(phase=phase, **fields)), flush=True)


def card_line():
    out = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'],
        check=True, capture_output=True, text=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def cuda_ms(fn, reps=TIMING_REPS, flush=None):
    """Median milliseconds of fn() over `reps` runs after one warm-up,
    each bracketed by CUDA events on the current stream. `flush()`, when
    given, runs before each timed run, outside the events: with a write
    of more than the L2's 50 MB it gives the time a caller sees whose
    other kernels have pushed the tables out of the cache."""
    import torch
    fn()
    times = []
    for _ in range(reps):
        if flush is not None:
            flush()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def time_in_turns(calls, reps, flush=None):
    """{name: median ms} of one launch of each call, the calls taken in
    turns, forwards and backwards alternately, each launch bracketed by
    CUDA events; `flush()` runs before each timed launch when given. Two
    kernels are compared so, within one run on one card."""
    import torch
    times = {name: [] for name in calls}
    for fn in calls.values():
        fn()
    torch.cuda.synchronize()
    order = list(calls)
    for rep in range(reps):
        for name in (order if rep % 2 == 0 else order[::-1]):
            if flush is not None:
                flush()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            calls[name]()
            end.record()
            end.synchronize()
            times[name].append(start.elapsed_time(end))
    return {name: statistics.median(v) for name, v in times.items()}


def start_ptxas(csrc, flags, out_dir, names=None):
    """One `nvcc -Xptxas=-v -c` per kernel source of `csrc` (or those in
    `names`), all started together; `read_ptxas` collects what they
    print."""
    nvcc = shutil.which('nvcc') or '/usr/local/cuda/bin/nvcc'
    os.makedirs(out_dir, exist_ok=True)
    return {name: subprocess.Popen(
        [nvcc, *flags, '-Xptxas=-v', '-c', os.path.join(csrc, name), '-o',
         os.path.join(out_dir, name + '.ptxas.o')], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
        for name in sorted(names or os.listdir(csrc)) if name.endswith('.cu')}


def kernel_name(entry):
    """`name<template arguments>` of a mangled kernel symbol: the
    length-prefixed identifier that ends in `_kernel`."""
    for run in re.finditer(r'\d+', entry):
        for start in range(run.start(), run.end()):
            length = int(entry[start:run.end()])
            name = entry[run.end():run.end() + length]
            if name.endswith('_kernel') and len(name) == length:
                args = re.match(r'I((?:L[a-z]\d+E)+)E', entry[run.end() + length:])
                if args:
                    name += '<%s>' % ','.join(
                        re.findall(r'L[a-z](\d+)E', args.group(1)))
                return name
    return entry


def read_ptxas(procs, fail_on_spill=True, **fields):
    """One `ptxas` line per kernel instantiation (the template arguments
    are leaf format and stats mode); a kernel that spills fails the run
    unless `fail_on_spill` is off. Returns the records it logged."""
    records = []
    for name, proc in procs.items():
        text = proc.communicate(timeout=600)[0]
        found = re.findall(
            r"Compiling entry function '(\w+)'.*?"
            r'(\d+) bytes stack frame, (\d+) bytes spill stores, '
            r'(\d+) bytes spill loads\s+ptxas info\s*: Used (\d+) registers',
            text, flags=re.S)
        if proc.returncode != 0 or not found:
            raise RuntimeError(f'nvcc -Xptxas=-v failed on {name}:\n{text}')
        for entry, stack, stores, loads, regs in found:
            records.append(dict(
                phase='ptxas', **fields, source=name, kernel=kernel_name(entry),
                registers=int(regs), stack_frame_bytes=int(stack),
                spill_store_bytes=int(stores), spill_load_bytes=int(loads)))
            log(**records[-1])
            if fail_on_spill and (int(stores) or int(loads)):
                raise RuntimeError(f'{entry} of {name} spills registers')
    return records


def compare(kernel_name, set_name, kernel_out, plain_out):
    """Hold a kernel's outputs (t, face, ...) to its plain version's bit
    for bit on every ray: both take each ray's own traversal order and
    round every operation alike (the kernels are built with -fmad=false),
    so tolerance zero. Returns (largest |difference| over the float
    outputs, face agreement)."""
    import torch
    same = [torch.equal(k, p) for k, p in zip(kernel_out, plain_out)]
    agree = (kernel_out[1] == plain_out[1]).float().mean().item()
    max_err = max((k - p).abs().max().item()
                  for k, p in zip(kernel_out, plain_out) if k.is_floating_point())
    log('compare', kernel=kernel_name, set=set_name,
        rays=int(plain_out[1].numel()),
        hit_rays=int((plain_out[1] >= 0).sum()), face_agreement=agree,
        max_abs_err=max_err, outputs=len(same), outputs_equal=same)
    if not (all(same) and bool((plain_out[1] >= 0).any())):
        raise RuntimeError(f'the {kernel_name} kernel disagrees with its '
                           f'plain version on {set_name}')
    return max_err, agree


def fraction_close(a, b, tol=5e-4):
    """Share of elements with |a - b| <= tol + tol * |b|. Two traversals
    whose triangle tests round differently (another leaf format, object
    against world space) agree so on all but the few rays that pass
    through an edge shared by two triangles, where one test may let the
    ray through to what lies behind."""
    return ((a - b).abs() <= tol + tol * b.abs()).float().mean().item()


def kernel_bound(counts, n_rays, table_bytes, out_words, ops_triangle,
                 extra_ops=0):
    """Least time the card could take for this traversal: the larger of
    the compulsory bytes (tables and the 7 ray rows read once, the
    `out_words` result rows written once) over HBM bandwidth and the
    counted float32 operations over the float32 peak. `counts` holds the
    per-ray interior pops, leaf pops, leaf rows, for inst_trace the
    instance entries, and last the triangles that the tested leaf rows
    hold: the padded slots of a row are not work the traversal needs.
    Returns (bound_ms, bound_by, bytes, ops)."""
    sums = [int(c.sum()) for c in counts]
    interior, triangles = sums[0], sums[-1]
    enter = sums[3] if len(sums) > 4 else 0
    ops = (n_rays * OPS_RAY + enter * OPS_ENTER + interior * OPS_INTERIOR
           + triangles * ops_triangle + extra_ops)
    nbytes = table_bytes + n_rays * (7 + out_words) * 4
    t_bytes, t_ops = nbytes / PEAK_BYTES_S, ops / PEAK_F32_S
    return (1e3 * max(t_bytes, t_ops), 'bytes' if t_bytes >= t_ops
            else 'operations', nbytes, ops)


def device_profile(run):
    """Device time of run() from torch.profiler's kernel events: (busy
    ms, the union of kernel intervals; {kernel name: ms}; the number of
    kernels)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    by_name, spans = {}, []
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        start, end = e.time_range.start, e.time_range.end
        spans.append((start, end))
        name = e.name.replace('(anonymous namespace)::', '').split('(')[0][:90]
        by_name[name] = by_name.get(name, 0.0) + (end - start) / 1e3
    busy, reach = 0.0, None
    for start, end in sorted(spans):
        if reach is None or start > reach:
            busy += end - start
            reach = end
        elif end > reach:
            busy += end - reach
            reach = end
    if not spans:
        raise RuntimeError('the profiler recorded no device activity')
    return busy / 1e3, by_name, len(spans)


def check_golden(name, img, repo):
    """Hold a 192x108 frame to data/bench_goldens/<name>.npz within
    bench.py's Monte-Carlo bands: rel < max(1.6 noise, 0.02), bias <
    max(4 bias floor, 0.02). Returns (rel, rel limit, bias, bias limit)."""
    import numpy as np
    golden = np.load(os.path.join(repo, 'data', 'bench_goldens', name + '.npz'))
    ref = golden['image']
    rel_lim = max(1.6 * float(golden['noise']), 0.02)
    bias_lim = max(4.0 * float(golden['bias']), 0.02)
    if img.shape != ref.shape:
        raise RuntimeError(f'{name}: frame {img.shape}, golden {ref.shape}')
    rel = float(np.abs(img - ref).mean() / (ref.mean() + 1e-3))
    bias = float(abs(img.mean() - ref.mean()) / (ref.mean() + 1e-3))
    return rel, rel_lim, bias, bias_lim


def media_render(dev, card, launches, reset_launches, width, height,
                 warmup=2, timed=6, profile_rounds=2):
    """Phase 11: bench config 5 through the main entry points at
    width x height in 'inst' mode. Returns inst_trace's launches."""
    import torch
    from path_tracer_tpu_torch.core.constants import SHAPE_INDEX_NONE
    from path_tracer_tpu_torch.integrator import wavefront
    from path_tracer_tpu_torch.integrator.resolve import resolve
    from path_tracer_tpu_torch.ops.intersect import SceneLayout, trace
    from path_tracer_tpu_torch.scene.compile import compile_scene
    from path_tracer_tpu_torch.scene.procedural import make_multi_mesh_scene

    t0 = time.perf_counter()
    scene = make_multi_mesh_scene(detail=1)
    packed = compile_scene(scene, aspect_ratio=width / height, device=dev)
    layout = SceneLayout.from_packed(packed)
    compile_s = time.perf_counter() - t0
    if not (layout.packet_mode == 'inst' and layout.scene_has_medium
            and layout.has_transmissive):
        raise RuntimeError(f'config 5 compiled to {layout}')
    config = wavefront.RenderConfig(width=width, height=height)
    lanes = width * height
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    state = wavefront.render(packed, config, warmup, seed=1, layout=layout)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state = wavefront.render(packed, config, timed, layout=layout, state=state)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    counted = launches()
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    for name, count in counted.items():
        if count != (warmup + timed if name == 'inst_trace' else 0):
            raise RuntimeError(f'config 5 launched {name} {count} times in '
                               f'{warmup + timed} rounds')
    inside = state['path']['active_shapes'].amin(0) != SHAPE_INDEX_NONE
    inside_share = inside.float().mean().item()
    # Lanes inside the ball whose next ray hits nothing: a list that the
    # edge ties of the ball's triangles left behind (ROADMAP Queue 3).
    hit = trace(packed, layout, state['origin'], state['direction'])
    stale = (inside & (hit['shape'] == SHAPE_INDEX_NONE)).sum().item()
    accum = state['accum']
    image = resolve(accum, width, height, lane=state['lane'])
    finite = bool(torch.isfinite(accum['xyz']).all()) and bool(
        torch.isfinite(image).all())
    round_ms = 1e3 * elapsed / timed
    log('media_render', scene='5_multi_mesh_4k', packet_mode='inst',
        width=width, height=height, rounds=timed, seconds=elapsed,
        mrays_s=lanes * timed / elapsed / 1e6, round_ms=round_ms,
        compile_seconds=compile_s, launches=counted, peak_gib=peak_gib,
        inside_share=inside_share, inside_lanes=int(inside.sum().item()),
        inside_no_hit_lanes=int(stale), samples=float(accum['count'].sum()),
        image_mean=float(image.mean()), finite=finite,
        material_types=list(layout.material_types), card=card)
    if not (finite and inside_share > 0.0 and float(accum['count'].sum()) > 0
            and tuple(image.shape) == (height, width, 3)):
        raise RuntimeError('config 5: the frame is not finite, holds no '
                           'sample, or no lane is inside the glass ball')
    del hit, image
    busy_ms, by_name, n_kernels = device_profile(lambda: wavefront.render(
        packed, config, profile_rounds, layout=layout, state=state))
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    log('media_profile', rounds=profile_rounds,
        device_busy_ms_per_round=busy_ms / profile_rounds,
        kernels_per_round=n_kernels / profile_rounds,
        idle_share_vs_unprofiled_round=1.0 - busy_ms / profile_rounds / round_ms,
        traversal_kernel_ms_per_round=sum(
            v for k, v in by_name.items() if 'inst_trace_kernel' in k)
        / profile_rounds,
        top_kernels_ms_per_round=[[k, v / profile_rounds, v / busy_ms]
                                  for k, v in top])
    return counted['inst_trace']


def bench_goldens(dev, repo, flat_mode, launches, reset_launches, rounds=24):
    """Phase 12: the golden frames of bench configs 1, 2, 4 and 5 (5 in
    both packet modes) through render_scene, each with the kernel its mode
    launches once a round (configs 1 and 2 have no mesh: none)."""
    from path_tracer_tpu_torch import render_scene
    from path_tracer_tpu_torch.scene import compile as scene_compile
    from path_tracer_tpu_torch.scene import procedural

    configs = [('1_cornell', procedural.make_cornell_scene, 'analytic'),
               ('2_spheres_dof', procedural.make_sphere_array_scene, 'analytic'),
               ('4_360_mixed', procedural.make_360_scene, 'inst'),
               ('5_multi_mesh_4k',
                lambda: procedural.make_multi_mesh_scene(detail=1), 'inst'),
               ('5_multi_mesh_4k',
                lambda: procedural.make_multi_mesh_scene(detail=1), 'flat')]
    kernel = dict(analytic=None, inst='inst_trace', flat='wide_trace5')
    for name, make, mode in configs:
        scene = make()
        reset_launches()
        with (flat_mode(scene_compile) if mode == 'flat'
              else contextlib.nullcontext()):
            img = render_scene(scene, 192, 108, spp_rounds=rounds, seed=123,
                               device=dev).cpu().numpy()
        counted = launches()
        rel, rel_lim, bias, bias_lim = check_golden(name, img, repo)
        log('golden', name=name, packet_mode=mode, rel_err=rel,
            rel_limit=rel_lim, bias=bias, bias_limit=bias_lim,
            launches={k: v for k, v in counted.items() if v})
        if any(v != (rounds if k == kernel[mode] else 0)
               for k, v in counted.items()):
            raise RuntimeError(f"the '{mode}' {name} frame launched {counted}")
        if not (rel < rel_lim and bias < bias_lim):
            raise RuntimeError(f"the '{mode}' {name} golden frame is outside "
                               'its bands')


def openpbr_card_vs_cpu(dev, width=96, height=48, rounds=16, seed=7):
    """Phase 13: the OpenPBR scene on the card and on the CPU."""
    import numpy as np
    from path_tracer_tpu_torch import render_scene
    from path_tracer_tpu_torch.scene import model, procedural
    from test_torch_cuda import openpbr_scene

    frames = {}
    for device in (dev, 'cpu'):
        t0 = time.perf_counter()
        frames[str(device)] = render_scene(
            openpbr_scene(model, procedural), width, height, spp_rounds=rounds,
            seed=seed, device=device).cpu().numpy()
        frames[str(device) + '_s'] = time.perf_counter() - t0
    img, ref = frames[str(dev)], frames['cpu']
    rel = float(np.abs(img - ref).mean() / (ref.mean() + 1e-3))
    bias = float(abs(img.mean() - ref.mean()) / (ref.mean() + 1e-3))
    finite = bool(np.isfinite(img).all() and np.isfinite(ref).all())
    log('openpbr', width=width, height=height, rounds=rounds, finite=finite,
        mean_card=float(img.mean()), mean_cpu=float(ref.mean()),
        card_vs_cpu_rel_err=rel, card_vs_cpu_bias=bias,
        card_seconds=frames[str(dev) + '_s'], cpu_seconds=frames['cpu_s'])
    if not (finite and img.mean() > 0.01 and ref.mean() > 0.01
            and rel < 0.02 and bias < 0.02):
        raise RuntimeError('the OpenPBR frames are black, not finite or '
                           'differ between the card and the CPU')


def main():
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device; nothing was run', file=sys.stderr)
        return 1
    repo = os.path.dirname(os.path.abspath(__file__))
    sys.path[:0] = [repo, os.path.join(repo, 'tests')]
    from path_tracer_tpu_torch import render_scene
    from path_tracer_tpu_torch.core.constants import (
        HIT_TIME_LIMIT, SHAPE_INDEX_NONE)
    from path_tracer_tpu_torch.integrator import wavefront
    from path_tracer_tpu_torch.integrator.resolve import resolve
    from path_tracer_tpu_torch.ops import (
        build, trace_inst, trace_packet, trace_wide)
    from path_tracer_tpu_torch.ops.intersect import (
        SceneLayout, intersect_analytic, make_hit, ray_sort_key, trace)
    from path_tracer_tpu_torch.scene import bvh8
    from path_tracer_tpu_torch.scene import compile as scene_compile
    from path_tracer_tpu_torch.scene import model, procedural
    # The scene and the mode switch that the tests of both packages share.
    from test_torch_cuda import flat_mode, two_instance_scene

    compile_scene = scene_compile.compile_scene
    make_viking_hall_scene = procedural.make_viking_hall_scene
    kernels = (trace_inst, trace_packet, trace_wide)

    def reset_launches():
        for module in kernels:
            module.reset_launches()

    def launches():
        return dict(inst_trace=trace_inst.launches,
                    wide_trace5=trace_packet.launches,
                    wide_trace=trace_wide.launches,
                    inst_trace_simple=trace_inst.launches_simple,
                    wide_trace5_simple=trace_packet.launches_simple,
                    wide_trace_simple=trace_wide.launches_simple)

    dev = torch.device(DEVICE)
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    log('card', nvidia_smi=card, torch=torch.__version__,
        cuda=torch.version.cuda, devices=torch.cuda.device_count())

    # -- 2. build -------------------------------------------------------
    ptxas = start_ptxas(build.CSRC, build.NVCC_FLAGS, build.BUILD_DIR)
    t0 = time.perf_counter()
    build.load()
    log('build', seconds=time.perf_counter() - t0, ninja=shutil.which('ninja'),
        sources=sorted(os.listdir(build.CSRC)))
    read_ptxas(ptxas)

    # -- 3. compile the flagship scene: both modes, three leaf formats ---
    def nbytes(*tables):
        return sum(x.numel() * x.element_size() for x in tables)

    @contextlib.contextmanager
    def leaf_format(fmt):
        saved = bvh8.LEAF_FMT
        bvh8.LEAF_FMT = fmt
        try:
            yield
        finally:
            bvh8.LEAF_FMT = saved

    packs, flats = {}, {}
    for fmt in LEAF_FMTS:
        for mode, store in (('inst', packs), ('flat', flats)):
            t0 = time.perf_counter()
            scene = make_viking_hall_scene(detail=1)
            with leaf_format(fmt), (flat_mode(scene_compile) if mode == 'flat'
                                    else contextlib.nullcontext()):
                packed = compile_scene(scene, aspect_ratio=WIDTH / HEIGHT,
                                       device=dev)
            layout = SceneLayout.from_packed(packed)
            if layout.packet_mode != mode:
                raise RuntimeError(f'compiled {layout.packet_mode}, not {mode}')
            store[fmt] = (packed, layout)
            log('compile' if mode == 'inst' else 'flat_tables', leaf_fmt=fmt,
                seconds=time.perf_counter() - t0,
                triangles=sum(len(m.faces) for m in scene.meshes),
                packet_mode=layout.packet_mode, atlas=layout.atlas_quad_fit,
                tlas_rows=layout.tlas_rows,
                inst_node_rows=int(packed.inst_nodes.shape[0]),
                inst_leaf_rows=int(packed.inst_tris.shape[0]),
                inst_table_bytes=nbytes(packed.inst_nodes, packed.inst_tris,
                                        packed.inst_rows),
                wide_nodes_g_rows=int(packed.wide_nodes_g.shape[0]),
                wide_tris_g_rows=int(packed.wide_tris_g.shape[0]),
                wide_tris_rows=int(packed.wide_tris.shape[0]),
                v5_table_bytes=nbytes(packed.wide_nodes_g, packed.wide_tris_g),
                v3_table_bytes=nbytes(packed.wide_nodes, packed.wide_tris),
                wide_face_slots=layout.wide_face_slots)
    packed, layout = packs[bvh8.LEAF_FMT]
    flat, flat_layout = flats[bvh8.LEAF_FMT]
    config = wavefront.RenderConfig(width=WIDTH, height=HEIGHT)

    # -- 4. each kernel against its plain version -------------------------
    state = wavefront.reset(packed, config, seed=0)
    ray_sets = {'primary': (state['origin'].clone(), state['direction'].clone())}
    wavefront.render_rounds(packed, layout, config, state, 0.05, rounds=2,
                            sort_each_round=True)
    ray_sets['bounce'] = (state['origin'].clone(), state['direction'].clone())
    del state
    n_rays = WIDTH * HEIGHT
    gen = torch.Generator().manual_seed(0)
    subset = torch.randperm(n_rays, generator=gen)[:SUBSET].to(dev)

    # The table sets of the three kernels: (kernel name, leaf format, the
    # tables the kernel reads, result rows written, operations a triangle,
    # kernel, plain version). Each kernel takes variant='simple' (its
    # baseline kernel) and each plain version cull=False (what the baseline
    # computes).
    def variants(fmt):
        pk, lay = packs[fmt]
        fl = flats[fmt][0]
        inst_tables = (pk.inst_nodes, pk.inst_tris, pk.inst_rows)
        yield ('inst_trace', fmt, inst_tables, 5, OPS_TRIANGLE[fmt],
               lambda *a, **k: trace_inst.inst_trace(
                   *inst_tables, *a, lay.tlas_rows, leaf_fmt=fmt, **k),
               lambda *a, **k: trace_inst.inst_trace_plain(
                   *inst_tables, *a, lay.tlas_rows, leaf_fmt=fmt, **k))
        v5_tables = (fl.wide_nodes_g, fl.wide_tris_g)
        yield ('wide_trace5', fmt, v5_tables, 4, OPS_TRIANGLE[fmt],
               lambda *a, **k: trace_packet.wide_trace5(
                   *v5_tables, *a, leaf_fmt=fmt, **k),
               lambda *a, **k: trace_packet.wide_trace5_plain(
                   *v5_tables, *a, leaf_fmt=fmt, **k))
        if fmt == bvh8.LEAF_FMT:
            # The v3 rows hold plain positions: one format.
            v3_tables = (fl.wide_nodes, fl.wide_tris)
            yield ('wide_trace', 'mt', v3_tables, 8, OPS_TRIANGLE_V3,
                   lambda *a, **k: trace_wide.wide_trace(*v3_tables, *a, **k),
                   lambda *a, **k: trace_wide.wide_trace_plain(
                       *v3_tables, *a, **k))

    flush_buffer = torch.empty(96 * 2**20, dtype=torch.float32, device=dev)
    flush = flush_buffer.zero_      # 384 MiB written: nothing stays in L2
    # The render paths feed the kernels rays in lane order unless
    # RenderConfig.sort_rays is set: the times of record are of that order.
    path_order = 'sorted' if config.sort_rays else 'lane'

    records = {}        # kernel name -> fields of the "kernels" line
    for set_name, (o, d) in ray_sets.items():
        t_in = intersect_analytic(packed, layout, o, d,
                                  make_hit(n_rays, HIT_TIME_LIMIT, dev))['time']
        perm = torch.argsort(ray_sort_key(packed, o, d), stable=True)
        rays = (o[:, perm].contiguous(), d[:, perm].contiguous(),
                t_in[perm].contiguous())
        orders = {'sorted': rays, 'lane': (o, d, t_in)}
        sub_rays = tuple(x[..., subset].contiguous() for x in rays)
        for fmt in LEAF_FMTS:
            for (name, leaf_fmt, tables, out_words, ops_tri, kernel,
                 plain) in variants(fmt):
                # What is compared and timed is the launch the render paths
                # make, without counters. The counters come from a second
                # launch (another instantiation of the kernel's template),
                # whose results must be the same.
                out = kernel(*rays)
                *counted, counts = kernel(*rays, stats=True)
                torch.cuda.synchronize()
                label = f'{set_name}/{leaf_fmt}'
                if not all(torch.equal(a, b) for a, b in zip(out, counted)):
                    raise RuntimeError(f'{name} on {label}: the launch with '
                                       'counters gives other results')
                del counted
                err, agree = compare(name, label,
                                     [x[..., subset] for x in out],
                                     plain(*sub_rays))
                rec = records.setdefault(name, dict(max_abs_err=0.0,
                                                    agreement=1.0))
                main_fmt = fmt == bvh8.LEAF_FMT
                # The baseline kernel: no pop cull, so held to the plain
                # version without it.
                simple_out = kernel(*rays, variant='simple')
                torch.cuda.synchronize()
                s_err, s_agree = compare(
                    name + '_simple', label,
                    [x[..., subset] for x in simple_out],
                    plain(*sub_rays, cull=False))
                err, agree = max(err, s_err), min(agree, s_agree)
                if main_fmt:
                    t_other = int((simple_out[0] != out[0]).sum())
                    face_other = int((simple_out[1] != out[1]).sum())
                    log('pop_cull', kernel=name, set=set_name, rays=n_rays,
                        t_differs=t_other, face_differs=face_other)
                    if t_other > 20 or face_other > 200:
                        raise RuntimeError(
                            f'the pop cull of {name} changes {t_other} '
                            f'distances and {face_other} faces')
                del simple_out
                # Times: every format on the sorted rays; the scene's own
                # format in both orders, warm and cold, and the baseline
                # kernel beside it.
                timed = orders if main_fmt else {'sorted': rays}
                ms = {k: cuda_ms(lambda: kernel(*r)) for k, r in timed.items()}
                ms_cold = {k: cuda_ms(lambda: kernel(*r), flush=flush)
                           for k, r in timed.items()}
                simple_ms = {k: cuda_ms(lambda: kernel(*r, variant='simple'))
                             for k, r in timed.items()}
                n_hit = int((out[1] >= 0).sum())
                bound_ms, bound_by, bound_bytes, ops = kernel_bound(
                    counts, n_rays, nbytes(*tables), out_words, ops_tri,
                    OPS_LERP_V3 * n_hit if name == 'wide_trace' else 0)
                per_ray = [c.float().mean().item() for c in counts]
                log('kernel', kernel=name, set=set_name, leaf_fmt=leaf_fmt,
                    rays=n_rays, ms=ms, ms_cold=ms_cold, simple_ms=simple_ms,
                    mrays_s=n_rays / ms['sorted'] / 1e3,
                    bound_ms=bound_ms, bound_by=bound_by,
                    compulsory_bytes=bound_bytes, f32_ops=ops,
                    per_ray_interior_pops=per_ray[0],
                    per_ray_leaf_pops=per_ray[1], per_ray_leaf_rows=per_ray[2],
                    per_ray_instance_entries=(per_ray[3] if len(per_ray) > 4
                                              else None),
                    per_ray_triangles=per_ray[-1],
                    hit_fraction=n_hit / n_rays)
                rec['max_abs_err'] = max(rec['max_abs_err'], err)
                rec['agreement'] = min(rec['agreement'], agree)
                if main_fmt:
                    # What each kernel measures of itself, and the two
                    # kernels in turns on sorted and unsorted rays.
                    for variant in ('tuned', 'simple'):
                        log('kernel_anatomy', kernel=name, set=set_name,
                            variant=variant, rays=n_rays,
                            **kernel(*rays, variant=variant, anatomy=True)[-1])
                    calls = {f'{variant}_{order}': (
                        lambda r=r, variant=variant: kernel(*r, variant=variant))
                        for order, r in orders.items()
                        for variant in ('tuned', 'simple')}
                    log('kernel_ab', kernel=name, set=set_name, rays=n_rays,
                        ms=time_in_turns(calls, TIMING_REPS),
                        ms_cold=time_in_turns(calls, TIMING_REPS, flush=flush))
                if set_name == 'bounce' and main_fmt:
                    # The main path's steady state: time the plain version
                    # on the same 2,073,600 rays, once, and check all of them.
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    plain_full = plain(*rays)
                    torch.cuda.synchronize()
                    plain_ms = 1e3 * (time.perf_counter() - t0)
                    err, agree = compare(name, label + '/all', out, plain_full)
                    rec.update(ms=ms[path_order], ms_cold=ms_cold[path_order],
                               ms_sorted=ms['sorted'], ms_lane=ms['lane'],
                               simple_ms=simple_ms[path_order],
                               plain_ms=plain_ms, bound_ms=bound_ms,
                               bound_by=bound_by,
                               max_abs_err=max(rec['max_abs_err'], err),
                               agreement=min(rec['agreement'], agree))
                    log('plain', kernel=name, set=set_name, leaf_fmt=leaf_fmt,
                        rays=n_rays, ms=plain_ms)
                    del plain_full
                del out, counts
        if set_name == 'bounce':
            bounce_rays = rays

    # -- 5. the three kernels against one another --------------------------
    # wide_trace sits on no branch of `trace`: this direct call on the flat
    # scene's tables, at the main path's width, is the path that runs it.
    reset_launches()
    hits = {
        'inst_trace': trace_inst.inst_trace(
            packed.inst_nodes, packed.inst_tris, packed.inst_rows,
            *bounce_rays, layout.tlas_rows)[:2],
        'wide_trace5': trace_packet.wide_trace5(
            flat.wide_nodes_g, flat.wide_tris_g, *bounce_rays)[:2],
        'wide_trace': trace_wide.wide_trace(
            flat.wide_nodes, flat.wide_tris, *bounce_rays)[:2]}
    torch.cuda.synchronize()
    direct_launches = launches()
    masks = [face >= 0 for _, face in hits.values()]
    mask_agreement = ((masks[0] == masks[1]) & (masks[1] == masks[2])
                      ).float().mean().item()
    all_hit = masks[0] & masks[1] & masks[2]
    ts = [t[all_hit] for t, _ in hits.values()]
    t_agreement = min(fraction_close(ts[0], x) for x in ts[1:])
    log('cross_check', set='bounce', rays=n_rays, hit_mask_agreement=mask_agreement,
        all_hit=int(all_hit.sum()), t_agreement=t_agreement,
        max_t_difference=max((ts[0] - x).abs().max().item() for x in ts[1:]),
        launches=direct_launches)
    if not (mask_agreement > 0.995 and t_agreement > 0.999
            and all(direct_launches[name] == 1 for name in hits)):
        raise RuntimeError('the three kernels disagree on the bounce rays')
    records['wide_trace']['launches'] = direct_launches['wide_trace']
    del hits, masks, ts, ray_sets

    # -- 6, 7. the two paths end to end -------------------------------------
    def render_path(mode, pk, lay, kernel_name):
        reset_launches()
        state = wavefront.render(pk, config, WARMUP_ROUNDS, seed=1, layout=lay)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state = wavefront.render(pk, config, TIMED_ROUNDS, layout=lay,
                                 state=state)
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
        counted = launches()
        rounds = WARMUP_ROUNDS + TIMED_ROUNDS
        for name, count in counted.items():
            if count != (rounds if name == kernel_name else 0):
                raise RuntimeError(f"the '{mode}' render launched {name} "
                                   f'{count} times in {rounds} rounds')
        accum = state['accum']
        if not (bool(torch.isfinite(accum['xyz']).all())
                and float(accum['count'].sum()) > 0):
            raise RuntimeError('the accumulator is not finite or holds no sample')
        image = resolve(accum, WIDTH, HEIGHT, lane=state['lane'])
        if tuple(image.shape) != (HEIGHT, WIDTH, 3) or not bool(
                torch.isfinite(image).all()):
            raise RuntimeError(f'bad image {tuple(image.shape)}')
        round_ms = 1e3 * elapsed / TIMED_ROUNDS
        # `trace` with and without the ray sort, on the rays of this state
        # and on fresh primary rays: what decides RenderConfig.sort_rays.
        fresh = wavefront.reset(pk, config, seed=1)
        sort_ms = {}
        for set_name, rs in (('bounce', state), ('primary', fresh)):
            sort_ms[set_name] = {
                order: cuda_ms(lambda: trace(pk, lay, rs['origin'],
                                             rs['direction'], sort_rays=flag))
                for order, flag in (('sorted', True), ('unsorted', False))}
        del fresh
        log('trace_sort', packet_mode=mode, rays=n_rays, ms=sort_ms,
            unsorted_faster={k: v['unsorted'] < v['sorted']
                             for k, v in sort_ms.items()},
            default_sort_rays=config.sort_rays)
        trace_ms = sort_ms['bounce']['sorted']
        trace_unsorted_ms = sort_ms['bounce']['unsorted']
        log('render', packet_mode=mode, width=WIDTH, height=HEIGHT,
            rounds=TIMED_ROUNDS, seconds=elapsed,
            mrays_s=n_rays * TIMED_ROUNDS / elapsed / 1e6, round_ms=round_ms,
            trace_ms=trace_ms, trace_unsorted_ms=trace_unsorted_ms,
            samples=float(accum['count'].sum()), launches=counted,
            image_mean=float(image.mean()),
            peak_gib=torch.cuda.max_memory_allocated() / 2**30, card=card)
        records[kernel_name]['launches'] = counted[kernel_name]

        # Where a round's device time goes: kernels by name over 4 rounds.
        busy_ms, by_name, n_kernels = device_profile(lambda: wavefront.render(
            pk, config, 4, layout=lay, state=state))
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
        log('profile', packet_mode=mode, rounds=4,
            device_busy_ms_per_round=busy_ms / 4,
            kernels_per_round=n_kernels / 4,
            idle_share_vs_unprofiled_round=1.0 - busy_ms / 4 / round_ms,
            traversal_kernel_ms_per_round=sum(
                v for k, v in by_name.items() if kernel_name + '_kernel' in k) / 4,
            top_kernels_ms_per_round=[[k, v / 4, v / busy_ms] for k, v in top])
        return state

    render_path('inst', packed, layout, 'inst_trace')
    state = render_path('flat', flat, flat_layout, 'wide_trace5')

    # -- 8. the portable BVH2 traversal -----------------------------------
    o, d = (state[k][:, subset].contiguous() for k in ('origin', 'direction'))
    del state
    kernel_hit = trace(flat, flat_layout, o, d)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    portable_hit = trace(flat, flat_layout, o, d, use_packet=False)
    torch.cuda.synchronize()
    portable_ms = 1e3 * (time.perf_counter() - t0)
    shape_agreement = (kernel_hit['shape'] == portable_hit['shape']
                       ).float().mean().item()
    t_agreement = fraction_close(kernel_hit['time'], portable_hit['time'])
    log('portable', rays=SUBSET, ms=portable_ms,
        kernel_path_ms=cuda_ms(lambda: trace(flat, flat_layout, o, d)),
        shape_agreement=shape_agreement, t_agreement=t_agreement,
        max_t_difference=(kernel_hit['time'] - portable_hit['time']
                          ).abs().max().item(),
        hit_fraction=(kernel_hit['shape'] != SHAPE_INDEX_NONE
                      ).float().mean().item())
    if not (shape_agreement > 0.995 and t_agreement > 0.999):
        raise RuntimeError('the portable traversal disagrees with wide_trace5')

    # -- 9. golden frame, both modes ----------------------------------------
    for mode in ('inst', 'flat'):
        scene = make_viking_hall_scene(detail=1)
        with (flat_mode(scene_compile) if mode == 'flat'
              else contextlib.nullcontext()):
            img = render_scene(scene, 192, 108, spp_rounds=24, seed=123,
                               device=dev).cpu().numpy()
        rel, rel_lim, bias, bias_lim = check_golden('3_viking_hall', img, repo)
        log('golden', name='3_viking_hall', packet_mode=scene.packet_mode,
            rel_err=rel, rel_limit=rel_lim, bias=bias, bias_limit=bias_lim)
        if (scene.packet_mode != mode
                or not (rel < rel_lim and bias < bias_lim)):
            raise RuntimeError(f"the '{mode}' viking golden frame is outside "
                               'its bands')

    # -- 10. diffuse + metal, both modes ----------------------------------------
    frames = {}
    for mode in ('inst', 'flat'):
        scene = two_instance_scene(model, procedural)
        with (flat_mode(scene_compile) if mode == 'flat'
              else contextlib.nullcontext()):
            frames[mode] = render_scene(scene, 640, 320, spp_rounds=16, seed=5,
                                        device=dev).cpu().numpy()
        if scene.packet_mode != mode:
            raise RuntimeError(f'compiled {scene.packet_mode}, not {mode}')
    mean = frames['inst'].mean()
    rel = float(np.abs(frames['flat'] - frames['inst']).mean() / (mean + 1e-3))
    bias = float(abs(frames['flat'].mean() - mean) / (mean + 1e-3))
    finite = all(bool(np.isfinite(f).all()) for f in frames.values())
    log('metal', width=640, height=320, rounds=16, finite=finite,
        mean_inst=float(mean), mean_flat=float(frames['flat'].mean()),
        flat_vs_inst_rel_err=rel, flat_vs_inst_bias=bias)
    if not (finite and mean > 0.01 and frames['flat'].mean() > 0.01
            and rel < 0.02 and bias < 0.02):
        raise RuntimeError('the diffuse + metal frames are black, not finite '
                           'or differ between the two modes')

    # -- 11. bench config 5 at 3840x2160: media and nested dielectrics -------
    del packs, flats, packed, flat, bounce_rays, flush, flush_buffer
    torch.cuda.empty_cache()
    records['inst_trace']['launches_media_render'] = media_render(
        dev, card, launches, reset_launches, MEDIA_WIDTH, MEDIA_HEIGHT)

    # -- 12. golden frames of bench configs 1, 2, 4 and 5 --------------------
    bench_goldens(dev, repo, flat_mode, launches, reset_launches)

    # -- 13. the OpenPBR scene, card against CPU ------------------------------
    openpbr_card_vs_cpu(dev)

    print(card)
    sources = dict(
        inst_trace=('trace_inst.cu', 'path_tracer_tpu/ops/trace_inst.py:149'),
        wide_trace5=('trace_packet.cu', 'path_tracer_tpu/ops/trace_packet.py:85'),
        wide_trace=('trace_wide.cu', 'path_tracer_tpu/ops/trace_wide.py:97'))
    print(json.dumps({'kernels': [dict(
        name=name, route='cuda',
        source='path_tracer_tpu_torch/csrc/' + sources[name][0],
        replaces=sources[name][1], library_ms=None, **records[name])
        for name in sources],
        'ray_order': path_order}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': kind,
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
