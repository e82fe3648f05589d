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
     and on the rays after 2 rounds, in lane order (the order the render
     paths launch in), for each leaf format, bit for bit (kernel and
     plain version take the same per-ray traversal order): a 65,536-ray
     subset of every set, and all rays of the bounce set in the default
     format. What is compared and timed is the launch the render paths
     make (for wide_trace, the launch of the direct call); the launch
     with the per-ray counters, another instantiation, must give the
     same. The pop cull's effect (`pop_cull`: the kernel with it and the
     plain version without it must agree on every ray of the subset, in
     every leaf format, t and face); kernel time warm and cold (CUDA
     events, median of 7; cold = a buffer larger than L2 written before
     each launch), plain time, and the kernel's bound from its counted
     pops and triangles; `kernel_anatomy`: what each kernel measured of
     itself (SIMT efficiency of each loop body, distinct rows a warp
     fetches in a pass, deepest stack, culled pops);
  5. the three kernels against one another on the bounce rays (hit masks
     equal on > 99.5% of the rays, t within 5e-4 on > 99.9% of the rays
     all three hit);
  6. the 'inst' path end to end: `render` at 1920x1080, 6 warm-up and 24
     timed rounds, Mrays/s; inst_trace's launch count must equal the
     rounds run; the time of `trace` alone on steady-state rays, and, from
     a profile of 4 more rounds, the device time by kernel;
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
     round ms, launches (inst_trace and hit_attributes once a round, no
     other kernel), peak
     memory, the share of lanes inside the ball (non-empty active-shape
     list) after the timed rounds, which must be above 0, and a profile of
     2 more rounds;
 12. the golden frames of bench configs 1, 2, 4 and 5 (config 5 in both
     modes) through `render_scene`, 192x108, 24 rounds, seed 123, against
     data/bench_goldens/ within the bands of phase 9;
 13. the OpenPBR scene of tests/test_torch_cuda.py (coat, metal and
     translucent bases, emitters, the fallback material, nested glass, fog)
     at 96x48, 16 rounds, on the card and on the CPU: finite, not black,
     within 2% mean absolute error and 2% bias of each other; then
     `openpbr_walk`: the OpenPBR walk kernel, which replaces no Pallas
     kernel, and the plain walk in turns on the walk's inputs of a round
     of the Cornell box at 2880x2880 (the benchmark's configuration):
     times, the kernel's bound from its compulsory bytes, the lanes and
     warps that walked, its `ptxas` registers and spills, and its
     agreement with the plain walk; then `shape_trace`: the analytic-shape
     kernel, which replaces the dense analytic path on the card, and that
     path in turns on 262,144 bounce rays of the benchmark's
     one_weekend_final scene (484 spheres) at 1200x675, bit for bit,
     with the kernel's bound, `ptxas` registers and spills, and the dense
     path once on a whole wave of camera rays; then `hit_attributes`: the
     hit-attribute kernel, which replaces the plain attribute chain of
     `trace` on the card, and that chain in turns on the third-round
     lanes of the Cornell box at 2880x2880 (8,294,400, mesh hits) and of
     one_weekend_final at 1200x675 with 8 waves (6,480,000, sphere hits),
     bit for bit in every field, with the bounds of the record scatter
     reads and of all the layer moves, and its `ptxas` registers and
     spills; then `medium_event`: the medium-event kernel, which replaces
     scatter's plain medium chain on the card, and that chain in turns on
     the third-round lanes of the same two cells, bit for bit in every
     output and the random state, with the layer's least bytes and what
     the kernel moves, and its `ptxas` registers and spills; then
     `basic_sample`: the basic models' BSDF-sample kernel, which replaces
     the plain per-model samples and their selects on the card, and the
     plain dispatch in turns on the third-round lanes of one_weekend_final,
     next_week_final (whose OpenPBR light the walk samples first) and the
     Cornell box at 2880x2880, bit for bit in every output of every lane
     that samples, with the lanes of each model, the layer's least bytes
     and what the kernel moves, and its `ptxas` registers and spills;
     then `scatter_tail`: the kernel of scatter's own code after the BSDF
     sample, which replaces the plain tail on the card, and that tail in
     turns on the third-round lanes of the Cornell box at 2880x2880 and
     of spd_tetra at 1440x1440 with 4 waves, bit for bit in every output
     and the random state, with the lanes of each branch, the layer's
     least bytes and what the kernel moves, and its `ptxas` registers and
     spills;
 14. bench config 6 (`make_terrain_scene(side=900)`, 1.62M unique
     triangles) compiled once for 16:9: seconds, triangles, the bytes of
     every table;
 15. config 6 at 1920x1080 through `render` with waves=1 and waves=4, 2
     warm-up and 6 timed rounds each: Mrays/s, round ms, peak memory,
     inst_trace once a round and no other kernel;
 16. inst_trace on config 6's bounce rays: warm and cold ms in lane
     order, bit-equal to its plain version on a 65,536-ray subset, its
     bound from the counted pops and triangles, and the pop cull on that
     subset (0 rays may differ from the plain version without it);
 17. resolve of the waves=4 state 8 times: the frames must be equal bit
     for bit, and the fold of the same slots shuffled too; the fold timed
     against the index_add_ fold it replaced;
     config 6's golden frame (192x108, 24 rounds, seed 123, one wave) on
     the same tables within bench.py's bands;
 18. `checkpoint`: the viking hall at 1920x1080 through render_resilient
     with one injected failure, bit-equal to the uninterrupted render;
     the checkpoint loaded on the CPU; save and load ms, file size;
 19. `cli`: `python -m path_tracer_tpu_torch render` of the reference
     schema's scene file and `... demo cornell`, subprocesses on the card
     at 192x108, 8 rounds: exit 0 and a PNG that is not black;
 20. `session`: app.Session on the viking hall at 960x540: steady and
     restart frame ms, a material edit through the incremental compile
     bit-equal to a full compile's frame, preview ms in all seven modes,
     pick ms, the mesh-complexity heatmap non-zero on mesh pixels with
     the kernel's per-ray counters equal to the plain version's; the
     steady and restart frames of the default (specialized) layout and of
     the generic one;
 21. `viewer`: viewer/server.py over a Session on the viking hall at
     960x540, driven over http://127.0.0.1: 10 /frame.png polls (inst_trace
     once a poll), a steady poll split into Session.frame, the copy to the
     host, encode_png and HTTP, /move and the restart poll, /pick on the
     hall, /material/update and the poll after it bit-equal to a full
     compile's frame, a preview poll in each of the seven modes, /status,
     and the steady poll of the generic layout;
 22. `cli_tools`: `python -m path_tracer_tpu_torch spectrum ... --png` and
     `bvhdump --demo viking --depth 2` as subprocesses on the card (exit
     0, bvh_statistics of the card's compile equal to the CPU's and to the
     CLI's), and `view --demo cornell --port 0` as a subprocess, one
     /frame.png fetched, then stopped;
 23. `sharded`: parallel/render.py at world size 1 over NCCL, the viking
     hall at 1920x1080 with 1 and 4 waves, 2 + 6 rounds: Mrays/s beside
     phase 6's, merge_accumulator ms, peak memory, the merged accumulator
     bit-equal to wavefront.render's; then dryrun_multichip over every
     card of the machine.

Every phase prints its lines and its seconds (`phase_seconds`); any
failure raises and exits non-zero. The
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
SESSION_WIDTH, SESSION_HEIGHT = 960, 540   # app.Session's default size
SUBSET = 65536          # rays the plain version checks per ray set
TIMING_REPS = 7
HTTP_TIMEOUT = 120      # seconds a request to the viewer may take
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


def pop_cull(kernel_out, plain_out, kernel_name, set_name, leaf_fmt):
    """The pop cull keeps every hit: the kernel, which culls, and the
    plain version without the cull agree on every ray in t and face."""
    t_other = int((kernel_out[0] != plain_out[0]).sum())
    face_other = int((kernel_out[1] != plain_out[1]).sum())
    log('pop_cull', kernel=kernel_name, set=set_name, leaf_fmt=leaf_fmt,
        rays=int(kernel_out[0].numel()), t_differs=t_other,
        face_differs=face_other)
    if t_other or face_other:
        raise RuntimeError(f'the pop cull of {kernel_name} changes {t_other} '
                           f'distances and {face_other} faces on '
                           f'{set_name}/{leaf_fmt}')


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


def launched_once_a_trace(counted, traces, kernel='inst_trace'):
    """Whether `counted` (kernel name -> launches) holds `traces` launches
    of the traversal `kernel` (None: a scene without mesh, which launches
    none) and of hit_attributes, which every trace on the card launches
    once, and no launch of any other kernel."""
    return all(count == (traces if name in (kernel, 'hit_attributes') else 0)
               for name, count in counted.items())


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
    if not launched_once_a_trace(counted, warmup + timed):
        raise RuntimeError(f'config 5 launched {counted} in {warmup + timed} '
                           'rounds')
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
    launches once a round (configs 1 and 2 have no mesh: none) and
    hit_attributes once a round."""
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
        if not launched_once_a_trace(counted, rounds, kernel[mode]):
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


def walk_bytes(openpbr, lanes, walking):
    """Compulsory bytes of one walk launch with a lane mask: every lane
    reads its type, mask and RNG state and writes the state and the four
    outputs; a walking lane also reads the rest of its inputs once."""
    def size(rows, dtype):
        import torch
        return max(rows, 1) * torch.empty((), dtype=dtype).element_size()

    every = ('type', 'rng_state')
    per_lane = (1 + sum(size(r, d) for n, d, r in openpbr.KERNEL_INPUTS
                        if n in every)
                + sum(size(r, d) for _, d, r in openpbr.KERNEL_OUTPUTS))
    per_walk = sum(size(r, d) for n, d, r in openpbr.KERNEL_INPUTS
                   if n not in every)
    return lanes * per_lane + walking * per_walk


def openpbr_walk_phase(dev, card, ptxas_records, seed=2 ** 31 + 13):
    """Phase `openpbr_walk`: the walk kernel (csrc/openpbr_walk.cu) on the
    8,294,400 lanes of the Cornell box's 2880x2880 state (the benchmark's
    configuration, after its 4 warm-up rounds): the walk's inputs of the
    next round are captured (the surface-event mask with them), then the
    kernel and the plain walk run on them on the card, in turns. Logs
    both times, the kernel's bound (its compulsory bytes over HBM
    bandwidth), the lanes and warps that walked, `ptxas`'s registers and
    spills, and the agreement with the plain walk on the lanes the kernel
    walks (the RNG state equal to the bit on every lane, `valid` on >=
    99.9% of them, the samples within 1e-5 relative on >= 99.9% of their
    elements), which fails the run when it is not met. Returns the
    record."""
    import types

    import numpy as np
    import torch

    from benchmark.harness.cell import load_cell
    from path_tracer_tpu_torch.core import constants
    from path_tracer_tpu_torch.core.sampling import Rng
    from path_tracer_tpu_torch.integrator import wavefront
    from path_tracer_tpu_torch.models import openpbr
    from path_tracer_tpu_torch.ops.intersect import SceneLayout
    from path_tracer_tpu_torch.scene import model
    from path_tracer_tpu_torch.scene.compile import compile_scene

    cell = load_cell('cornell_box.offline_2880x2880')
    api = types.SimpleNamespace(**{
        k: v for m in (constants, model) for k, v in vars(m).items()
        if not k.startswith('_')})
    width, height = cell.traffic['width'], cell.traffic['height']
    packed = compile_scene(cell.maker.make_scene(api, cell.config),
                           aspect_ratio=width / height, device=dev)
    layout = SceneLayout.from_packed(packed)
    config = wavefront.RenderConfig(
        width=width, height=height, flags=(constants.RENDER_FLAG_ACCUMULATE
                                           | constants.RENDER_FLAG_SAMPLE_JITTER),
        camera_model=packed.host_camera_models[0])
    term = cell.traffic['termination_probability']
    state = wavefront.reset(packed, config, seed)
    wavefront.render(packed, config, cell.traffic['warmup_rounds'], state=state,
                     layout=layout, termination_probability=term)
    captured = {}
    walk = openpbr.sample_bsdf

    def capture(ctx, view, u1, u2, u3, rng, where=None):
        captured.update(ctx={k: ctx[k] for k in openpbr.CTX_INPUTS},
                        args=(view, u1, u2, u3), state=rng.state.clone(),
                        where=where)
        return walk(ctx, view, u1, u2, u3, rng, where)

    openpbr.sample_bsdf = capture
    try:
        wavefront.render_round(packed, layout, config, state, term)
    finally:
        openpbr.sample_bsdf = walk
    del state
    cols, args, start = captured['ctx'], captured['args'], captured['state']
    where = captured['where']
    lanes = start.numel()
    typed = cols['type'] == constants.MATERIAL_TYPE_OPENPBR
    walks = typed & where
    walking = int(walks.sum())

    def kernel():
        return openpbr.openpbr_walk(cols, *args, start, where=where)

    def plain():
        return openpbr.sample_bsdf_plain(cols, *args, Rng(start))

    stats = torch.zeros(2, dtype=torch.int64, device=dev)
    openpbr.openpbr_walk(cols, *args, start, where=where, stats=stats)
    lanes_walked, walk_warps = stats.tolist()
    out = kernel()
    plain_rng = Rng(start)
    ref = openpbr.sample_bsdf_plain(cols, *args, plain_rng)
    rng_equal = bool(torch.equal(out[4], plain_rng.state))
    valid_agree = (out[3][walks] == ref[3][walks]).float().mean().item()
    within = []
    for k, p in zip(out[:3], ref[:3]):
        k, p = k[:, walks], p[:, walks]
        ok = ((k - p).abs() <= 1e-6 + 1e-5 * p.abs()) | (k.isnan() & p.isnan())
        within.append(ok.float().mean().item())
    del out, ref
    flush_buffer = torch.empty(96 * 2 ** 20, dtype=torch.float32, device=dev)
    ms = time_in_turns({'kernel': kernel, 'plain': plain}, TIMING_REPS)
    ms_cold = cuda_ms(kernel, flush=flush_buffer.zero_)
    del flush_buffer
    nbytes = walk_bytes(openpbr, lanes, walking)
    bound_ms = 1e3 * nbytes / PEAK_BYTES_S
    regs = [r for r in ptxas_records if r['source'] == 'openpbr_walk.cu']
    rec = dict(
        nvidia_smi=card, lanes=lanes, openpbr_typed_lanes=int(typed.sum()),
        surface_lanes=int(where.sum()), openpbr_lanes=walking,
        openpbr_lane_pct=100.0 * walking / lanes, lanes_walked=lanes_walked,
        warps=-(-lanes // 32), walk_warps=walk_warps,
        walk_warp_pct=100.0 * walk_warps / -(-lanes // 32),
        kernel_ms=ms['kernel'], kernel_ms_cold=ms_cold, plain_ms=ms['plain'],
        speedup=ms['plain'] / ms['kernel'], bound_ms=bound_ms, bound_by='bytes',
        compulsory_bytes=nbytes, roofline_pct=100.0 * bound_ms / ms['kernel'],
        registers=[r['registers'] for r in regs],
        spill_bytes=[r['spill_store_bytes'] + r['spill_load_bytes']
                     for r in regs],
        rng_equal=rng_equal, valid_agree=valid_agree,
        within_1e5=dict(zip(('in_dir', 'throughput', 'density'), within)))
    log('openpbr_walk', **rec)
    if not (rng_equal and valid_agree >= 0.999 and min(within) >= 0.999
            and lanes_walked == walking and walking > 0):
        raise RuntimeError('the OpenPBR walk kernel disagrees with the plain '
                           'walk on the Cornell box')
    return rec


def shape_trace_phase(dev, card, ptxas_records, subset=262144,
                      seed=2 ** 31 + 17):
    """Phase `shape_trace`: the analytic-shape kernel (csrc/shape_trace.cu)
    against the dense analytic path it replaces on the card, on the
    benchmark's one_weekend_final scene (484 spheres) at the book's
    1200x675 with one wave: `subset` of the bounce rays of its third
    round, bit for bit in every field but complexity (a difference fails
    the run), timed in turns and cold, with the kernel's bound (its
    compulsory bytes over HBM bandwidth: 52 a ray, 48 a shape), its
    nodes and tests a ray and `ptxas`'s registers and spills; then the
    dense path once on all 810,000 camera rays, which is what the kernel
    replaced (an out-of-memory error is recorded, not raised). Returns
    the record."""
    import numpy as np
    import torch

    from path_tracer_tpu_torch.core import constants
    from path_tracer_tpu_torch.integrator import wavefront
    from path_tracer_tpu_torch.ops import intersect
    from path_tracer_tpu_torch.scene.compile import compile_scene
    from test_torch_cuda import one_weekend_scene

    width, height = 1200, 675
    packed = compile_scene(one_weekend_scene(), aspect_ratio=width / height,
                           device=dev)
    layout = intersect.SceneLayout.from_packed(packed)
    shapes = int(packed.shape_rows.shape[0] + packed.plane_rows.shape[0])
    config = wavefront.RenderConfig(
        width=width, height=height,
        flags=(constants.RENDER_FLAG_ACCUMULATE
               | constants.RENDER_FLAG_SAMPLE_JITTER),
        camera_model=packed.host_camera_models[0])
    state = wavefront.reset(packed, config, seed)
    camera = (state['origin'].clone(), state['direction'].clone())
    wavefront.render(packed, config, 2, state=state, layout=layout,
                     termination_probability=0.05)
    rng = np.random.default_rng(seed)
    idx = torch.as_tensor(np.sort(rng.choice(width * height, subset,
                                             replace=False)), device=dev)
    o = state['origin'][:, idx].contiguous()
    d = state['direction'][:, idx].contiguous()
    del state
    hit = intersect.make_hit(subset, constants.HIT_TIME_LIMIT, dev)

    def kernel():
        return intersect.intersect_analytic(packed, layout, o, d, hit)

    def dense():
        return intersect.intersect_analytic_dense(packed, layout, o, d, hit)

    got, want = kernel(), dense()
    fields = ('time', 'shape', 'shape_type', 'primitive', 'coords')
    equal = {k: bool(torch.equal(got[k], want[k])) for k in fields}
    hits = float((want['shape'] != constants.SHAPE_INDEX_NONE).float().mean())
    visits = float(got['complexity'].float().mean())
    del got, want
    ms = time_in_turns({'kernel': kernel, 'dense': dense}, TIMING_REPS)
    flush_buffer = torch.empty(96 * 2 ** 20, dtype=torch.float32, device=dev)
    ms_cold = cuda_ms(kernel, flush=flush_buffer.zero_)
    del flush_buffer
    nbytes = subset * 52 + shapes * 48
    bound_ms = 1e3 * nbytes / PEAK_BYTES_S
    regs = [r for r in ptxas_records if r['source'] == 'shape_trace.cu']

    # What the kernel replaced: the dense path on a whole wave of camera rays.
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    full = intersect.make_hit(width * height, constants.HIT_TIME_LIMIT, dev)
    try:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        intersect.intersect_analytic_dense(packed, layout, *camera, full)
        end.record()
        end.synchronize()
        full_dense = dict(ms=start.elapsed_time(end),
                          peak_gib=torch.cuda.max_memory_allocated(dev) / 2 ** 30)
    except torch.cuda.OutOfMemoryError as e:
        full_dense = dict(error=str(e).splitlines()[0])
    del full, camera
    torch.cuda.empty_cache()
    rec = dict(
        nvidia_smi=card, rays=subset, shapes=shapes, hit_share=hits,
        visits_per_ray=visits, equal=equal, kernel_ms=ms['kernel'],
        kernel_ms_cold=ms_cold, dense_ms=ms['dense'],
        speedup=ms['dense'] / ms['kernel'], bound_ms=bound_ms,
        bound_by='bytes', compulsory_bytes=nbytes,
        roofline_pct=100.0 * bound_ms / ms['kernel'],
        registers=[r['registers'] for r in regs],
        spill_bytes=[r['spill_store_bytes'] + r['spill_load_bytes']
                     for r in regs],
        dense_full_wave=dict(rays=width * height, **full_dense))
    log('shape_trace', **rec)
    if not all(equal.values()) or hits < 0.2:
        raise RuntimeError('the shape kernel disagrees with the dense path '
                           'on the one_weekend_final scene')
    return rec


def attribute_bytes(lanes, analytic_lanes, winners, table_bytes):
    """(the resolved record's bytes, the layer's compulsory bytes) of one
    launch of the hit-attribute kernel. The record is 20 words a lane, all
    that scatter reads of it (benchmark/metrics/hit_attributes_roofline.py),
    a lower bound on the layer's traffic whatever implements it. The layer
    reads each lane's rays and hit record (10 words), the mesh kernel's
    `winners` words a lane, an analytic lane's 3 coordinates and the tables
    it gathers from once (`table_bytes`), and writes 15 words of the record
    (material, position, normal, tangent, bitangent, uv), and its first 4
    (time, shape, shape type, primitive) only where it merges winners: it
    passes them, and complexity, through otherwise."""
    record = lanes * 20 * 4
    written = 15 + (4 if winners else 0)
    traffic = (lanes * (10 + winners + written) * 4 + analytic_lanes * 12
               + table_bytes)
    return record, traffic


# The cells of hit_attributes_phase: the Cornell box's mesh hits, merged
# from the 'inst' mesh kernel's winners, and one_weekend_final's sphere
# hits, resolved without winners.
ATTRIBUTE_CELLS = ('cornell_box.offline_2880x2880',
                   'one_weekend_final.offline_1200x675_w8')


def hit_attributes_phase(dev, card, ptxas_records, seed=2 ** 31 + 19):
    """Phase `hit_attributes`: the hit-attribute kernel
    (csrc/hit_attributes.cu) against the plain chain it replaces
    (ops/intersect.py::resolve_attributes_plain), both on the card, on
    every lane of two benchmark cells' states in their third round with
    tracing off (the instantiations a render runs): the Cornell box at
    2880x2880 (8,294,400 lanes, 'inst' mode) and one_weekend_final at
    1200x675 with 8 waves (6,480,000 lanes, no winners). The inputs
    `trace` hands the kernel are captured, then both run on them, bit for
    bit in every field of every lane (a difference fails the run), timed
    in turns and cold (after 384 MiB written), beside the two bounds of
    attribute_bytes over HBM bandwidth and `ptxas`'s registers and spills.
    Returns the records by cell."""
    import types

    import torch

    from benchmark.harness.cell import load_cell
    from path_tracer_tpu_torch.core import constants
    from path_tracer_tpu_torch.integrator import wavefront
    from path_tracer_tpu_torch.ops import hit_attributes, intersect
    from path_tracer_tpu_torch.scene import model
    from path_tracer_tpu_torch.scene.compile import compile_scene
    from test_torch_cuda import same_bits

    api = types.SimpleNamespace(**{
        k: v for m in (constants, model) for k, v in vars(m).items()
        if not k.startswith('_')})
    regs = [r for r in ptxas_records if r['source'] == 'hit_attributes.cu']
    records = {}
    for name in ATTRIBUTE_CELLS:
        cell = load_cell(name)
        width, height = cell.traffic['width'], cell.traffic['height']
        packed = compile_scene(cell.maker.make_scene(api, cell.config),
                               aspect_ratio=width / height, device=dev)
        layout = intersect.SceneLayout.from_packed(packed)
        config = wavefront.RenderConfig(
            width=width, height=height, waves=cell.traffic.get('waves', 1),
            flags=(constants.RENDER_FLAG_ACCUMULATE
                   | constants.RENDER_FLAG_SAMPLE_JITTER),
            camera_model=packed.host_camera_models[0])
        state = wavefront.reset(packed, config, seed)
        wavefront.render(
            packed, config, 2, state=state, layout=layout,
            termination_probability=cell.traffic['termination_probability'])
        o, d = state['origin'], state['direction']
        del state
        captured = []
        launch = hit_attributes.hit_attributes
        hit_attributes.hit_attributes = (
            lambda *a, **k: captured.append(a) or launch(*a, **k))
        try:
            intersect.trace(packed, layout, o, d)
        finally:
            hit_attributes.hit_attributes = launch
        (_, _, _, _, hit, winners), = captured

        def kernel():
            return launch(packed, layout, o, d, hit, winners)

        def plain():
            return intersect.resolve_attributes_plain(packed, layout, o, d,
                                                      hit, winners)

        got, want = kernel(), plain()
        equal = {k: bool(same_bits(got[k], want[k])) for k in want}
        lanes = o.shape[1]
        hits = want['shape'] != constants.SHAPE_INDEX_NONE
        mesh = want['shape_type'] == constants.SHAPE_TYPE_MESH_INSTANCE
        mesh_hits = int((hits & mesh).sum())
        analytic_hits = int((hits & ~mesh).sum())
        analytic = int((~mesh).sum())
        del got, want
        ms = time_in_turns({'kernel': kernel, 'plain': plain}, TIMING_REPS)
        flush_buffer = torch.empty(96 * 2 ** 20, dtype=torch.float32,
                                   device=dev)
        ms_cold = cuda_ms(kernel, flush=flush_buffer.zero_)
        del flush_buffer
        tables = (packed.shape_material, packed.shape_world_from_object,
                  packed.shape_object_from_world)
        if winners is not None:
            tables += (packed.inst_attrs, packed.inst_aux)
        record_bytes, traffic_bytes = attribute_bytes(
            lanes, analytic, 0 if winners is None else len(winners),
            sum(x.numel() * x.element_size() for x in tables))
        record_ms = 1e3 * record_bytes / PEAK_BYTES_S
        traffic_ms = 1e3 * traffic_bytes / PEAK_BYTES_S
        rec = records[name] = dict(
            nvidia_smi=card, cell=name, lanes=lanes,
            mode='none' if winners is None else layout.packet_mode,
            mesh_hits=mesh_hits, analytic_hits=analytic_hits,
            analytic_lanes=analytic, equal=equal, kernel_ms=ms['kernel'],
            kernel_ms_cold=ms_cold, plain_ms=ms['plain'],
            speedup=ms['plain'] / ms['kernel'], record_bytes=record_bytes,
            record_bound_ms=record_ms, traffic_bytes=traffic_bytes,
            traffic_bound_ms=traffic_ms, bound_by='bytes',
            roofline_pct=100.0 * record_ms / ms['kernel'],
            traffic_pct=100.0 * traffic_ms / ms['kernel'],
            registers=[r['registers'] for r in regs],
            spill_bytes=[r['spill_store_bytes'] + r['spill_load_bytes']
                         for r in regs])
        log('hit_attributes', **rec)
        del packed, o, d, hit, winners, kernel, plain
        torch.cuda.empty_cache()
        engaged = mesh_hits if rec['mode'] != 'none' else analytic_hits
        if not all(equal.values()) or engaged < lanes // 2:
            raise RuntimeError('the hit-attribute kernel disagrees with the '
                               f'plain chain in {name}')
    return records


def medium_bytes(lanes, interior_lanes):
    """(the layer's least bytes, what the kernel moves) for one launch of
    the medium-event kernel. The least is 36 words a lane
    (benchmark/metrics/medium_roofline.py): 26 read (4 active-shape slots,
    the primary wavelength, throughput, probability, the hit's time, shape
    and normal, origin, direction, the 64-bit random state) and 10 written
    (the absorbed throughput, the exterior IOR, the random state). The
    kernel also writes the priority, three 1-byte masks and the volumetric
    branch (origin, direction, throughput, probability: 14 words), and a
    lane inside a shape reads its four wavelengths in place of one."""
    least = lanes * 36 * 4
    # The least's words without the primary wavelength, the priority and
    # the volumetric branch, the masks, and the wavelengths inside shapes.
    moved = lanes * (35 + 1 + 14) * 4 + lanes * 3 + interior_lanes * 16
    return least, moved


BASIC_CELLS = ('one_weekend_final.offline_1200x675_w8',
               'next_week_final.offline_800x800_w10',
               'cornell_box.offline_2880x2880')
# Bytes of one launch of the basic-sample kernel: every lane reads its type
# and its `where` entry (the walk's OpenPBR lanes the type alone); a lane
# that samples reads its uniforms and the columns of its model and writes
# the sample (scattered 3 words, throughput and probability 4 each, valid
# a byte: 45 bytes); without OpenPBR in the set a lane that does not sample
# writes a sample that is not valid, which no caller reads.
BASIC_READ_BYTES = {0: 2 * 4 + 4 * 4,                         # u1 u2, base
                    1: 2 * 4 + 3 * 4 + 2 * 4 * 4 + 2 * 4,     # view, spectra
                    2: 3 * 4 + 3 * 4 + 2 * 4 * 4 + 4 * 4}     # lam, ext IOR
BASIC_WRITE_BYTES = 3 * 4 + 2 * 4 * 4 + 1


def basic_bytes(counts, lanes, walk_lanes, with_walk):
    """(the layer's least bytes, what the kernel moves) for one launch of
    the basic-sample kernel over `lanes` lanes, `counts[m]` of which sample
    model m and `walk_lanes` of which are the walk's OpenPBR lanes. The
    least counts a sampling lane's reads and writes and every other lane's
    type and mask; the kernel also writes the lanes that do not sample,
    unless the walk's outputs are completed in place."""
    sampled = sum(counts)
    least = (5 * (lanes - walk_lanes) + 4 * walk_lanes
             + sum(c * (BASIC_READ_BYTES[m] + BASIC_WRITE_BYTES)
                   for m, c in enumerate(counts)))
    idle = lanes - walk_lanes - sampled
    return least, least + (0 if with_walk else idle * BASIC_WRITE_BYTES)


def basic_sample_phase(dev, card, ptxas_records, seed=2 ** 31 + 29):
    """Phase `basic_sample`: the basic models' BSDF-sample kernel
    (csrc/basic_sample.cu) against the plain dispatch it replaces
    (models/dispatch.py::sample_bsdf_plain: every model of the set on every
    lane, then the selects), both on the card, on every lane of three
    benchmark cells' states in their third round: one_weekend_final
    (6,480,000 lanes; diffuse, metal, glass), next_week_final (6,400,000;
    the same models and the OpenPBR light, which the walk samples first on
    both sides) and the Cornell box at 2880x2880 (8,294,400; diffuse and
    the OpenPBR light). The inputs `scatter` hands `dispatch.sample_bsdf`
    are captured; the card's path (the walk where the set holds OpenPBR,
    then the kernel in place) and the plain dispatch run on them from the
    same random state, bit for bit in every output of every lane that
    samples (a difference fails the run), timed in turns and the kernel
    alone cold (after 384 MiB written), beside its bytes over HBM bandwidth
    and `ptxas`'s registers and spills. Returns the records by cell."""
    import types

    import torch

    from benchmark.harness.cell import load_cell
    from path_tracer_tpu_torch.core import constants
    from path_tracer_tpu_torch.core.sampling import Rng
    from path_tracer_tpu_torch.integrator import wavefront
    from path_tracer_tpu_torch.models import dispatch, openpbr
    from path_tracer_tpu_torch.ops import basic_sample, intersect
    from path_tracer_tpu_torch.scene import model
    from path_tracer_tpu_torch.scene.compile import compile_scene
    from test_torch_cuda import basic_models, basic_plain, same_bits

    api = types.SimpleNamespace(**{
        k: v for m in (constants, model) for k, v in vars(m).items()
        if not k.startswith('_')})
    regs = [r for r in ptxas_records if r['source'] == 'basic_sample.cu']
    records = {}
    for name in BASIC_CELLS:
        cell = load_cell(name)
        width, height = cell.traffic['width'], cell.traffic['height']
        packed = compile_scene(cell.maker.make_scene(api, cell.config),
                               aspect_ratio=width / height, device=dev)
        layout = intersect.SceneLayout.from_packed(packed)
        config = wavefront.RenderConfig(
            width=width, height=height, waves=cell.traffic.get('waves', 1),
            flags=(constants.RENDER_FLAG_ACCUMULATE
                   | constants.RENDER_FLAG_SAMPLE_JITTER),
            camera_model=packed.host_camera_models[0])
        term = cell.traffic['termination_probability']
        state = wavefront.reset(packed, config, seed)
        wavefront.render(packed, config, 2, state=state, layout=layout,
                         termination_probability=term)
        captured = []
        sample = dispatch.sample_bsdf

        def capture(ctx, view, rng, types=(), where=None):
            captured.append((ctx, view, rng.state.clone(), types, where))
            return sample(ctx, view, rng, types, where)

        dispatch.sample_bsdf = capture
        try:
            wavefront.render_round(packed, layout, config, state, term)
        finally:
            dispatch.sample_bsdf = sample
        del state
        (ctx, view, start, type_set, where), = captured
        cols = {k: ctx[k].contiguous() for k in basic_sample.CTX_INPUTS
                if k in ctx}
        with_walk = constants.MATERIAL_TYPE_OPENPBR in dispatch.active_types(
            type_set)
        rng = Rng(start.clone())
        u = [rng.uniform() for _ in range(3)]
        walk_out = (openpbr.sample_bsdf(ctx, view, *u, Rng(rng.state.clone()),
                                        where) if with_walk else None)

        def card_path():
            return sample(ctx, view, Rng(start.clone()), type_set, where)

        def plain():
            return basic_plain(ctx, view, start, type_set, where)

        # The kernel alone completes the walk's outputs in place: the same
        # lanes with the same values at every launch.
        out = None if walk_out is None else [x.clone() for x in walk_out]

        def kernel():
            return basic_sample.basic_sample(cols, view, *u, type_set, where,
                                             out=out)

        models = basic_models(ctx['type'], type_set, where)
        got, want = card_path(), plain()
        lanes_used = models >= 0
        equal = {k: bool(same_bits(g[..., lanes_used], w[..., lanes_used]))
                 for k, g, w in zip(('scattered', 'throughput', 'probability',
                                     'valid'), got, want)}
        del got, want
        counts = [int((models == m).sum()) for m in range(3)]
        n = view.shape[1]
        walk_lanes = int((ctx['type'] == constants.MATERIAL_TYPE_OPENPBR).sum()
                         ) if with_walk else 0
        ms = time_in_turns({'card_path': card_path, 'plain': plain,
                            'kernel': kernel}, TIMING_REPS)
        flush_buffer = torch.empty(96 * 2 ** 20, dtype=torch.float32,
                                   device=dev)
        ms_cold = cuda_ms(kernel, flush=flush_buffer.zero_)
        del flush_buffer
        least, moved = basic_bytes(counts, n, walk_lanes, with_walk)
        least_ms = 1e3 * least / PEAK_BYTES_S
        moved_ms = 1e3 * moved / PEAK_BYTES_S
        rec = records[name] = dict(
            nvidia_smi=card, cell=name, lanes=n, types=list(type_set),
            sampled=dict(zip(('diffuse', 'metal', 'translucent'), counts)),
            walk_lanes=walk_lanes, equal=equal, kernel_ms=ms['kernel'],
            kernel_ms_cold=ms_cold, card_path_ms=ms['card_path'],
            plain_ms=ms['plain'], speedup=ms['plain'] / ms['card_path'],
            least_bytes=least, least_bound_ms=least_ms, moved_bytes=moved,
            moved_bound_ms=moved_ms, bound_by='bytes',
            roofline_pct=100.0 * least_ms / ms['kernel'],
            moved_pct=100.0 * moved_ms / ms['kernel'],
            registers=[r['registers'] for r in regs],
            spill_bytes=[r['spill_store_bytes'] + r['spill_load_bytes']
                         for r in regs])
        log('basic_sample', **rec)
        del packed, ctx, view, cols, walk_out, out, kernel, plain, card_path
        torch.cuda.empty_cache()
        if not all(equal.values()):
            raise RuntimeError('the basic-sample kernel disagrees with the '
                               f'plain dispatch in {name}')
    return records


def medium_event_phase(dev, card, ptxas_records, seed=2 ** 31 + 23):
    """Phase `medium_event`: the medium-event kernel (csrc/medium_event.cu)
    against the plain version it replaces
    (integrator/scatter.py::medium_event_plain), both on the card, on every
    lane of two benchmark cells' states in their third round: the Cornell
    box at 2880x2880 (8,294,400 lanes, all in the ambient medium) and
    one_weekend_final at 1200x675 with 8 waves (6,480,000 lanes, some
    inside glass). The inputs `scatter` hands the kernel are captured, then
    both run on them, bit for bit in every output and the random state (a
    difference fails the run), timed in turns and cold (after 384 MiB
    written), beside the least bytes over HBM bandwidth and `ptxas`'s
    registers and spills. Returns the records by cell."""
    import types

    import torch

    from benchmark.harness.cell import load_cell
    from path_tracer_tpu_torch.core import constants
    from path_tracer_tpu_torch.integrator import scatter, wavefront
    from path_tracer_tpu_torch.ops import intersect, medium_event
    from path_tracer_tpu_torch.scene import model
    from path_tracer_tpu_torch.scene.compile import compile_scene
    from test_torch_cuda import medium_event_plain_of, same_bits

    api = types.SimpleNamespace(**{
        k: v for m in (constants, model) for k, v in vars(m).items()
        if not k.startswith('_')})
    regs = [r for r in ptxas_records if r['source'] == 'medium_event.cu']
    records = {}
    for name in ATTRIBUTE_CELLS:
        cell = load_cell(name)
        width, height = cell.traffic['width'], cell.traffic['height']
        packed = compile_scene(cell.maker.make_scene(api, cell.config),
                               aspect_ratio=width / height, device=dev)
        layout = intersect.SceneLayout.from_packed(packed)
        config = wavefront.RenderConfig(
            width=width, height=height, waves=cell.traffic.get('waves', 1),
            flags=(constants.RENDER_FLAG_ACCUMULATE
                   | constants.RENDER_FLAG_SAMPLE_JITTER),
            camera_model=packed.host_camera_models[0])
        term = cell.traffic['termination_probability']
        state = wavefront.reset(packed, config, seed)
        wavefront.render(packed, config, 2, state=state, layout=layout,
                         termination_probability=term)
        captured = []
        launch = medium_event.medium_event
        medium_event.medium_event = (
            lambda p, t, lanes, **k: captured.append(
                (t, {n: v.clone() for n, v in lanes.items()})) or launch(
                    p, t, lanes, **k))
        try:
            wavefront.render_round(packed, layout, config, state, term)
        finally:
            medium_event.medium_event = launch
        del state
        (type_set, lanes), = captured

        def kernel():
            return launch(packed, type_set, lanes)

        def plain():
            return medium_event_plain_of(packed, type_set, lanes)

        got, want = kernel(), plain()
        equal = {k: bool(same_bits(got[k], want[k])) for k in want}
        bins = torch.bincount(scatter.medium_bins(want), minlength=3).tolist()
        del got, want
        n = lanes['origin'].shape[1]
        ms = time_in_turns({'kernel': kernel, 'plain': plain}, TIMING_REPS)
        flush_buffer = torch.empty(96 * 2 ** 20, dtype=torch.float32,
                                   device=dev)
        ms_cold = cuda_ms(kernel, flush=flush_buffer.zero_)
        del flush_buffer
        least, moved = medium_bytes(n, bins[1] + bins[2])
        least_ms = 1e3 * least / PEAK_BYTES_S
        moved_ms = 1e3 * moved / PEAK_BYTES_S
        rec = records[name] = dict(
            nvidia_smi=card, cell=name, lanes=n,
            bins=dict(zip(scatter.MEDIUM_BINS, bins)), equal=equal,
            kernel_ms=ms['kernel'], kernel_ms_cold=ms_cold,
            plain_ms=ms['plain'], speedup=ms['plain'] / ms['kernel'],
            least_bytes=least, least_bound_ms=least_ms, moved_bytes=moved,
            moved_bound_ms=moved_ms, bound_by='bytes',
            roofline_pct=100.0 * least_ms / ms['kernel'],
            moved_pct=100.0 * moved_ms / ms['kernel'],
            registers=[r['registers'] for r in regs],
            spill_bytes=[r['spill_store_bytes'] + r['spill_load_bytes']
                         for r in regs])
        log('medium_event', **rec)
        del packed, lanes, kernel, plain
        torch.cuda.empty_cache()
        if not all(equal.values()):
            raise RuntimeError('the medium-event kernel disagrees with the '
                               f'plain version in {name}')
    return records


TAIL_CELLS = ('cornell_box.offline_2880x2880', 'spd_tetra.offline_1440x1440_w4')


def tail_bytes(bins, lanes, flags):
    """(the layer's least bytes, what the kernel moves) for one launch of
    the scatter-tail kernel over `lanes` lanes, `bins` of which hit the
    sky, scatter in a volume, scatter off a surface and pass through one,
    under the ScatterTailFlags `flags`. The least is 23 words a lane
    (benchmark/metrics/scatter_tail_roofline.py). What it moves: every
    lane reads 18 words and the branch masks its flags hold, and writes
    the new throughput, probability, sample, origin, direction, the alive
    byte and the random state (and the active shapes where transmissive);
    a sky lane reads its origin, a volume lane the volumetric branch (14
    words), a ghost its position, a surface lane its position, frame,
    shape, priority and integrand (every surface lane counted as a real
    interface), and with OpenPBR its type; the sky's texels and the
    emission columns of emitting lanes are left out."""
    from path_tracer_tpu_torch.ops import scatter_tail

    medium = bool(flags & scatter_tail.MEDIUM)
    transmissive = bool(flags & scatter_tail.TRANSMISSIVE)
    every = (18 * 4 + (2 if medium else 0)
             + (1 if flags & scatter_tail.OPACITY else 0)
             + (16 if transmissive else 0)
             + 16 + 16 + 12 + 12 + 12 + 1 + 8 + (16 if transmissive else 0))
    surface = (12 + 36 + 4 + (4 if medium else 0 if transmissive else 16)
               + 12 + 16 + 16 + 1
               + (4 if flags & scatter_tail.OPENPBR else 0))
    moved = (lanes * every + bins['sky'] * 12 + bins['volume'] * 14 * 4
             + bins['ghost'] * 12 + bins['surface'] * surface)
    return lanes * 23 * 4, moved


def scatter_tail_phase(dev, card, ptxas_records, seed=2 ** 31 + 37):
    """Phase `scatter_tail`: the scatter-tail kernel (csrc/scatter_tail.cu)
    against the plain version it replaces
    (integrator/scatter.py::scatter_tail_plain), both on the card, on every
    lane of two benchmark cells' states in their third round: the Cornell
    box at 2880x2880 (8,294,400 lanes: a medium, OpenPBR emission,
    bookkeeping, the default sky) and spd_tetra at 1440x1440 with 4 waves
    (8,294,400: medium-free, most lanes on the sky). The arguments `scatter`
    hands the tail are captured, then both run on them, bit for bit in
    every output and the random state (a difference fails the run), timed
    in turns and the kernel alone cold (after 384 MiB written), beside the
    least bytes and what the kernel moves over HBM bandwidth and `ptxas`'s
    registers and spills. Returns the records by cell."""
    import types

    import torch

    from benchmark.harness.cell import load_cell
    from path_tracer_tpu_torch.core import constants
    from path_tracer_tpu_torch.integrator import scatter, wavefront
    from path_tracer_tpu_torch.ops import intersect, scatter_tail
    from path_tracer_tpu_torch.scene import model
    from path_tracer_tpu_torch.scene.compile import compile_scene
    from test_torch_cuda import (
        capture_tail, same_bits, tail_bin_counts, tail_outputs)

    api = types.SimpleNamespace(**{
        k: v for m in (constants, model) for k, v in vars(m).items()
        if not k.startswith('_')})
    regs = [r for r in ptxas_records if r['source'] == 'scatter_tail.cu']
    records = {}
    for name in TAIL_CELLS:
        cell = load_cell(name)
        width, height = cell.traffic['width'], cell.traffic['height']
        packed = compile_scene(cell.maker.make_scene(api, cell.config),
                               aspect_ratio=width / height, device=dev)
        layout = intersect.SceneLayout.from_packed(packed)
        config = wavefront.RenderConfig(
            width=width, height=height, waves=cell.traffic.get('waves', 1),
            flags=(constants.RENDER_FLAG_ACCUMULATE
                   | constants.RENDER_FLAG_SAMPLE_JITTER),
            camera_model=packed.host_camera_models[0])
        term = cell.traffic['termination_probability']
        state = wavefront.reset(packed, config, seed)
        wavefront.render(packed, config, 2, state=state, layout=layout,
                         termination_probability=term)
        args = capture_tail(packed, layout, config, state, term)
        del state
        lanes = {}
        launch = scatter_tail.scatter_tail
        scatter_tail.scatter_tail = (
            lambda p, lay, given, t, **k: lanes.update(given) or launch(
                p, lay, given, t, **k))
        try:
            got = tail_outputs(scatter.scatter_tail, args)
        finally:
            scatter_tail.scatter_tail = launch
        want = tail_outputs(scatter.scatter_tail_plain, args)
        equal = {k: bool(same_bits(got[k], want[k])) for k in want}
        bins = tail_bin_counts(args)
        del got, want

        def kernel():
            return launch(packed, layout, lanes, term)

        def plain():
            return tail_outputs(scatter.scatter_tail_plain, args)

        n = lanes['origin'].shape[1]
        ms = time_in_turns({'kernel': kernel, 'plain': plain}, TIMING_REPS)
        flush_buffer = torch.empty(96 * 2 ** 20, dtype=torch.float32,
                                   device=dev)
        ms_cold = cuda_ms(kernel, flush=flush_buffer.zero_)
        del flush_buffer
        least, moved = tail_bytes(bins, n, scatter_tail.layout_flags(layout))
        least_ms = 1e3 * least / PEAK_BYTES_S
        moved_ms = 1e3 * moved / PEAK_BYTES_S
        rec = records[name] = dict(
            nvidia_smi=card, cell=name, lanes=n, bins=bins, equal=equal,
            flags=scatter_tail.layout_flags(layout),
            kernel_ms=ms['kernel'], kernel_ms_cold=ms_cold,
            plain_ms=ms['plain'], speedup=ms['plain'] / ms['kernel'],
            least_bytes=least, least_bound_ms=least_ms, moved_bytes=moved,
            moved_bound_ms=moved_ms, bound_by='bytes',
            roofline_pct=100.0 * least_ms / ms['kernel'],
            moved_pct=100.0 * moved_ms / ms['kernel'],
            registers=[r['registers'] for r in regs],
            spill_bytes=[r['spill_store_bytes'] + r['spill_load_bytes']
                         for r in regs])
        log('scatter_tail', **rec)
        del packed, lanes, args, kernel, plain
        torch.cuda.empty_cache()
        if not all(equal.values()):
            raise RuntimeError('the scatter-tail kernel disagrees with the '
                               f'plain version in {name}')
    return records


def tree_map(fn, tree):
    """fn over the leaves of a nested dict (a render state)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def tree_equal(a, b):
    """Every leaf of two render states equal bit for bit (same device)."""
    import torch
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(tree_equal(a[k], b[k]) for k in a)
    return a.dtype == b.dtype and torch.equal(a, b)


def phase_clock():
    """lap(name) logs the seconds since the previous lap (or since this
    call): each phase's own time."""
    last = [time.perf_counter()]

    def lap(name):
        now = time.perf_counter()
        log('phase_seconds', of=name, seconds=now - last[0])
        last[0] = now
    return lap


def host_ms(fn, reps=3):
    """Median host milliseconds of fn() ending in a device synchronize,
    after one warm-up call: the time a caller waits for a result."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(times)


def terrain_compile(dev, width, height, side=900):
    """Phase 14: bench config 6 (make_terrain_scene(side): 2 side^2 unique
    triangles in one mesh instance) compiled once at the frame's aspect;
    the 192x108 golden frame has the same aspect and uses it too."""
    from path_tracer_tpu_torch.ops.intersect import SceneLayout
    from path_tracer_tpu_torch.scene.compile import PackedScene, compile_scene
    from path_tracer_tpu_torch.scene.procedural import make_terrain_scene
    import dataclasses

    t0 = time.perf_counter()
    scene = make_terrain_scene(side=side)
    packed = compile_scene(scene, aspect_ratio=width / height, device=dev)
    layout = SceneLayout.from_packed(packed)
    seconds = time.perf_counter() - t0
    table_bytes = {}
    for f in dataclasses.fields(PackedScene):
        for leaf in tree_values(getattr(packed, f.name)):
            table_bytes[f.name] = (table_bytes.get(f.name, 0)
                                   + leaf.numel() * leaf.element_size())
    inst_bytes = sum(table_bytes[k] for k in ('inst_nodes', 'inst_tris',
                                              'inst_rows'))
    log('terrain_compile', scene='6_terrain_stream', side=side,
        seconds=seconds, triangles=sum(len(m.faces) for m in scene.meshes),
        packet_mode=layout.packet_mode, tlas_rows=layout.tlas_rows,
        inst_node_rows=int(packed.inst_nodes.shape[0]),
        inst_leaf_rows=int(packed.inst_tris.shape[0]),
        inst_table_bytes=inst_bytes, all_table_bytes=sum(table_bytes.values()),
        table_bytes=table_bytes)
    if layout.packet_mode != 'inst':
        raise RuntimeError(f'config 6 compiled to {layout.packet_mode}')
    return packed, layout, inst_bytes


def tree_values(value):
    """The tensors of a PackedScene field (a tensor, a dict of tensors or
    a MaterialTable)."""
    import dataclasses
    if isinstance(value, dict):
        return list(value.values())
    if dataclasses.is_dataclass(value):
        return [getattr(value, f.name) for f in dataclasses.fields(value)]
    return [value]


def terrain_render(dev, card, packed, layout, launches, reset_launches,
                   width, height, waves, warmup=2, timed=6, profile_rounds=2):
    """Phase 15: config 6 at width x height with `waves` sample waves
    through `render`: warm-up and timed rounds, Mrays/s (every round
    traces one ray per slot), round ms, peak memory and the kernels
    launched (inst_trace and hit_attributes once a round, nothing
    else), then the device
    time by kernel over `profile_rounds` more rounds. Returns the state
    and inst_trace's launches in the warm-up and timed rounds."""
    import torch
    from path_tracer_tpu_torch.integrator import wavefront

    config = wavefront.RenderConfig(width=width, height=height, waves=waves)
    slots = waves * width * height
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    state = wavefront.render(packed, config, warmup, seed=1, layout=layout)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state = wavefront.render(packed, config, timed, layout=layout, state=state)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    counted = launches()
    accum = state['accum']
    finite = bool(torch.isfinite(accum['xyz']).all())
    log('terrain_render', scene='6_terrain_stream', width=width,
        height=height, waves=waves, slots=slots, rounds=timed,
        seconds=elapsed, mrays_s=slots * timed / elapsed / 1e6,
        round_ms=1e3 * elapsed / timed, launches=counted,
        peak_gib=torch.cuda.max_memory_allocated() / 2**30,
        samples=float(accum['count'].sum()), finite=finite, card=card)
    if not launched_once_a_trace(counted, warmup + timed):
        raise RuntimeError(f'config 6 at waves={waves} launched {counted} in '
                           f'{warmup + timed} rounds')
    if not (finite and float(accum['count'].sum()) > 0):
        raise RuntimeError(f'config 6 at waves={waves}: the accumulator is '
                           'not finite or holds no sample')
    round_ms = 1e3 * elapsed / timed
    busy_ms, by_name, n_kernels = device_profile(lambda: wavefront.render(
        packed, config, profile_rounds, layout=layout, state=state))
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    log('terrain_profile', waves=waves, rounds=profile_rounds,
        device_busy_ms_per_round=busy_ms / profile_rounds,
        kernels_per_round=n_kernels / profile_rounds,
        idle_share_vs_unprofiled_round=1.0 - busy_ms / profile_rounds / round_ms,
        traversal_kernel_ms_per_round=sum(
            v for k, v in by_name.items() if 'inst_trace_kernel' in k)
        / profile_rounds,
        top_kernels_ms_per_round=[[k, v / profile_rounds, v / busy_ms]
                                  for k, v in top])
    return state, counted['inst_trace']


def terrain_kernel(packed, layout, state, inst_bytes, subset_size, flush):
    """Phase 16: inst_trace on config 6's bounce rays (the waves=1 state
    after its rounds, in lane order as the render path feeds it): warm
    and cold ms, bit-equal to its plain version on a subset, the pop cull
    against the plain version without it on that subset, and its bound
    from the counted pops and triangles. The first scene whose
    tables do not fit the 50 MB L2."""
    import torch
    from path_tracer_tpu_torch.core.constants import HIT_TIME_LIMIT
    from path_tracer_tpu_torch.ops import trace_inst
    from path_tracer_tpu_torch.ops.intersect import intersect_analytic, make_hit
    from path_tracer_tpu_torch.scene import bvh8

    o, d = state['origin'], state['direction']
    n = int(o.shape[1])
    t_in = intersect_analytic(packed, layout, o, d,
                              make_hit(n, HIT_TIME_LIMIT, o.device))['time']
    rays = (o, d, t_in)
    tables = (packed.inst_nodes, packed.inst_tris, packed.inst_rows)

    def kernel(*rays, **kw):
        return trace_inst.inst_trace(*tables, *rays, layout.tlas_rows, **kw)

    gen = torch.Generator().manual_seed(1)
    subset = torch.randperm(n, generator=gen)[:subset_size].to(o.device)
    out = kernel(*rays)
    *counted, counts = kernel(*rays, stats=True)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(out, counted)):
        raise RuntimeError('inst_trace on config 6: the launch with counters '
                           'gives other results')
    sub = tuple(x[..., subset].contiguous() for x in rays)
    sub_out = [x[..., subset] for x in out]
    max_err, agree = compare('inst_trace', 'terrain_bounce/' + bvh8.LEAF_FMT,
                             sub_out, trace_inst.inst_trace_plain(
                                 *tables, *sub, layout.tlas_rows))
    pop_cull(sub_out, trace_inst.inst_trace_plain(
        *tables, *sub, layout.tlas_rows, cull=False), 'inst_trace',
        'terrain_bounce', bvh8.LEAF_FMT)
    ms = cuda_ms(lambda: kernel(*rays))
    ms_cold = cuda_ms(lambda: kernel(*rays), flush=flush)
    bound_ms, bound_by, nbytes, ops = kernel_bound(
        counts, n, inst_bytes, 5, OPS_TRIANGLE[bvh8.LEAF_FMT])
    per_ray = [c.float().mean().item() for c in counts]
    rec = dict(ms=ms, ms_cold=ms_cold, cold_over_warm=ms_cold / ms,
               bound_ms=bound_ms, bound_by=bound_by, max_abs_err=max_err,
               agreement=agree)
    log('terrain_kernel', kernel='inst_trace', set='bounce', rays=n,
        leaf_fmt=bvh8.LEAF_FMT, table_bytes=inst_bytes,
        compulsory_bytes=nbytes, f32_ops=ops,
        per_ray_interior_pops=per_ray[0], per_ray_leaf_pops=per_ray[1],
        per_ray_leaf_rows=per_ray[2], per_ray_instance_entries=per_ray[3],
        per_ray_triangles=per_ray[4],
        hit_fraction=float((out[1] >= 0).float().mean()),
        over_bound=ms / bound_ms, **rec)
    return rec


def index_add_fold(xyz, count, lane, width, height):
    """The per-pixel fold of integrator/resolve.py before it added the
    slots in a fixed order: index_add_, float atomics on the card. Kept
    here to time the two folds side by side."""
    import torch
    from path_tracer_tpu_torch.integrator.state import lane_to_pixel
    px, py = lane_to_pixel(lane, width, height)
    flat = (py * width + px).long()
    pix_xyz = torch.zeros((3, width * height), dtype=torch.float32,
                          device=xyz.device).index_add_(1, flat, xyz)
    pix_count = torch.zeros((width * height,), dtype=torch.float32,
                            device=xyz.device).index_add_(0, flat, count)
    return pix_xyz, pix_count


def resolve_determinism(state, width, height, repeats=8):
    """Phase 17: resolve the waves=4 state `repeats` times; the frames must
    be equal bit for bit (resolve adds a pixel's slots in slot order). The
    fold is timed against the index_add_ fold it replaced, on the reset
    layout and on the same slots shuffled (the sort and rank path, which
    must be bit-stable too)."""
    import torch
    from path_tracer_tpu_torch.integrator.resolve import fold, resolve

    xyz, count, lane = state['accum']['xyz'], state['accum']['count'], \
        state['lane']
    frames = [resolve(state['accum'], width, height, lane=lane)
              for _ in range(repeats)]
    diffs = [(f - frames[0]).abs() for f in frames[1:]]
    bit_equal = all(bool(torch.equal(f, frames[0])) for f in frames[1:])
    gen = torch.Generator().manual_seed(2)
    perm = torch.randperm(lane.numel(), generator=gen).to(lane.device)
    shuffled = (xyz[:, perm].contiguous(), count[perm].contiguous(),
                lane[perm].contiguous())
    shuffled_folds = [fold(*shuffled, width, height) for _ in range(3)]
    shuffled_equal = all(torch.equal(a, b) for f in shuffled_folds[1:]
                         for a, b in zip(f, shuffled_folds[0]))
    reference = index_add_fold(xyz, count, lane, width, height)
    new = fold(xyz, count, lane, width, height)
    ms = dict(
        fold=cuda_ms(lambda: fold(xyz, count, lane, width, height)),
        index_add_fold=cuda_ms(lambda: index_add_fold(xyz, count, lane,
                                                      width, height)),
        fold_shuffled=cuda_ms(lambda: fold(*shuffled, width, height), reps=3),
        resolve=cuda_ms(lambda: resolve(state['accum'], width, height,
                                        lane=lane)))
    log('resolve_determinism', slots=int(lane.numel()), width=width,
        height=height, resolves=repeats, bit_equal=bit_equal,
        pixels_differing=max(int((d > 0).any(-1).sum()) for d in diffs),
        max_abs_diff=max(float(d.max()) for d in diffs),
        shuffled_fold_bit_equal=shuffled_equal,
        max_rel_diff_vs_index_add=max(
            float(((a - b).abs() / b.abs().clamp(min=1e-6)).max())
            for a, b in zip(new, reference)), ms=ms)
    if not all(bool(torch.isfinite(f).all()) for f in frames):
        raise RuntimeError('the config 6 frame is not finite')
    if not (bit_equal and shuffled_equal):
        raise RuntimeError('resolve gave different frames from one state')
    return ms


def terrain_golden(dev, repo, packed, layout, launches, reset_launches,
                   rounds=24):
    """Config 6's golden frame (192x108, 24 rounds, seed 123, one wave),
    rendered on the tables compiled in phase 14, within bench.py's bands;
    inst_trace and hit_attributes once a round."""
    from path_tracer_tpu_torch.integrator import wavefront
    from path_tracer_tpu_torch.integrator.resolve import resolve

    reset_launches()
    state = wavefront.render(packed, wavefront.RenderConfig(width=192,
                                                            height=108),
                             rounds, seed=123, layout=layout)
    img = resolve(state['accum'], 192, 108).cpu().numpy()
    counted = launches()
    rel, rel_lim, bias, bias_lim = check_golden('6_terrain_stream', img, repo)
    log('golden', name='6_terrain_stream', packet_mode='inst', rel_err=rel,
        rel_limit=rel_lim, bias=bias, bias_limit=bias_lim,
        launches={k: v for k, v in counted.items() if v})
    if not launched_once_a_trace(counted, rounds):
        raise RuntimeError(f'the 6_terrain_stream frame launched {counted}')
    if not (rel < rel_lim and bias < bias_lim):
        raise RuntimeError('the 6_terrain_stream golden frame is outside its '
                           'bands')


def checkpoint_phase(dev, repo, width, height, rounds=4, every=2):
    """Phase 18: the viking hall at width x height through
    render_resilient with one failure injected after the first
    checkpoint, against the same render uninterrupted (bit for bit); the
    checkpoint file loaded on the CPU; save and load ms and the file's
    size."""
    import torch
    from path_tracer_tpu_torch.integrator.checkpoint import (
        load_render_state, save_render_state)
    from path_tracer_tpu_torch.scene.procedural import make_viking_hall_scene
    from path_tracer_tpu_torch.utils.resilience import render_resilient

    out_dir = os.path.join(repo, 'build', 'smoke')
    os.makedirs(out_dir, exist_ok=True)
    ckpt = os.path.join(out_dir, 'viking.npz')
    for path in (ckpt, ckpt + '.rounds'):
        if os.path.exists(path):
            os.remove(path)
    t0 = time.perf_counter()
    clean = render_resilient(make_viking_hall_scene(detail=1), width, height,
                             rounds, seed=3, checkpoint_every=every,
                             device=dev)
    torch.cuda.synchronize()
    clean_s = time.perf_counter() - t0
    fired = []

    def inject(done):
        if done == every and not fired:
            fired.append(done)
            raise RuntimeError('injected failure after the first checkpoint')

    t0 = time.perf_counter()
    recovered = render_resilient(make_viking_hall_scene(detail=1), width,
                                 height, rounds, seed=3,
                                 checkpoint_path=ckpt, checkpoint_every=every,
                                 device=dev, _inject_failure=inject)
    torch.cuda.synchronize()
    recovered_s = time.perf_counter() - t0
    equal = tree_equal(clean, recovered)
    on_card = recovered['accum']['xyz'].device.type == torch.device(dev).type

    timed = os.path.join(out_dir, 'timed.npz')
    t0 = time.perf_counter()
    save_render_state(timed, recovered)
    save_ms = 1e3 * (time.perf_counter() - t0)
    t0 = time.perf_counter()
    back = load_render_state(timed, recovered, device=dev)
    torch.cuda.synchronize()
    load_ms = 1e3 * (time.perf_counter() - t0)
    on_cpu = load_render_state(ckpt, tree_map(lambda x: x.cpu(), recovered),
                               device='cpu')
    cpu_equal = tree_equal(on_cpu, tree_map(lambda x: x.cpu(), recovered))
    log('checkpoint', scene='3_viking_hall', width=width, height=height,
        rounds=rounds, checkpoint_every=every, failure_injected_at=fired,
        resumed_equals_uninterrupted=equal, state_on_card=on_card,
        checkpoint_loads_on_cpu_equal=cpu_equal,
        file_mb=os.path.getsize(timed) / 1e6, save_ms=save_ms,
        load_ms=load_ms, reloaded_equal=tree_equal(back, recovered),
        uninterrupted_seconds=clean_s, recovered_seconds=recovered_s)
    if not (fired and equal and on_card and cpu_equal
            and tree_equal(back, recovered)):
        raise RuntimeError('the resumed viking render differs from the '
                           'uninterrupted one, or its checkpoint does not '
                           'load on the CPU')


def read_png(path):
    """(H, W, 4) uint8 pixels of a PNG as utils/image.encode_png writes it:
    8-bit RGBA, one IDAT stream, filter type 0 on every row."""
    import struct
    import zlib
    import numpy as np
    with open(path, 'rb') as f:
        data = f.read()
    if data[:8] != b'\x89PNG\r\n\x1a\n':
        raise RuntimeError(f'{path} is not a PNG')
    pos, idat, size = 8, b'', None
    while pos < len(data):
        (length,) = struct.unpack('>I', data[pos:pos + 4])
        tag = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        if tag == b'IHDR':
            size = struct.unpack('>II', body[:8])
        elif tag == b'IDAT':
            idat += body
        pos += 12 + length
    w, h = size
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + 4 * w)
    if rows[:, 0].any():
        raise RuntimeError(f'{path}: a row filter this reader does not decode')
    return rows[:, 1:].reshape(h, w, 4)


def cli_phase(repo, width=192, height=108, rounds=8):
    """Phase 19: `python -m path_tracer_tpu_torch render <the reference
    schema's scene file>` and `... demo cornell`, each a subprocess on the
    card; each must exit 0 and write a PNG that is not black."""
    out_dir = os.path.join(repo, 'build', 'smoke')
    os.makedirs(out_dir, exist_ok=True)
    fixture = os.path.join(repo, 'tests', 'fixtures', 'reference_scene',
                           'scene.json')
    size = ['--width', str(width), '--height', str(height),
            '--rounds', str(rounds), '--device', 'cuda']
    for name, args in (('render', ['render', fixture]),
                       ('demo', ['demo', 'cornell'])):
        png = os.path.join(out_dir, f'cli_{name}.png')
        if os.path.exists(png):
            os.remove(png)
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, '-m', 'path_tracer_tpu_torch', *args, png, *size],
            cwd=repo, capture_output=True, text=True, timeout=300)
        seconds = time.perf_counter() - t0
        pixels = read_png(png) if os.path.exists(png) else None
        mean = float(pixels[..., :3].mean()) if pixels is not None else None
        log('cli', command=name, returncode=proc.returncode, seconds=seconds,
            png_shape=None if pixels is None else list(pixels.shape),
            mean_8bit=mean, stderr_tail=proc.stderr[-300:])
        if proc.returncode != 0 or pixels is None or not (
                pixels.shape == (height, width, 4) and mean > 1.0):
            raise RuntimeError(f'the CLI {name} run failed or wrote a black '
                               f'or missing PNG:\n{proc.stderr[-2000:]}')


def session_phase(dev, card, launches, reset_launches, width, height):
    """Phase 20: a Session on the viking hall at width x height: restart
    and steady frame ms (inst_trace and hit_attributes once a round),
    with the default
    (specialized) layout and with the generic one, a material edit
    through the incremental compile against a full compile (the same
    frame bit for bit), preview ms in all seven modes, pick ms, and the
    mesh-complexity heatmap, whose kernel counters equal the plain
    version's on the card."""
    import numpy as np
    import torch
    from path_tracer_tpu_torch.app import Session
    from path_tracer_tpu_torch.core.constants import (
        HIT_TIME_LIMIT, SHAPE_INDEX_NONE, SHAPE_TYPE_MESH_INSTANCE)
    from path_tracer_tpu_torch.integrator import wavefront
    from path_tracer_tpu_torch.integrator.resolve import resolve
    from path_tracer_tpu_torch.ops import trace_inst
    from path_tracer_tpu_torch.ops.intersect import trace
    from path_tracer_tpu_torch.scene.compile import compile_scene
    from path_tracer_tpu_torch.scene.model import SCENE_DIRTY_MATERIALS
    from path_tracer_tpu_torch.scene.procedural import make_viking_hall_scene
    from path_tracer_tpu_torch.viewer import preview

    t0 = time.perf_counter()
    session = Session(make_viking_hall_scene(detail=1), width, height,
                      device=dev)
    torch.cuda.synchronize()
    open_s = time.perf_counter() - t0
    reset_launches()
    steady_ms = host_ms(session.frame, reps=5)
    steady_launches = launches()

    def restart_frame():
        session.move_camera(delta=(0.0, 0.0, 0.0))
        return session.frame()

    reset_launches()
    restart_ms = host_ms(restart_frame, reps=3)
    restart_launches = launches()
    busy_ms, _, n_kernels = device_profile(session.frame)

    # The JAX package's generic programs (its editor's default) keep its
    # program fixed under edits; here they only run every model's branch.
    # The same frames with the generic layout:
    generic = Session(make_viking_hall_scene(detail=1), width, height,
                      generic_programs=True, device=dev)
    generic_ms = host_ms(generic.frame, reps=5)
    generic_busy_ms, _, generic_kernels = device_profile(generic.frame)
    generic_restart_ms = host_ms(
        lambda: (generic.move_camera(), generic.frame())[1], reps=3)
    del generic
    if not (launched_once_a_trace(steady_launches, 6)
            and launched_once_a_trace(restart_launches, 8)):
        raise RuntimeError(f'Session frames launched {steady_launches} / '
                           f'{restart_launches}')

    # A material edit: the incremental compile against a full one.
    scene = session.scene
    t0 = time.perf_counter()
    scene.materials[0].base_color = np.asarray([0.8, 0.3, 0.2], np.float32)
    scene.mark_dirty(SCENE_DIRTY_MATERIALS)
    frame = session.frame()
    torch.cuda.synchronize()
    edit_ms = 1e3 * (time.perf_counter() - t0)
    fresh = make_viking_hall_scene(detail=1)
    fresh.compile_generic = session.generic_programs
    fresh.materials[0].base_color = np.asarray([0.8, 0.3, 0.2], np.float32)
    t0 = time.perf_counter()
    full = compile_scene(fresh, aspect_ratio=width / height, device=dev)
    full_compile_ms = 1e3 * (time.perf_counter() - t0)
    states = [wavefront.render(pk, session.config, 2, seed=session._seed)
              for pk in (session.packed, full)]
    images = [resolve(st['accum'], width, height, lane=st['lane'])
              for st in states]
    edit_equal = bool(torch.equal(*images)) and bool(torch.equal(
        images[0], frame))
    del states, full

    world = session.camera_world()
    preview_ms = {}
    for mode in range(7):
        preview_ms[mode] = host_ms(lambda: session.preview(mode=mode))
    pick_ms = host_ms(lambda: session.pick(width // 2, height // 2), reps=5)
    picked = session.pick(width // 2, height // 2)

    # The heatmap: the kernel's per-ray counters against the plain
    # version's, on the card, on the preview's primary rays.
    reset_launches()
    heat = session.preview(mode=preview.PREVIEW_RENDER_MODE_MESH_COMPLEXITY)
    torch.cuda.synchronize()
    heat_launches = launches()
    cam = torch.as_tensor(world, device=dev)
    origin, direction = preview._preview_rays(width, height, cam)
    t_in = torch.full((width * height,), HIT_TIME_LIMIT, device=dev)
    tables = (session.packed.inst_nodes, session.packed.inst_tris,
              session.packed.inst_rows)
    *out, stats = trace_inst.inst_trace(*tables, origin, direction, t_in,
                                        session.layout.tlas_rows, stats=True)
    *plain_out, plain_stats = trace_inst.inst_trace_plain(
        *tables, origin, direction, t_in, session.layout.tlas_rows, stats=True)
    counters_equal = bool(torch.equal(stats, plain_stats)) and all(
        torch.equal(a, b) for a, b in zip(out, plain_out))
    hit = trace(session.packed, session.layout, origin, direction)
    # A miss keeps the mesh shape type with SHAPE_INDEX_NONE as its shape.
    mesh = ((hit['shape_type'] == SHAPE_TYPE_MESH_INSTANCE)
            & (hit['shape'] != SHAPE_INDEX_NONE)).reshape(height, width)
    green = heat[..., 1]
    log('session', scene='3_viking_hall', width=width, height=height,
        open_seconds=open_s, steady_frame_ms=steady_ms,
        restart_frame_ms=restart_ms,
        generic_programs=session.generic_programs,
        steady_frame_device_busy_ms=busy_ms, steady_frame_kernels=n_kernels,
        generic_steady_frame_ms=generic_ms,
        generic_restart_frame_ms=generic_restart_ms,
        generic_device_busy_ms=generic_busy_ms,
        generic_kernels=generic_kernels, launches_steady=steady_launches,
        launches_restart=restart_launches, material_edit_frame_ms=edit_ms,
        full_compile_ms=full_compile_ms, edit_frame_equals_full_compile=edit_equal,
        preview_ms=preview_ms, pick_ms=pick_ms, picked_shape=picked,
        heatmap_launches=heat_launches, mesh_pixels=int(mesh.sum()),
        heat_min_on_mesh=float(green[mesh].min()) if bool(mesh.any()) else None,
        heat_mean=float(green.mean()), counters_equal_plain=counters_equal,
        per_ray_pops=float((stats[0] + stats[1]).float().mean()), card=card)
    if not (edit_equal and counters_equal and bool(mesh.any())
            and float(green[mesh].min()) > 0.0
            and heat_launches['inst_trace'] == 2 and picked >= -1):
        raise RuntimeError('Session: the incremental frame differs from the '
                           'full compile, the heatmap is empty on the mesh, '
                           'or the counters differ from the plain version')
    return steady_launches['inst_trace'] + restart_launches['inst_trace']


def http_get(url):
    import urllib.request
    with urllib.request.urlopen(url, timeout=HTTP_TIMEOUT) as resp:
        return resp.read()


def http_post(url, body):
    import urllib.request
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 method='POST')
    with urllib.request.urlopen(req, timeout=HTTP_TIMEOUT) as resp:
        return json.loads(resp.read())


def viewer_phase(dev, card, launches, reset_launches, width, height):
    """Phase 21: viewer/server.py over a Session on the viking hall at
    width x height, on the card, driven over http://127.0.0.1: the page,
    10 /frame.png polls (ms each, the median, inst_trace launches a poll,
    PNG bytes), one steady poll split into Session.frame, the copy to the
    host, encode_png and the rest (HTTP), /move and the restart frame,
    /pick on the hall, /material/update and the frame after it (bit-equal
    to a full compile's frame at the same seed: the incremental compile
    through HTTP), one preview frame in each of the seven modes, /status;
    and the steady poll of a Session with the generic layout."""
    import numpy as np
    import torch
    from path_tracer_tpu_torch.app import Session
    from path_tracer_tpu_torch.integrator import wavefront
    from path_tracer_tpu_torch.integrator.resolve import resolve
    from path_tracer_tpu_torch.scene.compile import compile_scene
    from path_tracer_tpu_torch.scene.model import ENTITY_TYPE_CAMERA
    from path_tracer_tpu_torch.scene.procedural import make_viking_hall_scene
    from path_tracer_tpu_torch.utils.image import encode_png
    from path_tracer_tpu_torch.viewer.server import ViewerServer

    def serve(generic):
        session = Session(make_viking_hall_scene(detail=1), width, height,
                          generic_programs=generic, device=dev)
        server = ViewerServer(session, port=0)
        server.serve_background()
        return session, server, f'http://127.0.0.1:{server.port}'

    def poll(base, query='mode=render'):
        t0 = time.perf_counter()
        png = http_get(f'{base}/frame.png?{query}')
        return 1e3 * (time.perf_counter() - t0), png

    session, server, base = serve(False)
    try:
        page = http_get(base + '/').decode()
        if '<title>path_tracer_tpu_torch</title>' not in page:
            raise RuntimeError('the viewer page is not the port\'s')
        reset_launches()
        polls = [poll(base) for _ in range(10)]
        poll_launches = launches()
        poll_ms = [ms for ms, _ in polls]
        png_bytes = len(polls[-1][1])

        # One steady poll, part by part, on the server's own session.
        frame_ms = host_ms(session.frame, reps=5)
        image = session.frame()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pixels = image.cpu().numpy()
        copy_ms = 1e3 * (time.perf_counter() - t0)
        t0 = time.perf_counter()
        encode_png(pixels, compress_level=1)
        encode_ms = 1e3 * (time.perf_counter() - t0)
        steady_ms = statistics.median(poll_ms[1:])

        http_post(base + '/move', {'delta': [0.0, 0.0, -0.05]})
        restart_ms, _ = poll(base)
        t0 = time.perf_counter()
        # The hall's floor, below the opening at the centre of the view.
        picked = http_post(base + '/pick', {'x': width // 2,
                                            'y': height - 1 - height // 20})
        pick_ms = 1e3 * (time.perf_counter() - t0)

        # The incremental compile through HTTP against a full compile.
        t0 = time.perf_counter()
        http_post(base + '/material/update',
                  {'index': 0, 'field': 'base_color',
                   'value': [0.8, 0.3, 0.2]})
        edit_ms, edit_png = poll(base)
        edit_total_ms = 1e3 * (time.perf_counter() - t0)
        edited = resolve(session.state['accum'], width, height,
                         lane=session.state['lane'])
        fresh = make_viking_hall_scene(detail=1)
        fresh.compile_generic = session.generic_programs
        fresh.materials[0].base_color = np.asarray([0.8, 0.3, 0.2],
                                                   np.float32)
        fresh_cam = [e for e in fresh.walk_entities()
                     if e.type == ENTITY_TYPE_CAMERA][session.camera_index]
        fresh_cam.transform.position = session.camera().transform.position
        fresh_cam.transform.rotation = session.camera().transform.rotation
        full = compile_scene(fresh, aspect_ratio=width / height, device=dev)
        state = wavefront.render(full, session.config, 2, seed=session._seed)
        full_image = resolve(state['accum'], width, height,
                             lane=state['lane'])
        edit_equal = (bool(torch.equal(edited, full_image))
                      and encode_png(full_image.cpu().numpy(),
                                     compress_level=1) == edit_png)
        del state, full

        preview_ms = {}
        for mode in range(7):
            preview_ms[mode], png = poll(base, f'mode={mode}')
            if png[:8] != b'\x89PNG\r\n\x1a\n':
                raise RuntimeError(f'preview mode {mode} gave no PNG')
        status = json.loads(http_get(base + '/status'))
    finally:
        server.shutdown()
    session_generic, server_generic, base_generic = serve(True)
    try:
        poll(base_generic)
        generic_ms = statistics.median(poll(base_generic)[0]
                                       for _ in range(5))
    finally:
        server_generic.shutdown()
    del session_generic
    log('viewer', scene='3_viking_hall', width=width, height=height,
        poll_ms=poll_ms, steady_poll_ms=steady_ms,
        steady_poll_parts_ms=dict(
            session_frame=frame_ms, device_to_host=copy_ms,
            encode_png=encode_ms,
            http_and_rest=steady_ms - frame_ms - copy_ms - encode_ms),
        png_bytes=png_bytes, launches_10_polls=poll_launches,
        inst_trace_launches_per_poll=poll_launches['inst_trace'] / 10,
        restart_poll_ms=restart_ms, pick=picked, pick_ms=pick_ms,
        material_edit_poll_ms=edit_ms, material_edit_total_ms=edit_total_ms,
        edit_frame_equals_full_compile=edit_equal, preview_poll_ms=preview_ms,
        status=status, generic_steady_poll_ms=generic_ms, card=card)
    if not launched_once_a_trace(poll_launches, 10):
        raise RuntimeError(f'10 viewer polls launched {poll_launches}')
    if not (edit_equal and picked['shape'] >= 0 and status['spp'] > 0):
        raise RuntimeError('viewer: the edited frame differs from a full '
                           'compile\'s, the pick missed the hall, or the '
                           'status shows no sample')
    return poll_launches['inst_trace']


def cli_tools_phase(dev, repo):
    """Phase 22: `spectrum 0.2 0.5 0.8 --png` and `bvhdump --demo viking
    --depth 2` as subprocesses on the card (exit 0; bvhdump's statistics
    equal bvh_statistics of a compile on the card and of one on the CPU),
    and `view --demo cornell --port 0` started as a subprocess, one
    /frame.png fetched from it, then stopped."""
    import ast
    import select
    from path_tracer_tpu_torch.scene.compile import compile_scene
    from path_tracer_tpu_torch.scene.procedural import make_viking_hall_scene
    from path_tracer_tpu_torch.utils.debug import bvh_statistics

    out_dir = os.path.join(repo, 'build', 'smoke')
    os.makedirs(out_dir, exist_ok=True)
    module = [sys.executable, '-m', 'path_tracer_tpu_torch']
    png = os.path.join(out_dir, 'spectrum.png')
    if os.path.exists(png):
        os.remove(png)
    runs = {}
    for name, args in (('spectrum', ['spectrum', '0.2', '0.5', '0.8',
                                     '--png', png]),
                       ('bvhdump', ['bvhdump', '--demo', 'viking',
                                    '--depth', '2'])):
        t0 = time.perf_counter()
        proc = subprocess.run(module + args, cwd=repo, capture_output=True,
                              text=True, timeout=300)
        runs[name] = proc
        log('cli_tools', command=name, returncode=proc.returncode,
            seconds=time.perf_counter() - t0, stdout_lines=len(
                proc.stdout.splitlines()), stderr_tail=proc.stderr[-300:])
        if proc.returncode != 0:
            raise RuntimeError(f'{name} failed:\n{proc.stderr[-2000:]}')
    spectrum_png = read_png(png)
    dumped = ast.literal_eval(runs['bvhdump'].stdout.splitlines()[0])
    stats = {d: bvh_statistics(compile_scene(make_viking_hall_scene(),
                                             device=d))
             for d in (dev, 'cpu')}
    log('cli_tools', command='bvh_statistics', subprocess=dumped,
        card=stats[dev], cpu=stats['cpu'],
        spectrum_png_shape=list(spectrum_png.shape),
        dump_lines=len(runs['bvhdump'].stdout.splitlines()))
    if not (dumped == stats[dev] == stats['cpu']
            and spectrum_png.shape == (160, 256, 4)):
        raise RuntimeError('bvh_statistics differ between the card, the CPU '
                           'and the CLI, or the spectrum PNG is wrong')

    t0 = time.perf_counter()
    proc = subprocess.Popen(
        module + ['view', '--demo', 'cornell', '--port', '0', '--width',
                  '192', '--height', '108'],
        cwd=repo, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        url, lines = None, []
        while url is None and time.perf_counter() - t0 < 240:
            ready, _, _ = select.select([proc.stdout], [], [], 5.0)
            if ready:
                line = proc.stdout.readline()
                if not line:
                    break
                lines.append(line)
                found = re.search(r'http://127\.0\.0\.1:(\d+)/', line)
                if found:
                    url = found.group(0)
        if url is None:
            raise RuntimeError('view printed no address:\n' + ''.join(lines))
        start_s = time.perf_counter() - t0
        t1 = time.perf_counter()
        frame = http_get(url + 'frame.png?mode=render')
        first_frame_ms = 1e3 * (time.perf_counter() - t1)
    finally:
        proc.terminate()
        try:
            proc.wait(30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
    log('cli_tools', command='view', url=url, start_seconds=start_s,
        first_frame_ms=first_frame_ms, png_bytes=len(frame),
        returncode=proc.returncode)
    if frame[:8] != b'\x89PNG\r\n\x1a\n':
        raise RuntimeError('view served no PNG')


def sharded_phase(dev, card, launches, reset_launches, width, height,
                  render_mrays, warmup=2, timed=6):
    """Phase 23: parallel/render.py at world size 1 over NCCL on the card:
    the viking hall at width x height with waves=1 and waves=4, `warmup`
    + `timed` rounds through render_sharded_state, Mrays/s beside phase
    `render`'s, merge_accumulator ms, peak memory; the merged accumulator
    bit-equal to wavefront.render's at the same seed (in lane order);
    then dryrun_multichip over every card of the machine."""
    import torch
    import torch.distributed as dist
    from path_tracer_tpu_torch.integrator import wavefront
    from path_tracer_tpu_torch.ops.intersect import SceneLayout
    from path_tracer_tpu_torch.parallel import render as parallel
    from path_tracer_tpu_torch.scene.compile import compile_scene
    from path_tracer_tpu_torch.scene.procedural import make_viking_hall_scene

    mesh = parallel.make_mesh(device=dev)
    launched = 0
    try:
        packed = compile_scene(make_viking_hall_scene(detail=1),
                               aspect_ratio=width / height, device=dev)
        layout = SceneLayout.from_packed(packed)
        for waves in (1, 4):
            config = wavefront.RenderConfig(width=width, height=height,
                                            waves=waves)
            slots = waves * width * height
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            reset_launches()
            state = parallel.reset_sharded(packed, config, mesh, seed=1)
            parallel.render_sharded_state(packed, config, warmup, mesh,
                                          state, layout=layout)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            parallel.render_sharded_state(packed, config, timed, mesh,
                                          state, layout=layout)
            torch.cuda.synchronize()
            elapsed = time.perf_counter() - t0
            t0 = time.perf_counter()
            merged = parallel.merge_accumulator(mesh, state)
            torch.cuda.synchronize()
            merge_ms = 1e3 * (time.perf_counter() - t0)
            merge_ms_warm = host_ms(
                lambda: parallel.merge_accumulator(mesh, state))
            counted = launches()
            peak = torch.cuda.max_memory_allocated() / 2**30
            del state
            single = wavefront.render(packed, config, warmup + timed, seed=1,
                                      layout=layout)
            order = torch.argsort(single['lane'], stable=True)
            equal = (torch.equal(merged['xyz'], single['accum']['xyz'][:, order])
                     and torch.equal(merged['count'],
                                     single['accum']['count'][order])
                     and torch.equal(merged['lane'], single['lane'][order]))
            del single
            log('sharded', scene='3_viking_hall', width=width, height=height,
                waves=waves, slots=slots, world_size=dist.get_world_size(),
                backend=dist.get_backend(), mesh=dict(mesh.shape),
                rounds=timed, seconds=elapsed,
                mrays_s=slots * timed / elapsed / 1e6,
                render_phase_mrays_s=render_mrays,
                round_ms=1e3 * elapsed / timed, merge_ms_first=merge_ms,
                merge_ms=merge_ms_warm, peak_gib=peak, launches=counted,
                merged_equals_render=equal, card=card)
            if not equal:
                raise RuntimeError(f'the sharded render at waves={waves} '
                                   'differs from wavefront.render')
            if not launched_once_a_trace(counted, warmup + timed):
                raise RuntimeError(f'the sharded render launched {counted}')
            launched += counted['inst_trace']
    finally:
        dist.destroy_process_group()
    t0 = time.perf_counter()
    report = parallel.dryrun_multichip(torch.cuda.device_count())
    log('dryrun_multichip', seconds=time.perf_counter() - t0, **report)
    if not report['ok']:
        raise RuntimeError('dryrun_multichip failed')
    return launched


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
        SceneLayout, intersect_analytic, make_hit, trace)
    from path_tracer_tpu_torch.scene import bvh8
    from path_tracer_tpu_torch.scene import compile as scene_compile
    from path_tracer_tpu_torch.scene import model, procedural
    from path_tracer_tpu_torch.utils import profiling
    # The scene and the mode switch that the tests of both packages share.
    from test_torch_cuda import flat_mode, two_instance_scene

    compile_scene = scene_compile.compile_scene
    make_viking_hall_scene = procedural.make_viking_hall_scene
    reset_launches = profiling.reset

    def launches():
        counted = profiling.counters()
        return {name: counted.get('kernel.' + name, 0)
                for name in ('inst_trace', 'wide_trace5', 'wide_trace',
                             'hit_attributes')}

    dev = torch.device(DEVICE)
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    log('card', nvidia_smi=card, torch=torch.__version__,
        cuda=torch.version.cuda, devices=torch.cuda.device_count())
    started = time.perf_counter()
    lap = phase_clock()

    # -- 2. build -------------------------------------------------------
    ptxas = start_ptxas(build.CSRC, build.NVCC_FLAGS, build.BUILD_DIR)
    t0 = time.perf_counter()
    build.load()
    log('build', seconds=time.perf_counter() - t0, ninja=shutil.which('ninja'),
        sources=sorted(os.listdir(build.CSRC)))
    ptxas_records = read_ptxas(ptxas)
    lap('build')

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
    lap('compile')
    config = wavefront.RenderConfig(width=WIDTH, height=HEIGHT)

    # -- 4. each kernel against its plain version -------------------------
    state = wavefront.reset(packed, config, seed=0)
    ray_sets = {'primary': (state['origin'].clone(), state['direction'].clone())}
    wavefront.render_rounds(packed, layout, config, state, 0.05, rounds=2)
    ray_sets['bounce'] = (state['origin'].clone(), state['direction'].clone())
    del state
    n_rays = WIDTH * HEIGHT
    gen = torch.Generator().manual_seed(0)
    subset = torch.randperm(n_rays, generator=gen)[:SUBSET].to(dev)

    # The table sets of the three kernels: (kernel name, leaf format, the
    # tables the kernel reads, result rows written, operations a triangle,
    # kernel, plain version); the plain version with cull=False is the
    # pop cull's reference.
    def table_sets(fmt):
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

    records = {}        # kernel name -> fields of the "kernels" line
    for set_name, (o, d) in ray_sets.items():
        t_in = intersect_analytic(packed, layout, o, d,
                                  make_hit(n_rays, HIT_TIME_LIMIT, dev))['time']
        rays = (o, d, t_in)
        sub_rays = tuple(x[..., subset].contiguous() for x in rays)
        for fmt in LEAF_FMTS:
            for (name, leaf_fmt, tables, out_words, ops_tri, kernel,
                 plain) in table_sets(fmt):
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
                sub_out = [x[..., subset] for x in out]
                err, agree = compare(name, label, sub_out, plain(*sub_rays))
                rec = records.setdefault(name, dict(max_abs_err=0.0,
                                                    agreement=1.0))
                main_fmt = fmt == bvh8.LEAF_FMT
                pop_cull(sub_out, plain(*sub_rays, cull=False), name,
                         set_name, leaf_fmt)
                ms = cuda_ms(lambda: kernel(*rays))
                ms_cold = cuda_ms(lambda: kernel(*rays), flush=flush)
                n_hit = int((out[1] >= 0).sum())
                bound_ms, bound_by, bound_bytes, ops = kernel_bound(
                    counts, n_rays, nbytes(*tables), out_words, ops_tri,
                    OPS_LERP_V3 * n_hit if name == 'wide_trace' else 0)
                per_ray = [c.float().mean().item() for c in counts]
                log('kernel', kernel=name, set=set_name, leaf_fmt=leaf_fmt,
                    rays=n_rays, ms=ms, ms_cold=ms_cold,
                    mrays_s=n_rays / ms / 1e3,
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
                    # What each kernel measures of itself.
                    log('kernel_anatomy', kernel=name, set=set_name,
                        rays=n_rays, **kernel(*rays, anatomy=True)[-1])
                if set_name == 'bounce' and main_fmt:
                    # The main path's steady state: time the plain version
                    # on the same 2,073,600 rays, once, and check all of them.
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    plain_full = plain(*rays)
                    torch.cuda.synchronize()
                    plain_ms = 1e3 * (time.perf_counter() - t0)
                    err, agree = compare(name, label + '/all', out, plain_full)
                    rec.update(ms=ms, ms_cold=ms_cold, plain_ms=plain_ms,
                               bound_ms=bound_ms, bound_by=bound_by,
                               max_abs_err=max(rec['max_abs_err'], err),
                               agreement=min(rec['agreement'], agree))
                    log('plain', kernel=name, set=set_name, leaf_fmt=leaf_fmt,
                        rays=n_rays, ms=plain_ms)
                    del plain_full
                del out, counts
        if set_name == 'bounce':
            bounce_rays = rays
    lap('kernels')

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
    lap('cross_check')

    # -- 6, 7. the two paths end to end -------------------------------------
    mrays = {}      # packet mode -> Mrays/s of its render

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
        if not launched_once_a_trace(counted, rounds, kernel_name):
            raise RuntimeError(f"the '{mode}' render launched {counted} in "
                               f'{rounds} rounds')
        accum = state['accum']
        if not (bool(torch.isfinite(accum['xyz']).all())
                and float(accum['count'].sum()) > 0):
            raise RuntimeError('the accumulator is not finite or holds no sample')
        image = resolve(accum, WIDTH, HEIGHT, lane=state['lane'])
        if tuple(image.shape) != (HEIGHT, WIDTH, 3) or not bool(
                torch.isfinite(image).all()):
            raise RuntimeError(f'bad image {tuple(image.shape)}')
        round_ms = 1e3 * elapsed / TIMED_ROUNDS
        # `trace` alone on the rays of this state.
        trace_ms = cuda_ms(lambda: trace(pk, lay, state['origin'],
                                         state['direction']))
        mrays[mode] = n_rays * TIMED_ROUNDS / elapsed / 1e6
        log('render', packet_mode=mode, width=WIDTH, height=HEIGHT,
            rounds=TIMED_ROUNDS, seconds=elapsed,
            mrays_s=n_rays * TIMED_ROUNDS / elapsed / 1e6, round_ms=round_ms,
            trace_ms=trace_ms,
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
    lap('render_inst')
    state = render_path('flat', flat, flat_layout, 'wide_trace5')
    lap('render_flat')

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
    lap('portable')

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
    lap('golden_viking')

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
    lap('metal')

    # -- 11. bench config 5 at 3840x2160: media and nested dielectrics -------
    del packs, flats, packed, flat, bounce_rays, flush, flush_buffer
    torch.cuda.empty_cache()
    records['inst_trace']['launches_media_render'] = media_render(
        dev, card, launches, reset_launches, MEDIA_WIDTH, MEDIA_HEIGHT)
    lap('media_render')

    # -- 12. golden frames of bench configs 1, 2, 4 and 5 --------------------
    bench_goldens(dev, repo, flat_mode, launches, reset_launches)
    lap('bench_goldens')

    # -- 13. the OpenPBR scene, card against CPU ------------------------------
    openpbr_card_vs_cpu(dev)
    lap('openpbr')

    # -- 13b. the OpenPBR walk kernel on the Cornell box's 2880x2880 lanes ----
    records['openpbr_walk'] = openpbr_walk_phase(dev, card, ptxas_records)
    torch.cuda.empty_cache()
    lap('openpbr_walk')

    # -- 13c. the analytic-shape kernel on the one_weekend_final scene --------
    records['shape_trace'] = shape_trace_phase(dev, card, ptxas_records)
    torch.cuda.empty_cache()
    lap('shape_trace')

    # -- 13d. the hit-attribute kernel on two benchmark cells' lanes --------
    records['hit_attributes'] = hit_attributes_phase(dev, card, ptxas_records)
    torch.cuda.empty_cache()
    lap('hit_attributes')

    # -- 13e. the medium-event kernel on two benchmark cells' lanes ----------
    records['medium_event'] = medium_event_phase(dev, card, ptxas_records)
    torch.cuda.empty_cache()
    lap('medium_event')

    # -- 13f. the basic-sample kernel on three benchmark cells' lanes --------
    records['basic_sample'] = basic_sample_phase(dev, card, ptxas_records)
    torch.cuda.empty_cache()
    lap('basic_sample')

    # -- 13g. the scatter-tail kernel on two benchmark cells' lanes ----------
    records['scatter_tail'] = scatter_tail_phase(dev, card, ptxas_records)
    torch.cuda.empty_cache()
    lap('scatter_tail')

    # -- 14-17. bench config 6 at 1920x1080 with 1 and 4 waves ----------------
    torch.cuda.empty_cache()
    terrain, terrain_layout, inst_bytes = terrain_compile(dev, WIDTH, HEIGHT)
    lap('terrain_compile')
    state, waves1 = terrain_render(dev, card, terrain, terrain_layout,
                                   launches, reset_launches, WIDTH, HEIGHT,
                                   waves=1)
    flush_buffer = torch.empty(96 * 2**20, dtype=torch.float32, device=dev)
    config6 = terrain_kernel(terrain, terrain_layout, state, inst_bytes,
                             SUBSET, flush_buffer.zero_)
    del state, flush_buffer
    lap('terrain_waves1_and_kernel')
    state, waves4 = terrain_render(dev, card, terrain, terrain_layout,
                                   launches, reset_launches, WIDTH, HEIGHT,
                                   waves=4)
    resolve_determinism(state, WIDTH, HEIGHT)
    del state
    lap('terrain_waves4')
    terrain_golden(dev, repo, terrain, terrain_layout, launches, reset_launches)
    del terrain
    torch.cuda.empty_cache()
    lap('terrain_golden')
    records['inst_trace']['config6'] = dict(
        ms=config6['ms'], ms_cold=config6['ms_cold'],
        bound_ms=config6['bound_ms'], bound_by=config6['bound_by'],
        max_abs_err=config6['max_abs_err'], launches_waves1=waves1,
        launches_waves4=waves4)

    # -- 18. checkpoint and recovery at 1920x1080 -----------------------------
    checkpoint_phase(dev, repo, WIDTH, HEIGHT)
    lap('checkpoint')

    # -- 19. the CLI in subprocesses on the card ------------------------------
    cli_phase(repo)
    lap('cli')

    # -- 20. the interactive Session, preview and picking ---------------------
    records['inst_trace']['launches_session_frames'] = session_phase(
        dev, card, launches, reset_launches, SESSION_WIDTH, SESSION_HEIGHT)
    lap('session')

    # -- 21. the HTTP viewer over a Session -----------------------------------
    records['inst_trace']['launches_viewer_polls'] = viewer_phase(
        dev, card, launches, reset_launches, SESSION_WIDTH, SESSION_HEIGHT)
    lap('viewer')

    # -- 22. the CLI's spectrum, bvhdump and view ------------------------------
    cli_tools_phase(dev, repo)
    lap('cli_tools')

    # -- 23. the sharded render at world size 1 over NCCL ----------------------
    records['inst_trace']['launches_sharded'] = sharded_phase(
        dev, card, launches, reset_launches, WIDTH, HEIGHT, mrays['inst'])
    lap('sharded')
    log('total', seconds=time.perf_counter() - started)

    print(card)
    sources = dict(
        inst_trace=('trace_inst.cu', 'path_tracer_tpu/ops/trace_inst.py:149'),
        wide_trace5=('trace_packet.cu', 'path_tracer_tpu/ops/trace_packet.py:85'),
        wide_trace=('trace_wide.cu', 'path_tracer_tpu/ops/trace_wide.py:97'),
        openpbr_walk=('openpbr_walk.cu', None),
        shape_trace=('shape_trace.cu', None),
        hit_attributes=('hit_attributes.cu', None),
        medium_event=('medium_event.cu', None),
        basic_sample=('basic_sample.cu', None),
        scatter_tail=('scatter_tail.cu', None))
    print(json.dumps({'kernels': [dict(
        name=name, route='cuda',
        source='path_tracer_tpu_torch/csrc/' + sources[name][0],
        replaces=sources[name][1], library_ms=None, **records[name])
        for name in sources]}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': kind,
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
