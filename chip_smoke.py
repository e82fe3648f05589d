"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py        (from the repository root)

Drives path_tracer_tpu_torch's main path on the card and holds its hand-
written kernel against the kernel's plain PyTorch version:

  1. the card's name and power limit (nvidia-smi);
  2. builds every CUDA kernel from path_tracer_tpu_torch/csrc/ (one
     torch.utils.cpp_extension.load call, nvcc for sm_90a);
  3. compiles the textured viking hall (detail=1) for 1920x1080;
  4. inst_trace, the instanced BVH8 traversal kernel, against its plain
     version on the 2,073,600 primary rays of `reset` and on the rays
     after 2 rounds, for both leaf formats, bit for bit (the two take
     the same per-ray traversal order); kernel time (CUDA events,
     median of 7), plain time, and the kernel's bound from its counted
     pops and rows;
  5. the main path end to end: `render` at 1920x1080, 6 warm-up and 24
     timed rounds, Mrays/s; the kernel's launch count must equal the
     rounds run; then the time of `trace` alone, with and without the
     ray sort, and, from a profile of 4 more rounds, the device time by
     kernel;
  6. the 192x108, 24-round, seed-123 viking frame through `render_scene`
     against data/bench_goldens/3_viking_hall.npz within bench.py's
     Monte-Carlo bands.

Every phase prints one line; any failure raises and exits non-zero. The
last three lines are the card's name and power limit, the
{"kernels": [...]} record and {"ok": true, "device": {...}}. Without a
CUDA device it exits 1 and prints no result.
"""

import json
import os
import shutil
import statistics
import subprocess
import sys
import time

DEVICE = 'cuda'
WIDTH, HEIGHT = 1920, 1080
WARMUP_ROUNDS, TIMED_ROUNDS = 6, 24
SUBSET = 65536          # rays the plain version checks per ray set
TIMING_REPS = 7
# H100 SXM peaks: HBM bytes/s (NVIDIA data sheet) and float32 instructions/s
# outside the tensor cores, 132 SMs x 128 lanes x 1.98 GHz. The data sheet's
# 67e12 counts a fused multiply-add as two; the kernel is built with
# -fmad=false, so each operation counted below is one instruction.
PEAK_BYTES_S = 3.35e12
PEAK_F32_S = 33.5e12
# float32 operations per unit of traversal work, counted from
# csrc/trace_inst.cu (add, mul, min/max, compare and divide count one):
# a ray's setup (3 safe reciprocals, 3 products, octant), an instance
# entry (3x4 transform, reciprocals, products), an interior pop (8
# children x 6 slab planes x (mul, sub), 6 min/max, 4 min/max, 4
# compares) and one triangle of a leaf row in each format.
OPS_RAY = 15
OPS_ENTER = 36
OPS_INTERIOR = 8 * (12 + 6 + 4 + 4)
OPS_TRIANGLE = {'bary': 36, 'mt': 55}


def log(phase, **fields):
    print(json.dumps(dict(phase=phase, **fields)), flush=True)


def card_line():
    out = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'],
        check=True, capture_output=True, text=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def cuda_ms(fn, reps=TIMING_REPS):
    """Median milliseconds of fn() over `reps` runs after one warm-up,
    each bracketed by CUDA events on the current stream."""
    import torch
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def compare(name, kernel_out, plain_out):
    """Hold the kernel's (t, face, fu, fv, inst) to the plain version's
    bit for bit on every ray: both take each ray's own traversal order
    and round every operation alike (the kernel is built with
    -fmad=false), so tolerance zero. Returns (largest |difference| of t,
    fu and fv, face agreement)."""
    import torch
    same = [torch.equal(k, p) for k, p in zip(kernel_out, plain_out)]
    agree = (kernel_out[1] == plain_out[1]).float().mean().item()
    max_err = max((kernel_out[j] - plain_out[j]).abs().max().item()
                  for j in (0, 2, 3))
    log('compare', set=name, rays=int(plain_out[1].numel()),
        hit_rays=int((plain_out[1] >= 0).sum()), face_agreement=agree,
        max_abs_err=max_err, equal_t_face_fu_fv_inst=same)
    if not (all(same) and bool((plain_out[1] >= 0).any())):
        raise RuntimeError(f'inst_trace kernel disagrees with its plain '
                           f'version on {name}')
    return max_err, agree


def kernel_bound(fmt, counts, n_rays, table_bytes):
    """Least time the card could take for this traversal: the larger of
    the compulsory bytes (tables and rays read once, results written
    once) over HBM bandwidth and the counted float32 operations over the
    float32 peak. Returns (bound_ms, bound_by, bytes, ops)."""
    interior, _leaf, rows, enter = (int(c.sum()) for c in counts)
    ops = (n_rays * OPS_RAY + enter * OPS_ENTER + interior * OPS_INTERIOR
           + rows * 8 * OPS_TRIANGLE[fmt])
    nbytes = table_bytes + n_rays * (7 + 5) * 4
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


def main():
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device; nothing was run', file=sys.stderr)
        return 1
    repo = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, repo)
    from path_tracer_tpu_torch import render_scene
    from path_tracer_tpu_torch.core.constants import HIT_TIME_LIMIT
    from path_tracer_tpu_torch.integrator import wavefront
    from path_tracer_tpu_torch.integrator.resolve import resolve
    from path_tracer_tpu_torch.ops import build, trace_inst
    from path_tracer_tpu_torch.ops.intersect import (
        SceneLayout, intersect_analytic, make_hit, ray_sort_key, trace)
    from path_tracer_tpu_torch.scene import bvh8
    from path_tracer_tpu_torch.scene.compile import compile_scene
    from path_tracer_tpu_torch.scene.procedural import make_viking_hall_scene

    dev = torch.device(DEVICE)
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    log('card', nvidia_smi=card, torch=torch.__version__,
        cuda=torch.version.cuda, devices=torch.cuda.device_count())

    # -- 2. build -------------------------------------------------------
    t0 = time.perf_counter()
    build.load()
    log('build', seconds=time.perf_counter() - t0, ninja=shutil.which('ninja'),
        sources=sorted(os.listdir(build.CSRC)))

    # -- 3. compile the flagship scene, both leaf formats ---------------
    packs = {}
    for fmt in ('bary', 'mt'):
        saved = bvh8.LEAF_FMT
        bvh8.LEAF_FMT = fmt
        try:
            t0 = time.perf_counter()
            scene = make_viking_hall_scene(detail=1)
            packed = compile_scene(scene, aspect_ratio=WIDTH / HEIGHT,
                                   device=dev)
        finally:
            bvh8.LEAF_FMT = saved
        layout = SceneLayout.from_packed(packed)
        tables = (packed.inst_nodes, packed.inst_tris, packed.inst_rows)
        table_bytes = sum(x.numel() * x.element_size() for x in tables)
        packs[fmt] = (packed, layout, table_bytes)
        log('compile', leaf_fmt=fmt, seconds=time.perf_counter() - t0,
            triangles=sum(len(m.faces) for m in scene.meshes),
            node_rows=int(packed.inst_nodes.shape[0]),
            leaf_rows=int(packed.inst_tris.shape[0]),
            tlas_rows=layout.tlas_rows, table_bytes=table_bytes,
            packet_mode=layout.packet_mode, atlas=layout.atlas_quad_fit)
    packed, layout, table_bytes = packs[bvh8.LEAF_FMT]
    config = wavefront.RenderConfig(width=WIDTH, height=HEIGHT)

    # -- 4. kernel against its plain version ------------------------------
    state = wavefront.reset(packed, config, seed=0)
    ray_sets = {'primary': (state['origin'].clone(), state['direction'].clone())}
    wavefront.render_rounds(packed, layout, config, state, 0.05, rounds=2,
                            sort_each_round=True)
    ray_sets['bounce'] = (state['origin'].clone(), state['direction'].clone())
    n_rays = WIDTH * HEIGHT
    gen = torch.Generator().manual_seed(0)
    subset = torch.randperm(n_rays, generator=gen)[:SUBSET].to(dev)

    max_err, agreement, record = 0.0, 1.0, {}
    for set_name, (o, d) in ray_sets.items():
        t_in = intersect_analytic(packed, layout, o, d,
                                  make_hit(n_rays, HIT_TIME_LIMIT, dev))['time']
        unsorted_ms = cuda_ms(lambda: trace_inst.inst_trace(
            packed.inst_nodes, packed.inst_tris, packed.inst_rows, o, d, t_in,
            layout.tlas_rows))
        log('kernel_unsorted', set=set_name, leaf_fmt=bvh8.LEAF_FMT,
            rays=n_rays, ms=unsorted_ms)
        # The main path feeds the kernel rays in ray_sort_key order.
        perm = torch.argsort(ray_sort_key(packed, o, d), stable=True)
        o, d, t_in = (o[:, perm].contiguous(), d[:, perm].contiguous(),
                      t_in[perm].contiguous())
        so, sd, st = (o[:, subset].contiguous(), d[:, subset].contiguous(),
                      t_in[subset].contiguous())
        for fmt, (pk, lay, tb) in packs.items():
            args = (pk.inst_nodes, pk.inst_tris, pk.inst_rows)
            out = trace_inst.inst_trace(*args, o, d, t_in, lay.tlas_rows,
                                        leaf_fmt=fmt, stats=True)
            torch.cuda.synchronize()
            counts = out[5]
            plain = trace_inst.inst_trace_plain(*args, so, sd, st,
                                                lay.tlas_rows, leaf_fmt=fmt)
            err, agree = compare(f'{set_name}/{fmt}',
                                 [x[subset] for x in out[:5]], plain)
            max_err, agreement = max(max_err, err), min(agreement, agree)
            ms = cuda_ms(lambda: trace_inst.inst_trace(
                *args, o, d, t_in, lay.tlas_rows, leaf_fmt=fmt))
            bound_ms, bound_by, nbytes, ops = kernel_bound(fmt, counts,
                                                           n_rays, tb)
            per_ray = [c.float().mean().item() for c in counts]
            log('kernel', set=set_name, leaf_fmt=fmt, rays=n_rays, ms=ms,
                mrays_s=n_rays / ms / 1e3, bound_ms=bound_ms,
                bound_by=bound_by, compulsory_bytes=nbytes, f32_ops=ops,
                per_ray_interior_pops=per_ray[0], per_ray_leaf_pops=per_ray[1],
                per_ray_leaf_rows=per_ray[2], per_ray_instance_entries=per_ray[3],
                row_bytes_popped=512 * int(counts[0].sum() + counts[2].sum()),
                hit_fraction=(out[1] >= 0).float().mean().item())
            if set_name == 'bounce' and fmt == bvh8.LEAF_FMT:
                # The main path's steady state: time the plain version on
                # the same 2,073,600 rays, once, and check all of them.
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                plain_full = trace_inst.inst_trace_plain(
                    *args, o, d, t_in, lay.tlas_rows, leaf_fmt=fmt)
                torch.cuda.synchronize()
                plain_ms = 1e3 * (time.perf_counter() - t0)
                err, agree = compare(f'{set_name}/{fmt}/all', out[:5], plain_full)
                max_err, agreement = max(max_err, err), min(agreement, agree)
                record = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                              bound_by=bound_by)
                log('plain', set=set_name, leaf_fmt=fmt, rays=n_rays,
                    ms=plain_ms)
    del state, ray_sets

    # -- 5. main path end to end ------------------------------------------
    trace_inst.reset_launches()
    state = wavefront.render(packed, config, WARMUP_ROUNDS, seed=1,
                             layout=layout)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state = wavefront.render(packed, config, TIMED_ROUNDS, layout=layout,
                             state=state)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = trace_inst.launches
    rounds = WARMUP_ROUNDS + TIMED_ROUNDS
    if launches != rounds:
        raise RuntimeError(f'inst_trace launched {launches} times in '
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
    trace_ms, trace_unsorted_ms = (
        cuda_ms(lambda: trace(packed, layout, state['origin'],
                              state['direction'], sort_rays=sort_rays))
        for sort_rays in (True, False))
    log('render', width=WIDTH, height=HEIGHT, rounds=TIMED_ROUNDS,
        seconds=elapsed, mrays_s=n_rays * TIMED_ROUNDS / elapsed / 1e6,
        round_ms=round_ms, trace_ms=trace_ms,
        trace_unsorted_ms=trace_unsorted_ms,
        samples=float(accum['count'].sum()), launches=launches,
        image_mean=float(image.mean()),
        peak_gib=torch.cuda.max_memory_allocated() / 2**30, card=card)

    # Where a round's device time goes: kernels by name over 4 rounds.
    busy_ms, by_name, n_kernels = device_profile(lambda: wavefront.render(
        packed, config, 4, layout=layout, state=state))
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    log('profile', rounds=4, device_busy_ms_per_round=busy_ms / 4,
        kernels_per_round=n_kernels / 4,
        idle_share_vs_unprofiled_round=1.0 - busy_ms / 4 / round_ms,
        inst_trace_ms_per_round=sum(v for k, v in by_name.items()
                                    if 'inst_trace' in k) / 4,
        top_kernels_ms_per_round=[[k, v / 4, v / busy_ms] for k, v in top])

    # -- 6. golden frame ------------------------------------------------------
    golden = np.load(os.path.join(repo, 'data', 'bench_goldens',
                                  '3_viking_hall.npz'))
    img = render_scene(make_viking_hall_scene(detail=1), 192, 108,
                       spp_rounds=24, seed=123, device=dev).cpu().numpy()
    ref = golden['image']
    noise, bias_floor = float(golden['noise']), float(golden['bias'])
    rel = float(np.abs(img - ref).mean() / (ref.mean() + 1e-3))
    bias = float(abs(img.mean() - ref.mean()) / (ref.mean() + 1e-3))
    rel_lim, bias_lim = max(1.6 * noise, 0.02), max(4.0 * bias_floor, 0.02)
    log('golden', name='3_viking_hall', rel_err=rel, rel_limit=rel_lim,
        bias=bias, bias_limit=bias_lim)
    if img.shape != ref.shape or not (rel < rel_lim and bias < bias_lim):
        raise RuntimeError('the viking golden frame is outside its bands')

    print(card)
    print(json.dumps({'kernels': [dict(
        name='inst_trace', route='cuda',
        source='path_tracer_tpu_torch/csrc/trace_inst.cu',
        replaces='path_tracer_tpu/ops/trace_inst.py:149',
        launches=launches, max_abs_err=max_err, agreement=agreement,
        library_ms=None, **record)]}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': kind,
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
