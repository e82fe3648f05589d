"""Time variants of the traversal kernels against one another on one card.

    python3 -m path_tracer_tpu_torch.tools.kernel_lab [--spec NAME] [--out FILE]

The tool behind the A/B numbers of PERF.md. It compiles the textured
viking hall for 1920x1080 in 'inst' and in 'flat' mode, takes the primary
rays and the rays after two rounds, each in ray_sort_key order and in lane
order, and times every variant of the spec's kernels (`inst_trace` and
`wide_trace5`, or `wide_trace`) on each of the four ray sets in turns (v1
v2 .. vn, then vn .. v1, and so on: two runs on two cards, or minutes apart
on one, differ by more than most changes, so variants are compared only
within one call). Each launch is
timed alone with CUDA events, warm (launches back to back, the tables in
L2) and cold (a buffer larger than L2 written before each launch). Every
variant's (t, face) is held against the first variant's, and the anatomy
counters of csrc/traverse.cuh are read once per variant and ray set.

A variant is a copy of path_tracer_tpu_torch/csrc/ with textual edits,
built and loaded as the committed sources are (ops/build.py::load, under
the variant's name, in build/lab/), the variants building side by side. A
variant is a dict: `name`; `family` 'new' (csrc/trace_inst.cu,
trace_packet.cu and trace_wide.cu, the default) or 'simple' (the
*_simple.cu baselines); `set` {file: {NAME: value}} rewrites `constexpr T
NAME = ...;` lines; `sub` is a list of [file, regular expression,
replacement], each of which must match. --spec names one of the specs
below: for `inst_trace` and `wide_trace5`, `step0` (the default), the
ablations of the simple kernels that say what binds them, or `design`,
the kernels without each of their design decisions in turn; for
`wide_trace`, `v3step0`, the same ablations of its simple kernel (the
edits apply to every simple kernel; the spec times only this one), or
`v3design`, each design step of csrc/trace_wide.cu against the kernel
without it, the sweep of its blocks an SM and the leaf test spread over
the warp against the one a lane runs alone.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import json
import os
import re
import shutil
import sys
import time

import torch

_HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(os.path.dirname(_HERE))

_SIMPLE = ('trace_inst_simple.cu', 'trace_packet_simple.cu',
           'trace_wide_simple.cu')
_KERNELS = ('trace_inst.cu', 'trace_packet.cu', 'trace_wide.cu')
_ORDER = ('inst_trace', 'wide_trace5', 'wide_trace')  # as in the two above
_V3 = 'trace_wide.cu'


# The table rows read with ld.global.ca instead of ld.global.nc.
_LDCA = ['traverse.cuh',
         r'return __ldg\(reinterpret_cast<const float4\*>\(p\)\);',
         'return __ldca(reinterpret_cast<const float4*>(p));']


def _simple(name, *subs):
    return dict(name=name, family='simple',
                sub=[[f, *s] for f in _SIMPLE for s in subs])


def _design(name, **consts):
    return dict(name=name, set={f: dict(consts) for f in _KERNELS})


def _v3(name, *subs, **consts):
    """A variant of csrc/trace_wide.cu alone: constants and substitutions."""
    return dict(name=name, set={_V3: consts},
                sub=[[_V3, *s] for s in subs])


# Steps of the v3 design, each undone in the kernel whose leaf test a lane
# runs alone: every slot of a leaf row tested, the leaf tested inside the
# loop that pops, the attributes lerped each time a slot wins.
_ALL_SLOTS = [r'k < filled;', 'k < TRIS_PER_ROW;']
_ONE_LOOP = [r'pending = v;\s*break;', 'test_leaf(v);']
_LERP_EACH_WIN = [
    [r'fv = hv;', 'fv = hv; lerp_attributes(tris, face, fu, fv, nx, ny, nz, '
                  'tu, tv, shape);'],
    [r'if \(face >= 0\) lerp_attributes\(', 'if (false) lerp_attributes(']]


# The ablations of step 0: what binds the simple kernels.
_STEP0 = [
    dict(name='simple', family='simple'),
    _simple('simple_lb8', [r'__launch_bounds__\(128\)',
                           '__launch_bounds__(128, 8)']),
    _simple('simple_block64',
            [r'__launch_bounds__\(128\)', '__launch_bounds__(64)'],
            [r'const int block = 128;', 'const int block = 64;']),
    _simple('simple_block256',
            [r'__launch_bounds__\(128\)', '__launch_bounds__(256)'],
            [r'const int block = 128;', 'const int block = 256;']),
    _simple('simple_noleaf', [r'\+\+n_leaf;', '++n_leaf; continue;']),
    dict(name='simple_ldca', family='simple', sub=[_LDCA]),
    dict(name='new'),
]

SPECS = dict(
    step0=dict(reps=9, kernels=('inst_trace', 'wide_trace5'), variants=_STEP0),
    design=dict(reps=11, kernels=('inst_trace', 'wide_trace5'), variants=[
        dict(name='simple', family='simple'),
        dict(name='new'),
        _design('no_cull', CULL_POPS='false'),
        dict(name='leaf_unroll2', sub=[[f, '#pragma unroll 1', '#pragma unroll 2']
                                       for f in _KERNELS]),
        _design('min_blocks_4', MIN_BLOCKS=4),
        _design('min_blocks_6', MIN_BLOCKS=6),
        _design('min_blocks_8', MIN_BLOCKS=8),
        _design('min_blocks_10', MIN_BLOCKS=10),
        dict(name='block_64', set={'trace_inst.cu': dict(BLOCK=64, MIN_BLOCKS=14),
                                   'trace_packet.cu': dict(BLOCK=64, MIN_BLOCKS=18)}),
        dict(name='ldca', sub=[_LDCA]),
    ]),
    v3step0=dict(reps=9, kernels=('wide_trace',), variants=_STEP0),
    v3design=dict(reps=11, kernels=('wide_trace',), variants=[
        dict(name='simple', family='simple'),
        dict(name='new'),
        _v3('new_twin'),            # the same source: the spread in one call
        _v3('lane_leaf_min7', WARP_LEAF='false', MIN_BLOCKS=7),
        _v3('lane_leaf_min8', WARP_LEAF='false', MIN_BLOCKS=8),
        _v3('lane_leaf_min9', WARP_LEAF='false', MIN_BLOCKS=9),
        _v3('lane_leaf_min10', WARP_LEAF='false', MIN_BLOCKS=10),
        _v3('lane_leaf_all_slots', _ALL_SLOTS, WARP_LEAF='false'),
        _v3('lane_leaf_no_cull', WARP_LEAF='false', CULL_POPS='false'),
        _v3('lane_leaf_one_loop', _ONE_LOOP, WARP_LEAF='false'),
        _v3('lane_leaf_lerp_each_win', *_LERP_EACH_WIN, WARP_LEAF='false'),
        _v3('warp_leaf_min6', WARP_PASS_COST=0, MIN_BLOCKS=6),
        _v3('warp_leaf_min7', WARP_PASS_COST=0, MIN_BLOCKS=7),
        _v3('warp_leaf_min8', WARP_PASS_COST=0, MIN_BLOCKS=8),
        _v3('warp_leaf_min9', WARP_PASS_COST=0, MIN_BLOCKS=9),
        _v3('warp_leaf_cost2', WARP_PASS_COST=2, MIN_BLOCKS=8),
        _v3('warp_leaf_cost3', WARP_PASS_COST=3, MIN_BLOCKS=8),
        _v3('warp_leaf_cost2_min9', WARP_PASS_COST=2, MIN_BLOCKS=9),
        _v3('warp_leaf_cost4_min9', WARP_PASS_COST=4, MIN_BLOCKS=9),
    ]),
)


def prepare_sources(variant, out_dir):
    """Copy csrc/ to out_dir and apply the variant's edits."""
    from path_tracer_tpu_torch.ops import build
    shutil.rmtree(out_dir, ignore_errors=True)
    shutil.copytree(build.CSRC, out_dir)
    for name, consts in variant.get('set', {}).items():
        path = os.path.join(out_dir, name)
        text = open(path).read()
        for const, value in consts.items():
            text, count = re.subn(
                r'(constexpr\s+\w+\s+%s\s*=\s*)[^;]+;' % re.escape(const),
                lambda m: m.group(1) + str(value) + ';', text)
            if count != 1:
                raise RuntimeError(f'{variant["name"]}: {count} definitions '
                                   f'of {const} in {name}')
        open(path, 'w').write(text)
    for name, pattern, replacement in variant.get('sub', []):
        path = os.path.join(out_dir, name)
        text, count = re.subn(pattern, lambda m: replacement,
                              open(path).read())
        if count == 0:
            raise RuntimeError(f'{variant["name"]}: {pattern!r} matches '
                               f'nothing in {name}')
        open(path, 'w').write(text)


def build_variants(variants, root, kernels, workers=4):
    """({variant name: extension module}, the `ptxas` records of each
    variant's sources of the timed `kernels`), the variants built side by
    side."""
    from chip_smoke import read_ptxas, start_ptxas
    from path_tracer_tpu_torch.ops import build

    def one(variant):
        name = variant['name']
        src = os.path.join(root, name, 'src')
        prepare_sources(variant, src)
        files = _SIMPLE if variant.get('family') == 'simple' else _KERNELS
        ptxas = start_ptxas(
            src, build.NVCC_FLAGS, os.path.join(root, name, 'ptxas'),
            names=[files[_ORDER.index(k)] for k in kernels])
        ext = build.load(csrc=src, name=f'{build.NAME}_lab_{name}',
                         build_dir=os.path.join(root, name, 'obj'))
        return name, ext, read_ptxas(ptxas, fail_on_spill=False, variant=name)

    with concurrent.futures.ThreadPoolExecutor(workers) as pool:
        built = list(pool.map(one, variants))
    return ({name: ext for name, ext, _ in built},
            [rec for _, _, recs in built for rec in recs])


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--spec', default='step0', choices=sorted(SPECS))
    ap.add_argument('--out', default=os.path.join(REPO, 'build',
                                                  'kernel_lab.jsonl'))
    ap.add_argument('--width', type=int, default=1920)
    ap.add_argument('--height', type=int, default=1080)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print('kernel_lab: no CUDA device', file=sys.stderr)
        return 1
    sys.path[:0] = [REPO, os.path.join(REPO, 'tests')]
    spec = SPECS[args.spec]
    variants = spec['variants']
    reps = int(spec['reps'])

    from chip_smoke import card_line, log, time_in_turns
    from path_tracer_tpu_torch.core.constants import HIT_TIME_LIMIT
    from path_tracer_tpu_torch.integrator import wavefront
    from path_tracer_tpu_torch.ops import build, trace_inst
    from path_tracer_tpu_torch.ops.intersect import (
        SceneLayout, intersect_analytic, make_hit, ray_sort_key)
    from path_tracer_tpu_torch.scene import compile as scene_compile
    from path_tracer_tpu_torch.scene.procedural import make_viking_hall_scene
    from test_torch_cuda import flat_mode

    card = card_line()
    log('lab_card', nvidia_smi=card, torch=torch.__version__)
    t0 = time.perf_counter()
    exts, records = build_variants(
        variants, os.path.join(os.path.dirname(build.BUILD_DIR), 'lab'),
        spec['kernels'])
    build.load()        # the committed kernels, for the rays after two rounds
    records.append(dict(phase='lab_build', seconds=time.perf_counter() - t0,
                        variants=[v['name'] for v in variants]))
    log(**records[-1])

    dev = torch.device('cuda')
    scenes = {}
    for mode in ('inst', 'flat'):
        with (flat_mode(scene_compile) if mode == 'flat'
              else contextlib.nullcontext()):
            packed = scene_compile.compile_scene(
                make_viking_hall_scene(detail=1),
                aspect_ratio=args.width / args.height, device=dev)
        scenes[mode] = (packed, SceneLayout.from_packed(packed))
    packed, layout = scenes['inst']
    flat = scenes['flat'][0]
    config = wavefront.RenderConfig(width=args.width, height=args.height)
    state = wavefront.reset(packed, config, seed=0)
    lane_sets = {'primary': (state['origin'].clone(), state['direction'].clone())}
    wavefront.render_rounds(packed, layout, config, state, 0.05, rounds=2,
                            sort_each_round=True)
    lane_sets['bounce'] = (state['origin'].clone(), state['direction'].clone())
    del state
    n = args.width * args.height
    ray_sets = {}
    for name, (o, d) in lane_sets.items():
        t_in = intersect_analytic(packed, layout, o, d,
                                  make_hit(n, HIT_TIME_LIMIT, dev))['time']
        ray_sets[name + '/unsorted'] = (o, d, t_in)
        perm = torch.argsort(ray_sort_key(packed, o, d), stable=True)
        ray_sets[name + '/sorted'] = (o[:, perm].contiguous(),
                                      d[:, perm].contiguous(),
                                      t_in[perm].contiguous())

    tables = {'inst_trace': (packed.inst_nodes, packed.inst_tris,
                             packed.inst_rows),
              'wide_trace5': (flat.wide_nodes_g, flat.wide_tris_g),
              'wide_trace': (flat.wide_nodes, flat.wide_tris)}
    f32, i32 = torch.float32, torch.int32
    # (shape, dtype) of each kernel's outputs, and its per-ray pop counters.
    results = {'inst_trace': ([(n, f32), (n, i32), (n, f32), (n, f32),
                               (n, i32)], 5),
               'wide_trace5': ([(n, f32), (n, i32), (n, f32), (n, f32)], 4),
               'wide_trace': ([(n, f32), (n, i32), ((3, n), f32),
                               ((2, n), f32), (n, i32)], 4)}
    fmt = trace_inst.LEAF_FMTS['bary']
    stream = torch.cuda.current_stream(dev).cuda_stream
    flush_buffer = torch.empty(96 * 2 ** 20, dtype=torch.float32, device=dev)
    empty = torch.empty((0,), dtype=torch.int32, device=dev)

    def launch(variant, kernel, rays, outs, per_ray=empty, warps=empty):
        fn = getattr(exts[variant['name']], kernel + (
            '_simple' if variant.get('family') == 'simple' else ''))
        if kernel == 'inst_trace':
            err = fn(*tables[kernel], *rays, layout.tlas_rows, fmt, *outs,
                     per_ray, warps, stream)
        elif kernel == 'wide_trace5':
            err = fn(*tables[kernel], *rays, fmt, *outs, per_ray, warps, stream)
        else:       # the v3 rows hold plain positions: no leaf format
            err = fn(*tables[kernel], *rays, *outs, per_ray, warps, stream)
        if err:
            raise RuntimeError(f'{variant["name"]}/{kernel}: cudaError {err}')

    for kernel in spec['kernels']:
        kinds, rows = results[kernel]
        for set_name, rays in ray_sets.items():
            outs = {v['name']: [torch.empty(shape, dtype=k, device=dev)
                                for shape, k in kinds] for v in variants}
            calls = {v['name']: (lambda v=v: launch(v, kernel, rays,
                                                    outs[v['name']]))
                     for v in variants}
            warm = time_in_turns(calls, reps)
            cold = time_in_turns(calls, reps, flush=flush_buffer.zero_)
            torch.cuda.synchronize()
            first = outs[variants[0]['name']]
            for v in variants:
                got = outs[v['name']]
                per_ray, warps = trace_inst.stats_buffers(True, rows + 2, n, dev)
                counted = [torch.empty_like(x) for x in got]
                launch(v, kernel, rays, counted, per_ray, warps)
                torch.cuda.synchronize()
                rec = dict(
                    phase='lab', kernel=kernel, set=set_name, variant=v['name'],
                    ms=warm[v['name']], ms_cold=cold[v['name']],
                    t_differs=int((got[0] != first[0]).sum()),
                    face_differs=int((got[1] != first[1]).sum()),
                    outputs_differ=sum(int((a != b).sum())
                                       for a, b in zip(got, first)),
                    stats_launch_differs=sum(
                        int((a != b).sum()) for a, b in zip(counted, got)),
                    interior_pops_per_ray=per_ray[0].float().mean().item(),
                    leaf_pops_per_ray=per_ray[1].float().mean().item(),
                    leaf_rows_per_ray=per_ray[2].float().mean().item(),
                    triangles_per_ray=per_ray[rows - 1].float().mean().item(),
                    **trace_inst.anatomy_record(per_ray, warps, rows))
                records.append(rec)
                log(**rec)
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, 'w') as f:
        f.write(json.dumps(dict(card=card, spec=args.spec)) + '\n')
        for rec in records:
            f.write(json.dumps(rec) + '\n')
    log('lab_done', card=card, records=len(records))
    return 0


if __name__ == '__main__':
    sys.exit(main())
