"""How much slack the pop cull needs: a sweep over CULL_SLACK on one card.

    python3 -m path_tracer_tpu_torch.tools.cull_sweep [--out FILE]

The tool behind the cull slack of csrc/traverse.cuh and ops/trace_inst.py
(PERF.md). It makes the rays of chip_smoke.py's `pop_cull` phase --
the viking hall's 2,073,600 primary rays and the rays after two rounds at
1920x1080, in ray_sort_key order -- and, for bench config 6, the rays after
eight rounds, and runs the plain versions of the three kernels on the card
(bit-equal to the kernels) in every leaf format: once without the cull,
then with it at slack 1 (a cull without slack) and at 1 + 2^-k for
each k of KS. Each line counts the rays whose t or face differs from the
run without the cull; every ray that the slack-1 cull changes is written
out (origin, direction and t_in as float.hex) for a test to replay.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys

import torch

_HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(os.path.dirname(_HERE))
KS = (23, 22, 21, 20, 19, 18, 17, 16, 15, 14, 12, 10)
LEAF_FMTS = ('bary', 'mt', 'woop')


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--out', default=os.path.join(REPO, 'build',
                                                  'cull_sweep.json'))
    ap.add_argument('--width', type=int, default=1920)
    ap.add_argument('--height', type=int, default=1080)
    ap.add_argument('--side', type=int, default=900,
                    help='config 6 heightfield side (0 skips config 6)')
    ap.add_argument('--device', default='cuda')
    args = ap.parse_args(argv)
    sys.path[:0] = [REPO, os.path.join(REPO, 'tests')]
    from path_tracer_tpu_torch.core.constants import HIT_TIME_LIMIT
    from path_tracer_tpu_torch.integrator import wavefront
    from path_tracer_tpu_torch.ops import trace_inst, trace_packet, trace_wide
    from path_tracer_tpu_torch.ops.intersect import (
        SceneLayout, intersect_analytic, make_hit, ray_sort_key)
    from path_tracer_tpu_torch.scene import bvh8
    from path_tracer_tpu_torch.scene import compile as scene_compile
    from path_tracer_tpu_torch.scene.procedural import (
        make_terrain_scene, make_viking_hall_scene)
    from test_torch_cuda import flat_mode

    dev = torch.device(args.device)
    width, height = args.width, args.height
    config = wavefront.RenderConfig(width=width, height=height)
    out = dict(device=str(dev), width=width, height=height, results=[],
               lost=[])

    def set_slack(k):
        slack = 1.0 if k is None else 1.0 + 2.0 ** -k
        trace_inst.CULL_SLACK = trace_packet.CULL_SLACK = slack

    @contextlib.contextmanager
    def leaf_format(fmt):
        saved = bvh8.LEAF_FMT
        bvh8.LEAF_FMT = fmt
        try:
            yield
        finally:
            bvh8.LEAF_FMT = saved

    def ray_sets(packed, layout, rounds):
        state = wavefront.reset(packed, config, seed=0)
        sets = {'primary': (state['origin'].clone(),
                            state['direction'].clone())}
        wavefront.render_rounds(packed, layout, config, state, 0.05,
                                rounds=rounds, sort_each_round=True)
        sets['bounce'] = (state['origin'], state['direction'])
        n = width * height
        for name, (o, d) in sets.items():
            t_in = intersect_analytic(packed, layout, o, d, make_hit(
                n, HIT_TIME_LIMIT, dev))['time']
            perm = torch.argsort(ray_sort_key(packed, o, d), stable=True)
            sets[name] = (o[:, perm].contiguous(), d[:, perm].contiguous(),
                          t_in[perm].contiguous())
        return sets

    def sweep(scene, set_name, kernel, fmt, plain, rays):
        set_slack(None)
        full = plain(*rays, cull=False)
        for k in (None,) + KS:
            set_slack(k)
            culled = plain(*rays, cull=True)
            t_diff, face_diff = culled[0] != full[0], culled[1] != full[1]
            rec = dict(scene=scene, set=set_name, kernel=kernel, fmt=fmt,
                       slack_exponent=k, t_differs=int(t_diff.sum()),
                       face_differs=int(face_diff.sum()))
            out['results'].append(rec)
            print(json.dumps(rec), flush=True)
            if k is None:
                o, d, t_in = rays
                for i in torch.nonzero(t_diff | face_diff).flatten().tolist():
                    out['lost'].append(dict(
                        scene=scene, set=set_name, kernel=kernel, fmt=fmt,
                        origin=[float(x).hex() for x in o[:, i].tolist()],
                        direction=[float(x).hex() for x in d[:, i].tolist()],
                        t_in=float(t_in[i]).hex(),
                        t_cull=float(culled[0][i]), t_full=float(full[0][i]),
                        face_cull=int(culled[1][i]),
                        face_full=int(full[1][i])))
                    print(json.dumps(out['lost'][-1]), flush=True)
        set_slack(None)

    tables = {}
    for fmt in LEAF_FMTS:
        for mode in ('inst', 'flat'):
            with leaf_format(fmt), (flat_mode(scene_compile) if mode == 'flat'
                                    else contextlib.nullcontext()):
                tables[fmt, mode] = scene_compile.compile_scene(
                    make_viking_hall_scene(detail=1),
                    aspect_ratio=width / height, device=dev)
    packed = tables[bvh8.LEAF_FMT, 'inst']
    layout = SceneLayout.from_packed(packed)
    for set_name, rays in ray_sets(packed, layout, 2).items():
        for fmt in LEAF_FMTS:
            pk, fl = tables[fmt, 'inst'], tables[fmt, 'flat']
            tlas_rows = SceneLayout.from_packed(pk).tlas_rows
            sweep('3_viking_hall', set_name, 'inst_trace', fmt,
                  lambda *a, **kw: trace_inst.inst_trace_plain(
                      pk.inst_nodes, pk.inst_tris, pk.inst_rows, *a,
                      tlas_rows, leaf_fmt=fmt, **kw), rays)
            sweep('3_viking_hall', set_name, 'wide_trace5', fmt,
                  lambda *a, **kw: trace_packet.wide_trace5_plain(
                      fl.wide_nodes_g, fl.wide_tris_g, *a, leaf_fmt=fmt,
                      **kw), rays)
            if fmt == bvh8.LEAF_FMT:
                # The v3 rows hold plain positions: one format.
                sweep('3_viking_hall', set_name, 'wide_trace', 'mt',
                      lambda *a, **kw: trace_wide.wide_trace_plain(
                          fl.wide_nodes, fl.wide_tris, *a, **kw), rays)
    del tables, packed
    if args.side:
        terrain = scene_compile.compile_scene(
            make_terrain_scene(side=args.side), aspect_ratio=width / height,
            device=dev)
        layout = SceneLayout.from_packed(terrain)
        for set_name, rays in ray_sets(terrain, layout, 8).items():
            sweep('6_terrain_stream', set_name, 'inst_trace', bvh8.LEAF_FMT,
                  lambda *a, **kw: trace_inst.inst_trace_plain(
                      terrain.inst_nodes, terrain.inst_tris,
                      terrain.inst_rows, *a, layout.tlas_rows, **kw), rays)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, 'w') as f:
        json.dump(out, f, indent=1)
    return 0


if __name__ == '__main__':
    sys.exit(main())
