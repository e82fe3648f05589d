"""Command-line renderer and tools.

    python -m path_tracer_tpu_torch render scene.json out.png [options]
    python -m path_tracer_tpu_torch demo cornell out.png [options]
    python -m path_tracer_tpu_torch view [scene.json | --demo NAME] [--port P]
    python -m path_tracer_tpu_torch spectrum R G B [--png plot.png]
    python -m path_tracer_tpu_torch bvhdump [scene.json | --demo NAME]

Port of path_tracer_tpu/__main__.py, every command with the same options
plus `--device {cuda,cpu}` (default cuda: the card; the JAX package
picks its platform through JAX_PLATFORMS instead). `view` serves the
interactive editor of viewer/server.py over an app.Session (the
built-in default scene when neither a scene file nor a demo is given);
`spectrum` and `bvhdump` print what utils/debug.py computes.
"""

from __future__ import annotations

import argparse
import sys
import time

DEMOS = ('cornell', 'spheres', 'viking', 'pano', 'multi')


def _demo_scene(name):
    from .scene import procedural

    return {
        'cornell': procedural.make_cornell_scene,
        'spheres': procedural.make_sphere_array_scene,
        'viking': procedural.make_viking_hall_scene,
        'pano': procedural.make_360_scene,
        'multi': procedural.make_multi_mesh_scene,
    }[name]()


def main(argv=None):
    parser = argparse.ArgumentParser(prog='path_tracer_tpu_torch')
    sub = parser.add_subparsers(dest='command', required=True)

    def add_render_args(p):
        p.add_argument('output', help='output PNG path')
        p.add_argument('--width', type=int, default=1280)
        p.add_argument('--height', type=int, default=720)
        p.add_argument('--rounds', type=int, default=128,
                       help='wavefront rounds (approx spp * mean path length)')
        p.add_argument('--seed', type=int, default=0)
        p.add_argument('--tonemap', choices=['clamp', 'reinhard', 'hable', 'aces'],
                       default='aces')
        p.add_argument('--brightness', type=float, default=1.0)
        p.add_argument('--camera', type=int, default=0)
        p.add_argument('--checkpoint', default=None, metavar='NPZ',
                       help='checkpoint path: save progress periodically '
                            'and recover from device failures')
        p.add_argument('--checkpoint-every', type=int, default=64,
                       help='rounds between checkpoints')
        p.add_argument('--resume', action='store_true',
                       help='resume from --checkpoint if it exists')
        p.add_argument('--device', choices=['cuda', 'cpu'], default='cuda',
                       help='render on the card (default) or on the CPU')

    p_render = sub.add_parser('render', help='render a scene JSON file')
    p_render.add_argument('scene', help='scene .json (reference-compatible)')
    add_render_args(p_render)

    p_demo = sub.add_parser('demo', help='render a built-in demo scene')
    p_demo.add_argument('name', choices=DEMOS)
    add_render_args(p_demo)

    def add_device_arg(p):
        p.add_argument('--device', choices=['cuda', 'cpu'], default='cuda',
                       help='run on the card (default) or on the CPU')

    p_view = sub.add_parser(
        'view', help='serve an interactive progressive render over HTTP')
    p_view.add_argument('scene', nargs='?', default=None,
                        help='scene .json (default: built-in default scene)')
    p_view.add_argument('--demo', choices=DEMOS)
    p_view.add_argument('--width', type=int, default=960)
    p_view.add_argument('--height', type=int, default=540)
    p_view.add_argument('--host', default='127.0.0.1')
    p_view.add_argument('--port', type=int, default=8000)
    add_device_arg(p_view)

    p_spec = sub.add_parser(
        'spectrum', help='plot the uplifted spectrum of an sRGB color')
    p_spec.add_argument('rgb', type=float, nargs=3, metavar=('R', 'G', 'B'))
    p_spec.add_argument('--png', help='also write a PNG plot')
    add_device_arg(p_spec)

    p_dump = sub.add_parser(
        'bvhdump', help='dump the flattened wide-BVH structure of a scene')
    p_dump.add_argument('scene', nargs='?', default=None)
    p_dump.add_argument('--demo', choices=DEMOS, default='viking')
    p_dump.add_argument('--depth', type=int, default=3)
    add_device_arg(p_dump)

    args = parser.parse_args(argv)

    if args.command == 'spectrum':
        from .utils.debug import ascii_plot, plot_spectrum_png, spectrum_report

        report = spectrum_report(args.rgb, device=args.device)
        print(ascii_plot(report['lambda_nm'], report['reflectance'],
                         label=f'uplifted spectrum of sRGB {args.rgb}'))
        print(f'sigmoid-polynomial beta: {report["beta"]}')
        print(f'observed under D65:      {report["observed_rgb"]} '
              f'(round-trip error {report["roundtrip_error"]:.4f})')
        if args.png:
            plot_spectrum_png(args.rgb, args.png, device=args.device)
            print(f'wrote {args.png}')
        return 0

    if args.command == 'bvhdump':
        from .scene.compile import compile_scene
        from .utils.debug import bvh_statistics, dump_wide_bvh

        if args.scene:
            from .scene.serializer import load_scene
            scene = load_scene(args.scene)
        else:
            scene = _demo_scene(args.demo)
        packed = compile_scene(scene, device=args.device)
        print(bvh_statistics(packed))
        dump_wide_bvh(packed, max_depth=args.depth)
        return 0

    if args.command == 'view':
        from .app import Session
        from .viewer.server import ViewerServer

        if args.scene:
            from .scene.serializer import load_scene
            scene = load_scene(args.scene)
        elif args.demo:
            scene = _demo_scene(args.demo)
        else:
            from .scene.procedural import make_default_scene
            scene = make_default_scene()
        session = Session(scene, width=args.width, height=args.height,
                          device=args.device)
        ViewerServer(session, host=args.host, port=args.port).serve_forever()
        return 0

    from . import render_scene
    from .core import constants
    from .utils.image import save_png

    modes = {
        'clamp': constants.TONE_MAPPING_MODE_CLAMP,
        'reinhard': constants.TONE_MAPPING_MODE_REINHARD,
        'hable': constants.TONE_MAPPING_MODE_HABLE,
        'aces': constants.TONE_MAPPING_MODE_ACES,
    }

    if args.command == 'render':
        from .scene.serializer import load_scene
        scene = load_scene(args.scene)
    else:
        scene = _demo_scene(args.name)

    t0 = time.time()
    if args.checkpoint:
        from .integrator.resolve import resolve
        from .utils.resilience import render_resilient

        state = render_resilient(
            scene, args.width, args.height, args.rounds, seed=args.seed,
            camera_index=args.camera, checkpoint_path=args.checkpoint,
            checkpoint_every=args.checkpoint_every, resume=args.resume,
            device=args.device)
        image = resolve(state['accum'], args.width, args.height,
                        brightness=args.brightness,
                        mode=modes[args.tonemap], lane=state['lane'])
    else:
        image = render_scene(scene, width=args.width, height=args.height,
                             spp_rounds=args.rounds, seed=args.seed,
                             tonemap_mode=modes[args.tonemap],
                             brightness=args.brightness,
                             camera_index=args.camera, device=args.device)
    save_png(args.output, image.cpu().numpy())
    print(f'rendered {args.width}x{args.height} on {args.device} in '
          f'{time.time()-t0:.1f}s -> {args.output}', file=sys.stderr)
    return 0


if __name__ == '__main__':
    sys.exit(main())
