"""The comparison that decides `correct`.

The program's side is captured by the traffic generator once the window
has closed:
the sampled lanes' state before and after one more round of the
window's own call on the window's own state, that round's hit records,
and the resolved output of the window (the image at sampled pixels)
with the accumulator it came from. The reference
(../reference) rebuilds the scene from the configuration, compiles it
itself, and works out the same quantities; `numbers` compares them.

Numbers (each is held to its limit in cells/<workload>.json):
- reset_lanes_off: share of sampled lanes whose reset state differs;
- trace_rays_off: share of sampled rays whose hit differs (shape and
  time; normal and uv where there is a hit);
- round_lanes_off: share of sampled lanes whose state after the round
  differs (path, ray, RNG state, accumulator);
- image_max_err: largest difference of a sampled pixel's display value.
A float differs where |a - b| > ATOL + RTOL * m, with m the largest
|a| or |b| among the channels of its lane (the vector's scale).
"""

from __future__ import annotations

import contextlib
import types

import numpy as np

RTOL = 1e-3
ATOL = 1e-6
SAMPLE_LANES = 65536


def sample_slots(seed, n, k=SAMPLE_LANES):
    """k distinct slots of n, drawn from the seed, in increasing order."""
    rng = np.random.default_rng(int(seed))
    return np.sort(rng.choice(n, size=min(k, n), replace=False))


def snapshot(state, idx):
    """The program's render state at slots `idx` (a long tensor)."""
    return dict(
        path={k: v[..., idx] for k, v in state['path'].items()},
        origin=state['origin'][:, idx],
        direction=state['direction'][:, idx],
        rng_state=state['rng_state'][idx],
        accum={k: v[..., idx] for k, v in state['accum'].items()},
        lane=state['lane'][idx],
    )


@contextlib.contextmanager
def capture_hits(module, idx):
    """Replace `module.trace` for the body by a wrapper that keeps the
    hit records of the slots `idx` of the last call."""
    original = module.trace
    out = {}

    def capture(*args, **kwargs):
        hit = original(*args, **kwargs)
        out['hit'] = hit_fields(hit, idx)
        return hit

    module.trace = capture
    try:
        yield out
    finally:
        module.trace = original


def hit_fields(hit, idx=None):
    keys = ('time', 'shape', 'normal', 'uv')
    if idx is None:
        return {k: hit[k] for k in keys}
    return {k: hit[k][..., idx] for k in keys}


def _leaves(tree, prefix=''):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f'{prefix}{k}.')
    else:
        yield prefix[:-1], tree


def lanes_off(a, b):
    """(K,) bool: the lanes at which the trees of (..., K) tensors a and b
    differ."""
    import torch

    bad = None
    for (name, x), (name_b, y) in zip(_leaves(a), _leaves(b)):
        if name != name_b:
            raise ValueError(f'fields differ: {name} / {name_b}')
        x, y = x.to(y.device), y
        if x.is_floating_point() or y.is_floating_point():
            x, y = x.double(), y.double()
            scale = torch.maximum(x.abs(), y.abs())
            if scale.dim() > 1:
                scale = scale.reshape(-1, scale.shape[-1]).amax(dim=0)
            ok = ((x - y).abs() <= ATOL + RTOL * scale) \
                | (x == y) | (x.isnan() & y.isnan())
        else:
            ok = x == y
        off = ~ok.reshape(-1, ok.shape[-1]).all(dim=0)
        bad = off if bad is None else bad | off
    return bad


def hits_off(a, b):
    """(K,) bool: the rays whose hit records differ: in shape or time, or,
    where there is a hit, in normal or uv (a miss's are not defined)."""
    from ..reference.plain.core.constants import SHAPE_INDEX_NONE

    off = lanes_off({k: a[k] for k in ('shape', 'time')},
                    {k: b[k] for k in ('shape', 'time')})
    surface = lanes_off({k: a[k] for k in ('normal', 'uv')},
                        {k: b[k] for k in ('normal', 'uv')})
    hit = b['shape'] != SHAPE_INDEX_NONE
    return off | (hit.to(surface.device) & surface)


def share(mask):
    return float(mask.double().mean())


def reference_api():
    from ..reference.plain.core import constants
    from ..reference.plain.scene import model
    return types.SimpleNamespace(**{
        k: v for m in (constants, model) for k, v in vars(m).items()
        if not k.startswith('_')})


def reference_outputs(cell, cap, dtype):
    """The reference's counterparts of the captured program outputs,
    worked out in `dtype`."""
    import torch

    from ..reference import follow
    from ..reference.plain.scene.compile import compile_scene

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    p = cap['params']
    width, height = p['width'], p['height']
    scene = cell.maker.make_scene(reference_api(), cell.config)
    dev = cap['before']['origin'].device
    packed = compile_scene(scene, aspect_ratio=width / height, device=dev)
    layout = packed.host_layout
    instances = [(si, faces) for si, faces, _ in scene.reference_instances]
    camera = (0, packed.host_camera_models[0])
    out = {}
    if cap.get('reset') is not None:
        out['reset'] = follow.rounded(follow.reset(
            packed, camera, width, height, p['seed'], cap['slots'],
            p['flags']), dtype)
    out['after'], hit = follow.round_(
        packed, layout, instances, camera, width, height, p['flags'],
        cap['before'], p['termination_probability'], dtype)
    out['hit'] = hit_fields(hit)
    if cap.get('pixels') is not None:
        px = cap['pixels']
        out['pixels'] = follow.resolve_pixels(
            px['xyz'], px['count'], p['brightness'], p['tonemap'], dtype)
    return out


def numbers(cap, ref):
    """The compared numbers of the program's capture against the
    reference's outputs."""
    import torch

    out = {}
    if 'reset' in ref:
        out['reset_lanes_off'] = share(lanes_off(cap['reset'], ref['reset']))
    # A round that traced nothing has no hit records: every ray is off.
    out['trace_rays_off'] = (1.0 if cap['hit'] is None
                             else share(hits_off(cap['hit'], ref['hit'])))
    out['round_lanes_off'] = share(lanes_off(cap['after'], ref['after']))
    if 'pixels' in ref:
        err = (cap['pixels']['values'].to(ref['pixels'].device).double()
               - ref['pixels'].double()).abs()
        out['image_max_err'] = float(torch.nan_to_num(err, nan=1.0).max())
    return out


def control_capture(cap, ref_low):
    """The capture with the low-precision reference's outputs put in the
    program's place."""
    low = dict(cap)
    for key in ('reset', 'after', 'hit'):
        if key in ref_low:
            low[key] = ref_low[key]
    if 'pixels' in ref_low:
        low['pixels'] = dict(cap['pixels'], values=ref_low['pixels'])
    return low


def judge(values, limits):
    """(correct, {name: {value, limit}}): every limit's number is
    present, finite and at most its limit."""
    checks, correct = {}, True
    for name, limit in limits.items():
        value = values.get(name)
        ok = value is not None and np.isfinite(value) and value <= limit
        correct &= bool(ok)
        checks[name] = dict(value=value, limit=limit)
    return correct, checks
