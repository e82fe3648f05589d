"""Scatter's own code after the BSDF sample on the card: csrc/scatter_tail.cu.

`scatter_tail` does in one launch what integrator/scatter.py's
`scatter_tail_plain` does in plain PyTorch: the sky's radiance on the lanes
that hit it, the observer and the emission into the sample, the surface
branch and the active-shape bookkeeping, Russian roulette, the new ray and
the three-way merge, bit for bit in every output and in the stepped random
state. It launches on CUDA tensors only; integrator/scatter.py's
`scatter_tail` routes the card's rounds here and keeps the plain version on
the CPU.
"""

from __future__ import annotations

import torch

from ..core.constants import ACTIVE_SHAPE_LIMIT, MATERIAL_TYPE_OPENPBR
from ..models.dispatch import active_types
from ..utils import profiling
from .trace_inst import check_tensor

F32, I32, I64, BOOL = torch.float32, torch.int32, torch.int64, torch.bool
# The kernel's tensors, in the order of csrc/scatter_tail.h's fields:
# (name, dtype, leading rows of an (rows, N) tensor, 0 for (N,), the
# ScatterTailFlags bit without which the kernel reads none of it, 0 for
# always). The state, the ray, the random state, the hit record, the
# integrand, the medium event's outputs, the ghost mask and the emission.
LANE_INPUTS = (
    ('lambda0', F32, 0, 0), ('throughput', F32, 4, 0),
    ('probability', F32, 4, 0), ('sample', F32, 3, 0),
    ('active_shapes', I32, ACTIVE_SHAPE_LIMIT, 0), ('origin', F32, 3, 0),
    ('direction', F32, 3, 0), ('rng_state', I64, 0, 0), ('time', F32, 0, 0),
    ('shape', I32, 0, 0), ('position', F32, 3, 0), ('normal', F32, 3, 0),
    ('tangent', F32, 3, 0), ('bitangent', F32, 3, 0),
    ('scattered', F32, 3, 0), ('s_throughput', F32, 4, 0),
    ('s_probability', F32, 4, 0), ('s_valid', BOOL, 0, 0),
    ('priority', I32, 0, 1), ('vol_scatter', BOOL, 0, 1),
    ('sky_hit', BOOL, 0, 1), ('vol_origin', F32, 3, 1), ('vol_dir', F32, 3, 1),
    ('vol_throughput', F32, 4, 1), ('vol_probability', F32, 4, 1),
    ('ghost', BOOL, 0, 4), ('type', I32, 0, 16),
    ('emission_reflectance', F32, 4, 16), ('emission_luminance', F32, 0, 16))
# Then the scene's tables it reads: (name, dtype, shape, None for any
# length); the sky's texture, its rows and the atlas table of the layout's
# mode only with a sky texture.
TABLES = (
    ('skybox_brightness', F32, ()), ('skybox_texture_index', I32, ()),
    ('texture_meta', F32, (None, 8)), ('atlas', F32, (None, 4)),
    ('atlas_quad', F32, (None, 16)), ('atlas_pair', torch.bfloat16, (None, 8)))
KERNEL_OUTPUTS = (
    ('throughput', F32, 4), ('probability', F32, 4), ('sample', F32, 3),
    ('active_shapes', I32, ACTIVE_SHAPE_LIMIT), ('origin', F32, 3),
    ('direction', F32, 3), ('alive', BOOL, 0), ('rng_state', I64, 0))
# csrc/scatter_tail.h's ScatterTailFlags bits; its ScatterTailAtlas modes
# in order, as SceneLayout.atlas_quad_fit names them, and their tables.
MEDIUM, TRANSMISSIVE, OPACITY, SKY_TEXTURE, OPENPBR, BILINEAR, NEAREST = (
    1, 2, 4, 8, 16, 32, 64)
ATLAS_MODES = (False, 'quad', 'pair')
ATLAS_TABLES = ('atlas', 'atlas_quad', 'atlas_pair')
# sample_skybox_radiance's spectrum of a sky without a texture.
DEFAULT_SKY = (0.0, 0.0, 100.0, 1.0)


def layout_flags(layout):
    """The ScatterTailFlags bits of a SceneLayout."""
    bilinear, nearest = layout.texture_filter_modes
    return ((MEDIUM if layout.scene_has_medium else 0)
            | (TRANSMISSIVE if layout.has_transmissive else 0)
            | (OPACITY if layout.has_opacity else 0)
            | (SKY_TEXTURE if layout.has_skybox_texture else 0)
            | (OPENPBR if MATERIAL_TYPE_OPENPBR in active_types(
                layout.material_types) else 0)
            | (BILINEAR if bilinear else 0) | (NEAREST if nearest else 0))


def scatter_tail(packed, layout, lanes, termination_probability, stats=None):
    """Launch csrc/scatter_tail.cu, counted as `kernel.scatter_tail`.

    `lanes` holds the tensors of LANE_INPUTS by name, those of a flag the
    layout lacks may be left out: the path state (`lambda0`, `throughput`
    the medium event's where the scene has a medium, `probability`,
    `sample`, `active_shapes`), the ray, the random state after the BSDF
    sample, the hit's time, shape, position and frame, the surface
    integrand (`scattered`, `s_throughput`, `s_probability`, `s_valid`),
    the medium event's outputs, the ghost mask and fetch_ctx's `type` and
    emission columns. Every tensor must lie on the lanes' device,
    contiguous, of its dtype and shape, and that device must be a card;
    anything else raises ValueError before a launch. `stats`, when given,
    is a (4,) int64 tensor to which the kernel adds the lanes that hit the
    sky, scatter in a volume, scatter off a surface and pass through one.
    Returns the outputs of KERNEL_OUTPUTS by name (`active_shapes` only
    where the layout has transmissive materials)."""
    origin = lanes['origin']
    dev, n = origin.device, origin.shape[-1]
    flags = layout_flags(layout)
    empty = {dtype: torch.empty((0,), dtype=dtype, device=dev)
             for dtype in (F32, I32, I64, BOOL, torch.bfloat16)}
    inputs = []
    for name, dtype, rows, flag in LANE_INPUTS:
        if flag and not flags & flag:
            inputs.append(empty[dtype])
            continue
        x = lanes[name]
        check_tensor(name, x, dev, (rows, n) if rows else (n,), dtype)
        inputs.append(x)
    mode = ATLAS_MODES.index(layout.atlas_quad_fit)
    read = {'skybox_brightness'}
    if flags & SKY_TEXTURE:
        read |= {'skybox_texture_index', 'texture_meta', ATLAS_TABLES[mode]}
    for name, dtype, shape in TABLES:
        if name not in read:
            inputs.append(empty[dtype])
            continue
        x = getattr(packed, name)
        check_tensor(name, x, dev, shape, dtype)
        inputs.append(x)
    if stats is None:
        stats = empty[I64]
    else:
        check_tensor('stats', stats, dev, (4,), I64)
    if dev.type != 'cuda':
        raise ValueError(f'scatter_tail runs on a CUDA device, not {dev}')
    outputs = [torch.empty((rows, n) if rows else (n,), dtype=dtype, device=dev)
               if name != 'active_shapes' or flags & TRANSMISSIVE
               else empty[I32] for name, dtype, rows in KERNEL_OUTPUTS]
    from .build import load
    load().scatter_tail(inputs, outputs, flags, mode,
                        int(layout.atlas_size), float(termination_probability),
                        list(DEFAULT_SKY), stats,
                        torch.cuda.current_stream(dev).cuda_stream)
    profiling.count('kernel.scatter_tail')
    out = {name: t for (name, _, _), t in zip(KERNEL_OUTPUTS, outputs)}
    if not flags & TRANSMISSIVE:
        del out['active_shapes']
    return out
