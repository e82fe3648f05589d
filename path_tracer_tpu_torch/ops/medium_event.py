"""The medium event of a scatter round on the card: csrc/medium_event.cu.

`medium_event` does in one launch what integrator/scatter.py's
`medium_event_plain` does in plain PyTorch: each lane's innermost active
shape and its medium, the absorbed throughput, the three draws of the
free flight and the volumetric sample, the event masks, the volumetric
branch and the exterior IOR, bit for bit in every output and in the
stepped random state. It launches on CUDA tensors only;
integrator/scatter.py's `medium_event` routes the card's rounds here and
keeps the plain version on the CPU.
"""

from __future__ import annotations

import torch

from ..core.constants import (
    ACTIVE_SHAPE_LIMIT,
    MATERIAL_TYPE_BASIC_TRANSLUCENT,
    MATERIAL_TYPE_OPENPBR,
)
from ..models.dispatch import active_types
from ..utils import profiling
from .trace_inst import check_tensor

F32, I32, I64 = torch.float32, torch.int32, torch.int64
# The kernel's tensors, in the order of csrc/medium_event.h's fields:
# (name, dtype, leading rows of an (rows, N) tensor, 0 for (N,)), then
# the tables of packed.materials, (name, rows of a (rows, M) column).
LANE_INPUTS = (
    ('active_shapes', I32, ACTIVE_SHAPE_LIMIT), ('lam', F32, 4),
    ('throughput', F32, 4), ('probability', F32, 4), ('time', F32, 0),
    ('shape', I32, 0), ('normal', F32, 3), ('origin', F32, 3),
    ('direction', F32, 3), ('rng_state', I64, 0))
MATERIAL_COLUMNS = (
    ('type', 0), ('ior', 0), ('abbe_number', 0),
    ('transmission_spectrum', 3), ('transmission_depth', 0),
    ('scattering_spectrum', 3), ('scattering_anisotropy', 0),
    ('specular_ior', 0), ('transmission_dispersion_abbe', 0),
    ('transmission_scatter_spectrum', 3),
    ('transmission_scatter_anisotropy', 0))
KERNEL_OUTPUTS = (
    ('priority', I32, 0), ('throughput', F32, 4),
    ('medium_event', torch.bool, 0), ('vol_scatter', torch.bool, 0),
    ('sky_hit', torch.bool, 0), ('vol_origin', F32, 3), ('vol_dir', F32, 3),
    ('vol_throughput', F32, 4), ('vol_probability', F32, 4),
    ('exterior_ior', F32, 4), ('rng_state', I64, 0))
# csrc/medium_event.h's MediumEventModels bits.
TRANSLUCENT, OPENPBR = 1, 2


def medium_event(packed, types, lanes, stats=None):
    """Launch csrc/medium_event.cu, counted as `kernel.medium_event`.

    `lanes` holds the tensors of LANE_INPUTS by name: the state's
    active-shape lists, the hero wavelengths `lam`, the state's throughput
    and probability, the hit's time, shape and normal, the ray's origin
    and direction, and the lanes' random state. `types` is the scene's
    material type set (SceneLayout.material_types). Every tensor must lie
    on the lanes' device, contiguous, of its dtype and shape, and that
    device must be a card; anything else raises ValueError before a
    launch. `stats`, when given, is a (3,) int64 tensor to which the
    kernel adds the lanes with no active shape, those inside a shape's
    medium and those that scatter in a volume. Returns the outputs of
    KERNEL_OUTPUTS by name; `rng_state` is a new tensor."""
    origin = lanes['origin']
    dev, n = origin.device, origin.shape[-1]
    inputs = []
    for name, dtype, rows in LANE_INPUTS:
        x = lanes[name]
        check_tensor(name, x, dev, (rows, n) if rows else (n,), dtype)
        inputs.append(x)
    s = packed.shape_material.shape[0]
    check_tensor('shape_material', packed.shape_material, dev, (s,), I32)
    check_tensor('scene_scatter_rate', packed.scene_scatter_rate, dev, (), F32)
    inputs += [packed.shape_material, packed.scene_scatter_rate]
    m = packed.materials.type.shape[0]
    for name, rows in MATERIAL_COLUMNS:
        x = getattr(packed.materials, name)
        check_tensor(name, x, dev, (rows, m) if rows else (m,),
                     I32 if name == 'type' else F32)
        inputs.append(x)
    if stats is None:
        stats = torch.empty((0,), dtype=I64, device=dev)
    else:
        check_tensor('stats', stats, dev, (3,), I64)
    if dev.type != 'cuda':
        raise ValueError(f'medium_event runs on a CUDA device, not {dev}')
    present = active_types(types)
    models = ((TRANSLUCENT if MATERIAL_TYPE_BASIC_TRANSLUCENT in present else 0)
              | (OPENPBR if MATERIAL_TYPE_OPENPBR in present else 0))
    outputs = [torch.empty((rows, n) if rows else (n,), dtype=dtype, device=dev)
               for _, dtype, rows in KERNEL_OUTPUTS]
    from .build import load
    load().medium_event(inputs, outputs, models, stats,
                        torch.cuda.current_stream(dev).cuda_stream)
    profiling.count('kernel.medium_event')
    return {name: t for (name, _, _), t in zip(KERNEL_OUTPUTS, outputs)}
