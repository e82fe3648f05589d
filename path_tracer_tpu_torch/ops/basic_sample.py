"""The basic models' BSDF samples on the card: csrc/basic_sample.cu.

`basic_sample` does in one launch what models/dispatch.py's
`sample_bsdf_plain` does for the basic diffuse, metal and translucent
models in plain PyTorch: each lane samples its own model's lobe, only where
its sample is used, bit for bit equal to the plain version there in every
output. It launches on CUDA tensors only; `dispatch.sample_bsdf` routes the
card's rounds here and keeps the plain version on the CPU.
"""

from __future__ import annotations

import torch

from ..core.constants import (
    MATERIAL_TYPE_BASIC_DIFFUSE,
    MATERIAL_TYPE_BASIC_METAL,
    MATERIAL_TYPE_BASIC_TRANSLUCENT,
    MATERIAL_TYPE_OPENPBR,
)
from ..utils import profiling
from .trace_inst import check_tensor

F32, I32 = torch.float32, torch.int32
BASIC_TYPES = (MATERIAL_TYPE_BASIC_DIFFUSE, MATERIAL_TYPE_BASIC_METAL,
               MATERIAL_TYPE_BASIC_TRANSLUCENT)
# The kernel's tensors, in the order of csrc/basic_sample.h's fields:
# (name, dtype, leading rows of an (rows, N) tensor, 0 for (N,)). The
# sample's own inputs, then the ctx columns of fetch_ctx that the models
# read.
LANE_INPUTS = (('type', I32, 0), ('view', F32, 3), ('u1', F32, 0),
               ('u2', F32, 0), ('u3', F32, 0))
CTX_COLUMNS = (('lam', F32, 4), ('exterior_ior', F32, 4),
               ('base_reflectance', F32, 4),
               ('specular_reflectance', F32, 4), ('roughness', F32, 0),
               ('roughness_anisotropy', F32, 0), ('ior', F32, 0),
               ('abbe_number', F32, 0))
KERNEL_INPUTS = LANE_INPUTS + CTX_COLUMNS
CTX_INPUTS = ('type',) + tuple(name for name, _, _ in CTX_COLUMNS)
KERNEL_OUTPUTS = (('scattered', F32, 3), ('throughput', F32, 4),
                  ('probability', F32, 4), ('valid', torch.bool, 0))
# The columns each model's sample_bsdf reads.
READS = {
    MATERIAL_TYPE_BASIC_DIFFUSE: ('base_reflectance',),
    MATERIAL_TYPE_BASIC_METAL: ('base_reflectance', 'specular_reflectance',
                                'roughness', 'roughness_anisotropy'),
    MATERIAL_TYPE_BASIC_TRANSLUCENT: ('lam', 'exterior_ior', 'roughness',
                                      'roughness_anisotropy', 'ior',
                                      'abbe_number'),
}


def model_bits(types):
    """csrc/basic_sample.h's BasicSampleModels bits of a material type set
    (SceneLayout.material_types; empty: all four models)."""
    present = types or BASIC_TYPES + (MATERIAL_TYPE_OPENPBR,)
    return sum(1 << t for t in set(present))


def basic_sample(ctx, view, u1, u2, u3, types, where=None, out=None,
                 stats=None):
    """Launch csrc/basic_sample.cu, counted as `kernel.basic_sample`.

    `ctx` holds the material context of fetch_ctx: its `type`, and the
    columns of CTX_COLUMNS that the basic models of `types` read (READS);
    `view` is (3, N), `u1`..`u3` the sample's three uniforms. A lane of a
    basic type in `types` samples its own model; one of a type outside it
    the lowest basic model in it; an OpenPBR lane, where OpenPBR is in
    `types`, is left as it is. `where` ((N,) bool, or None for every lane)
    holds the lanes whose sample is used; no other lane samples. `out`,
    when given, is the OpenPBR walk's (in_dir, throughput, density,
    valid), which the kernel completes in place on the lanes it samples;
    without it the outputs are new and a lane that samples nothing gets a
    sample that is not valid. `stats`, when given, is a (3,) int64 tensor
    to which the kernel adds the lanes that sampled the diffuse, the metal
    and the translucent model. Every tensor must lie on the lanes' device,
    contiguous, of its dtype and shape, that device must be a card, and
    `types` must hold a basic model; anything else raises ValueError
    before a launch. Returns (scattered, throughput, probability,
    valid)."""
    dev, n = view.device, view.shape[-1]
    bits = model_bits(types)
    sampled = [t for t in BASIC_TYPES if bits >> t & 1]
    if not sampled:
        raise ValueError(f'basic_sample: no basic model in types {types}')
    needed = ({name for name, _, _ in LANE_INPUTS}
              | {name for t in sampled for name in READS[t]})
    given = dict(ctx, view=view, u1=u1, u2=u2, u3=u3)
    inputs = []
    for name, dtype, rows in KERNEL_INPUTS:
        if name not in needed:
            inputs.append(torch.empty((0,), dtype=dtype, device=dev))
            continue
        if name not in given:
            raise ValueError(f'basic_sample needs ctx[{name!r}]')
        check_tensor(name, given[name], dev, (rows, n) if rows else (n,),
                     dtype)
        inputs.append(given[name])
    empty = torch.empty((0,), dtype=torch.int64, device=dev)
    if where is None:
        where = empty
    else:
        check_tensor('where', where, dev, (n,), torch.bool)
    if stats is None:
        stats = empty
    else:
        check_tensor('stats', stats, dev, (3,), torch.int64)
    if out is None:
        out = [torch.empty((rows, n) if rows else (n,), dtype=dtype, device=dev)
               for _, dtype, rows in KERNEL_OUTPUTS]
    else:
        if len(out) != len(KERNEL_OUTPUTS):
            raise ValueError(f'basic_sample takes {len(KERNEL_OUTPUTS)} '
                             f'outputs, got {len(out)}')
        for (name, dtype, rows), x in zip(KERNEL_OUTPUTS, out):
            check_tensor(name, x, dev, (rows, n) if rows else (n,), dtype)
        out = list(out)
    if dev.type != 'cuda':
        raise ValueError(f'basic_sample runs on a CUDA device, not {dev}')
    from .build import load
    load().basic_sample(inputs, out, where, bits, stats,
                        torch.cuda.current_stream(dev).cuda_stream)
    profiling.count('kernel.basic_sample')
    return tuple(out)
