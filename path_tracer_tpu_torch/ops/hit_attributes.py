"""The resolved hit record on the card: csrc/hit_attributes.cu.

`hit_attributes` does in one launch what ops/intersect.py's
`resolve_attributes_plain` does in plain PyTorch after the traversals of
`trace`: it merges the mesh kernel's winners into the hit record, where
one ran, and resolves every lane's position, normal, tangent frame, uv and
material, bit for bit in every field. The layout's packet mode picks what
a mesh hit's attributes come from (the kernel's instantiation): 'inst'
and 'flat' lerp the winners' attribute rows (`inst_attrs` with
`inst_aux`, or `wide_attrs`); without winners (the portable traversal, or
a layout without instance slots) a mesh hit takes the vertex tables' lerp
by its barycentrics, as the plain version does. It runs on CUDA tensors
only: ops/intersect.py's `resolve_attributes` routes the card's traces
here and keeps the plain version on the CPU.
"""

from __future__ import annotations

import torch

from ..utils import profiling
from .trace_inst import check_tensor

F32, I32 = torch.float32, torch.int32
MODES = {'none': 0, 'inst': 1, 'flat': 2}
WINNERS = {'inst': ('t', 'face', 'fu', 'fv', 'inst'),
           'flat': ('t', 'face', 'fu', 'fv')}

# The kernel's tensors, in the order of csrc/hit_attributes.h's fields; an
# input the mode does not read is an empty tensor.
KERNEL_INPUTS = (
    ('origin', F32), ('direction', F32), ('time', F32), ('shape', I32),
    ('shape_type', I32), ('primitive', I32), ('coords', F32),
    ('world_from_object', F32), ('object_from_world', F32),
    ('material', I32), ('face_vertices', I32), ('vertex_normals', F32),
    ('vertex_uvs', F32), ('t', F32), ('face', I32), ('fu', F32),
    ('fv', F32), ('inst', I32), ('attrs', F32), ('aux', F32))
# (name, dtype, leading rows of an (rows, N) tensor, 0 for (N,)).
KERNEL_OUTPUTS = (
    ('time', F32, 0), ('shape', I32, 0), ('shape_type', I32, 0),
    ('primitive', I32, 0), ('material', I32, 0), ('position', F32, 3),
    ('normal', F32, 3), ('tangent', F32, 3), ('bitangent', F32, 3),
    ('uv', F32, 2))
MERGED = 4     # the first outputs, which only a merge writes


def hit_attributes(packed, layout, origin, direction, hit, winners=None,
                   stats=None):
    """The resolved hit record of `trace` (resolve_hit_attributes' dict)
    from `hit`, a record of ops/intersect.py::make_hit's fields after the
    analytic pass, and the mesh kernel's `winners` in lane order: (t,
    face, fu, fv, inst) in 'inst' mode, (t, face, fu, fv) in 'flat', None
    where no mesh kernel ran (the portable traversal, or a layout without
    instance slots). Every
    tensor must lie on one card, contiguous, of its dtype and shape; the
    fields the launch leaves as they were (without winners: time, shape,
    shape_type, primitive; always complexity) are the given tensors.
    `stats`, when given, is a (5,) int64 tensor to which the kernel adds
    the lanes that missed and those that hit a mesh, a plane, a sphere and
    a cube. Counted as `kernel.hit_attributes`."""
    dev = origin.device
    if dev.type != 'cuda':
        raise ValueError(f'hit_attributes runs on a CUDA device, not {dev}')
    n = origin.shape[-1]
    mode = 'none' if winners is None else layout.packet_mode
    if mode not in MODES:
        raise ValueError(f'no hit_attributes kernel for packet mode {mode!r}')
    s = packed.shape_material.shape[0]
    # name -> (tensor, shape); None in a shape matches any length.
    given = dict(
        origin=(origin, (3, n)), direction=(direction, (3, n)),
        time=(hit['time'], (n,)), shape=(hit['shape'], (n,)),
        shape_type=(hit['shape_type'], (n,)),
        primitive=(hit['primitive'], (n,)), coords=(hit['coords'], (3, n)),
        world_from_object=(packed.shape_world_from_object, (4, 4, s)),
        object_from_world=(packed.shape_object_from_world, (4, 4, s)),
        material=(packed.shape_material, (s,)))
    n_aux = 0
    if mode == 'none':
        v = packed.vertex_normals.shape[-1]
        given.update(face_vertices=(packed.face_vertices, (3, None)),
                     vertex_normals=(packed.vertex_normals, (3, v)),
                     vertex_uvs=(packed.vertex_uvs, (2, v)))
    else:
        names = WINNERS[mode]
        if len(winners) != len(names):
            raise ValueError(f'{mode!r} mode takes the winners {names}, got '
                             f'{len(winners)} tensors')
        given.update({k: (w, (n,)) for k, w in zip(names, winners)})
        given['attrs'] = (packed.inst_attrs if mode == 'inst'
                          else packed.wide_attrs, (None, 16))
        if mode == 'inst':
            given['aux'] = (packed.inst_aux, (None, 16))
            n_aux = layout.instance_slots
    inputs = []
    for name, dtype in KERNEL_INPUTS:
        if name in given:
            x, shape = given[name]
            check_tensor(name, x, dev, shape, dtype)
        else:
            x = torch.empty((0,), dtype=dtype, device=dev)
        inputs.append(x)
    if stats is None:
        stats = torch.empty((0,), dtype=torch.int64, device=dev)
    else:
        check_tensor('stats', stats, dev, (5,), torch.int64)
    outputs = [torch.empty((rows, n) if rows else (n,), dtype=dtype, device=dev)
               if k >= MERGED or mode != 'none'
               else torch.empty((0,), dtype=dtype, device=dev)
               for k, (_, dtype, rows) in enumerate(KERNEL_OUTPUTS)]
    from .build import load
    load().hit_attributes(MODES[mode], inputs, outputs, n_aux, stats,
                          torch.cuda.current_stream(dev).cuda_stream)
    profiling.count('kernel.hit_attributes')
    out = {name: t for (name, _, _), t in zip(KERNEL_OUTPUTS, outputs)}
    if mode == 'none':
        out.update({name: hit[name] for name, _, _ in KERNEL_OUTPUTS[:MERGED]})
    out['complexity'] = hit['complexity']
    return out
