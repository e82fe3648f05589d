"""Material dispatch: compute every model a scene uses, select by type.

Port of path_tracer_tpu/models/dispatch.py. The reference branches per
GPU thread (scene.glsl.inc:687-764); here, as in the JAX package, every
lane evaluates every model of the scene and the results are selected by
material type, except for the BSDF sample on the card, which branches per
lane too: OpenPBR's inside one kernel (csrc/openpbr_walk.cu) that walks
only the OpenPBR lanes whose sample is used, and the three basic models'
inside another (csrc/basic_sample.cu, ops/basic_sample.py) in which each
lane whose sample is used samples only its own model.
`types` is the static set from SceneLayout.material_types:
a scene without an OpenPBR material never runs the 8-bounce layer walk,
and a diffuse-only scene runs one model with no selects. An empty tuple
means all four models. Lanes whose type is not in the set (missed rays
carrying the fallback slot) get the first model's result, which callers
mask.
"""

from __future__ import annotations

import torch

from ..core.constants import (
    MATERIAL_TYPE_BASIC_DIFFUSE,
    MATERIAL_TYPE_BASIC_METAL,
    MATERIAL_TYPE_BASIC_TRANSLUCENT,
    MATERIAL_TYPE_OPENPBR,
)
from ..ops.basic_sample import CTX_INPUTS as BASIC_CTX_INPUTS, basic_sample
from ..utils import profiling
from . import basic_diffuse, basic_metal, basic_translucent, openpbr

_MODELS = {
    MATERIAL_TYPE_BASIC_DIFFUSE: basic_diffuse,
    MATERIAL_TYPE_BASIC_METAL: basic_metal,
    MATERIAL_TYPE_BASIC_TRANSLUCENT: basic_translucent,
    MATERIAL_TYPE_OPENPBR: openpbr,
}
_ALL_TYPES = tuple(_MODELS)
# Each model's short name, indexed by its material type: the bins of the
# `pt.scatter.surface_lanes_by_type` counter and the names of its spans.
TYPE_NAMES = tuple(_MODELS[t].__name__.rsplit('.', 1)[-1]
                   for t in sorted(_MODELS))
_SAMPLE_SPANS = {t: f'pt.model.{TYPE_NAMES[t]}.sample' for t in _MODELS}
_LANE_COUNTS = {t: f'pt.model.{TYPE_NAMES[t]}.lanes' for t in _MODELS}
# On the card: the span around the basic models' one launch, and their
# lane counters in the kernel's order (diffuse, metal, translucent).
BASIC_SPAN = 'pt.model.basic.sample'
BASIC_LANE_COUNTS = tuple(_LANE_COUNTS[t] for t in sorted(_MODELS)
                          if t != MATERIAL_TYPE_OPENPBR)


def active_types(types):
    if not types:
        return _ALL_TYPES
    return tuple(t for t in _ALL_TYPES if t in types)


def _select(mat_type, results):
    """Per-lane results from {material_type: value}, selected by type in
    the order of `results`; (N,) masks broadcast against (C, N) values."""
    types = list(results)
    out = results[types[0]]
    for t in types[1:]:
        mask = mat_type == t
        if isinstance(out, tuple):
            out = tuple(torch.where(mask, n, o) for o, n in zip(out, results[t]))
        else:
            out = torch.where(mask, results[t], out)
    return out


def has_dirac_bsdf(ctx, types=()):
    """MaterialHasDiracBSDF (scene.glsl.inc:713-718)."""
    return _select(ctx['type'], {t: _MODELS[t].has_dirac_bsdf(ctx)
                                 for t in active_types(types)})


def sample_bsdf(ctx, view, rng, types=(), where=None):
    """MaterialSampleBSDF over all lanes. Every model shares the same
    three uniforms, drawn here first, so lane streams stay aligned;
    OpenPBR's layer walk draws its own from `rng` after them. `where`
    ((N,) bool, or None for every lane) holds the lanes whose sample the
    caller uses. On CUDA tensors the OpenPBR walk (models/openpbr.py) and
    one launch of csrc/basic_sample.cu for the basic models sample those
    lanes alone, each lane only its own model, and no other lane's sample
    is valid; the basic launch runs in the span `pt.model.basic.sample`
    and, while tracing, counts the lanes that sampled each basic model in
    `pt.model.<name>.lanes` on the device. On CPU tensors it is
    `sample_bsdf_plain`."""
    u1 = rng.uniform()
    u2 = rng.uniform()
    u3 = rng.uniform()
    if view.device.type == 'cpu':
        return sample_bsdf_plain(ctx, view, u1, u2, u3, rng, types, where)
    if view.device.type != 'cuda':
        raise ValueError(f'dispatch.sample_bsdf: unsupported device {view.device}')
    act = active_types(types)
    out = None
    if MATERIAL_TYPE_OPENPBR in act:
        with profiling.span(_SAMPLE_SPANS[MATERIAL_TYPE_OPENPBR]):
            out = openpbr.sample_bsdf(ctx, view, u1, u2, u3, rng, where)
    if act != (MATERIAL_TYPE_OPENPBR,):
        with profiling.span(BASIC_SPAN):
            # fetch_ctx's columns come from gathers, texture taps and
            # selects; the kernel reads each as contiguous rows.
            out = basic_sample(
                {k: ctx[k].contiguous() for k in BASIC_CTX_INPUTS if k in ctx},
                view.contiguous(), u1, u2, u3, types,
                None if where is None else where.contiguous(), out=out,
                stats=profiling.kernel_counts(BASIC_LANE_COUNTS, view.device))
    return out


def sample_bsdf_plain(ctx, view, u1, u2, u3, rng, types=(), where=None):
    """The BSDF sample in plain PyTorch, on any device, from the three
    uniforms u1..u3: every model of `types` on every lane, then selected
    by type. OpenPBR's `sample_bsdf` draws its walk from `rng` (its
    kernel on the card, which walks only the lanes in `where`). Each model
    runs in a span `pt.model.<name>.sample` and counts the lanes it ran on
    in `pt.model.<name>.lanes`: every lane, except OpenPBR's kernel on the
    card, which counts the lanes it walked (models/openpbr.py)."""
    results = {}
    for t in active_types(types):
        with profiling.span(_SAMPLE_SPANS[t]):
            if t == MATERIAL_TYPE_OPENPBR:
                results[t] = openpbr.sample_bsdf(ctx, view, u1, u2, u3, rng,
                                                 where)
            else:
                profiling.count(_LANE_COUNTS[t], view.shape[1])
                results[t] = _MODELS[t].sample_bsdf(ctx, view, u1, u2, u3)
    return _select(ctx['type'], results)


def evaluate_bsdf(ctx, view, scattered, types=()):
    """MaterialEvaluateBSDF over all lanes."""
    return _select(ctx['type'], {t: _MODELS[t].evaluate_bsdf(ctx, view, scattered)
                                 for t in active_types(types)})


def surface_emission(ctx, types=()):
    """Emission radiance (4, N) of the hit surface. Only OpenPBR carries
    emission (openpbr.hpp:127-133); the reference packs it but never
    accumulates it, and, as in the JAX package, the integrator does."""
    if MATERIAL_TYPE_OPENPBR not in active_types(types):
        lam = ctx['lam']
        return torch.zeros((4, lam.shape[1]), dtype=lam.dtype, device=lam.device)
    return torch.where(ctx['type'] == MATERIAL_TYPE_OPENPBR,
                       openpbr.emission(ctx), 0.0)


def load_medium(ctx, types=()):
    """MaterialLoadMedium (scene.glsl.inc:704-708): only translucent and
    OpenPBR materials define an interior medium."""
    act = active_types(types)
    lam = ctx['lam']
    n = lam.shape[1]
    out = dict(
        ior=torch.ones((4, n), device=lam.device),
        absorption=torch.zeros((4, n), device=lam.device),
        scattering=torch.zeros((4, n), device=lam.device),
        anisotropy=torch.zeros((n,), device=lam.device),
        has_medium=torch.zeros((n,), dtype=torch.bool, device=lam.device),
    )
    sources = [(t, _MODELS[t].load_medium(ctx)) for t in act
               if t in (MATERIAL_TYPE_BASIC_TRANSLUCENT, MATERIAL_TYPE_OPENPBR)]
    for key in out:
        v = out[key]
        for t, r in sources:
            v = torch.where(ctx['type'] == t, r[key], v)
        out[key] = v
    return out


def has_any_medium(types):
    """Static: can any material in the scene define an interior medium?"""
    act = active_types(types)
    return (MATERIAL_TYPE_BASIC_TRANSLUCENT in act
            or MATERIAL_TYPE_OPENPBR in act)
