"""Material dispatch: compute every model a scene uses, select by type.

Port of path_tracer_tpu/models/dispatch.py for the models ported so
far, BASIC_DIFFUSE and BASIC_METAL; a scene whose layout lists any
other material type raises NotImplementedError (BASIC_TRANSLUCENT and
OPENPBR are queued in ROADMAP.md). As in the JAX package, `types` is
the static set from SceneLayout.material_types: a scene with one model
runs it with no selects, and lanes of a type outside the set (missed
rays carrying the fallback slot) get the first active model's result,
which callers mask.
"""

from __future__ import annotations

import torch

from ..core.constants import (
    MATERIAL_TYPE_BASIC_DIFFUSE,
    MATERIAL_TYPE_BASIC_METAL,
)
from . import basic_diffuse, basic_metal

_MODELS = {
    MATERIAL_TYPE_BASIC_DIFFUSE: basic_diffuse,
    MATERIAL_TYPE_BASIC_METAL: basic_metal,
}
PORTED_TYPES = tuple(_MODELS)


def check_types(types):
    """Raise unless every material type in `types` is ported."""
    missing = sorted(set(types) - set(PORTED_TYPES))
    if not types or missing:
        raise NotImplementedError(
            f'material types {missing or "(unknown)"} are not ported yet; '
            'this port dispatches BASIC_DIFFUSE and BASIC_METAL only '
            '(ROADMAP.md Queue 1)')


def _select(mat_type, types, call):
    """call(model) for each ported model in `types`, in the order of
    PORTED_TYPES, selected per lane by material type; (N,) masks
    broadcast against (C, N) values."""
    check_types(types)
    active = [t for t in PORTED_TYPES if t in types]
    out = call(_MODELS[active[0]])
    for t in active[1:]:
        mask = mat_type == t
        new = call(_MODELS[t])
        if isinstance(out, tuple):
            out = tuple(torch.where(mask, n, o) for o, n in zip(out, new))
        else:
            out = torch.where(mask, new, out)
    return out


def has_dirac_bsdf(ctx, types):
    """MaterialHasDiracBSDF (scene.glsl.inc:713-718)."""
    return _select(ctx['type'], types, lambda m: m.has_dirac_bsdf(ctx))


def sample_bsdf(ctx, view, rng, types):
    """MaterialSampleBSDF over all lanes; draws the fixed three-uniform
    budget every model shares, so lane streams stay aligned."""
    u1 = rng.uniform()
    u2 = rng.uniform()
    u3 = rng.uniform()
    return _select(ctx['type'], types,
                   lambda m: m.sample_bsdf(ctx, view, u1, u2, u3))


def evaluate_bsdf(ctx, view, scattered, types):
    """MaterialEvaluateBSDF over all lanes."""
    return _select(ctx['type'], types,
                   lambda m: m.evaluate_bsdf(ctx, view, scattered))
