"""Material dispatch over the material types a scene uses.

Port of path_tracer_tpu/models/dispatch.py. This slice of the port
wires BASIC_DIFFUSE only; a scene whose layout lists any other material
type raises NotImplementedError (the other models are queued in
ROADMAP.md). As in the JAX package, `types` is the static set from
SceneLayout.material_types and lanes of other types (missed rays
carrying the fallback slot) get the active model's result, which
callers mask.
"""

from __future__ import annotations

from ..core.constants import MATERIAL_TYPE_BASIC_DIFFUSE
from . import basic_diffuse

PORTED_TYPES = (MATERIAL_TYPE_BASIC_DIFFUSE,)


def check_types(types):
    """Raise unless every material type in `types` is ported."""
    missing = sorted(set(types) - set(PORTED_TYPES))
    if not types or missing:
        raise NotImplementedError(
            f'material types {missing or "(unknown)"} are not ported yet; '
            'this port dispatches BASIC_DIFFUSE only (ROADMAP.md Queue 1)')


def has_dirac_bsdf(ctx, types):
    check_types(types)
    return basic_diffuse.has_dirac_bsdf(ctx)


def sample_bsdf(ctx, view, rng, types):
    """MaterialSampleBSDF over all lanes; draws the fixed three-uniform
    budget every model shares, so lane streams stay aligned."""
    check_types(types)
    u1 = rng.uniform()
    u2 = rng.uniform()
    u3 = rng.uniform()
    return basic_diffuse.sample_bsdf(ctx, view, u1, u2, u3)


def evaluate_bsdf(ctx, view, scattered, types):
    check_types(types)
    return basic_diffuse.evaluate_bsdf(ctx, view, scattered)

