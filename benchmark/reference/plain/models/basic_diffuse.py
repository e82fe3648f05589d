# Frozen copy of path_tracer_tpu_torch/models/basic_diffuse.py, part of the benchmark's
# plain reference: not kept in step with the program.
"""Basic Diffuse material: Lambertian with texturable base color.

Port of path_tracer_tpu/models/basic_diffuse.py
(reference src/scene/basic_diffuse.glsl.inc). Directions (3, N)
in the hit tangent frame (+Z = shading normal); spectral quantities
(4, N). `view` points toward the viewer, `scattered` is the sampled or
evaluated light direction.
"""

from __future__ import annotations

import torch

from ..core.constants import PI
from ..core.vec import safe_normalize, vec3


def has_dirac_bsdf(ctx):
    return torch.zeros_like(ctx['type'], dtype=torch.bool)


def evaluate_bsdf(ctx, view, scattered):
    """Cosine-lobe evaluation (basic_diffuse.glsl.inc:19-34), with the
    pdf of the scattered direction (the JAX package's documented fix of
    the reference's view-cosine pdf). Returns (throughput (4, N),
    probability (4, N), valid (N,))."""
    n = scattered.shape[1]
    probability = (torch.clamp(scattered[2], min=0.0) / PI).expand(4, n)
    throughput = probability * ctx['base_reflectance']
    valid = torch.ones(n, dtype=torch.bool, device=scattered.device)
    return throughput, probability, valid


def sample_bsdf(ctx, view, u1, u2, u3):
    """Cosine-weighted hemisphere sample (basic_diffuse.glsl.inc:37-50):
    uniform sphere direction + z-axis, normalized."""
    z = 2.0 * u1 - 1.0
    r = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
    phi = 2.0 * PI * u2
    scattered = safe_normalize(vec3(r * torch.cos(phi), r * torch.sin(phi), z + 1.0))
    throughput, probability, valid = evaluate_bsdf(ctx, view, scattered)
    return scattered, throughput, probability, valid
