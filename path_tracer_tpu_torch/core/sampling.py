"""Vectorized random sampling: RNG, directions, vMF.

Port of path_tracer_tpu/core/sampling.py (the parts the diffuse surface
path draws from). Channels-first: directions are (3, N), uniforms (N,).

The RNG is the same per-lane PCG-style counter hash as the JAX package
and the reference (common.glsl.inc:189-203). torch has no uint32
arithmetic on the CPU, so the state rides in an int64 tensor holding a
value in [0, 2^32) and every multiply/add is reduced with
`& 0xFFFFFFFF`: every intermediate stays below 2^63, so the streams are
bit-exact with the JAX package's uint32 arithmetic on both devices.
"""

from __future__ import annotations

import torch

from .constants import EPSILON, PI, TAU
from .vec import cross, dot, safe_normalize, vec3

_MASK = 0xFFFFFFFF


class Rng:
    """Stateful per-lane random stream over an int64 state tensor
    holding uint32 values. `state` is replaced as numbers are drawn."""

    def __init__(self, state):
        self.state = state

    @staticmethod
    def seed(lane_index, frame_seed):
        """Seed like the reference scatter kernel (basic_scatter.glsl:314-318).

        lane_index: (N,) integer tensor; frame_seed: python int."""
        lane = lane_index.to(torch.int64) & _MASK
        s = int(frame_seed) & _MASK
        return Rng((lane * 65537 + s * 277803737) & _MASK)

    def next_u32(self):
        s = (self.state * 747796405 + 2891336453) & _MASK
        self.state = s
        shift = (s >> 28) + 4
        w = (((s >> shift) ^ s) * 277803737) & _MASK
        return (w >> 22) ^ w

    def uniform(self):
        """Uniform float32 in [0, 1). The u32 -> float32 conversion rounds
        to nearest even, as JAX's astype does."""
        return self.next_u32().to(torch.float32) * (1.0 / 4294967296.0)


def compute_tangent_vector(normal):
    """Arbitrary tangent for a (3, N) normal (common.glsl.inc:113-117)."""
    use_x = torch.abs(normal[0]) < 0.9
    one = torch.ones_like(normal[0])
    zero = torch.zeros_like(normal[0])
    v = torch.where(use_x, vec3(one, zero, zero), vec3(zero, one, zero))
    return safe_normalize(cross(v, normal))


def coordinate_frame(z):
    """Orthonormal frame (x, y) completing (3, N) unit z
    (common.glsl.inc:120-125); left-handed like the reference."""
    x = compute_tangent_vector(z)
    y = cross(x, z)
    return x, y


def random_point_on_disk(rng: Rng):
    """Uniform point on the unit disk; returns (2, N)."""
    r = torch.sqrt(rng.uniform())
    theta = rng.uniform() * TAU
    return torch.stack([r * torch.cos(theta), r * torch.sin(theta)], dim=0)


def random_von_mises_fisher(rng: Rng, kappa, mu=None):
    """Sample a vMF distribution with concentration kappa; (3, N).

    kappa: 0-dim float32 tensor; mu: optional (3, N) mean direction
    (+Z if omitted). Matches RandomVonMisesFisher (common.glsl.inc:228-247).
    """
    xi = rng.uniform()
    safe_kappa = torch.clamp(kappa, min=1e-6)
    z = 1.0 + (1.0 / safe_kappa) * torch.log(
        xi + (1.0 - xi) * torch.exp(-2.0 * safe_kappa))
    z = torch.clamp(z, -1.0, 1.0)
    r = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
    phi = rng.uniform() * TAU
    local = vec3(r * torch.cos(phi), r * torch.sin(phi), z)
    if mu is None:
        return local
    mu_x, mu_y = coordinate_frame(mu)
    return safe_normalize(local[0] * mu_x + local[1] * mu_y + local[2] * mu)


def von_mises_fisher_pdf(kappa, mu, direction):
    """vMF PDF (common.glsl.inc:249-254). mu/direction (3, N) -> (N,)."""
    cos_theta = dot(mu, direction)
    safe_kappa = torch.clamp(kappa, min=EPSILON)
    c = safe_kappa / (2.0 * PI * (1.0 - torch.exp(-2.0 * safe_kappa)))
    pdf = c * torch.exp(safe_kappa * (cos_theta - 1.0))
    return torch.where(kappa < EPSILON, torch.full_like(pdf, 1.0 / (4.0 * PI)),
                       pdf)
