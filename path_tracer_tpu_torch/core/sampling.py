"""Vectorized random sampling: RNG, directions, vMF, GGX.

Port of path_tracer_tpu/core/sampling.py (the parts the integrator
draws from). Channels-first: directions are (3, N), GGX alphas (2, N),
uniforms (N,).

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

    def skip(self, draws):
        """Step the state past `draws` draws whose values nobody reads, in
        one affine step: s -> (a^k s + c (a^(k-1) + ... + a + 1)) mod 2^32.
        The multiplier is taken as a signed value below 2^31 in magnitude,
        so that s times it plus the increment stays inside int64."""
        mul, add = 1, 0
        for _ in range(draws):
            mul, add = (mul * 747796405) & _MASK, (add * 747796405 + 2891336453) & _MASK
        if mul >= 1 << 31:
            mul -= 1 << 32
        self.state = (self.state * mul + add) & _MASK


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


def sample_direction_hg(anisotropy, u1, u2):
    """Henyey-Greenstein phase sample (common.glsl.inc:259-276); (3, N)
    in the frame whose +Z is the incident direction. Keeps the
    reference's convention, in which the sampled mean cosine is
    -anisotropy relative to +Z."""
    g = anisotropy
    iso_z = 1.0 - 2.0 * u1
    g_safe = torch.where(torch.abs(g) < 1e-3, 1.0, g)
    s = (1.0 - g_safe * g_safe) / (1.0 + g_safe - 2.0 * g_safe * u1)
    aniso_z = -(1.0 + g_safe * g_safe - s * s) / (2.0 * g_safe)
    z = torch.clamp(torch.where(torch.abs(g) < 1e-3, iso_z, aniso_z), -1.0, 1.0)
    r = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
    phi = u2 * TAU
    return vec3(r * torch.cos(phi), r * torch.sin(phi), z)


# --- GGX microfacet model with anisotropic roughness ----------------------


def ggx_roughness_alpha(roughness, anisotropy):
    """2D GGX alpha (common.glsl.inc:281-288); (N,), (N,) -> (2, N)."""
    s = 1.0 - anisotropy
    alpha_x = roughness * roughness * torch.sqrt(2.0 / (1.0 + s * s))
    return torch.stack([alpha_x, s * alpha_x], dim=0)


def ggx_smith_g1(direction, alpha):
    """Smith G1 for anisotropic GGX (common.glsl.inc:294-301).
    direction: (3, N) in tangent space, alpha: (2, N) -> (N,)."""
    dx2 = direction[0] * direction[0]
    dy2 = direction[1] * direction[1]
    dz2 = direction[2] * direction[2]
    dz_safe = torch.clamp(dz2, min=EPSILON)
    tan_term = (alpha[0] * alpha[0] * dx2 + alpha[1] * alpha[1] * dy2) / dz_safe
    g1 = 2.0 / (1.0 + torch.sqrt(1.0 + tan_term))
    return torch.where(dz2 < EPSILON, torch.zeros_like(g1), g1)


def ggx_visible_normal(direction, alpha, u1, u2):
    """Heitz VNDF sampling of the GGX distribution (common.glsl.inc:306-346).
    direction: (3, N) view in tangent space, alpha: (2, N) -> (3, N)."""
    vz = safe_normalize(vec3(alpha[0] * direction[0], alpha[1] * direction[1],
                             direction[2]))
    len_sq = vz[0] * vz[0] + vz[1] * vz[1]
    inv_len = 1.0 / torch.sqrt(torch.clamp(len_sq, min=1e-20))
    zero = torch.zeros_like(len_sq)
    one = torch.ones_like(len_sq)
    vx = torch.where(len_sq > 0.0,
                     vec3(-vz[1] * inv_len, vz[0] * inv_len, zero),
                     vec3(one, zero, zero))
    vy = cross(vz, vx)

    r = torch.sqrt(u1)
    phi = TAU * u2
    s = 0.5 * (1.0 + vz[2])
    tx = r * torch.cos(phi)
    ty = ((1.0 - s) * torch.sqrt(torch.clamp(1.0 - tx * tx, min=0.0))
          + s * r * torch.sin(phi))
    tz = torch.sqrt(torch.clamp(1.0 - tx * tx - ty * ty, min=0.0))
    n = tx * vx + ty * vy + tz * vz
    return safe_normalize(vec3(alpha[0] * n[0], alpha[1] * n[1],
                               torch.clamp(n[2], min=0.0)))


def ggx_distribution(normal, alpha):
    """Anisotropic GGX NDF D(m) (common.glsl.inc:349-354); (N,)."""
    inv_ax = 1.0 / alpha[0]
    inv_ay = 1.0 / alpha[1]
    b = (normal[0] * normal[0] * inv_ax * inv_ax
         + normal[1] * normal[1] * inv_ay * inv_ay
         + normal[2] * normal[2])
    return 1.0 / (PI * alpha[0] * alpha[1] * b * b)
