"""Shared material machinery: texture sampling and attribute fetch.

Port of path_tracer_tpu/models/common.py (scene.glsl.inc:181-302) for
the material models the port dispatches. Channels-first: UVs are
(2, N), spectra (3/4, N); material columns are gathered along the
trailing material axis into a `ctx` dict once per scatter.
"""

from __future__ import annotations

import torch

from ..core.constants import TEXTURE_FLAG_FILTER_NEAREST, TEXTURE_INDEX_NONE
from ..core.spectrum import sample_parametric_spectrum


def _bilinear(c00, c10, c01, c11, fx, fy):
    return ((c00 * (1 - fx) + c10 * fx) * (1 - fy)
            + (c01 * (1 - fx) + c11 * fx) * fy)


def _nearest_of_quad(c00, c10, c01, c11, x, y, x0c, y0c, size):
    xn = torch.clamp(torch.round(x).to(torch.int32), 0, size - 1)
    yn = torch.clamp(torch.round(y).to(torch.int32), 0, size - 1)
    sx = (xn > x0c)[..., None]
    sy = (yn > y0c)[..., None]
    return torch.where(sx & sy, c11,
                       torch.where(sx, c10, torch.where(sy, c01, c00)))


def sample_texture(packed, texture_index, uv, atlas_size,
                   filter_modes=(True, True), use_quad=False, meta=None):
    """Sample the texture atlas (scene.glsl.inc:181-205).

    texture_index: (N,) int32 (TEXTURE_INDEX_NONE lanes give garbage;
    callers mask); uv: (2, N); atlas_size: the layer edge length.
    Returns (4, N). Per-texture placement with wrap, then nearest or
    bilinear filtering by flag. `meta` is an (8, 1) column for callers
    with one texture (the skybox). use_quad picks the table a bilinear
    tap reads: 'pair' (bf16 [c(x,y) | c(x,y+1)] rows, two gathers; the
    mode of atlases too big for the quad table, such as the textured
    viking hall's 2048^2 atlas), 'quad' (f32 2x2 rows, one gather) or
    False (four corner gathers of the flat atlas).
    """
    if meta is None:
        safe_idx = torch.where(texture_index == TEXTURE_INDEX_NONE,
                               torch.zeros_like(texture_index), texture_index)
        meta = packed.texture_meta[safe_idx].T  # (8, N)
    pmin = meta[0:2]
    pmax = meta[2:4]
    layer = meta[4].to(torch.int32)
    flags = meta[5].to(torch.int32)

    frac_uv = uv - torch.floor(uv)
    u = pmin[0] + (pmax[0] - pmin[0]) * frac_uv[0]
    v = pmin[1] + (pmax[1] - pmin[1]) * frac_uv[1]
    size = int(atlas_size)
    x = u * size - 0.5
    y = v * size - 0.5
    has_bilinear, has_nearest = filter_modes
    linear = nearest = None

    if use_quad in ('pair', 'quad'):
        x0 = torch.floor(x).to(torch.int32)
        y0 = torch.floor(y).to(torch.int32)
        # A zero fraction where floor clips below 0 reproduces the
        # 4-gather path's double-clamped corners exactly.
        fx = torch.where(x0 < 0, torch.zeros_like(x), x - x0)[..., None]
        fy = torch.where(y0 < 0, torch.zeros_like(y), y - y0)[..., None]
        x0c = torch.clamp(x0, 0, size - 1)
        y0c = torch.clamp(y0, 0, size - 1)
        if use_quad == 'pair':
            x1c = torch.clamp(x0 + 1, 0, size - 1)
            base_i = (layer * size + y0c) * size
            pl = packed.atlas_pair[base_i + x0c].float()   # (N, 8)
            pr = packed.atlas_pair[base_i + x1c].float()
            c00, c01 = pl[..., 0:4], pl[..., 4:8]
            c10, c11 = pr[..., 0:4], pr[..., 4:8]
        else:
            q = packed.atlas_quad[(layer * size + y0c) * size + x0c]  # (N, 16)
            c00, c10, c01, c11 = q[..., 0:4], q[..., 4:8], q[..., 8:12], q[..., 12:16]
        if has_bilinear:
            linear = _bilinear(c00, c10, c01, c11, fx, fy)
        if has_nearest:
            nearest = _nearest_of_quad(c00, c10, c01, c11, x, y, x0c, y0c, size)
    else:
        def fetch(px, py):
            px = torch.clamp(px, 0, size - 1)
            py = torch.clamp(py, 0, size - 1)
            return packed.atlas[(layer * size + py) * size + px]  # (N, 4)

        if has_bilinear:
            x0 = torch.floor(x).to(torch.int32)
            y0 = torch.floor(y).to(torch.int32)
            fx = (x - x0)[..., None]
            fy = (y - y0)[..., None]
            linear = _bilinear(fetch(x0, y0), fetch(x0 + 1, y0),
                               fetch(x0, y0 + 1), fetch(x0 + 1, y0 + 1), fx, fy)
        if has_nearest:
            nearest = fetch(torch.round(x).to(torch.int32),
                            torch.round(y).to(torch.int32))

    if not has_nearest:
        return linear.T
    if not has_bilinear:
        return nearest.T
    use_nearest = ((flags & TEXTURE_FLAG_FILTER_NEAREST) != 0)[..., None]
    return torch.where(use_nearest, nearest, linear).T


def texturable_reflectance(packed, beta, texture_index, lam, uv, textured,
                           atlas_size, filter_modes=(True, True),
                           use_quad=False):
    """Spectral reflectance of a texturable color attribute
    (scene.glsl.inc:276-290). beta: (3, N), lam: (4, N) -> (4, N).
    Untextured scenes (`textured` False) skip the taps."""
    value = sample_parametric_spectrum(beta, lam)
    if not textured:
        return value
    has_texture = texture_index != TEXTURE_INDEX_NONE
    tex_beta = sample_texture(packed, texture_index, uv, atlas_size,
                              filter_modes, use_quad)[:3]
    tex_value = sample_parametric_spectrum(tex_beta, lam)
    return torch.where(has_texture, value * tex_value, value)


def col(table_column, i):
    """Gather a material column ((M,) or (C, M)) at lane indices i."""
    return table_column[..., i]


def fetch_ctx(packed, material_index, lam, uv, exterior_ior,
              textured=True, atlas_size=8, filter_modes=(True, True),
              textured_attrs=('base',), use_quad=False):
    """Gather the material attributes the basic diffuse model reads for
    the given lanes (material_index: (N,) slots into the table)."""
    m = packed.materials
    i = material_index
    return dict(
        type=col(m.type, i),
        lam=lam,
        uv=uv,
        exterior_ior=exterior_ior,
        base_reflectance=texturable_reflectance(
            packed, col(m.base_spectrum, i), col(m.base_texture, i), lam, uv,
            textured and 'base' in textured_attrs, atlas_size, filter_modes,
            use_quad),
    )
