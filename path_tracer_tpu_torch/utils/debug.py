"""Introspection tooling: spectrum curves and BVH structure dumps.

Port of path_tracer_tpu/utils/debug.py, the headless counterparts of the
reference editor's parametric-spectrum plot window and its TLAS tree
dump, also reachable from the CLI:

    python -m path_tracer_tpu_torch spectrum 0.2 0.5 0.8 [--png plot.png]
    python -m path_tracer_tpu_torch bvhdump scene.json [--depth 4]

The spectrum functions evaluate the port's core/spectrum on `device`
(the card unless the caller asks for the CPU) and return numpy arrays.
The BVH functions read a PackedScene's node and leaf tables, which live
on the compile's device: each brings what it reads to the host once.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from ..core.constants import CIE_LAMBDA_MAX, CIE_LAMBDA_MIN
from ..core.spectrum import (
    observe_parametric_spectrum_under_d65,
    sample_parametric_spectrum,
    xyz_to_srgb,
)
from ..core.uplift import rgb_to_coefficients
from ..ops.trace_inst import INST_BASE
from ..scene.bvh8 import AXIS_LANE, LEAF_ROW_LIMIT, META_LANE
from .image import save_png


def spectrum_curve(rgb, samples=128, device='cuda'):
    """The uplifted reflectance spectrum of an sRGB color.

    Returns (wavelengths_nm (S,), reflectance (S,)) as numpy arrays --
    the curve the reference plots across the CIE range.
    """
    beta = rgb_to_coefficients(np.asarray(rgb, np.float32))
    lam_nm = np.linspace(CIE_LAMBDA_MIN, CIE_LAMBDA_MAX, samples)
    values = sample_parametric_spectrum(
        torch.as_tensor(beta.reshape(3, 1), device=device),
        torch.as_tensor(lam_nm.astype(np.float32)[None, :], device=device))
    return lam_nm, values[0].cpu().numpy()


def ascii_plot(xs, ys, width=72, height=16, label=''):
    """Terminal plot of a curve (y clipped to [0, 1])."""
    ys = np.clip(np.asarray(ys, np.float64), 0.0, 1.0)
    cols = np.linspace(0, len(xs) - 1, width).astype(int)
    rows = (ys[cols] * (height - 1) + 0.5).astype(int)
    grid = [[' '] * width for _ in range(height)]
    for c, r in enumerate(rows):
        grid[height - 1 - r][c] = '*'
    lines = [f'{label}'] if label else []
    lines.append('1.0 ' + '-' * width)
    lines += ['    |' + ''.join(row) for row in grid]
    lines.append('0.0 ' + '-' * width)
    lines.append(f'    {xs[0]:.0f} nm{"":{width - 12}}{xs[-1]:.0f} nm')
    return '\n'.join(lines)


def spectrum_report(rgb, device='cuda'):
    """Round-trip check: RGB -> spectrum -> observed-under-D65 RGB."""
    rgb = np.asarray(rgb, np.float32)
    beta = rgb_to_coefficients(rgb)
    spectrum4 = np.concatenate([beta, [1.0]]).astype(np.float32)
    observed = xyz_to_srgb(observe_parametric_spectrum_under_d65(
        torch.as_tensor(spectrum4[:, None], device=device)))[:, 0]
    observed = observed.cpu().numpy()
    lam, values = spectrum_curve(rgb, device=device)
    return dict(rgb=rgb.tolist(), beta=beta.tolist(),
                observed_rgb=observed.tolist(),
                roundtrip_error=float(np.abs(observed - rgb).max()),
                lambda_nm=lam, reflectance=values)


def plot_spectrum_png(rgb, path, samples=256, device='cuda'):
    """Write a simple PNG line plot of the uplifted spectrum."""
    lam, values = spectrum_curve(rgb, samples, device=device)
    w, h = samples, 160
    img = np.full((h, w, 3), 0.08, np.float32)
    ys = np.clip(values, 0.0, 1.0)
    for x in range(w):
        y = int((1.0 - ys[x]) * (h - 1))
        img[y, x] = [1.0, 1.0, 1.0]
        img[y:, x] = np.maximum(img[y:, x], np.asarray(rgb, np.float32) * 0.35)
    save_png(path, img)


def _packet_nodes(packed):
    """The node table the packet kernel actually traverses, on the host:
    the two-level table when built (TLAS + object-space mesh trees), else
    the world-flattened one."""
    if packed.inst_nodes.shape[0] > 1:
        return packed.inst_nodes.cpu().numpy()
    return packed.wide_nodes_g.cpu().numpy()


def dump_wide_bvh(packed, max_depth=None, file=None):
    """Textual dump of the packet-kernel BVH (PrintShapeNode analog).

    Prints one line per wide node with bounds, child kinds and leaf
    sizes; the tree these rows describe is what the traversal kernels
    walk (ops/trace_inst.py / ops/trace_packet.py). In the two-level
    table, metas >= INST_BASE are instance tags (TLAS leaves).
    """
    out = file or sys.stdout
    nodes = _packet_nodes(packed)
    inst_rows = None

    def visit(w, depth):
        nonlocal inst_rows
        if max_depth is not None and depth > max_depth:
            return
        meta = nodes[w, META_LANE:META_LANE + 8]
        axis = int(nodes[w, AXIS_LANE])
        kids = []
        for c in range(8):
            m = meta[c]
            if m == 0.0:  # empty slot (node 0 is the root, never a child)
                continue
            if m >= INST_BASE:
                kids.append(('inst', int(m) - INST_BASE))
            elif m >= 0:
                kids.append(('node', int(m)))
            else:
                kids.append(('leaf', int(-m) % LEAF_ROW_LIMIT,
                             int(-m) // LEAF_ROW_LIMIT))
        lo = [nodes[w, 8 * ax:8 * ax + 8].min() for ax in range(3)]
        hi = [nodes[w, 24 + 8 * ax:24 + 8 * ax + 8].max() for ax in range(3)]
        pad = '  ' * depth
        print(f'{pad}node {w}: axis={"xyz"[axis]} '
              f'bounds=({lo[0]:.2f},{lo[1]:.2f},{lo[2]:.2f})..'
              f'({hi[0]:.2f},{hi[1]:.2f},{hi[2]:.2f}) '
              f'children={len(kids)}', file=out)
        for kid in kids:
            if kid[0] == 'leaf':
                print(f'{pad}  leaf @row {kid[1]}: {kid[2]} tris', file=out)
            elif kid[0] == 'inst':
                if inst_rows is None:
                    inst_rows = packed.inst_rows.cpu().numpy()
                root = int(inst_rows[kid[1], 12])
                print(f'{pad}  instance {kid[1]} -> mesh root {root}',
                      file=out)
                visit(root, depth + 1)
            else:
                visit(kid[1], depth + 1)

    visit(0, 0)


def bvh_statistics(packed):
    """Aggregate structure stats of the packet-kernel BVH."""
    nodes = _packet_nodes(packed)
    meta = nodes[:, META_LANE:META_LANE + 8]
    leaves = meta[meta < 0]
    counts = (-leaves).astype(np.int64) // LEAF_ROW_LIMIT
    interior_children = int((meta > 0).sum())
    return dict(
        wide_nodes=int(nodes.shape[0]),
        leaves=int(leaves.size),
        triangles=int(counts.sum()),
        mean_leaf_size=float(counts.mean()) if counts.size else 0.0,
        mean_fanout=float((interior_children + leaves.size)
                          / max(nodes.shape[0], 1)),
        tri_rows=int(max(packed.inst_tris.shape[0],
                         packed.wide_tris_g.shape[0])),
    )
