"""Real-time preview raycaster: false-color modes + mouse picking.

Port of path_tracer_tpu/viewer/preview.py (the reference's preview
renderer, preview_render.{cpp,glsl}): one primary ray per pixel through
the editor camera, resolved to one of the debug visualization modes
(base color / shaded / normal / material-ID / primitive-ID false
colors, two traversal-cost heatmaps), with selection highlighting and a
pick query that returns the shape index under the cursor.

Every trace rides `ops.intersect.trace`. On the card the mesh rays go
through the packet mode's CUDA kernel, as the JAX package's go through
its Pallas kernel on the TPU; on the CPU they take the portable BVH2
traversal, as the JAX package's do off the TPU, so that the CPU frames
(the primitive ids and the heatmaps' traversal counts) are the JAX
package's.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.constants import HIT_TIME_LIMIT, SHAPE_INDEX_NONE, TEXTURE_INDEX_NONE
from ..core.spectrum import observe_parametric_spectrum_under_d65, xyz_to_srgb
from ..core.vec import normalize, transform_vector, vec3
from ..models.common import col, sample_texture
from ..ops import trace_inst
from ..ops.intersect import SceneLayout, trace

PREVIEW_RENDER_MODE_BASE_COLOR = 0
PREVIEW_RENDER_MODE_BASE_COLOR_SHADED = 1
PREVIEW_RENDER_MODE_NORMAL = 2
PREVIEW_RENDER_MODE_MATERIAL_INDEX = 3
PREVIEW_RENDER_MODE_PRIMITIVE_INDEX = 4
PREVIEW_RENDER_MODE_MESH_COMPLEXITY = 5
PREVIEW_RENDER_MODE_SCENE_COMPLEXITY = 6

# 20-color false-color palette (preview_render.glsl COLORS table role).
_PALETTE = np.asarray([
    [0.90, 0.10, 0.29], [0.24, 0.71, 0.29], [1.00, 0.88, 0.10],
    [0.00, 0.51, 0.78], [0.96, 0.51, 0.19], [0.57, 0.12, 0.71],
    [0.27, 0.94, 0.94], [0.94, 0.20, 0.90], [0.82, 0.96, 0.24],
    [0.98, 0.75, 0.83], [0.00, 0.50, 0.50], [0.90, 0.75, 1.00],
    [0.67, 0.43, 0.16], [1.00, 0.98, 0.78], [0.50, 0.00, 0.00],
    [0.67, 1.00, 0.76], [0.50, 0.50, 0.00], [1.00, 0.84, 0.71],
    [0.00, 0.00, 0.50], [0.50, 0.50, 0.50],
], np.float32)


def shape_entities(scene):
    """Entities in packed-shape-index order (the scene compiler's
    flattening walk): shape index i from a pick/trace corresponds to the
    i-th entity yielded here. Unlike the JAX package's, it also skips a
    mesh instance whose mesh has no faces, which packs no shape slot
    either (scene.compile.entity_packs_shape)."""
    from ..scene.compile import entity_packs_shape

    for entity, _ in scene.walk_entities_with_transform():
        if entity_packs_shape(entity):
            yield entity


def _camera_on(packed, device, camera_world):
    """camera_world (numpy or tensor) as a float32 tensor on `device`,
    where the packed scene must live."""
    device = torch.device(device)
    have = packed.camera_model.device
    if have.type != device.type:
        raise ValueError(f'the packed scene lives on {have}, not on {device}')
    return torch.as_tensor(np.asarray(camera_world, np.float32)
                           if not torch.is_tensor(camera_world)
                           else camera_world, device=have)


def _preview_rays(width, height, camera_world):
    """One centered primary ray per pixel through a simple pinhole
    (preview_render.glsl:98-106: unit sensor at z=-1, aspect-corrected)."""
    dev = camera_world.device
    aspect = width / height
    xs = (torch.arange(width, dtype=torch.float32, device=dev) + 0.5) / width
    ys = (torch.arange(height, dtype=torch.float32, device=dev) + 0.5) / height
    gy, gx = torch.meshgrid(ys, xs, indexing='ij')
    near_x = (gx.reshape(-1) - 0.5) * aspect
    near_y = 0.5 - gy.reshape(-1)
    d = normalize(vec3(near_x, near_y, torch.full_like(near_x, -1.0)))
    n = width * height
    origin = camera_world[:3, 3][:, None].expand(3, n).contiguous()
    direction = normalize(transform_vector(camera_world, d))
    return origin, direction


def kernel_counters_apply(layout: SceneLayout, origin):
    """Whether the heatmaps add the traversal kernel's own per-ray
    counters: on the card, for a scene with mesh instances in 'inst'
    mode (the JAX package adds its packet counters on the TPU alike).
    On the CPU the heat is the portable traversal's `complexity` only,
    as in the JAX package."""
    return (origin.is_cuda and bool(layout.instance_slots)
            and layout.packet_mode == 'inst')


def complexity_heat(complexity, mode, stats=None):
    """(N,) float32 traversal cost of a heatmap mode: hit['complexity']
    plus, given inst_trace's (5, N) per-ray counters (interior pops,
    leaf pops, leaf rows, instance entries, triangles), the pops (rows
    0 + 1) and, for scene complexity, the instance entries (row 3).

    The counts are per ray: they cannot equal the JAX package's on the
    TPU, which adds per-packet totals broadcast to the packet's lanes
    (and per packet group, stats='lanes')."""
    heat = complexity.to(torch.float32)
    if stats is not None:
        pops = (stats[0] + stats[1]).to(torch.float32)
        if mode == PREVIEW_RENDER_MODE_SCENE_COMPLEXITY:
            pops = pops + stats[3].to(torch.float32)
        heat = heat + pops
    return heat


def render_preview(packed, layout: SceneLayout, width, height,
                   camera_world, mode=PREVIEW_RENDER_MODE_BASE_COLOR_SHADED,
                   selected_shape=-1, brightness=1.0, device='cuda'):
    """Render one preview frame -> (H, W, 3) float32 on `device`, where
    `packed` must live. camera_world: (4, 4) world-from-camera matrix
    (numpy or tensor)."""
    camera_world = _camera_on(packed, device, camera_world)
    dev = camera_world.device
    origin, direction = _preview_rays(width, height, camera_world)
    hit = trace(packed, layout, origin, direction, use_packet=origin.is_cuda)

    n = width * height
    miss = hit['shape'] == SHAPE_INDEX_NONE

    if mode in (PREVIEW_RENDER_MODE_BASE_COLOR,
                PREVIEW_RENDER_MODE_BASE_COLOR_SHADED):
        m = packed.materials
        beta = col(m.base_spectrum, hit['material'])         # (3, N)
        color = xyz_to_srgb(observe_parametric_spectrum_under_d65(beta))
        if layout.materials_textured:
            tex = col(m.base_texture, hit['material'])
            tex_beta = sample_texture(packed, tex, hit['uv'],
                                      layout.atlas_size)[:3]
            tex_color = xyz_to_srgb(
                observe_parametric_spectrum_under_d65(tex_beta))
            color = torch.where(tex == TEXTURE_INDEX_NONE, color,
                                color * tex_color)
        if mode == PREVIEW_RENDER_MODE_BASE_COLOR_SHADED:
            ndotv = torch.sum(hit['normal'] * -direction, dim=0)
            color = color * ndotv
        # Skybox: the observed color of the sky spectrum.
        if layout.has_skybox_texture:
            idx = packed.skybox_texture_index.expand(n)
            phi = torch.atan2(direction[1], direction[0])
            theta = torch.asin(torch.clamp(direction[2], -1.0, 1.0))
            uv = torch.stack([0.5 + phi / (2 * np.pi), 0.5 + theta / np.pi], 0)
            sky_spec = sample_texture(packed, idx, uv, layout.atlas_size)
        else:
            sky_spec = torch.tensor([0.0, 0.0, 100.0, 1.0],
                                    device=dev)[:, None].expand(4, n)
        sky = xyz_to_srgb(observe_parametric_spectrum_under_d65(sky_spec))
        color = torch.where(miss, sky, color)
    elif mode == PREVIEW_RENDER_MODE_NORMAL:
        color = torch.where(miss, 0.5 * (1.0 - direction),
                            0.5 * (hit['normal'] + 1.0))
    elif mode in (PREVIEW_RENDER_MODE_MATERIAL_INDEX,
                  PREVIEW_RENDER_MODE_PRIMITIVE_INDEX):
        palette = torch.as_tensor(_PALETTE.T.copy(), device=dev)
        key = hit['material' if mode == PREVIEW_RENDER_MODE_MATERIAL_INDEX
                  else 'primitive']
        color = torch.where(miss, torch.zeros(3, n, device=dev),
                            palette[:, (key % 20).long()])
    elif mode in (PREVIEW_RENDER_MODE_MESH_COMPLEXITY,
                  PREVIEW_RENDER_MODE_SCENE_COMPLEXITY):
        # Green traversal-cost heatmap (preview_render.glsl:154-163). As
        # in the JAX package, the counters are traced with
        # t_in = HIT_TIME_LIMIT, not the analytic shapes' clipped time.
        stats = None
        if kernel_counters_apply(layout, origin):
            *_, stats = trace_inst.inst_trace(
                packed.inst_nodes, packed.inst_tris, packed.inst_rows,
                origin, direction,
                torch.full((n,), HIT_TIME_LIMIT, dtype=torch.float32,
                           device=dev),
                layout.tlas_rows, stats=True)
        heat = complexity_heat(hit['complexity'], mode, stats) / 256.0
        zeros = torch.zeros_like(heat)
        color = torch.stack([zeros, heat, zeros], dim=0)
    else:
        raise ValueError(f'unknown preview mode {mode}')

    # Selection tint (preview_render.glsl:166-167).
    selected = hit['shape'] == selected_shape
    tint = torch.tensor([[1.0], [0.5], [0.5]], device=dev)
    color = color * torch.where(selected, tint, torch.ones_like(tint))
    color = torch.clamp(color * brightness, 0.0, 1.0)
    return color.reshape(3, height, width).permute(1, 2, 0)


def pick(packed, layout: SceneLayout, width, height, camera_world, x, y,
         device='cuda'):
    """Mouse picking: shape index under pixel (x, y), or -1.

    The reference writes the hovered shape index to a query SSBO and
    reads it back (preview_render.cpp:96-116); here it is one
    single-ray trace on `device`, where `packed` must live."""
    camera_world = _camera_on(packed, device, camera_world)
    dev = camera_world.device
    aspect = width / height
    xy = torch.tensor([x, y], dtype=torch.float32, device=dev)
    near_x = ((xy[0] + 0.5) / width - 0.5) * aspect
    near_y = 0.5 - (xy[1] + 0.5) / height
    d = normalize(vec3(near_x.reshape(1), near_y.reshape(1),
                       torch.full((1,), -1.0, device=dev)))
    origin = camera_world[:3, 3][:, None].contiguous()
    direction = normalize(transform_vector(camera_world, d))
    shape = int(trace(packed, layout, origin, direction,
                      use_packet=origin.is_cuda)['shape'][0])
    return -1 if shape == SHAPE_INDEX_NONE else shape
