# Copied from path_tracer_tpu/scene/bvh.py (numpy-only host code shared with the JAX package; the cache file is written atomically).
"""Binned-SAH BVH builder for triangle meshes (host side).

Numpy re-implementation of the reference's recursive builder
(reference src/scene/scene.cpp:435-599): 32 centroid bins per axis,
prefix/suffix half-area sweeps for split costs, in-place face
partitioning, leaf whenever splitting costs at least as much as not
splitting, children allocated at consecutive indices (traversal relies
on child+1). The per-node work is vectorized over faces with numpy.

Node array layout (matches packed_mesh_node semantics,
scene.glsl.inc:72-78):
  - node_min/node_max: (B, 3) float32 AABBs
  - a: (B,) int32 — child index for internal nodes, face_begin for leaves
  - b: (B,) int32 — 0 for internal nodes, face_end (exclusive) for leaves
Face indices refer to the builder's permuted face order.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

BINS = 32


@dataclass
class Bvh:
    node_min: np.ndarray   # (B, 3) float32
    node_max: np.ndarray   # (B, 3) float32
    a: np.ndarray          # (B,) int32
    b: np.ndarray          # (B,) int32
    face_order: np.ndarray  # (F,) int32 permutation applied to faces
    depth: int


def _half_area(lo, hi):
    size = np.maximum(hi - lo, 0.0)
    return size[..., 0] * size[..., 1] + size[..., 1] * size[..., 2] + size[..., 2] * size[..., 0]


def build_bvh_cached(tri_positions, max_leaf_faces=4, cache_dir=None,
                     spatial=False):
    """build_bvh with a content-addressed disk cache.

    The binned-SAH build is host-side numpy and this container has one
    vCPU; caching by triangle-buffer hash makes repeated scene compiles
    (tests, benches, profiling runs) effectively free. Mirrors the
    reference's persistence of prebuilt BVH nodes in .mesh sidecars
    (serializer.cpp:269-309).

    spatial=True requests the native SBVH (spatial splits; face_order
    may be longer than the face count and contain duplicates -- see
    native/bvh_builder.cpp build_sbvh). Requires the native library;
    silently falls back to object splits without it (identical hit
    results, fewer culling opportunities).
    """
    import hashlib
    import os

    tris = np.ascontiguousarray(np.asarray(tri_positions, np.float32))
    key = hashlib.sha1(tris.tobytes()).hexdigest()[:16]
    cache_dir = cache_dir or os.path.join(
        os.path.dirname(__file__), '..', '..', 'data', 'bvh_cache')
    variant = '-s' if spatial else ''
    path = os.path.join(cache_dir, f'{key}-{max_leaf_faces}{variant}.npz')
    if os.path.exists(path):
        z = np.load(path)
        return Bvh(z['node_min'], z['node_max'], z['a'], z['b'],
                   z['face_order'], int(z['depth']))
    # Prefer the native C++ builder (native/bvh_builder.cpp); fall back
    # to the numpy implementation below.
    from .native import build_bvh_native, build_sbvh_native
    native = (build_sbvh_native(tris, max_leaf_faces) if spatial
              else build_bvh_native(tris, max_leaf_faces))
    if native is None and spatial:
        native = build_bvh_native(tris, max_leaf_faces)
    if native is not None:
        bvh = Bvh(*native)
    else:
        bvh = build_bvh(tris, max_leaf_faces)
    os.makedirs(cache_dir, exist_ok=True)
    # Uncompressed: zlib on a 1.8M-tri tree costs ~16 s of the compile
    # for ~2x disk on a scratch cache (profiled in the round-4 terrain
    # compile breakdown).
    # Written under a private name and renamed, so a concurrent reader
    # never opens a half-written file.
    tmp = f'{path}.{os.getpid()}.tmp.npz'
    np.savez(tmp, node_min=bvh.node_min, node_max=bvh.node_max,
             a=bvh.a, b=bvh.b, face_order=bvh.face_order,
             depth=bvh.depth)
    os.replace(tmp, path)
    return bvh


def build_bvh(tri_positions, max_leaf_faces=4):
    """Build a binned-SAH BVH over triangles.

    tri_positions: (F, 3, 3) float32 vertex positions per face.
    Returns a Bvh; `face_order` maps new face slots to original indices.

    Leaves are capped at `max_leaf_faces` (the device traversal unrolls
    leaf intersection to a static bound): when the SAH would stop early,
    oversized nodes are median-split instead.
    """
    tris = np.asarray(tri_positions, np.float32)
    f = len(tris)
    if f == 0:
        return Bvh(
            node_min=np.zeros((1, 3), np.float32),
            node_max=np.zeros((1, 3), np.float32),
            a=np.zeros(1, np.int32),
            b=np.zeros(1, np.int32),
            face_order=np.zeros(0, np.int32),
            depth=0,
        )

    centroids = tris.mean(axis=1)
    tri_min = tris.min(axis=1)
    tri_max = tris.max(axis=1)

    order = np.arange(f, dtype=np.int32)

    node_min = [np.zeros(3, np.float32)]
    node_max = [np.zeros(3, np.float32)]
    node_a = [0]
    node_b = [f]
    max_depth = 0

    # Iterative DFS over (node_index, depth).
    stack = [(0, 0)]
    while stack:
        node_index, depth = stack.pop()
        max_depth = max(max_depth, depth)
        begin, end = node_a[node_index], node_b[node_index]
        idx = order[begin:end]
        count = end - begin

        lo = tri_min[idx].min(axis=0)
        hi = tri_max[idx].max(axis=0)
        node_min[node_index] = lo
        node_max[node_index] = hi

        cent = centroids[idx]
        best_cost = np.inf
        best_axis = -1
        best_position = 0.0

        for axis in range(3):
            c = cent[:, axis]
            cmin, cmax = float(c.min()), float(c.max())
            if cmin == cmax:
                continue
            scale = BINS / (cmax - cmin)
            bins = np.minimum((scale * (c - cmin)).astype(np.int32), BINS - 1)

            # Per-bin bounds and counts, vectorized.
            counts = np.bincount(bins, minlength=BINS)
            bin_min = np.full((BINS, 3), np.inf, np.float32)
            bin_max = np.full((BINS, 3), -np.inf, np.float32)
            np.minimum.at(bin_min, bins, tri_min[idx])
            np.maximum.at(bin_max, bins, tri_max[idx])

            # Prefix (left) and suffix (right) sweeps.
            left_min = np.minimum.accumulate(bin_min[:-1], axis=0)
            left_max = np.maximum.accumulate(bin_max[:-1], axis=0)
            left_count = np.cumsum(counts[:-1])
            right_min = np.minimum.accumulate(bin_min[::-1], axis=0)[::-1][1:]
            right_max = np.maximum.accumulate(bin_max[::-1], axis=0)[::-1][1:]
            right_count = np.cumsum(counts[::-1])[::-1][1:]

            left_area = np.where(left_count > 0, _half_area(left_min, left_max), 0.0)
            right_area = np.where(right_count > 0, _half_area(right_min, right_max), 0.0)
            cost = left_count * left_area + right_count * right_area

            i = int(np.argmin(cost))
            if cost[i] < best_cost:
                best_cost = float(cost[i])
                best_axis = axis
                interval = (cmax - cmin) / BINS
                best_position = cmin + interval * (i + 1)

        no_split_cost = count * float(_half_area(lo, hi))
        must_split = count > max_leaf_faces
        if (best_axis < 0 or best_cost >= no_split_cost) and not must_split:
            continue  # leaf: a/b already hold the face range

        split = 0
        if best_axis >= 0:
            mask = cent[:, best_axis] < best_position
            split = int(mask.sum())
        if split == 0 or split == count:
            if not must_split:
                continue
            # Degenerate distribution: median split by largest-extent axis.
            axis = int(np.argmax(hi - lo))
            part = np.argsort(cent[:, axis], kind='stable')
            split = count // 2
            order[begin:end] = idx[part]
        else:
            # Stable partition of the face order (left, then right block).
            order[begin:end] = np.concatenate([idx[mask], idx[~mask]])
        idx = order[begin:end]

        left = len(node_a)
        node_a[node_index] = left
        node_b[node_index] = 0
        node_min.extend([np.zeros(3, np.float32)] * 2)
        node_max.extend([np.zeros(3, np.float32)] * 2)
        node_a.extend([begin, begin + split])
        node_b.extend([begin + split, end])
        stack.append((left + 1, depth + 1))
        stack.append((left, depth + 1))

    return Bvh(
        node_min=np.stack(node_min).astype(np.float32),
        node_max=np.stack(node_max).astype(np.float32),
        a=np.asarray(node_a, np.int32),
        b=np.asarray(node_b, np.int32),
        face_order=order,
        depth=max_depth,
    )


def validate_bvh(bvh: Bvh, tri_positions, face_order_applied=False):
    """Property checks: every face inside its leaf bounds; ranges partition.

    tri_positions: original (F, 3, 3) array. Returns list of error strings.
    """
    tris = np.asarray(tri_positions, np.float32)
    if not face_order_applied:
        tris = tris[bvh.face_order]
    errors = []
    seen = np.zeros(len(tris), bool)
    for i in range(len(bvh.a)):
        if bvh.b[i] > 0:  # leaf
            begin, end = int(bvh.a[i]), int(bvh.b[i])
            seen[begin:end] = True
            t = tris[begin:end]
            if len(t) and (
                (t.min(axis=(0, 1)) < bvh.node_min[i] - 1e-4).any()
                or (t.max(axis=(0, 1)) > bvh.node_max[i] + 1e-4).any()
            ):
                errors.append(f'leaf {i}: faces outside bounds')
        else:
            c = int(bvh.a[i])
            for child in (c, c + 1):
                if (bvh.node_min[child] < bvh.node_min[i] - 1e-4).any() or \
                   (bvh.node_max[child] > bvh.node_max[i] + 1e-4).any():
                    errors.append(f'node {i}: child {child} escapes bounds')
    if len(tris) and not seen.all():
        errors.append('not all faces covered by leaves')
    return errors
