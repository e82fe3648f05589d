# Copied from path_tracer_tpu/scene/native.py (host code shared with the JAX package; the library is built into build/native/).
"""ctypes bindings for the native (C++) scene-compiler components.

The reference's scene compiler is C++ (scene.cpp); the TPU framework
keeps its host hot paths native too: the binned-SAH BVH builder lives in
native/bvh_builder.cpp, compiled on first use with g++ (no pybind11 in
this image -- plain C ABI + ctypes). scene/bvh.py transparently uses it
and falls back to the numpy builder when no compiler is available.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_LOCK = threading.Lock()
_LIB = None
_TRIED = False

_SRC = os.path.join(os.path.dirname(__file__), '..', '..', 'native',
                    'bvh_builder.cpp')
# The port builds its own copy of the library into the repository's
# build directory (listed in .gitignore), leaving native/ untouched.
_SO = os.path.join(os.path.dirname(__file__), '..', '..', 'build', 'native',
                   'libbvh_builder.so')


def _load():
    global _LIB, _TRIED
    with _LOCK:
        if _LIB is not None or _TRIED:
            return _LIB
        _TRIED = True
        src = os.path.abspath(_SRC)
        so = os.path.abspath(_SO)
        try:
            if (not os.path.exists(so)
                    or os.path.getmtime(so) < os.path.getmtime(src)):
                # Build to a private name and rename, so concurrent
                # processes never load a half-written library.
                os.makedirs(os.path.dirname(so), exist_ok=True)
                tmp = f'{so}.{os.getpid()}.tmp'
                subprocess.run(
                    ['g++', '-O3', '-march=native', '-shared', '-fPIC',
                     '-o', tmp, src],
                    check=True, capture_output=True)
                os.replace(tmp, so)
            lib = ctypes.CDLL(so)
            lib.build_bvh.restype = ctypes.c_int
            lib.build_bvh.argtypes = [
                ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int,
                ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
                ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
                ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
                ctypes.POINTER(ctypes.c_int),
            ]
            lib.build_sbvh.restype = ctypes.c_int
            lib.build_sbvh.argtypes = [
                ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int,
                ctypes.c_int,
                ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
                ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
                ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
                ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
            ]
            _LIB = lib
        except (OSError, subprocess.CalledProcessError):
            _LIB = None
        return _LIB


def available():
    return _load() is not None


def build_bvh_native(tri_positions, max_leaf_faces=4):
    """Native binned-SAH build; returns the same tuple layout as
    scene.bvh.Bvh fields, or None if the native library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    tris = np.ascontiguousarray(np.asarray(tri_positions, np.float32))
    f = len(tris)
    max_nodes = max(2 * f, 1)
    node_min = np.empty((max_nodes, 3), np.float32)
    node_max = np.empty((max_nodes, 3), np.float32)
    node_a = np.empty(max_nodes, np.int32)
    node_b = np.empty(max_nodes, np.int32)
    face_order = np.empty(max(f, 1), np.int32)
    node_count = ctypes.c_int(0)
    depth = ctypes.c_int(0)

    def ptr(arr, typ):
        return arr.ctypes.data_as(ctypes.POINTER(typ))

    lib.build_bvh(
        ptr(tris, ctypes.c_float), f, int(max_leaf_faces),
        ptr(node_min, ctypes.c_float), ptr(node_max, ctypes.c_float),
        ptr(node_a, ctypes.c_int), ptr(node_b, ctypes.c_int),
        ptr(face_order, ctypes.c_int),
        ctypes.byref(node_count), ctypes.byref(depth))

    n = node_count.value
    return (node_min[:n].copy(), node_max[:n].copy(), node_a[:n].copy(),
            node_b[:n].copy(), face_order[:f].copy(), depth.value)


def build_sbvh_native(tri_positions, max_leaf_faces=4, frag_budget=1.5):
    """Native SBVH build (binned spatial splits, native/bvh_builder.cpp
    build_sbvh). Fragments straddling a chosen split plane are clipped
    and duplicated, up to frag_budget x the face count; face_order may
    therefore be LONGER than the input and contain repeats. Returns the
    scene.bvh.Bvh field tuple, or None if the native library is
    unavailable (callers fall back to the object-split builder -- same
    results, fewer culling opportunities).
    """
    lib = _load()
    if lib is None:
        return None
    tris = np.ascontiguousarray(np.asarray(tri_positions, np.float32))
    f = len(tris)
    max_frags = int(f * frag_budget) + 64
    max_nodes = max(2 * max_frags, 1)
    node_min = np.empty((max_nodes, 3), np.float32)
    node_max = np.empty((max_nodes, 3), np.float32)
    node_a = np.empty(max_nodes, np.int32)
    node_b = np.empty(max_nodes, np.int32)
    face_order = np.empty(max(max_frags, 1), np.int32)
    node_count = ctypes.c_int(0)
    depth = ctypes.c_int(0)
    frag_count = ctypes.c_int(0)

    def ptr(arr, typ):
        return arr.ctypes.data_as(ctypes.POINTER(typ))

    rc = lib.build_sbvh(
        ptr(tris, ctypes.c_float), f, int(max_leaf_faces), max_frags,
        ptr(node_min, ctypes.c_float), ptr(node_max, ctypes.c_float),
        ptr(node_a, ctypes.c_int), ptr(node_b, ctypes.c_int),
        ptr(face_order, ctypes.c_int),
        ctypes.byref(node_count), ctypes.byref(depth),
        ctypes.byref(frag_count))
    if rc != 0:
        return None

    n = node_count.value
    nf = frag_count.value if f else 0
    return (node_min[:n].copy(), node_max[:n].copy(), node_a[:n].copy(),
            node_b[:n].copy(), face_order[:nf].copy(), depth.value)
