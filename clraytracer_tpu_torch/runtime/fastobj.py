"""Native-backed BVH building (returns None when the library is missing,
and the builder then takes the numpy version, as the JAX package does)."""

from __future__ import annotations

import ctypes

import numpy as np

from clraytracer_tpu_torch.runtime.build import native_lib


def _f32p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _i32p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def _longp(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_long))


def build_bvh_native(
    v0: np.ndarray,
    v1: np.ndarray,
    v2: np.ndarray,
    mesh_tri_counts,
    min_leaf: int = 1,
    max_leaf: int | None = None,
):
    """Native binned-SAH build; returns a bvh.BVHBuild or None if
    unavailable/overflowed."""
    from clraytracer_tpu_torch.bvh import BVHBuild

    lib = native_lib()
    if lib is None:
        return None
    T = v0.shape[0]
    counts = np.asarray(mesh_tri_counts, np.int64)
    max_nodes = 2 * T + 2 * len(counts) + 16
    node_min = np.zeros((max_nodes, 3), np.float32)
    node_max = np.zeros((max_nodes, 3), np.float32)
    left_first = np.zeros(max_nodes, np.int32)
    tri_count = np.zeros(max_nodes, np.int32)
    roots = np.zeros(len(counts), np.int32)
    perm = np.zeros(T, np.int32)
    v0c = np.ascontiguousarray(v0, np.float32)
    v1c = np.ascontiguousarray(v1, np.float32)
    v2c = np.ascontiguousarray(v2, np.float32)
    n = lib.clrt_build_bvh(
        _f32p(v0c), _f32p(v1c), _f32p(v2c), T,
        _longp(counts), len(counts), min_leaf, 0 if max_leaf is None else max_leaf,
        _f32p(node_min), _f32p(node_max), _i32p(left_first), _i32p(tri_count),
        _i32p(roots), _i32p(perm), max_nodes,
    )
    if n < 0:
        return None
    # epsilon padding as in the numpy builder (flat-box slab robustness)
    extent = float(np.max(node_max[:n] - node_min[:n], initial=1.0))
    pad = np.float32(max(extent, 1.0) * 1e-5)
    return BVHBuild(
        node_min=node_min[:n] - pad,
        node_max=node_max[:n] + pad,
        left_first=left_first[:n],
        tri_count=tri_count[:n],
        roots=roots,
        perm=perm,
    )
