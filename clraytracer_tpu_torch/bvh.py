"""Binned-SAH BVH construction, level-synchronous and fully vectorized
(numpy; a copy of the JAX package's portable builder).

Re-design of the reference's recursive SSE builder (BVH.cpp:103-255):

* Same algorithm: per node, 8 bins x 3 axes over triangle centroids, bin AABBs
  grown by full triangles, prefix/suffix area sweeps, best-plane selection,
  split-vs-leaf decision by SAH cost against the parent cost
  (BVH.cpp:173-176), children allocated adjacently (right = left + 1 — the
  traversal relies on this, kernel_main.cl:142-143), triangles partitioned in
  place per node.
* Different execution shape: instead of one node at a time down a recursion,
  every node of a tree *level* is processed at once with numpy segment
  reductions (``reduceat``) and one stable ``lexsort`` partition per level —
  the vectorized equivalent of the reference's "SIMD + custom swap" tuning
  (556 ms, BVH.cpp:220-222) that also scales to >1M-triangle scenes.

One root per mesh into a shared node pool (BVH.cpp:239-252).
"""

from __future__ import annotations

import dataclasses

import numpy as np

_BINS = 8
_BIG = np.float32(1e30)


@dataclasses.dataclass
class BVHBuild:
    """Host-side build result; ``perm`` reorders the original triangle arrays
    into leaf-contiguous order (the reference reorders its Tri arena in
    place, BVH.cpp:179-198)."""

    node_min: np.ndarray  # [N, 3] f32
    node_max: np.ndarray  # [N, 3] f32
    left_first: np.ndarray  # [N] i32 (child index for inner, tri start for leaf)
    tri_count: np.ndarray  # [N] i32 (0 for inner nodes)
    roots: np.ndarray  # [M] i32
    perm: np.ndarray  # [T] i32


def _half_area(bmin: np.ndarray, bmax: np.ndarray) -> np.ndarray:
    """Half surface area ex*ey + ey*ez + ez*ex (reference aabb::area,
    BVH.cpp:41-46). Empty boxes (min>max) produce large finite values that
    are masked by zero counts, as in the reference."""
    e = (bmax - bmin).astype(np.float64)
    return e[..., 0] * e[..., 1] + e[..., 1] * e[..., 2] + e[..., 2] * e[..., 0]


def build_bvh(
    v0: np.ndarray,
    v1: np.ndarray,
    v2: np.ndarray,
    mesh_tri_counts: np.ndarray | list[int],
    min_leaf: int = 1,
    max_leaf: int | None = None,
    max_depth: int = 64,
) -> BVHBuild:
    """Build one BVH per mesh over the shared triangle arena.

    ``mesh_tri_counts[m]`` triangles belong to mesh ``m``; meshes are
    contiguous ranges in input order (reference MeshInfo.triangleStart).

    ``max_leaf`` (optional) forces splits while leaves exceed that size even
    when SAH prefers a leaf — used by TPU tracers that want bounded leaf
    batches. ``min_leaf`` stops splitting below a size.
    """
    T = v0.shape[0]
    counts = np.asarray(mesh_tri_counts, np.int64)
    assert counts.sum() == T, (counts.sum(), T)
    assert np.all(counts > 0), "empty meshes are not supported"

    c = ((v0 + v1 + v2) * np.float32(1.0 / 3.0)).astype(np.float32)  # centroids
    tvmin = np.minimum(np.minimum(v0, v1), v2).astype(np.float32)
    tvmax = np.maximum(np.maximum(v0, v1), v2).astype(np.float32)

    perm = np.arange(T, dtype=np.int64)

    # node pools (grown geometrically)
    cap = max(16, 2 * T + 2 * len(counts))
    node_min = np.zeros((cap, 3), np.float32)
    node_max = np.zeros((cap, 3), np.float32)
    left_first = np.zeros(cap, np.int64)
    tri_count = np.zeros(cap, np.int64)
    n_nodes = 0

    def _ensure(n: int) -> None:
        nonlocal cap, node_min, node_max, left_first, tri_count
        if n <= cap:
            return
        new_cap = max(n, cap * 2)
        node_min = np.concatenate([node_min, np.zeros((new_cap - cap, 3), np.float32)])
        node_max = np.concatenate([node_max, np.zeros((new_cap - cap, 3), np.float32)])
        left_first = np.concatenate([left_first, np.zeros(new_cap - cap, np.int64)])
        tri_count = np.concatenate([tri_count, np.zeros(new_cap - cap, np.int64)])
        cap = new_cap

    # roots
    M = len(counts)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    roots = np.arange(M, dtype=np.int64)
    n_nodes = M
    _ensure(n_nodes)
    left_first[:M] = starts
    tri_count[:M] = counts

    # frontier: (node_id, start, count) triples as arrays
    f_node = roots.copy()
    f_start = starts.copy()
    f_count = counts.copy()

    for _depth in range(max_depth):
        live = f_count > 0
        f_node, f_start, f_count = f_node[live], f_start[live], f_count[live]
        if len(f_node) == 0:
            break

        # ---- node AABBs over full triangles (UpdateNodeBounds, BVH.cpp:54-74)
        seg_id = np.repeat(np.arange(len(f_node)), f_count)  # [Ta]
        seg_offsets = np.concatenate([[0], np.cumsum(f_count)[:-1]])
        gather = (
            np.arange(len(seg_id), dtype=np.int64)
            - seg_offsets[seg_id]
            + f_start[seg_id]
        )
        p_gather = perm[gather]
        bounds_min = np.minimum.reduceat(tvmin[p_gather], seg_offsets)
        bounds_max = np.maximum.reduceat(tvmax[p_gather], seg_offsets)
        node_min[f_node] = bounds_min
        node_max[f_node] = bounds_max

        ca = c[p_gather]  # active centroids [Ta, 3]
        avmin = tvmin[p_gather]
        avmax = tvmax[p_gather]

        # ---- centroid bounds per axis (FindBestSplitPlane, BVH.cpp:110-120)
        cmin = np.minimum.reduceat(ca, seg_offsets)  # [F, 3]
        cmax = np.maximum.reduceat(ca, seg_offsets)
        extent = cmax - cmin
        axis_valid = extent > 0.0  # [F, 3]

        # ---- binning (BVH.cpp:122-133)
        scale = np.where(axis_valid, _BINS / np.maximum(extent, 1e-30), 0.0)
        rel = (ca - cmin[seg_id]) * scale[seg_id]
        bin_idx = np.minimum(_BINS - 1, rel.astype(np.int64))  # [Ta, 3]

        F = len(f_node)
        # per (frontier, axis, bin) counts
        flat_key = (
            seg_id[:, None] * (3 * _BINS)
            + np.arange(3)[None, :] * _BINS
            + bin_idx
        )  # [Ta, 3]
        bin_counts = np.bincount(
            flat_key.ravel(), minlength=F * 3 * _BINS
        ).reshape(F, 3, _BINS)

        # per (frontier, axis, bin) AABBs via masked segment reductions
        bin_min = np.full((F, 3, _BINS, 3), _BIG, np.float32)
        bin_max = np.full((F, 3, _BINS, 3), -_BIG, np.float32)
        for axis in range(3):
            for b in range(_BINS):
                m = bin_idx[:, axis] == b
                if not m.any():
                    continue
                mn = np.where(m[:, None], avmin, _BIG)
                mx = np.where(m[:, None], avmax, -_BIG)
                bin_min[:, axis, b] = np.minimum.reduceat(mn, seg_offsets)
                bin_max[:, axis, b] = np.maximum.reduceat(mx, seg_offsets)

        # ---- prefix/suffix SAH sweep (BVH.cpp:135-160)
        lmin = np.minimum.accumulate(bin_min, axis=2)[:, :, :-1]  # planes 0..6
        lmax = np.maximum.accumulate(bin_max, axis=2)[:, :, :-1]
        rmin = np.minimum.accumulate(bin_min[:, :, ::-1], axis=2)[:, :, ::-1][:, :, 1:]
        rmax = np.maximum.accumulate(bin_max[:, :, ::-1], axis=2)[:, :, ::-1][:, :, 1:]
        lcount = np.cumsum(bin_counts, axis=2)[:, :, :-1]
        rcount = f_count[:, None, None] - lcount

        cost = lcount * _half_area(lmin, lmax) + rcount * _half_area(rmin, rmax)
        cost = np.where((lcount == 0) | (rcount == 0), np.inf, cost)
        cost = np.where(axis_valid[:, :, None], cost, np.inf)  # [F, 3, BINS-1]

        flat_cost = cost.reshape(F, -1)
        best_flat = np.argmin(flat_cost, axis=1)
        best_cost = flat_cost[np.arange(F), best_flat]
        best_axis = best_flat // (_BINS - 1)
        best_plane = best_flat % (_BINS - 1)
        split_pos = (
            cmin[np.arange(F), best_axis]
            + extent[np.arange(F), best_axis] / _BINS * (best_plane + 1)
        )

        # ---- split-vs-leaf decision (CalculateCost / BVH.cpp:173-176)
        parent_cost = f_count * _half_area(bounds_min, bounds_max)
        do_split = np.isfinite(best_cost) & (best_cost < parent_cost)
        do_split &= f_count > min_leaf
        forced = np.zeros_like(do_split)
        if max_leaf is not None:
            # max_leaf is a hard bound (TPU tracers unroll leaf batches):
            # oversize nodes split even when SAH prefers a leaf, falling back
            # to an object-median split when no SAH plane exists.
            forced = f_count > max_leaf
            do_split |= forced
        do_split &= f_count >= 2

        if not do_split.any():
            break

        # ---- stable in-place partition across all splitting nodes at once
        split_seg = do_split[seg_id]
        rank = np.arange(len(seg_id)) - seg_offsets[seg_id]
        sah_side = ca[np.arange(len(seg_id)), best_axis[seg_id]] >= split_pos[seg_id]
        median_side = rank >= (f_count[seg_id] // 2)
        use_median_seg = forced & ~np.isfinite(best_cost)
        side = np.where(split_seg, np.where(use_median_seg[seg_id], median_side, sah_side), False)

        left_sizes = np.bincount(seg_id[split_seg & ~side], minlength=F)

        # guard: SAH picked a plane but everything landed on one side
        # (reference abort, BVH.cpp:199-201); forced nodes fall back to median
        degenerate = do_split & ((left_sizes == 0) | (left_sizes == f_count))
        retry_median = degenerate & forced & ~use_median_seg
        if retry_median.any():
            side = np.where(
                split_seg & retry_median[seg_id], median_side, side
            )
            left_sizes = np.bincount(seg_id[split_seg & ~side], minlength=F)
            degenerate = do_split & ((left_sizes == 0) | (left_sizes == f_count))
        do_split &= ~degenerate

        order = np.lexsort((side, seg_id))
        perm[gather] = perm[gather][order]

        ns = int(do_split.sum())
        if ns == 0:
            break
        _ensure(n_nodes + 2 * ns)
        child_left = n_nodes + 2 * np.arange(ns)
        child_right = child_left + 1
        n_nodes += 2 * ns

        sel = np.flatnonzero(do_split)
        lf = f_start[sel]
        lc = left_sizes[sel]
        rf = lf + lc
        rc = f_count[sel] - lc

        left_first[child_left] = lf
        tri_count[child_left] = lc
        left_first[child_right] = rf
        tri_count[child_right] = rc
        left_first[f_node[sel]] = child_left
        tri_count[f_node[sel]] = 0  # inner marker

        f_node = np.concatenate([child_left, child_right])
        f_start = np.concatenate([lf, rf])
        f_count = np.concatenate([lc, rc])
    else:
        # max_depth exhausted with children pending bounds: finalize them.
        if len(f_node):
            seg_id = np.repeat(np.arange(len(f_node)), f_count)
            seg_offsets = np.concatenate([[0], np.cumsum(f_count)[:-1]])
            gather = (
                np.arange(len(seg_id), dtype=np.int64)
                - seg_offsets[seg_id]
                + f_start[seg_id]
            )
            node_min[f_node] = np.minimum.reduceat(tvmin[perm[gather]], seg_offsets)
            node_max[f_node] = np.maximum.reduceat(tvmax[perm[gather]], seg_offsets)

    # Pad boxes by a tiny relative epsilon: perfectly flat (planar) nodes
    # otherwise fail the strict slab test tnear < tfar (kernel_main.cl:115)
    # for rays in the plane-normal direction — e.g. axis-aligned cube faces.
    # Padding keeps traversal conservative (extra visits, never lost hits).
    scene_extent = float(
        np.max(node_max[:n_nodes] - node_min[:n_nodes], initial=1.0)
    )
    pad = np.float32(max(scene_extent, 1.0) * 1e-5)
    return BVHBuild(
        node_min=node_min[:n_nodes].copy() - pad,
        node_max=node_max[:n_nodes].copy() + pad,
        left_first=left_first[:n_nodes].astype(np.int32),
        tri_count=tri_count[:n_nodes].astype(np.int32),
        roots=roots.astype(np.int32),
        perm=perm.astype(np.int32),
    )



def validate_bvh(build: BVHBuild, num_tris: int) -> None:
    """Structural invariants (bvh.py:291 of the JAX package): every triangle
    in exactly one leaf, children adjacent, child boxes inside their
    parent's. Raises ``AssertionError`` naming the first broken one."""
    seen = np.zeros(num_tris, np.int32)
    n = len(build.tri_count)
    eps = 1e-4
    for node in range(n):
        tc = build.tri_count[node]
        lf = build.left_first[node]
        if tc > 0:
            seen[lf : lf + tc] += 1
            continue
        left, right = lf, lf + 1
        if not (0 <= left < n and right < n):
            raise AssertionError(f"node {node}: children {left}, {right} outside {n} nodes")
        for ch in (left, right):
            if not (np.all(build.node_min[ch] >= build.node_min[node] - eps)
                    and np.all(build.node_max[ch] <= build.node_max[node] + eps)):
                raise AssertionError(f"node {node}: child {ch}'s box is not inside it")
    if not np.all(seen == 1):
        raise AssertionError(f"{(seen != 1).sum()} triangles not covered exactly once")
