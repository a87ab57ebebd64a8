"""Cluster tables for the traversal kernels (numpy; a copy of the JAX
package's ``ops/clusters.py``, whose table layout the scene keeps).

* Triangles, already in BVH leaf order (spatially coherent — the SAH build's
  in-place partition, bvh.py), are grouped into clusters of at most
  ``CLUSTER_SIZE`` tris aligned to BVH subtrees; 32 clusters form a
  supercluster and 32 superclusters a hypercluster. Every level carries
  AABBs used for culling.
* Cluster triangle data is packed one cluster per row as **plane-based
  (Baldwin-Weber) intersection coefficients**: three 4-vectors per triangle
  — the plane N = (n, -n.v0) and two barycentric planes U, V with
  u(p) = U.(p,1), v(p) = V.(p,1) on the triangle plane — so an intersection
  is six dot products and one reciprocal. The ``[C, 128]`` rows hold each
  component for 32 triangles (the TPU kernel's layout); the CUDA kernels
  read a per-triangle re-layout made on upload (ops/trace.py).
* Padding triangles are fully degenerate (zeros): their plane normal is
  zero, so ``den = 0 → t = 0 * -inf = nan`` and every accept test fails.
"""

from __future__ import annotations

import dataclasses

import numpy as np

CLUSTER_SIZE = 32
SUPER_SIZE = 32  # clusters per supercluster
HYPER_SIZE = 32  # superclusters per hypercluster (phase-A0 culling level)


@dataclasses.dataclass(frozen=True)
class ClusterTables:
    """Host-built, device-ready cluster tables (numpy).

    The 12 plane coefficients are packed 4-per-row across three
    [C, 128] tables: ``tri_a`` = Nx|Ny|Nz|Nw (32 lanes each),
    ``tri_b`` = Ux|Uy|Uz|Uw, ``tri_c`` = Vx|Vy|Vz|Vw.
    """

    tri_a: np.ndarray  # [C, 128] f32
    tri_b: np.ndarray  # [C, 128] f32
    tri_c: np.ndarray  # [C, 128] f32
    #: shading attributes, same packing (4 components x 32 lanes), f32 cast
    #: from the canonical f16 attrs so in-kernel interpolation is
    #: bit-identical to the XLA gather path:
    at_a: np.ndarray  # [C, 128]: n0x|n0y|n0z|n1x
    at_b: np.ndarray  # [C, 128]: n1y|n1z|n2x|n2y
    at_c: np.ndarray  # [C, 128]: n2z|uv0u|uv0v|uv1u
    at_d: np.ndarray  # [C, 128]: uv1v|uv2u|uv2v|mat_local
    tri_gid: np.ndarray  # [C * CLUSTER_SIZE] i32 global arena tri index
    cluster_min: np.ndarray  # [C, 3] f32 (padded to [C, 8] on device)
    cluster_max: np.ndarray  # [C, 3] f32
    super_min: np.ndarray  # [S, 3] f32 — S is per-mesh padded to a
    #   multiple of HYPER_SIZE (inverted-empty pads) so each mesh's
    #   hypercluster range is derivable as super_start // HYPER_SIZE
    super_max: np.ndarray  # [S, 3] f32
    hyper_min: np.ndarray  # [H, 3] f32 — AABBs over HYPER_SIZE supers
    hyper_max: np.ndarray  # [H, 3] f32
    # per-mesh static ranges (indices into the global cluster/supercluster
    # tables): (super_start, super_count, cluster_start, cluster_count);
    # super_count is the REAL (unpadded) count
    mesh_ranges: tuple[tuple[int, int, int, int], ...]


def subtree_cluster_ranges(
    left_first: np.ndarray,
    tri_count: np.ndarray,
    root: int,
    max_size: int = CLUSTER_SIZE,
) -> list[tuple[int, int]]:
    """Partition a mesh's (BVH-reordered) triangle range into clusters
    aligned to BVH subtrees of <= ``max_size`` triangles: descend from the
    root and emit each highest node whose subtree fits. Subtree-aligned
    clusters have much tighter AABBs than fixed 32-triangle runs (a run can
    straddle two major branches): measured 2.2x less total box surface area
    on the 160k-tri museum scenes and 2.4x on the bench sphere, at ~1.5x
    the cluster count (average fill ~20/32; padding triangles fail every
    accept test, so partial fill only costs dead intersection lanes)."""
    lf = np.asarray(left_first, np.int64)
    tc = np.asarray(tri_count, np.int64)
    n = lf.shape[0]
    # subtree tri start/count, leaves-up: children are allocated after
    # their parent, so a reverse scan sees children first
    st = np.zeros(n, np.int64)
    ct = np.zeros(n, np.int64)
    for i in range(n - 1, -1, -1):
        if tc[i] > 0:
            st[i], ct[i] = lf[i], tc[i]
        else:
            st[i] = min(st[lf[i]], st[lf[i] + 1])
            ct[i] = ct[lf[i]] + ct[lf[i] + 1]
    out: list[tuple[int, int]] = []
    stack = [int(root)]
    while stack:
        node = stack.pop()
        c = int(ct[node])
        if c <= max_size:
            out.append((int(st[node]), c))
        elif tc[node] > 0:
            # oversized leaf (builder leaf bound > max_size): fall back to
            # fixed runs within it
            s = int(st[node])
            out.extend(
                (c0, min(max_size, s + c - c0))
                for c0 in range(s, s + c, max_size)
            )
        else:
            stack.append(int(lf[node]) + 1)
            stack.append(int(lf[node]))
    out.sort()  # leaf order
    return out


def merge_cluster_ranges(
    ranges: list[tuple[int, int]],
    v0: np.ndarray,
    v1: np.ndarray,
    v2: np.ndarray,
    max_size: int = CLUSTER_SIZE,
    area_factor: float = 1.0,
) -> list[tuple[int, int]]:
    """Greedily merge adjacent cluster ranges while they fit ``max_size``
    and the merged AABB half-area stays <= ``area_factor`` x the sum of the
    parts. Subtree-aligned clusters average ~20/32 fill, but a leaf batch
    costs a full 32-wide intersect (and one slab test + one 4 KiB DMA on
    the streamed path) REGARDLESS of fill — so packing two partial
    neighbors into one cluster is a strict win whenever the union's area
    does not exceed the sum (a tile that culled either part still pays at
    most what it paid before). The area guard keeps merges from straddling
    major BVH branches, which is what made fixed 32-triangle runs loose in
    the first place (see subtree_cluster_ranges). Measured on the museum
    scene: 7.9k -> 5.3k clusters."""
    if len(ranges) < 2:
        return ranges
    tmin = np.minimum(np.minimum(v0, v1), v2).astype(np.float64)
    tmax = np.maximum(np.maximum(v0, v1), v2).astype(np.float64)

    def half_area(mn, mx):
        d = np.maximum(mx - mn, 0.0)
        return d[0] * d[1] + d[1] * d[2] + d[2] * d[0]

    out: list[tuple[int, int]] = []
    s, c = ranges[0]
    mn = tmin[s : s + c].min(axis=0)
    mx = tmax[s : s + c].max(axis=0)
    for s2, c2 in ranges[1:]:
        mn2 = tmin[s2 : s2 + c2].min(axis=0)
        mx2 = tmax[s2 : s2 + c2].max(axis=0)
        if c + c2 <= max_size:
            mnm = np.minimum(mn, mn2)
            mxm = np.maximum(mx, mx2)
            if half_area(mnm, mxm) <= area_factor * (
                half_area(mn, mx) + half_area(mn2, mx2)
            ):
                c += c2
                mn, mx = mnm, mxm
                continue
        out.append((s, c))
        s, c, mn, mx = s2, c2, mn2, mx2
    out.append((s, c))
    return out


def build_clusters(
    v0: np.ndarray,
    v1: np.ndarray,
    v2: np.ndarray,
    mesh_tri_start: tuple[int, ...],
    mesh_tri_count: tuple[int, ...],
    attrs: np.ndarray | None = None,  # [T, 16] f32 (shade.ShadingTables layout)
    cluster_ranges: list[list[tuple[int, int]]] | None = None,
) -> ClusterTables:
    """Build per-mesh cluster/supercluster tables from BVH-ordered triangles.

    ``cluster_ranges``: per-mesh list of (tri_start, tri_count<=32) cluster
    ranges (``subtree_cluster_ranges``); None falls back to fixed
    32-triangle runs."""
    if attrs is None:
        attrs = np.zeros((v0.shape[0], 16), np.float32)
    tri_rows: list[np.ndarray] = []
    at_rows: list[tuple[np.ndarray, ...]] = []
    gids: list[np.ndarray] = []
    cmins: list[np.ndarray] = []
    cmaxs: list[np.ndarray] = []
    smins: list[np.ndarray] = []
    smaxs: list[np.ndarray] = []
    hmins: list[np.ndarray] = []
    hmaxs: list[np.ndarray] = []
    ranges: list[tuple[int, int, int, int]] = []

    c_cursor = 0
    s_cursor = 0
    for mesh_i, (start, count) in enumerate(zip(mesh_tri_start, mesh_tri_count)):
        if cluster_ranges is not None:
            rs = cluster_ranges[mesh_i]
        else:
            rs = [
                (c0, min(CLUSTER_SIZE, start + count - c0))
                for c0 in range(start, start + count, CLUSTER_SIZE)
            ]
        if not rs:
            rs = [(start, 0)]
        n_clusters = len(rs)
        padded = n_clusters * CLUSTER_SIZE

        # per-cluster triangle slot -> arena index (-1 = padding slot)
        idx = np.full((n_clusters, CLUSTER_SIZE), -1, np.int64)
        for j, (s, c) in enumerate(rs):
            idx[j, :c] = np.arange(s, s + c)
        valid_slots = (idx >= 0).reshape(padded)
        slot_idx = np.where(idx >= 0, idx, 0).reshape(padded)

        mv0 = np.where(valid_slots[:, None], v0[slot_idx], 0).astype(np.float32)
        mv1 = np.where(valid_slots[:, None], v1[slot_idx], 0).astype(np.float32)
        mv2 = np.where(valid_slots[:, None], v2[slot_idx], 0).astype(np.float32)
        gid = np.where(valid_slots, slot_idx, 0).astype(np.int32)

        # Baldwin-Weber plane coefficients (f64 intermediates for plane
        # quality, stored f32). N = e1 x e2 with Nw = -N.v0 gives
        # t = -(N.o + Nw) / (N.d); the barycentric planes follow from the
        # scalar triple product identity (e2 x n).e1 = n.(e1 x e2) = |n|^2:
        #   U = (e2 x n) / |n|^2,  Uw = -U.v0   (u(v0)=0, u(v1)=1, u(v2)=0)
        #   V = (n x e1) / |n|^2,  Vw = -V.v0   (v(v2)=1)
        # Degenerate (incl. padding) triangles get all-zero planes: the
        # kernel's t becomes 0 * -inf = nan and every accept test fails.
        v0d, v1d, v2d = mv0.astype(np.float64), mv1.astype(np.float64), mv2.astype(np.float64)
        e1 = v1d - v0d
        e2 = v2d - v0d
        n = np.cross(e1, e2)
        nn = (n * n).sum(axis=1, keepdims=True)
        nn_safe = np.where(nn > 0.0, nn, 1.0)
        u3 = np.where(nn > 0.0, np.cross(e2, n) / nn_safe, 0.0)
        v3 = np.where(nn > 0.0, np.cross(n, e1) / nn_safe, 0.0)
        n = np.where(nn > 0.0, n, 0.0)
        nw = -(n * v0d).sum(axis=1, keepdims=True)
        uw = -(u3 * v0d).sum(axis=1, keepdims=True)
        vw = -(v3 * v0d).sum(axis=1, keepdims=True)
        planes = [
            np.concatenate([p, w], axis=1).astype(np.float32)
            for p, w in ((n, nw), (u3, uw), (v3, vw))
        ]
        comp = lambda arr, j: arr[:, j].reshape(n_clusters, CLUSTER_SIZE)
        ta, tb, tc = (
            np.concatenate([comp(p, j) for j in range(4)], axis=1)
            for p in planes
        )

        mat_ = np.where(
            valid_slots[:, None], attrs[slot_idx], 0
        ).astype(np.float32)
        acomp = lambda j: mat_[:, j].reshape(n_clusters, CLUSTER_SIZE)
        at_rows.append(
            (
                np.concatenate([acomp(0), acomp(1), acomp(2), acomp(3)], axis=1),
                np.concatenate([acomp(4), acomp(5), acomp(6), acomp(7)], axis=1),
                np.concatenate([acomp(8), acomp(9), acomp(10), acomp(11)], axis=1),
                np.concatenate([acomp(12), acomp(13), acomp(14), acomp(15)], axis=1),
            )
        )

        # cluster AABBs over real (non-padding) triangles
        tmin = np.minimum(np.minimum(mv0, mv1), mv2).reshape(
            n_clusters, CLUSTER_SIZE, 3
        )
        tmax = np.maximum(np.maximum(mv0, mv1), mv2).reshape(
            n_clusters, CLUSTER_SIZE, 3
        )
        valid = valid_slots.reshape(n_clusters, CLUSTER_SIZE)
        big = np.float32(1e30)
        cmin = np.where(valid[..., None], tmin, big).min(axis=1)
        cmax = np.where(valid[..., None], tmax, -big).max(axis=1)

        n_super = -(-n_clusters // SUPER_SIZE)
        pad_c = n_super * SUPER_SIZE - n_clusters
        cmin_p = np.concatenate([cmin, np.full((pad_c, 3), big, np.float32)])
        cmax_p = np.concatenate([cmax, np.full((pad_c, 3), -big, np.float32)])
        smin = cmin_p.reshape(n_super, SUPER_SIZE, 3).min(axis=1)
        smax = cmax_p.reshape(n_super, SUPER_SIZE, 3).max(axis=1)

        # pad each mesh's super table to a multiple of HYPER_SIZE with
        # inverted-empty boxes (they fail every slab test), and roll the
        # hypercluster level up over the padded groups — the padding keeps
        # every mesh's hyper range derivable (super_start // HYPER_SIZE)
        # without widening mesh_ranges
        n_hyper = -(-n_super // HYPER_SIZE)
        pad_s = n_hyper * HYPER_SIZE - n_super
        smin_p = np.concatenate([smin, np.full((pad_s, 3), big, np.float32)])
        smax_p = np.concatenate([smax, np.full((pad_s, 3), -big, np.float32)])
        hmin = smin_p.reshape(n_hyper, HYPER_SIZE, 3).min(axis=1)
        hmax = smax_p.reshape(n_hyper, HYPER_SIZE, 3).max(axis=1)

        tri_rows.append((ta, tb, tc))
        gids.append(gid)
        cmins.append(cmin)
        cmaxs.append(cmax)
        smins.append(smin_p)
        smaxs.append(smax_p)
        hmins.append(hmin)
        hmaxs.append(hmax)
        ranges.append((s_cursor, n_super, c_cursor, n_clusters))
        c_cursor += n_clusters
        s_cursor += n_hyper * HYPER_SIZE

    return ClusterTables(
        tri_a=np.concatenate([r[0] for r in tri_rows], axis=0),
        tri_b=np.concatenate([r[1] for r in tri_rows], axis=0),
        tri_c=np.concatenate([r[2] for r in tri_rows], axis=0),
        at_a=np.concatenate([r[0] for r in at_rows], axis=0),
        at_b=np.concatenate([r[1] for r in at_rows], axis=0),
        at_c=np.concatenate([r[2] for r in at_rows], axis=0),
        at_d=np.concatenate([r[3] for r in at_rows], axis=0),
        tri_gid=np.concatenate(gids),
        cluster_min=np.concatenate(cmins, axis=0),
        cluster_max=np.concatenate(cmaxs, axis=0),
        super_min=np.concatenate(smins, axis=0),
        super_max=np.concatenate(smaxs, axis=0),
        hyper_min=np.concatenate(hmins, axis=0),
        hyper_max=np.concatenate(hmaxs, axis=0),
        mesh_ranges=tuple(ranges),
    )
