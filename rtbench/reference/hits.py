"""The reference's hit query: the nearest triangle along each ray, in plain
PyTorch, independent of the program's BVH and cluster tables.

Each mesh's triangles are sorted along a Morton curve of their centroids
and cut into chunks of ``CHUNK`` triangles, the chunks into groups of
``CHUNK`` chunks; a ray tests the group boxes, then the boxes of the chunks
in the groups it enters, then by Möller–Trumbore every triangle of the
chunks it enters. A hit is t > 0 inside the closed triangle, both faces;
the nearest wins, the lowest sorted index among equal distances. Rays go
to object space through each instance's inverse transform (row vectors),
so t is the object-space distance, as the upstream's kernel measures it.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

CHUNK = 64
#: rays a batch and (ray, box) pairs a pass: bounds on the memory a query takes
RAY_BATCH = 8192
PAIR_BATCH = 1 << 17


def _morton(c: np.ndarray) -> np.ndarray:
    """30-bit Morton codes of points [n, 3] in their bounding box."""
    lo, hi = c.min(axis=0), c.max(axis=0)
    q = ((c - lo) / np.maximum(hi - lo, 1e-12) * 1023.0).astype(np.uint64)
    code = np.zeros(c.shape[0], np.uint64)
    for bit in range(10):
        for ax in range(3):
            code |= ((q[:, ax] >> np.uint64(bit)) & np.uint64(1)) << np.uint64(3 * bit + 2 - ax)
    return code


@dataclasses.dataclass
class MeshTables:
    """One mesh's triangles in chunk order on the device."""

    order: torch.Tensor  # [T] int64: the mesh's own triangle index of each sorted one
    v0: torch.Tensor  # [Tp, 3], padded to whole chunks with degenerate triangles
    v1: torch.Tensor
    v2: torch.Tensor
    box_lo: torch.Tensor  # [C, 3] chunk boxes
    box_hi: torch.Tensor
    group_lo: torch.Tensor  # [G, 3]
    group_hi: torch.Tensor
    count: int


def mesh_tables(mesh, device: torch.device, dtype=torch.float32) -> MeshTables:
    v = np.stack([mesh.v0, mesh.v1, mesh.v2], axis=1).astype(np.float32)  # [T, 3, 3]
    order = np.argsort(_morton(v.mean(axis=1)), kind="stable")
    v = v[order]
    t = v.shape[0]
    pad = -t % (CHUNK * CHUNK)
    # padding: degenerate triangles at the first vertex, which no ray hits
    v = np.concatenate([v, np.repeat(v[:1, :1], pad, axis=0).repeat(3, axis=1)])
    lo, hi = v.min(axis=1), v.max(axis=1)
    c_lo = lo.reshape(-1, CHUNK, 3).min(axis=1)
    c_hi = hi.reshape(-1, CHUNK, 3).max(axis=1)
    g_lo = c_lo.reshape(-1, CHUNK, 3).min(axis=1)
    g_hi = c_hi.reshape(-1, CHUNK, 3).max(axis=1)
    to = lambda a: torch.as_tensor(np.ascontiguousarray(a)).to(device=device, dtype=dtype)
    return MeshTables(
        order=torch.as_tensor(order).to(device), v0=to(v[:, 0]), v1=to(v[:, 1]),
        v2=to(v[:, 2]), box_lo=to(c_lo), box_hi=to(c_hi), group_lo=to(g_lo), group_hi=to(g_hi),
        count=t)


def _slab(o, inv, lo, hi):
    """Ray-box overlap [R, B] of rays (o, 1/d) [R, 3] and boxes [B, 3]:
    the box is entered at some t >= 0."""
    t0 = (lo[None] - o[:, None]) * inv[:, None]
    t1 = (hi[None] - o[:, None]) * inv[:, None]
    near = torch.minimum(t0, t1).nan_to_num(nan=-float("inf")).amax(dim=2)
    far = torch.maximum(t0, t1).nan_to_num(nan=float("inf")).amin(dim=2)
    return (far >= near) & (far >= 0.0)


def _pair_slab(o, inv, lo, hi):
    """Ray-box overlap [P] of P (ray, box) pairs."""
    t0 = (lo - o) * inv
    t1 = (hi - o) * inv
    near = torch.minimum(t0, t1).nan_to_num(nan=-float("inf")).amax(dim=1)
    far = torch.maximum(t0, t1).nan_to_num(nan=float("inf")).amin(dim=1)
    return (far >= near) & (far >= 0.0)


def moller_trumbore(o, d, v0, v1, v2):
    """(t, u, v) of rays o, d [..., 3] against triangles [..., 3]."""
    e1 = v1 - v0
    e2 = v2 - v0
    p = torch.linalg.cross(d, e2, dim=-1)
    det = (e1 * p).sum(-1)
    inv = 1.0 / det
    s = o - v0
    u = (s * p).sum(-1) * inv
    q = torch.linalg.cross(s, e1, dim=-1)
    v = (d * q).sum(-1) * inv
    t = (e2 * q).sum(-1) * inv
    return t, u, v


def _closest_batch(m: MeshTables, o, d):
    """Nearest hit of R rays [R, 3] in mesh ``m`` → (t [R], sorted index
    [R]); t = inf on a miss."""
    r = o.shape[0]
    dev = o.device
    inv = 1.0 / d
    best_t = torch.full((r,), float("inf"), dtype=o.dtype, device=dev)
    best_i = torch.zeros(r, dtype=torch.long, device=dev)
    rg = torch.nonzero(_slab(o, inv, m.group_lo, m.group_hi))  # [P, 2] (ray, group)
    ar = torch.arange(CHUNK, device=dev)
    for a in range(0, rg.shape[0], PAIR_BATCH // CHUNK):
        pg = rg[a:a + PAIR_BATCH // CHUNK]
        ray = pg[:, 0:1].expand(-1, CHUNK).reshape(-1)
        chunk = (pg[:, 1:2] * CHUNK + ar).reshape(-1)
        keep = _pair_slab(o[ray], inv[ray], m.box_lo[chunk], m.box_hi[chunk])
        ray, chunk = ray[keep], chunk[keep]
        for b in range(0, ray.shape[0], PAIR_BATCH // CHUNK):
            rr = ray[b:b + PAIR_BATCH // CHUNK]
            tri = (chunk[b:b + PAIR_BATCH // CHUNK, None] * CHUNK + ar).reshape(-1)
            rx = rr[:, None].expand(-1, CHUNK).reshape(-1)
            t, u, v = moller_trumbore(o[rx], d[rx], m.v0[tri], m.v1[tri], m.v2[tri])
            ok = (t > 0.0) & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
            t = torch.where(ok, t, torch.full_like(t, float("inf")))
            prev = best_t.clone()
            best_t.scatter_reduce_(0, rx, t, "amin")
            # the lowest index among the rays' nearest in this pass
            cand = torch.where((t == best_t[rx]) & torch.isfinite(t), tri,
                               torch.full_like(tri, 1 << 62))
            low = torch.full((r,), 1 << 62, dtype=torch.long, device=dev)
            low.scatter_reduce_(0, rx, cand, "amin")
            # a pass that lowers t replaces the index; one that ties keeps the lower
            found = low < (1 << 62)
            best_i = torch.where(found & (best_t < prev), low,
                                 torch.where(found, torch.minimum(low, best_i), best_i))
    return best_t, best_i


@dataclasses.dataclass
class Hits:
    t: torch.Tensor  # [n] object-space distance, inf on a miss
    instance: torch.Tensor  # [n] int64
    tri: torch.Tensor  # [n] int64: the mesh's own triangle index
    u: torch.Tensor
    v: torch.Tensor

    @property
    def hit(self) -> torch.Tensor:
        return torch.isfinite(self.t)


class Geometry:
    """The scene's meshes and instances as the reference traces them."""

    def __init__(self, spec, device: torch.device, dtype=torch.float32) -> None:
        self.spec = spec
        self.dtype = dtype
        self.meshes = [mesh_tables(m, device, dtype) for m in spec.meshes]
        self.inverse = [np.linalg.inv(i.transform).astype(np.float32) for i in spec.instances]
        self.device = device

    def set_transform(self, instance: int, transform: np.ndarray) -> None:
        self.inverse[instance] = np.linalg.inv(np.asarray(transform, np.float32)).astype(np.float32)

    def object_rays(self, k: int, o, d):
        """Rays [3, n] in instance ``k``'s object space."""
        m = torch.as_tensor(self.inverse[k], dtype=o.dtype, device=o.device)
        mo = torch.stack([o[0] * m[0, c] + o[1] * m[1, c] + o[2] * m[2, c] + m[3, c]
                          for c in range(3)])
        md = torch.stack([d[0] * m[0, c] + d[1] * m[1, c] + d[2] * m[2, c] for c in range(3)])
        return mo, md

    def closest(self, o: torch.Tensor, d: torch.Tensor) -> Hits:
        """Nearest hits of world rays o, d [3, n] over every instance."""
        n = o.shape[1]
        dev = o.device
        best = torch.full((n,), float("inf"), dtype=o.dtype, device=dev)
        inst = torch.zeros(n, dtype=torch.long, device=dev)
        tri = torch.zeros(n, dtype=torch.long, device=dev)
        for k, ins in enumerate(self.spec.instances):
            m = self.meshes[ins.mesh]
            mo, md = self.object_rays(k, o, d)
            for a in range(0, n, RAY_BATCH):
                t, i = _closest_batch(m, mo[:, a:a + RAY_BATCH].T.contiguous(),
                                      md[:, a:a + RAY_BATCH].T.contiguous())
                take = t < best[a:a + RAY_BATCH]
                best[a:a + RAY_BATCH] = torch.where(take, t, best[a:a + RAY_BATCH])
                inst[a:a + RAY_BATCH] = torch.where(take, k, inst[a:a + RAY_BATCH])
                tri[a:a + RAY_BATCH] = torch.where(take, i, tri[a:a + RAY_BATCH])
        # barycentrics of the winners, and their mesh-order indices
        u = torch.zeros_like(best)
        v = torch.zeros_like(best)
        own = torch.zeros_like(tri)
        for k, ins in enumerate(self.spec.instances):
            sel = torch.isfinite(best) & (inst == k)
            if not bool(sel.any()):
                continue
            m = self.meshes[ins.mesh]
            mo, md = self.object_rays(k, o[:, sel], d[:, sel])
            j = tri[sel]
            _t, uu, vv = moller_trumbore(mo.T, md.T, m.v0[j], m.v1[j], m.v2[j])
            u[sel], v[sel] = uu, vv
            own[sel] = m.order[j]
        return Hits(t=best, instance=inst, tri=own, u=u, v=v)
