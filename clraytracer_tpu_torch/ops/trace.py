"""Nearest-hit tracing over the cluster tables: kernel K2.1 and its plain
version.

* ``trace_cuda`` launches the hand-written CUDA kernel (csrc/trace.cu), a
  port of the TPU kernel ``clraytracer_tpu/ops/trace_pallas.py``
  (``_make_kernel`` → ``_emit_traversal``).
* ``trace_plain`` is the plain PyTorch version: brute force over every
  cluster slot of every instance, with the kernel's plane test in the same
  expression order. The tests use it, and ``trace`` takes it only for
  tensors on the CPU.
* ``trace`` is the JAX ``trace_pallas`` entry (trace_pallas.py:1126):
  planar ``[3, ...]`` rays in, a ``SceneHit`` out.

Both versions read ``KernelTables``: the scene's cluster tables re-laid
once per cluster and packed tables into per-slot rows ([S, 12] planes, [S, 16]
attributes) and one AABB per row ([N, 8]).
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import NamedTuple

import torch

from clraytracer_tpu_torch.ops.clusters import CLUSTER_SIZE
from clraytracer_tpu_torch.scene.types import MISS_DISTANCE, Scene

BIG = 1e30  # rounds to the f32 miss sentinel of the kernels


class SceneHit(NamedTuple):
    """Closest hit across all instances (the JAX package's ``SceneHit``
    fields; the object-space ray fields are never filled by this tracer)."""

    t: torch.Tensor
    u: torch.Tensor
    v: torch.Tensor
    tri: torch.Tensor  # i32 arena triangle index (cluster slot with return_slots)
    instance: torch.Tensor
    hit: torch.Tensor
    mesh_origin: torch.Tensor | None = None
    mesh_direction: torch.Tensor | None = None
    attr_normal: torch.Tensor | None = None  # [3, ...] object space
    attr_uu: torch.Tensor | None = None
    attr_vv: torch.Tensor | None = None
    attr_mat: torch.Tensor | None = None


@dataclasses.dataclass(frozen=True)
class KernelTables:
    """Device tables of the traversal, one row per box or triangle slot."""

    inst: torch.Tensor  # [I, 17] f32: inverse transform | material_start
    ranges: torch.Tensor  # [I, 4] i32: super start/count, cluster start/count
    hyper_box: torch.Tensor  # [H, 8] f32
    super_box: torch.Tensor  # [S, 8] f32
    cluster_box: torch.Tensor  # [C, 8] f32
    planes: torch.Tensor  # [C*32, 12] f32: N xyzw | U xyzw | V xyzw
    attrs: torch.Tensor  # [C*32, 16] f32: n0 n1 n2 | uv0 uv1 uv2 | mat
    tri_gid: torch.Tensor  # [C*32] i64: slot → arena triangle index
    ranges_host: tuple[tuple[int, int, int, int], ...]

    @property
    def n_inst(self) -> int:
        return len(self.ranges_host)

    def as_c(self):
        from clraytracer_tpu_torch.runtime.kernels import SceneTablesC

        return SceneTablesC(
            self.inst.data_ptr(), self.ranges.data_ptr(),
            self.hyper_box.data_ptr(), self.super_box.data_ptr(),
            self.cluster_box.data_ptr(), self.planes.data_ptr(),
            self.attrs.data_ptr(), self.n_inst,
        )


def _per_slot(*tables: torch.Tensor) -> torch.Tensor:
    """[C, 128] tables of 4 components x 32 slots → [C*32, 4 * len]."""
    cols = [t.reshape(-1, 4, CLUSTER_SIZE).transpose(1, 2) for t in tables]
    return torch.cat(cols, dim=2).reshape(-1, 4 * len(tables)).contiguous()


def kernel_tables(scene: Scene) -> KernelTables:
    """The scene's traversal tables, built on first use and kept with its
    ``clusters`` object, keyed by its ``packed`` object and instance meshes
    (a scene's tensors never change after build): scenes that share them,
    as a ``dataclasses.replace`` of the materials does, share the tables."""
    cl, pk = scene.clusters, scene.packed
    if cl is None or pk is None or cl.hyper_aabb is None:
        raise NotImplementedError(
            "scene built without cluster, hypercluster or packed tables"
        )
    mesh_index = scene.instances.mesh_index
    cached = cl.__dict__.get("_kernel_tables")
    if cached is not None and cached[0] is pk and cached[1] == mesh_index:
        return cached[2]
    ranges = tuple(cl.mesh_ranges[m] for m in mesh_index)
    dev = cl.tri_a.device
    kt = KernelTables(
        inst=pk.inst_rows.float().contiguous(),
        ranges=torch.tensor(ranges, dtype=torch.int32, device=dev).reshape(-1, 4),
        hyper_box=cl.hyper_aabb.reshape(-1, 8).contiguous(),
        super_box=cl.super_aabb.reshape(-1, 8).contiguous(),
        cluster_box=cl.cluster_aabb.reshape(-1, 8).contiguous(),
        planes=_per_slot(cl.tri_a, cl.tri_b, cl.tri_c),
        attrs=_per_slot(cl.at_a, cl.at_b, cl.at_c, cl.at_d),
        tri_gid=cl.tri_gid.long(),
        ranges_host=ranges,
    )
    cl.__dict__["_kernel_tables"] = (pk, mesh_index, kt)
    return kt


# ---------------------------------------------------------------------------
# plain version
# ---------------------------------------------------------------------------


def _object_ray(m: torch.Tensor, o, d):
    """World ray → object space by the row-vector inverse ``m`` [17]."""
    ox = o[0] * m[0] + o[1] * m[4] + o[2] * m[8] + m[12]
    oy = o[0] * m[1] + o[1] * m[5] + o[2] * m[9] + m[13]
    oz = o[0] * m[2] + o[1] * m[6] + o[2] * m[10] + m[14]
    dx = d[0] * m[0] + d[1] * m[4] + d[2] * m[8]
    dy = d[0] * m[1] + d[1] * m[5] + d[2] * m[9]
    dz = d[0] * m[2] + d[1] * m[6] + d[2] * m[10]
    return ox, oy, oz, dx, dy, dz


def trace_plain(
    kt: KernelTables,
    rays: torch.Tensor,  # [6, n] f32: origin xyz | direction xyz
    live: torch.Tensor | None = None,  # [n] f32, 0 = dead lane
) -> torch.Tensor:
    """The plain version of K2.1: the same [11, n] output, by brute force
    over every cluster slot (no culling; the kernel's culling is
    conservative, so the nearest hit is the same up to equal-t ties)."""
    n = rays.shape[1]
    dev = rays.device
    alive = (
        torch.ones(n, dtype=torch.bool, device=dev) if live is None else live != 0
    )
    bt = torch.where(alive, torch.full((n,), BIG, device=dev),
                     torch.full((n,), -BIG, device=dev))
    bu = torch.zeros(n, device=dev)
    bv = torch.zeros(n, device=dev)
    bslot = torch.zeros(n, dtype=torch.int64, device=dev)
    binst = torch.zeros(n, dtype=torch.int64, device=dev)
    o = rays[0:3, :, None]
    d = rays[3:6, :, None]
    for inst, (_sc0, _scn, cl0, cl_n) in enumerate(kt.ranges_host):
        ox, oy, oz, dx, dy, dz = _object_ray(kt.inst[inst], o, d)
        s0, s1 = cl0 * CLUSTER_SIZE, (cl0 + cl_n) * CLUSTER_SIZE
        chunk = max(CLUSTER_SIZE, (1 << 22) // max(n, 1) // 32 * 32)
        for c0 in range(s0, s1, chunk):
            p = kt.planes[c0 : min(c0 + chunk, s1)].T  # [12, k]
            nx, ny, nz, nw, ux, uy, uz, uw, vx, vy, vz, vw = p[:, None, :]
            den = dx * nx + dy * ny + dz * nz
            b_n = ox * nx + oy * ny + oz * nz + nw
            t = b_n * (-1.0 / den)
            u = (ox * ux + oy * uy + oz * uz + uw) + t * (dx * ux + dy * uy + dz * uz)
            v = (ox * vx + oy * vy + oz * vz + vw) + t * (dx * vx + dy * vy + dz * vz)
            ok = (t > 0.0) & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
            tm = torch.where(ok, t, torch.full_like(t, float("inf")))
            k = torch.argmin(tm, dim=1)  # first of equal minima: slot order
            tk = tm.gather(1, k[:, None])[:, 0]
            take = tk < bt  # strict, as the sequential accept
            bt = torch.where(take, tk, bt)
            bu = torch.where(take, u.gather(1, k[:, None])[:, 0], bu)
            bv = torch.where(take, v.gather(1, k[:, None])[:, 0], bv)
            bslot = torch.where(take, k + c0, bslot)
            binst = torch.where(take, torch.full_like(binst, inst), binst)
    hit = bt.abs() < BIG
    a = kt.attrs[bslot].T  # [16, n]
    w0 = 1.0 - bu - bv
    zero = torch.zeros_like(bu)

    def interp(i0, i1, i2):
        return torch.where(hit, a[i0] * w0 + a[i1] * bu + a[i2] * bv, zero)

    out = torch.stack([
        bt, bu, bv,
        bslot.to(torch.int32).view(torch.float32),
        binst.to(torch.int32).view(torch.float32),
        interp(0, 3, 6), interp(1, 4, 7), interp(2, 5, 8),
        interp(9, 11, 13), interp(10, 12, 14),
        torch.where(hit, a[15], zero),
    ])
    return out


# ---------------------------------------------------------------------------
# kernel wrapper
# ---------------------------------------------------------------------------


def trace_cuda(
    kt: KernelTables,
    rays: torch.Tensor,
    live: torch.Tensor | None = None,
    counters: torch.Tensor | None = None,
) -> torch.Tensor:
    """Launch K2.1 (csrc/trace.cu) on CUDA tensors → [11, n] f32.
    ``counters``: optional int64 [4] device tensor that receives the box
    tests, triangle tests, per-instance ray transforms and interpolated hits
    the launch ran."""
    from clraytracer_tpu_torch.runtime import kernels

    dev = rays.device
    n = rays.shape[1]
    if dev.type != "cuda" or kt.planes.device != dev:
        raise ValueError("trace_cuda needs the rays and tables on one CUDA device")
    if rays.dtype != torch.float32 or rays.shape[0] != 6 or not rays.is_contiguous():
        raise ValueError("rays must be a contiguous [6, n] f32 tensor")
    if live is not None and (live.shape != (n,) or live.dtype != torch.float32):
        raise ValueError("live must be an [n] f32 tensor")
    live = None if live is None else live.contiguous()
    lib = kernels.build_all()["trace.cu"]
    out = torch.empty((11, n), dtype=torch.float32, device=dev)
    tables = kt.as_c()
    code = lib.clrt_trace(
        ctypes.byref(tables), rays.data_ptr(), kernels.ptr(live), n,
        out.data_ptr(), kernels.ptr(counters), kernels.stream_handle(dev),
    )
    kernels.check(code, "clrt_trace")
    trace_cuda.launches += 1
    return out


trace_cuda.launches = 0


def trace(
    scene: Scene,
    origin: torch.Tensor,  # [3, ...] planar
    direction: torch.Tensor,  # [3, ...] planar
    live: torch.Tensor | None = None,  # [...] bool
    return_slots: bool = False,
) -> SceneHit:
    """Nearest hit per ray (the JAX ``trace_pallas`` contract,
    trace_pallas.py:1126-1251): dead lanes report ``hit=False``; ``tri`` is
    the arena triangle index, or the raw cluster slot with
    ``return_slots``."""
    kt = kernel_tables(scene)
    shape = origin.shape[1:]
    rays = torch.cat(
        [origin.reshape(3, -1), direction.reshape(3, -1)]
    ).float().contiguous()
    lv = None if live is None else live.reshape(-1).float().contiguous()
    if rays.device.type == "cuda":
        out = trace_cuda(kt, rays, lv)
    else:
        out = trace_plain(kt, rays, lv)
    t = out[0].reshape(shape)
    slot = out[3].view(torch.int32).reshape(shape)
    inst = out[4].view(torch.int32).reshape(shape)
    hit = (t < BIG) if live is None else (t.abs() < BIG)
    if return_slots:
        tri = slot
    else:
        idx = slot.long().clamp(0, kt.tri_gid.shape[0] - 1)
        tri = kt.tri_gid[idx].to(torch.int32)
    return SceneHit(
        t=torch.where(hit, t, torch.full_like(t, MISS_DISTANCE)),
        u=out[1].reshape(shape),
        v=out[2].reshape(shape),
        tri=tri,
        instance=inst,
        hit=hit,
        attr_normal=out[5:8].reshape((3,) + tuple(shape)),
        attr_uu=out[8].reshape(shape),
        attr_vv=out[9].reshape(shape),
        attr_mat=out[10].reshape(shape),
    )
