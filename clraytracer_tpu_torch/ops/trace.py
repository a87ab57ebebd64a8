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
* ``pick_cuda`` launches the same file's pick entry: one ray walked as
  K2.1 walks it and its whole hit record, packed (``raycast.pick`` on the
  card; its plain version is ``raycast.raycast`` then
  ``raycast.pack_record``).

The module owns the device tables the kernels read, ``KernelTables`` and
``FrameTables``. A scene's tables are kept with its ``packed`` object
(``_keep``), for the ``clusters`` object and instance meshes they were
built from; its first ``kernel_tables`` or ``frame_tables`` builds both.
An edit makes a new ``packed`` object and keeps with it tables made from
the old ones (``carry``): new instance rows and world boxes (csrc/instbox.cu
on the card, ``instance_boxes_plain`` elsewhere, bit for bit), new material
rows where they were rebuilt, every other table the same tensor. Nothing is
written in place: a frame still queued reads the tables it was given.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math
from typing import NamedTuple

import numpy as np
import torch

from clraytracer_tpu_torch.ops.clusters import CLUSTER_SIZE
from clraytracer_tpu_torch.ops.shade import _OFF_MASK, _OFF_SHIFT
from clraytracer_tpu_torch.scene import procedural_tex as ptex
from clraytracer_tpu_torch.scene.types import MISS_DISTANCE, Clusters, Instances, Scene
from clraytracer_tpu_torch.utils.timer import ScopeTimer

BIG = 1e30  # rounds to the f32 miss sentinel of the kernels
#: instances a chunk box holds (the instance level's upper step, above
#: this many instances): csrc/traverse.cuh CLRT_ICHUNK, which the kernels
#: index the chunk boxes by
INSTANCE_CHUNK = 32
#: the kernels' optional int64 counters (csrc/traverse.cuh TestCount): work
#: the rays' own walks needed (box tests, triangle tests of real, non-padding
#: slots, per-instance ray transforms, interpolated hits), then the warps'
#: steps (32-child node tests, clusters staged into shared memory)
COUNTER_NAMES = (
    "boxes", "triangles", "ray_transforms", "hits", "node_steps", "staged_clusters",
)


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
    # the instance level's world boxes (``_with_rows``), from ``inst``
    inst_box: torch.Tensor  # [I, 8] f32: min xyz | max xyz | alpha | beta
    chunk_box: torch.Tensor  # [n_chunks, 8] f32: 32 instances' union each

    @property
    def n_inst(self) -> int:
        return len(self.ranges_host)

    @property
    def n_chunks(self) -> int:
        return self.chunk_box.shape[0]

    def as_c(self):
        from clraytracer_tpu_torch.runtime.kernels import SceneTablesC

        for t in (self.hyper_box, self.super_box, self.cluster_box, self.planes,
                  self.inst_box, self.chunk_box):
            if t.data_ptr() % 16:
                raise ValueError("box and plane tables must be 16-byte aligned")
        if self.n_chunks != chunk_count(self.n_inst):
            raise ValueError("chunk boxes must number chunk_count(n_inst)")
        return SceneTablesC(
            self.inst.data_ptr(), self.ranges.data_ptr(),
            self.hyper_box.data_ptr(), self.super_box.data_ptr(),
            self.cluster_box.data_ptr(), self.planes.data_ptr(),
            self.attrs.data_ptr(), self.n_inst, self.inst_box.data_ptr(),
            self.chunk_box.data_ptr(), self.n_chunks,
        )


@dataclasses.dataclass(frozen=True)
class FrameTables:
    """Per-scene shading tables of the fused frame, on the scene's device."""

    mat_rows: torch.Tensor  # [M, 16] f32
    tex: torch.Tensor  # [D, TEX_COLS] f32 procedural descriptors
    descs: tuple  # ((off_hi, off_lo, ProceduralTexture), ...)


@dataclasses.dataclass(frozen=True)
class _Kept:
    """A ``packed`` object's tables, for the ``clusters`` and meshes named,
    and the frame plans made over them (``render_fused.render_plan``), which
    an instance edit hands on with the frame tables."""

    clusters: Clusters
    mesh_index: tuple[int, ...]
    kernel: KernelTables
    frame: FrameTables
    plans: dict


def _per_slot(*tables: torch.Tensor) -> torch.Tensor:
    """[C, 128] tables of 4 components x 32 slots → [C*32, 4 * len]."""
    cols = [t.reshape(-1, 4, CLUSTER_SIZE).transpose(1, 2) for t in tables]
    return torch.cat(cols, dim=2).reshape(-1, 4 * len(tables)).contiguous()


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous at a 16-byte aligned address: the kernels read box
    and plane rows as float4."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def kernel_tables(scene: Scene) -> KernelTables:
    """The scene's traversal tables (``kept_tables``)."""
    return kept_tables(scene).kernel


def frame_tables(scene: Scene) -> FrameTables:
    """The scene's fused-frame tables (``kept_tables``)."""
    return kept_tables(scene).frame


def kept_tables(scene: Scene, build: bool = True) -> _Kept | None:
    """The tables kept with ``scene.packed`` for its instance meshes, with
    the frame plans made over them; built at the scene's first use, or
    None there without ``build``."""
    kept = _kept(scene)
    if kept is not None and (kept.mesh_index is scene.instances.mesh_index
                             or kept.mesh_index == scene.instances.mesh_index):
        return kept
    if not build:
        return None
    cl, pk = scene.clusters, scene.packed
    if cl is None or pk is None or cl.hyper_aabb is None:
        raise NotImplementedError(
            "scene built without cluster, hypercluster or packed tables"
        )
    with ScopeTimer("tables.kernel", log=False):
        geometry = KernelTables(
            inst=None, inst_box=None, chunk_box=None,  # the instance part: _with_rows
            hyper_box=_aligned(cl.hyper_aabb.reshape(-1, 8)),
            super_box=_aligned(cl.super_aabb.reshape(-1, 8)),
            cluster_box=_aligned(cl.cluster_aabb.reshape(-1, 8)),
            planes=_aligned(_per_slot(cl.tri_a, cl.tri_b, cl.tri_c)),
            attrs=_per_slot(cl.at_a, cl.at_b, cl.at_c, cl.at_d),
            tri_gid=cl.tri_gid.long(),
            **_ranges(cl, scene.instances.mesh_index),
        )
        kernel = _with_rows(geometry, pk.inst_rows)
    with ScopeTimer("tables.frame", log=False):
        descs = tuple(
            (off >> _OFF_SHIFT, off & _OFF_MASK, desc)
            for _h, off, desc in scene.procedural_tex
        )
        rows = [ptex.descriptor_row(hi, lo, d) for hi, lo, d in descs]
        tex = torch.tensor(
            np.asarray(rows, np.float32).reshape(-1, ptex.TEX_COLS), device=pk.mat_rows.device
        )
        frame = FrameTables(mat_rows=pk.mat_rows.float().contiguous(), tex=tex, descs=descs)
    return _keep(scene, kernel, frame)


def _kept(scene: Scene) -> _Kept | None:
    """The tables kept with ``scene.packed`` if built from ``scene.clusters``."""
    kept = None if scene.packed is None else scene.packed.__dict__.get("_tables")
    return kept if kept is not None and kept.clusters is scene.clusters else None


def _keep(scene: Scene, kernel: KernelTables, frame: FrameTables,
          plans: dict | None = None) -> _Kept:
    """Keep the tables with ``scene.packed``: the one write into a scene object."""
    kept = _Kept(scene.clusters, scene.instances.mesh_index, kernel, frame,
                 {} if plans is None else plans)
    scene.packed.__dict__["_tables"] = kept
    return kept


def _ranges(cl, mesh_index: tuple[int, ...]) -> dict:
    """Each instance's (super start/count, cluster start/count), host and
    device."""
    host = tuple(cl.mesh_ranges[m] for m in mesh_index)
    dev = torch.tensor(host, dtype=torch.int32, device=cl.tri_a.device).reshape(-1, 4)
    return dict(ranges_host=host, ranges=dev)


def _with_rows(kt: KernelTables, inst_rows: torch.Tensor) -> KernelTables:
    """``kt`` with the instance rows ``inst_rows`` and their world boxes:
    one launch of csrc/instbox.cu on the card, its plain version elsewhere."""
    inst = inst_rows.float().contiguous()
    if inst.device.type == "cuda":
        inst_box, chunk_box = instance_boxes_cuda(inst, kt.ranges, kt.hyper_box)
    else:
        inst_box, chunk_box = instance_boxes_plain(inst, kt.ranges_host, kt.hyper_box)
    return dataclasses.replace(kt, inst=inst, inst_box=inst_box, chunk_box=chunk_box)


def carry(old: Scene, new: Scene) -> Scene:
    """``new`` (``old`` with a new ``packed`` object, maybe new instances)
    with tables made from ``old``'s, if it has them: new instance rows and
    world boxes, new ranges and material rows where those changed; the
    other tables are the same tensors. The frame plans go with the frame
    tables: new material rows start none."""
    kept = _kept(old)
    if kept is None:
        return new
    kt, ft, pk = kept.kernel, kept.frame, new.packed
    mesh_index = new.instances.mesh_index
    if mesh_index is not kept.mesh_index and mesh_index != kept.mesh_index:
        kt = dataclasses.replace(kt, **_ranges(new.clusters, mesh_index))
    plans = kept.plans
    if pk.mat_rows is not old.packed.mat_rows:
        ft = dataclasses.replace(ft, mat_rows=pk.mat_rows.float().contiguous())
        plans = None
    _keep(new, _with_rows(kt, pk.inst_rows), ft, plans)
    return new


def with_instances(scene: Scene, inst_rows: torch.Tensor,
                   mesh_index: tuple[int, ...]) -> Scene:
    """``scene`` with the edited instance rows (``Engine.tick``):
    ``inst_rows`` [I, 17] f32 (inverse transform | material start,
    ``SceneBuilder.instance_rows``) of the instances of ``mesh_index``
    become its packed object's and tables' instance rows, with their world
    boxes (``carry``), and no other table. The instance table's inverse
    transforms are a view of them; its material starts, which only a new
    instance changes, stay the same tensor for the same ``mesh_index``."""
    with ScopeTimer("tables.instances", log=False):
        old = scene.instances
        if mesh_index is old.mesh_index:
            material_start = old.material_start
        else:
            material_start = inst_rows[:, 16].to(torch.int32)
        instances = Instances(inverse_transform=inst_rows[:, :16].reshape(-1, 4, 4),
                              material_start=material_start, mesh_index=mesh_index)
        packed = dataclasses.replace(scene.packed, inst_rows=inst_rows)
        return carry(scene, dataclasses.replace(scene, instances=instances, packed=packed))


# ---------------------------------------------------------------------------
# the instance level's world boxes
# ---------------------------------------------------------------------------

#: the margin's factor times float32's unit roundoff, 64 * 2**-24
#: (csrc/instbox.cu CLRT_BOX_K * CLRT_EPS32)
_BOX_MARGIN = 2.0**-18


def chunk_count(n_inst: int) -> int:
    """Chunk boxes of the instance level: none up to INSTANCE_CHUNK
    instances, one per INSTANCE_CHUNK above."""
    return 0 if n_inst <= INSTANCE_CHUNK else -(-n_inst // INSTANCE_CHUNK)


def _round_down(x: torch.Tensor) -> torch.Tensor:
    """f64 → the largest f32 at or below it (``__double2float_rd``)."""
    f = x.float()
    return torch.where(f.double() > x, torch.nextafter(f, torch.full_like(f, -math.inf)), f)


def _round_up(x: torch.Tensor) -> torch.Tensor:
    """f64 → the least f32 at or above it (``__double2float_ru``)."""
    f = x.float()
    return torch.where(f.double() < x, torch.nextafter(f, torch.full_like(f, math.inf)), f)


def instance_boxes_plain(
    inst: torch.Tensor,  # [I, 17] f32: inverse transform | material_start
    ranges_host: tuple[tuple[int, int, int, int], ...],
    hyper_box: torch.Tensor,  # [H, 8] f32
) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain version of csrc/instbox.cu, bit for bit: per instance its
    mesh's root box (the union of its hyper boxes) mapped to world space
    by the inverse of its stored inverse rows, in f64 (cofactors; centre
    and half extent), rounded outwards to f32, with the walk's margin
    alpha | beta; then the union of each chunk of INSTANCE_CHUNK boxes →
    (inst_box [I, 8], chunk_box [chunk_count(I), 8]). A singular or
    non-finite transform gives an unbounded box, an instance without
    triangles one at +inf on every axis."""
    n = len(ranges_host)
    dev = inst.device
    inf = math.inf
    # each distinct mesh's root box once: the union of its hyper boxes
    first, roots, which = {}, [], []
    for sc0, sc_n, _cl0, _cl_n in ranges_host:
        k = first.setdefault((sc0, sc_n), len(roots))
        if k == len(roots):
            hb = hyper_box[sc0 // 32:sc0 // 32 + -(-sc_n // 32)]
            roots.append(torch.cat([hb[:, 0:3].amin(dim=0), hb[:, 3:6].amax(dim=0)])
                         if sc_n else torch.full((6,), inf, device=dev))
        which.append(k)
    root = torch.stack(roots)[torch.tensor(which, device=dev)].double()
    empty = torch.isinf(root[:, 0]) & (root[:, 0] > 0)
    a = [[inst[:, 4 * r + c].double() for c in range(3)] for r in range(3)]
    t = [inst[:, 12 + c].double() for c in range(3)]
    c00 = a[1][1] * a[2][2] - a[1][2] * a[2][1]
    c01 = a[1][2] * a[2][0] - a[1][0] * a[2][2]
    c02 = a[1][0] * a[2][1] - a[1][1] * a[2][0]
    det = a[0][0] * c00 + a[0][1] * c01 + a[0][2] * c02
    f = [[None] * 3 for _ in range(3)]
    f[0][0], f[1][0], f[2][0] = c00 / det, c01 / det, c02 / det
    f[0][1] = (a[0][2] * a[2][1] - a[0][1] * a[2][2]) / det
    f[1][1] = (a[0][0] * a[2][2] - a[0][2] * a[2][0]) / det
    f[2][1] = (a[0][1] * a[2][0] - a[0][0] * a[2][1]) / det
    f[0][2] = (a[0][1] * a[1][2] - a[0][2] * a[1][1]) / det
    f[1][2] = (a[0][2] * a[1][0] - a[0][0] * a[1][2]) / det
    f[2][2] = (a[0][0] * a[1][1] - a[0][1] * a[1][0]) / det
    ctr = [(root[:, r] + root[:, 3 + r]) * 0.5 - t[r] for r in range(3)]
    half = [(root[:, 3 + r] - root[:, r]) * 0.5 for r in range(3)]
    lo, hi = [], []
    zero = torch.zeros(n, dtype=torch.float64, device=dev)
    rw, n_a, n_f, n_t = zero, zero, zero, zero
    for c in range(3):
        wc = ctr[0] * f[0][c] + ctr[1] * f[1][c] + ctr[2] * f[2][c]
        we = half[0] * f[0][c].abs() + half[1] * f[1][c].abs() + half[2] * f[2][c].abs()
        lo.append(wc - we)
        hi.append(wc + we)
        rw = torch.maximum(rw, torch.maximum(lo[c].abs(), hi[c].abs()))
        n_a = torch.maximum(n_a, a[0][c].abs() + a[1][c].abs() + a[2][c].abs())
        n_f = torch.maximum(n_f, f[0][c].abs() + f[1][c].abs() + f[2][c].abs())
        n_t = torch.maximum(n_t, t[c].abs())
    cond = n_a * n_f
    alpha = _BOX_MARGIN * (n_f * n_t + cond * rw)
    beta = _BOX_MARGIN * cond
    lo, hi = torch.stack(lo, dim=1), torch.stack(hi, dim=1)
    finite = ((det != 0) & torch.isfinite(alpha) & torch.isfinite(beta)
              & torch.isfinite(lo).all(dim=1) & torch.isfinite(hi).all(dim=1))
    lo = torch.where(finite[:, None], lo, -inf)
    hi = torch.where(finite[:, None], hi, inf)
    margin = torch.where(finite[:, None], torch.stack([alpha, beta], dim=1), 0.0)
    box = torch.cat([_round_down(lo), _round_up(hi), _round_up(margin)], dim=1)
    box[empty] = torch.tensor([inf] * 6 + [0.0, 0.0], device=dev)
    box = box.contiguous()
    n_chunks = chunk_count(n)
    if n_chunks == 0:
        return box, torch.zeros((0, 8), device=dev)
    pad = torch.tensor([inf] * 6 + [0.0, 0.0], device=dev).expand(
        n_chunks * INSTANCE_CHUNK - n, 8)
    members = torch.cat([box, pad]).reshape(n_chunks, INSTANCE_CHUNK, 8)
    gone = torch.isinf(members[..., 0:1]) & (members[..., 0:1] > 0)
    u_lo = members[..., 0:3].amin(dim=1)
    u_hi = torch.where(gone, -inf, members[..., 3:6]).amax(dim=1)
    u_hi = torch.where(torch.isinf(u_lo[:, 0:1]) & (u_lo[:, 0:1] > 0), inf, u_hi)
    chunk = torch.cat([u_lo, u_hi, members[..., 6:8].amax(dim=1)], dim=1)
    return box, chunk.contiguous()


def instance_boxes_cuda(
    inst: torch.Tensor, ranges: torch.Tensor, hyper_box: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch csrc/instbox.cu (one block) on the tables' CUDA device →
    (inst_box [I, 8], chunk_box [chunk_count(I), 8]), as
    ``instance_boxes_plain``."""
    from clraytracer_tpu_torch.runtime import kernels

    dev = inst.device
    if dev.type != "cuda" or ranges.device != dev or hyper_box.device != dev:
        raise ValueError("instance_boxes_cuda needs its tables on one CUDA device")
    n = inst.shape[0]
    if inst.shape != (n, 17) or ranges.shape != (n, 4) or not inst.is_contiguous():
        raise ValueError("inst must be a contiguous [I, 17] f32 tensor beside [I, 4] ranges")
    box = torch.empty((n, 8), dtype=torch.float32, device=dev)
    chunk = torch.empty((chunk_count(n), 8), dtype=torch.float32, device=dev)
    lib = kernels.build_all()["instbox.cu"]
    code = lib.clrt_instance_boxes(
        inst.data_ptr(), ranges.data_ptr(), hyper_box.data_ptr(), n, box.data_ptr(),
        chunk.data_ptr(), chunk.shape[0], kernels.stream_handle(dev))
    kernels.check(code, "clrt_instance_boxes")
    instance_boxes_cuda.launches += 1
    return box, chunk


instance_boxes_cuda.launches = 0


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
    ``counters``: optional int64 [6] device tensor the launch adds its work
    to, in ``COUNTER_NAMES`` order."""
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
    check_counters(counters, dev)
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

#: words of the pick's record (csrc/trace.cu CLRT_PICK_WORDS): hit (1 or 0)
#: | distance | triangle (i32 bits) | instance (i32 bits) | normal xyz | uv
#: | colour rgb
PICK_WORDS = 12


def pick_cuda(scene: Scene, origin: np.ndarray, direction: np.ndarray) -> torch.Tensor:
    """Launch the pick (csrc/trace.cu ``clrt_pick``, one warp) for one
    world ray, passed by value, over the scene's tables on its CUDA device
    → the [PICK_WORDS] f32 record on the card, bit-equal to
    ``raycast.pack_record(raycast.raycast(scene, o, d, trace))``."""
    from clraytracer_tpu_torch.runtime import kernels

    dev = scene.device
    if dev.type != "cuda":
        raise ValueError("pick_cuda needs a scene on a CUDA device")
    kept = kept_tables(scene)
    kt = kept.kernel
    attr, mat, texels = scene.packed.tri_attr, kept.frame.mat_rows, scene.atlas.texels
    f32 = torch.float32
    for t, dtype in ((attr, f32), (mat, f32), (texels, f32), (kt.tri_gid, torch.int64)):
        if t.device != dev or t.dtype != dtype or not t.is_contiguous() or not len(t):
            raise ValueError("pick_cuda needs contiguous, non-empty tables on the scene's card")
    params = kernels.PickParamsC(
        (ctypes.c_float * 6)(*origin, *direction),
        kt.tri_gid.data_ptr(), attr.data_ptr(), mat.data_ptr(), texels.data_ptr(),
        kt.tri_gid.shape[0], attr.shape[0], mat.shape[0], texels.shape[0], texels.shape[1],
    )
    out = torch.empty(PICK_WORDS, dtype=torch.float32, device=dev)
    code = kernels.build_all()["trace.cu"].clrt_pick(
        ctypes.byref(kt.as_c()), ctypes.byref(params), out.data_ptr(),
        kernels.stream_handle(dev),
    )
    kernels.check(code, "clrt_pick")
    pick_cuda.launches += 1
    return out


pick_cuda.launches = 0


def check_counters(counters: torch.Tensor | None, dev: torch.device) -> None:
    """The kernels add ``len(COUNTER_NAMES)`` int64 counts: refuse any
    other tensor rather than write past it."""
    if counters is not None and (
        counters.shape != (len(COUNTER_NAMES),) or counters.dtype != torch.int64
        or counters.device != dev or not counters.is_contiguous()
    ):
        raise ValueError(
            f"counters must be a contiguous int64 [{len(COUNTER_NAMES)}] tensor on {dev}"
        )


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
