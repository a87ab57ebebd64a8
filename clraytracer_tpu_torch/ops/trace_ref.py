"""Reference tracers: brute force (the golden) and stack-based BVH
traversal, the JAX package's ``ops/trace_ref.py`` in torch.

* ``trace_brute``: every ray against every triangle of each instanced
  mesh, chunked over triangles. Correct by construction.
* ``trace_bvh``: the reference's ordered near-child-first stack traversal
  (kernel_main.cl:124-160) with a 32-entry stack per ray and the
  250-iteration protection cap. The JAX package runs it as a per-ray
  vmapped while loop; here the rays advance in lock step
  (``trace_wavefront._traverse_batch``), each with its own stack: one pop
  per ray per round, so each ray visits its nodes in the same order and
  keeps the reference's inside-box miss quirk.

Both loop over mesh instances like the Trace kernel (kernel_main.cl:198-
217): the ray moves into each instance's object space by its cached
inverse transform, and the closest accepted ``t`` is compared across
instances (object-space t, as in the reference). Hits carry the arena
triangle index and the winning instance's object-space ray
(``mesh_origin``/``mesh_direction``, [..., 3]). These are plain torch
code on any device, not kernels: the port's golden, its tracer for scenes
without cluster tables, and choices by name (``render.TRACERS``).

A tracer takes ``live`` ([...] bool, or None): the dead lanes report a
miss without being traced, as K2.1's do.
"""

from __future__ import annotations

import numpy as np
import torch

from clraytracer_tpu_torch.ops.intersect import moller_trumbore, take_min
from clraytracer_tpu_torch.ops.trace import SceneHit
from clraytracer_tpu_torch.scene.types import MISS_DISTANCE, Scene

_STACK_SIZE = 32


def _instance_tables(scene: Scene):
    """Host-side per-instance (mesh index, triangle start, count, root)."""
    mesh_idx = np.asarray(scene.instances.mesh_index, np.int64)
    starts = np.asarray(scene.bvh.mesh_tri_start, np.int64)[mesh_idx]
    counts = np.asarray(scene.bvh.mesh_tri_count, np.int64)[mesh_idx]
    roots = np.asarray(scene.bvh.roots, np.int64)[mesh_idx]
    return mesh_idx, starts, counts, roots


def _merge(best: SceneHit, cand: SceneHit) -> SceneHit:
    """Keep the closer accepted hit (strict <, as the reference's
    ``triout.t = besthit.distance`` chaining does)."""
    take = cand.hit & (cand.t < best.t)
    sel = lambda a, b: torch.where(take, a, b)
    sel3 = lambda a, b: torch.where(take[..., None], a, b)
    return SceneHit(
        t=sel(cand.t, best.t),
        u=sel(cand.u, best.u),
        v=sel(cand.v, best.v),
        tri=sel(cand.tri, best.tri),
        instance=sel(cand.instance, best.instance),
        hit=best.hit | take,
        mesh_origin=sel3(cand.mesh_origin, best.mesh_origin),
        mesh_direction=sel3(cand.mesh_direction, best.mesh_direction),
    )


def _empty_hit(origin: torch.Tensor, direction: torch.Tensor) -> SceneHit:
    """No hit yet for rays [..., 3] (the zeros derive from the rays, as the
    JAX package's do)."""
    zero = (origin[..., 0] + direction[..., 0]) * 0.0
    zero_i = zero.to(torch.int32)
    return SceneHit(
        t=zero + MISS_DISTANCE, u=zero, v=zero, tri=zero_i, instance=zero_i,
        hit=zero_i > 0, mesh_origin=origin, mesh_direction=direction,
    )


def object_space_ray(scene: Scene, inst: int, origin, direction):
    """Rays [..., 3] into instance ``inst``'s object space (the row-vector
    ``math3d.transform_point``/``transform_vector``)."""
    inv = scene.instances.inverse_transform[inst]
    rot = inv[:3, :3]
    o = torch.sum(origin[..., :, None] * rot, dim=-2) + inv[3, :3]
    d = torch.sum(direction[..., :, None] * rot, dim=-2)
    return o, d


def per_live_ray(trace_flat, origin, direction, live):
    """Planar [3, ...] rays → a SceneHit of [...] fields from
    ``trace_flat(o [N, 3], d [N, 3])``, which sees the live rays only
    (all of them when ``live`` is None); dead lanes report a miss."""
    shape = origin.shape[1:]
    flat_o = torch.movedim(origin, 0, -1).reshape(-1, 3)
    flat_d = torch.movedim(direction, 0, -1).reshape(-1, 3)
    if live is None:
        best = trace_flat(flat_o, flat_d)
    else:
        idx = torch.nonzero(live.reshape(-1))[:, 0]
        sub = trace_flat(flat_o[idx], flat_d[idx])
        best = _empty_hit(flat_o, flat_d)
        best = SceneHit(*(
            None if b is None else b.index_put((idx,), s)
            for b, s in zip(best, sub)
        ))
    return SceneHit(*(
        None if x is None else x.reshape(tuple(shape) + x.shape[1:]) for x in best
    ))


# ---------------------------------------------------------------------------
# brute force (golden)
# ---------------------------------------------------------------------------


def trace_brute(
    scene: Scene,
    origin: torch.Tensor,  # [3, ...] planar
    direction: torch.Tensor,  # [3, ...] planar
    live: torch.Tensor | None = None,
    chunk: int = 2048,
) -> SceneHit:
    """All rays x all triangles per instance, chunked over triangles."""
    _, starts, counts, _ = _instance_tables(scene)
    tris = scene.tris

    def trace_flat(flat_o, flat_d):
        best = _empty_hit(flat_o, flat_d)
        for inst in range(int(scene.instances.count)):
            o, d = object_space_ray(scene, inst, flat_o, flat_d)
            start, count = int(starts[inst]), int(counts[inst])
            for cs in range(start, start + count, chunk):
                ce = min(cs + chunk, start + count)
                t, u, v, ok = moller_trumbore(
                    o[:, None, :], d[:, None, :], tris.v0[cs:ce], tris.v1[cs:ce],
                    tris.v2[cs:ce], best.t[:, None],
                )
                k, (tk, uk, vk) = take_min(
                    torch.where(ok, t, torch.full_like(t, MISS_DISTANCE)), u, v
                )
                cand = SceneHit(
                    t=tk, u=uk, v=vk, tri=(k + cs).to(torch.int32),
                    instance=torch.full_like(k, inst, dtype=torch.int32),
                    hit=tk < MISS_DISTANCE, mesh_origin=o, mesh_direction=d,
                )
                best = _merge(best, cand)
        return best

    return per_live_ray(trace_flat, origin, direction, live)


# ---------------------------------------------------------------------------
# stack-based BVH traversal
# ---------------------------------------------------------------------------


def trace_all_instances(scene: Scene, flat_o, flat_d, stack_size: int) -> SceneHit:
    """The instance loop of the BVH tracers over flat rays [N, 3]: each
    instance's walk (``trace_wavefront._traverse_batch``) starts from the
    best t so far."""
    from clraytracer_tpu_torch.ops.trace_wavefront import _traverse_batch

    best = _empty_hit(flat_o, flat_d)
    _, _, _, roots = _instance_tables(scene)
    for inst in range(int(scene.instances.count)):
        o, d = object_space_ray(scene, inst, flat_o, flat_d)
        t, u, v, tri, hit = _traverse_batch(
            scene, int(roots[inst]), o, d, best.t, stack_size
        )
        cand = SceneHit(
            t=t, u=u, v=v, tri=tri, instance=torch.full_like(tri, inst), hit=hit,
            mesh_origin=o, mesh_direction=d,
        )
        best = _merge(best, cand)
    return best


def trace_bvh(
    scene: Scene,
    origin: torch.Tensor,  # [3, ...] planar
    direction: torch.Tensor,
    live: torch.Tensor | None = None,
) -> SceneHit:
    """BVH traversal over all instances, a 32-entry stack per ray."""
    return per_live_ray(
        lambda o, d: trace_all_instances(scene, o, d, _STACK_SIZE),
        origin, direction, live,
    )
