"""Instance sharding: the scene-parallel axis (the JAX package's
``parallel/geometry.py``).

``parallel/sharding.py`` shards the pixel rows. This module adds the
other axis: each rank of a ``geo`` group walks only its block of
``ceil(I / n)`` instances, and the closest hits of the group are combined
per ray with a min and a masked sum all-reduce. On a 2-D mesh
(``make_mesh_2d``) rows shard over the ``rows`` groups and instances over
the ``geo`` groups.

Combining hit records (five numbers a ray) rather than gathering geometry
keeps the collective at O(rays), whatever the scene's size.

Ties: the sequential instance loop keeps the first instance at equal t
(``trace_ref._merge`` takes a candidate only when strictly closer), and
the instances are dealt to the ranks in ascending blocks, so the lowest
rank holding the least t is the same winner: the records equal
``trace_wavefront``'s bit for bit. The walk is the wavefront tracer's,
plain torch on any device; no kernel runs in it.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from clraytracer_tpu_torch.config import RenderConfig
from clraytracer_tpu_torch.diff import make_differentiable_tracer
from clraytracer_tpu_torch.ops.post import post_process
from clraytracer_tpu_torch.ops.trace import SceneHit
from clraytracer_tpu_torch.ops.trace_ref import (
    _empty_hit,
    _instance_tables,
    _merge,
    object_space_ray,
    per_live_ray,
)
from clraytracer_tpu_torch.ops.trace_wavefront import (
    _STACK_SIZE,
    WAVEFRONT_CHUNK,
    _traverse_batch,
)
from clraytracer_tpu_torch.parallel.sharding import (
    DeviceMesh,
    _all_gather_rows,
    _all_reduce,
    _check_device,
    _pad_rows,
    _shade_rows,
    _train_step,
    local_device,
)
from clraytracer_tpu_torch.render import FrameInputs
from clraytracer_tpu_torch.scene.types import MISS_DISTANCE, Scene


#: the names of the 2-D mesh's axes, as in the JAX package: instance
#: blocks along ``GEO_AXIS`` (``Mesh2D.geo``), rows along ``RAY_AXIS``
#: (``Mesh2D.rows``; the name of ``parallel.sharding.AXIS``)
GEO_AXIS = "geo"
RAY_AXIS = "devices"


@dataclasses.dataclass(frozen=True)
class Mesh2D:
    """A 2-D mesh of ``n_rows x n_geo`` ranks: world rank ``r`` is row
    shard ``r // n_geo`` and instance block ``r % n_geo``. ``rows``: this
    rank's group along the row axis (``RAY_AXIS``; the ranks of its
    instance block), ``geo``: its group along the instance axis
    (``GEO_AXIS``; the ranks of its rows)."""

    rows: DeviceMesh
    geo: DeviceMesh


def combine_hits(best: SceneHit, mesh: DeviceMesh) -> SceneHit:
    """The closest of the mesh's hit records per ray, on every rank
    (geometry.py:49 of the JAX package): min t, ties to the lowest rank,
    the winner's fields by a sum all-reduce of the records masked to it.

    The records come from a tracer that runs under ``torch.no_grad()``
    (``diff.make_differentiable_tracer`` recomputes t, u and v from the
    hit triangle with autograd), so no gradient needs to pass through
    these collectives."""
    n = mesh.size
    t = best.t
    t_min = _all_reduce(mesh, torch.where(best.hit, t, torch.full_like(t, MISS_DISTANCE)),
                        dist.ReduceOp.MIN)
    rank = torch.full_like(best.tri, mesh.rank)
    owner = _all_reduce(mesh, torch.where(best.hit & (t == t_min), rank,
                                          torch.full_like(rank, n)), dist.ReduceOp.MIN)
    hit_any = owner < n
    win = hit_any & (owner == mesh.rank)
    # one sum for the floats, one for the indices
    fl = _all_reduce(mesh, torch.where(win, torch.stack([t, best.u, best.v]), 0.0))
    ix = _all_reduce(mesh, torch.where(win, torch.stack([best.tri, best.instance]), 0))
    return SceneHit(
        t=torch.where(hit_any, fl[0], torch.full_like(t, MISS_DISTANCE)),
        u=fl[1], v=fl[2], tri=ix[0], instance=ix[1], hit=hit_any,
    )


def make_geo_sharded_tracer(mesh: DeviceMesh):
    """A ``Tracer`` over the mesh's instance blocks (geometry.py:89 of the
    JAX package): rank ``k`` walks instances ``[k * p, (k + 1) * p)``,
    ``p = ceil(I / n)``, with the wavefront walk, each from the best t of
    its block so far, then ``combine_hits``. Every rank of the mesh calls
    it on the same rays and live mask; a rank whose block is empty
    contributes misses."""

    def tracer(scene: Scene, origin, direction, live=None) -> SceneHit:
        _, _, _, roots = _instance_tables(scene)
        n_inst = int(scene.instances.count)
        per = -(-n_inst // mesh.size)
        block = range(mesh.rank * per, min((mesh.rank + 1) * per, n_inst))

        def walk(flat_o, flat_d):
            best = _empty_hit(flat_o, flat_d)
            for inst in block:
                o, d = object_space_ray(scene, inst, flat_o, flat_d)
                t, u, v, tri, hit = _traverse_batch(
                    scene, int(roots[inst]), o, d, best.t, _STACK_SIZE
                )
                best = _merge(best, SceneHit(
                    t=t, u=u, v=v, tri=tri, instance=torch.full_like(tri, inst),
                    hit=hit, mesh_origin=o, mesh_direction=d,
                ))
            return best

        def trace_flat(flat_o, flat_d):
            # the wavefront tracer's chunks, then one combine of them all
            # (one chunk, perhaps empty, where no ray is live)
            parts = [walk(flat_o[c:c + WAVEFRONT_CHUNK], flat_d[c:c + WAVEFRONT_CHUNK])
                     for c in range(0, max(1, flat_o.shape[0]), WAVEFRONT_CHUNK)]
            best = SceneHit(*(torch.cat(p) if p[0] is not None else None
                              for p in zip(*parts)))
            return combine_hits(best, mesh)

        return per_live_ray(trace_flat, origin, direction, live)

    return tracer


def make_mesh_2d(n_ray_shards: int, n_geo_shards: int,
                 device: str | torch.device | None = None) -> Mesh2D:
    """The 2-D mesh over the first ``n_ray_shards * n_geo_shards`` ranks of
    the default group (geometry.py:148 of the JAX package). Every rank of
    the default group calls it: the groups are made by ``dist.new_group``
    on every rank in the same order, the instance-axis groups first."""
    n = n_ray_shards * n_geo_shards
    if not dist.is_initialized() or dist.get_world_size() < n:
        raise ValueError(f"a {n_ray_shards}x{n_geo_shards} mesh needs {n} ranks")
    rank = dist.get_rank()
    geo = [dist.new_group([i * n_geo_shards + g for g in range(n_geo_shards)])
           for i in range(n_ray_shards)]
    rows = [dist.new_group([i * n_geo_shards + g for i in range(n_ray_shards)])
            for g in range(n_geo_shards)]
    if rank >= n:
        raise ValueError(f"rank {rank} lies outside the {n_ray_shards}x{n_geo_shards} mesh")
    dev = local_device(device)
    i, g = divmod(rank, n_geo_shards)
    return Mesh2D(rows=DeviceMesh(rows[g], i, n_ray_shards, dev),
                  geo=DeviceMesh(geo[i], g, n_geo_shards, dev))


def render_sharded_2d(
    scene: Scene,
    frame: FrameInputs,
    config: RenderConfig,
    mesh: Mesh2D,
) -> torch.Tensor:
    """The whole frame over a 2-D mesh → [H, W, 3] on every rank
    (geometry.py:227 of the JAX package): the rows shard over ``rows`` as
    in ``render_sharded``'s planar path, the instances over ``geo``
    (``make_geo_sharded_tracer``), the windows gather over ``rows``, then
    the post chain."""
    _check_device(scene, mesh.rows)
    w, h = config.width, config.height
    local_rows = _pad_rows(h, mesh.rows.size) // mesh.rows.size
    local = _shade_rows(
        scene, frame, w, h, mesh.rows.rank * local_rows, local_rows, config.bounces,
        make_geo_sharded_tracer(mesh.geo), config.reference_parity_shading,
        config.integer_colors,
    )
    img = _all_gather_rows(mesh.rows, local)[:h]
    if config.enable_post:
        img = post_process(img, enable_fxaa=config.enable_fxaa)
    return img


def train_step_sharded_2d(
    scene: Scene,
    frame: FrameInputs,
    target: torch.Tensor,  # [H, W, 3], H a multiple of the row-axis size
    mesh: Mesh2D,
    lr: float = 1e-2,
    bounces: int = 2,
) -> tuple[torch.Tensor, Scene]:
    """One SGD step over a 2-D mesh (geometry.py:160 of the JAX package):
    ``parallel.sharding.train_step_sharded`` with the instance-sharded
    tracer under the differentiable recompute. The recompute runs on the
    combined records, so each rank's gradient is the same across its
    ``geo`` group, and the all-reduce sums over ``rows`` only (a sum over
    ``geo`` too would count each gradient ``n_geo`` times). Returns (loss /
    (H * W * 3), the updated scene), the same on every rank."""
    height, width = target.shape[0], target.shape[1]
    return _train_step(scene, frame, target, mesh.rows, lr, width, height, bounces,
                       make_differentiable_tracer(make_geo_sharded_tracer(mesh.geo)))
