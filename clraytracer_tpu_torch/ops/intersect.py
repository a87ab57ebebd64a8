"""Ray-triangle and ray-AABB intersection (branchless, batched): the JAX
package's ``ops/intersect.py`` in torch, with the same expression order.

Semantics match the reference's OpenCL/SSE twins exactly:

* Möller–Trumbore with **no** parallel-ray epsilon (the ``fabs(a) < eps``
  reject is commented out in the reference, kernel_main.cl:90) and the
  accept mask ``t > 0 && t < best_t && u in [0,1] && v >= 0 && u+v <= 1``
  (kernel_main.cl:99-104).
* Slab AABB test returning ``tnear`` or MISS with ``tnear < tfar && tnear
  > 0 && tnear < best_t`` (kernel_main.cl:108-117): a ray starting
  *inside* a box counts as a miss (tnear <= 0), kept for image parity.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from clraytracer_tpu_torch.scene.types import MISS_DISTANCE


class TriHit(NamedTuple):
    """Closest-hit record over a triangle batch (reference Triout,
    kernel_main.cl:45-47)."""

    t: torch.Tensor  # [...] f32 (best_t when no hit)
    u: torch.Tensor
    v: torch.Tensor
    tri: torch.Tensor  # [...] i32 triangle index
    hit: torch.Tensor  # [...] bool


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Cross product over the last axis, broadcasting (``jnp.cross``)."""
    ax, ay, az = a.unbind(-1)
    bx, by, bz = b.unbind(-1)
    return torch.stack([ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx], dim=-1)


def moller_trumbore(origin, direction, v0, v1, v2, best_t):
    """Branchless Möller–Trumbore; all arguments broadcast ([..., 3] vectors,
    [...] best_t). Returns (t, u, v, ok): ``ok`` is the reference's accept
    mask, t/u/v are raw."""
    e1 = v1 - v0
    e2 = v2 - v0
    h = cross(direction, e2)
    a = torch.sum(e1 * h, dim=-1)
    f = 1.0 / a  # inf for parallel rays, as in the reference
    s = origin - v0
    u = f * torch.sum(s * h, dim=-1)
    q = cross(s, e1)
    v = f * torch.sum(direction * q, dim=-1)
    t = f * torch.sum(e2 * q, dim=-1)
    ok = (t > 0.0) & (t < best_t) & (u >= 0.0) & (u <= 1.0) & (v >= 0.0) & (u + v <= 1.0)
    return t, u, v, ok


def take_min(t_masked: torch.Tensor, *planes: torch.Tensor):
    """The first index of the minimum over the last axis of ``t_masked`` and
    each of ``planes`` at it (``jnp.argmin`` + ``take_along_axis``)."""
    k = torch.argmin(t_masked, dim=-1)
    take = lambda x: torch.gather(x, -1, k[..., None])[..., 0]
    return k, [take(p) for p in (t_masked, *planes)]


def intersect_tris(
    origin: torch.Tensor,  # [..., 3]
    direction: torch.Tensor,  # [..., 3]
    v0: torch.Tensor,  # [T, 3]
    v1: torch.Tensor,
    v2: torch.Tensor,
    best_t: torch.Tensor,  # [...]
    tri_offset: int = 0,
) -> TriHit:
    """Closest hit of each ray against a triangle batch: ``[..., T]``
    candidates, min-reduced. ``tri_offset`` shifts the reported index."""
    t, u, v, ok = moller_trumbore(
        origin[..., None, :], direction[..., None, :], v0, v1, v2, best_t[..., None]
    )
    k, (_tk, tk, uk, vk, hit) = take_min(
        torch.where(ok, t, torch.full_like(t, MISS_DISTANCE)), t, u, v, ok
    )
    return TriHit(
        t=torch.where(hit, tk, best_t), u=uk, v=vk,
        tri=(k + tri_offset).to(torch.int32), hit=hit,
    )


def intersect_aabb(
    origin: torch.Tensor,  # [..., 3]
    inv_dir: torch.Tensor,  # [..., 3]
    bmin: torch.Tensor,  # [..., 3]
    bmax: torch.Tensor,  # [..., 3]
    best_t: torch.Tensor,  # [...]
) -> torch.Tensor:
    """Slab test → tnear, or MISS_DISTANCE (reference kernel_main.cl:108-117)."""
    t0 = (bmin - origin) * inv_dir
    t1 = (bmax - origin) * inv_dir
    tnear = torch.amax(torch.minimum(t0, t1), dim=-1)
    tfar = torch.amin(torch.maximum(t0, t1), dim=-1)
    ok = (tnear < tfar) & (tnear > 0.0) & (tnear < best_t)
    return torch.where(ok, tnear, torch.full_like(tnear, MISS_DISTANCE))
