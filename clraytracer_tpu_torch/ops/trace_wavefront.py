"""Wavefront BVH traversal: explicitly batched, one loop, no per-ray
control flow (the JAX package's ``ops/trace_wavefront.py`` in torch).

Every ray advances in lock-step rounds:

* State is SoA over all rays: stack [N, S], stack pointer [N], best hit [N].
* Each round every live ray pops one node; leaf-vs-inner is handled by
  masking (both paths computed, ``torch.where`` selects) instead of
  branching.
* Leaves are intersected as a fixed-size batch of ``max_leaf_size``
  triangle slots: a dense [N, L] test whose first minimum is the hit the
  reference's sequential strict-closer loop over the leaf accepts.

Traversal semantics match the reference: ordered near-child-first
descent, the same slab/Möller-Trumbore accept rules (a ray starting inside
a box misses it) and the 250-round protection cap (kernel_main.cl:126-131).
A ray pops once per round while its stack is not empty, so its visit
order is that of the per-ray loop (``trace_ref.trace_bvh`` runs this walk
with the JAX ``trace_bvh``'s 32-entry stack). Plain torch code on any
device; the port's tracer for scenes without cluster tables.
"""

from __future__ import annotations

import torch

from clraytracer_tpu_torch.ops.intersect import moller_trumbore, take_min
from clraytracer_tpu_torch.ops.trace import SceneHit
from clraytracer_tpu_torch.ops.trace_ref import per_live_ray, trace_all_instances
from clraytracer_tpu_torch.scene.types import MISS_DISTANCE, Scene

_STACK_SIZE = 48
_MAX_ROUNDS = 250  # reference protection cap

#: rays per sequential chunk: the lock-step state (the [N, 48] stack and
#: the [N, L, 3] leaf gathers) grows with the batch, so a 1080p frame runs
#: in chunks of this many rays
WAVEFRONT_CHUNK = 128 * 1024


def _traverse_batch(
    scene: Scene,
    root: int,
    o: torch.Tensor,  # [N, 3]
    d: torch.Tensor,  # [N, 3]
    t_init: torch.Tensor,  # [N]
    stack_size: int = _STACK_SIZE,
):
    """One instance's walk for every ray → (t, u, v, tri, hit), [N] each."""
    bvh = scene.bvh
    tris = scene.tris
    n = o.shape[0]
    dev = o.device
    inv_dir = 1.0 / d
    leaf_size = max(1, int(bvh.max_leaf_size))
    n_nodes = bvh.tri_count.shape[0]
    n_tris = tris.v0.shape[0]
    slots = torch.arange(leaf_size, dtype=torch.int32, device=dev)

    zero = (o[:, 0] + d[:, 0] + t_init) * 0.0
    zero_i = zero.to(torch.int32)
    stack = torch.zeros((n, stack_size), dtype=torch.int32, device=dev) + zero_i[:, None]
    stack[:, 0] = root
    sp = zero_i + 1
    t, u, v, tri, hit = t_init, zero, zero, zero_i, zero_i > 0

    clip = lambda idx, size: idx.clamp(0, size - 1).long()
    for _ in range(_MAX_ROUNDS):
        active = sp > 0
        if not bool(active.any()):
            break
        sp = torch.where(active, sp - 1, sp)
        node = torch.gather(stack, 1, clip(sp, stack_size)[:, None])[:, 0]
        node = torch.where(active, node, torch.zeros_like(node))

        tri_count = bvh.tri_count[clip(node, n_nodes)]
        left_first = bvh.left_first[clip(node, n_nodes)]
        is_leaf = active & (tri_count > 0)
        is_inner = active & (tri_count == 0)

        # ---- leaf path: dense fixed-width triangle batch
        tri_idx = left_first[:, None] + slots
        tri_valid = is_leaf[:, None] & (slots < tri_count[:, None])
        safe_idx = torch.where(tri_valid, tri_idx, torch.zeros_like(tri_idx))
        g = clip(safe_idx, n_tris)
        tt, uu, vv, ok = moller_trumbore(
            o[:, None, :], d[:, None, :], tris.v0[g], tris.v1[g], tris.v2[g], t[:, None]
        )
        ok = ok & tri_valid
        _, (_tk, tk, uk, vk, idx_k, leaf_hit) = take_min(
            torch.where(ok, tt, torch.full_like(tt, MISS_DISTANCE)), tt, uu, vv,
            safe_idx, ok,
        )
        t = torch.where(leaf_hit, tk, t)
        u = torch.where(leaf_hit, uk, u)
        v = torch.where(leaf_hit, vk, v)
        tri = torch.where(leaf_hit, idx_k, tri)
        hit = hit | leaf_hit

        # ---- inner path: ordered children push
        left = left_first
        right = left + 1

        def slab(child):
            c = clip(child, n_nodes)
            t0 = (bvh.node_min[c] - o) * inv_dir
            t1 = (bvh.node_max[c] - o) * inv_dir
            tnear = torch.amax(torch.minimum(t0, t1), dim=-1)
            tfar = torch.amin(torch.maximum(t0, t1), dim=-1)
            ok_box = (tnear < tfar) & (tnear > 0.0) & (tnear < t)
            return torch.where(ok_box, tnear, torch.full_like(tnear, MISS_DISTANCE))

        d1 = slab(left)
        d2 = slab(right)
        near = torch.where(d1 <= d2, left, right)
        far = torch.where(d1 <= d2, right, left)
        dnear = torch.minimum(d1, d2)
        dfar = torch.maximum(d1, d2)

        # push far first (popped last), then near
        push_far = is_inner & (dfar < MISS_DISTANCE)
        stack = _scatter_push(stack, sp, far, push_far)
        sp2 = torch.where(push_far, sp + 1, sp)
        push_near = is_inner & (dnear < MISS_DISTANCE)
        stack = _scatter_push(stack, sp2, near, push_near)
        sp = torch.where(push_near, sp2 + 1, sp2)
    return t, u, v, tri, hit


def _scatter_push(stack, sp, value, mask):
    """``stack[i, sp[i]] = value[i]`` where ``mask``; a push past the top
    of the stack is dropped, as the JAX package's one-hot select drops it."""
    write = mask & (sp < stack.shape[1])
    rows = torch.nonzero(write)[:, 0]
    out = stack.clone()
    out[rows, sp[rows].long()] = value[rows]
    return out


def trace_wavefront(
    scene: Scene,
    origin: torch.Tensor,  # [3, ...] planar
    direction: torch.Tensor,
    live: torch.Tensor | None = None,
) -> SceneHit:
    """Batched BVH trace over all instances, ``WAVEFRONT_CHUNK`` rays at a
    time (the last chunk padded with origin 0 and direction 1, so 1/d
    stays finite)."""

    def trace_flat(flat_o, flat_d):
        n = flat_o.shape[0]
        if n <= WAVEFRONT_CHUNK:
            return trace_all_instances(scene, flat_o, flat_d, _STACK_SIZE)
        pad = -n % WAVEFRONT_CHUNK
        if pad:
            flat_o = torch.cat([flat_o, flat_o.new_zeros((pad, 3))])
            flat_d = torch.cat([flat_d, flat_d.new_ones((pad, 3))])
        chunks = [
            trace_all_instances(
                scene, flat_o[c : c + WAVEFRONT_CHUNK], flat_d[c : c + WAVEFRONT_CHUNK],
                _STACK_SIZE,
            )
            for c in range(0, n + pad, WAVEFRONT_CHUNK)
        ]
        return SceneHit(*(
            None if parts[0] is None else torch.cat(parts)[:n] for parts in zip(*chunks)
        ))

    return per_live_ray(trace_flat, origin, direction, live)

