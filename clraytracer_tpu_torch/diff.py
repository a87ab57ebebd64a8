"""Differentiable rendering (the JAX package's ``diff.py``): pixel gradients
w.r.t. vertices, normals and uvs, instance transforms, material colours and
texels.

Strategy: **no-grad traversal + differentiable recompute**.

1. K2.1 (``ops.trace.trace``) finds which triangle and instance each ray
   hits, under ``torch.no_grad()``: the discrete choice is piecewise
   constant and carries no gradient.
2. (t, u, v) are recomputed by Möller–Trumbore from the hit triangle's
   vertices and the object-space ray, and autograd flows through it, the
   attribute interpolation, shading, texel gathers and the reflection
   bounce. The per-triangle data rides one wide row gather of a [S, 25]
   slot-ordered table: K2.3 forward, K2.4 backward (``ops/gather_rows.py``).

Interior pixels get exact gradients; silhouettes are not differentiated
(the usual almost-everywhere convention).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from clraytracer_tpu_torch.camera import ray_directions_planar
from clraytracer_tpu_torch.device import resolve_device
from clraytracer_tpu_torch.ops import planar
from clraytracer_tpu_torch.ops.gather import wide_rows_diff
from clraytracer_tpu_torch.ops.shade import object_space_rays
from clraytracer_tpu_torch.ops.trace import SceneHit, trace
from clraytracer_tpu_torch.render import FrameInputs, Tracer, trace_planar
from clraytracer_tpu_torch.scene.types import MISS_DISTANCE, Scene

#: the scene groups the step reads with gradients; the others (bvh,
#: clusters, packed) are read only by the traversal, under no_grad, so
#: their gradients are zero (the JAX package's stop_gradient)
DIFF_GROUPS = ("tris", "materials", "atlas", "instances")


def make_differentiable_tracer() -> Tracer:
    """A tracer whose hit records are differentiable w.r.t. the scene's
    geometry, attributes and instance transforms (diff.py:42 of the JAX
    package)."""

    def traced(
        scene: Scene,
        origin: torch.Tensor,
        direction: torch.Tensor,
        live: torch.Tensor | None = None,
    ) -> SceneHit:
        with torch.no_grad():
            hit = trace(
                scene, origin.detach(), direction.detach(),
                live=None if live is None else live.detach(),
                return_slots=True,
            )
        # miss and dead lanes carry no triangle: pin them to row 0 (their
        # values are discarded below and their cotangents are zero)
        tri = torch.where(hit.hit, hit.tri, torch.zeros_like(hit.tri))
        o, d = object_space_rays(scene, hit.instance, origin, direction)
        trs = scene.tris
        f32 = lambda a: a.to(torch.float32)
        vt = torch.cat(
            [
                trs.v0, trs.v1, trs.v2,
                f32(trs.n0), f32(trs.n1), f32(trs.n2),
                f32(trs.uv0), f32(trs.uv1), f32(trs.uv2),
                f32(trs.mat_idx)[:, None],
            ],
            dim=1,
        )  # [T, 25]
        # slot order: the tracer returns cluster slots, so the table is
        # re-ordered once per call (its gradient scatters back to T rows)
        gid = scene.clusters.tri_gid.long().clamp(0, vt.shape[0] - 1)
        vt = vt.index_select(0, gid)  # [S, 25]
        rows = wide_rows_diff(vt, tri)  # [25, ...]
        v0, v1, v2 = rows[0:3], rows[3:6], rows[6:9]
        e1 = v1 - v0
        e2 = v2 - v0
        h = planar.cross(d, e2)
        f = 1.0 / planar.dot(e1, h)
        s = o - v0
        u = f * planar.dot(s, h)
        q = planar.cross(s, e1)
        v = f * planar.dot(d, q)
        t = f * planar.dot(e2, q)

        w0 = 1.0 - u - v
        n_obj = torch.stack(
            [rows[9 + c] * w0 + rows[12 + c] * u + rows[15 + c] * v
             for c in range(3)]
        )
        uu = rows[18] * w0 + rows[20] * u + rows[22] * v
        vv = rows[19] * w0 + rows[21] * u + rows[23] * v

        keep = hit.hit
        return SceneHit(
            t=torch.where(keep, t, torch.full_like(t, MISS_DISTANCE)),
            u=torch.where(keep, u, torch.zeros_like(u)),
            v=torch.where(keep, v, torch.zeros_like(v)),
            tri=hit.tri,
            instance=hit.instance,
            hit=hit.hit,
            attr_normal=n_obj,
            attr_uu=uu,
            attr_vv=vv,
            attr_mat=rows[24],
        )

    return traced


def render_image_diff(
    scene: Scene,
    frame: FrameInputs,
    width: int,
    height: int,
    bounces: int = 2,
    enable_post: bool = False,
    device: str | torch.device | None = None,
) -> torch.Tensor:
    """Differentiable [H, W, 3] render on the float colour path with
    reference-parity shading (diff.py:177 of the JAX package). ``device``
    (None = the CUDA card) must be where the scene lies."""
    dev = resolve_device(device)
    if scene.device.type != dev.type:
        raise ValueError(f"scene is on {scene.device}, render asked for {dev}")
    if enable_post:
        raise NotImplementedError(
            "render_image_diff: the untiled post_process is not ported yet"
        )
    f32 = lambda a: torch.as_tensor(a, dtype=torch.float32).to(dev)
    dirs = ray_directions_planar(
        f32(frame.inverse_view), f32(frame.inverse_projection), width, height
    )  # [3, H, W]
    origin = f32(frame.camera_position)[:, None, None].expand(dirs.shape)
    result = trace_planar(
        scene, origin, dirs, f32(frame.sun_angle), bounces,
        make_differentiable_tracer(),
    )
    return planar.to_last(result, (height, width))


def _float_leaves(scene: Scene):
    """(group, field, tensor) of every floating-point tensor leaf."""
    for g in dataclasses.fields(scene):
        group = getattr(scene, g.name)
        if not dataclasses.is_dataclass(group):
            continue
        for f in dataclasses.fields(group):
            v = getattr(group, f.name)
            if isinstance(v, torch.Tensor) and v.is_floating_point():
                yield g.name, f.name, v


def grad_leaves(scene: Scene) -> tuple[Scene, dict[str, torch.Tensor]]:
    """The scene with every floating leaf of ``DIFF_GROUPS`` replaced by a
    fresh autograd leaf, and those leaves by ``"<group>.<field>"``."""
    params: dict[str, torch.Tensor] = {}
    swaps: dict[str, dict] = {g: {} for g in DIFF_GROUPS}
    for gname, fname, v in _float_leaves(scene):
        if gname in swaps:
            swaps[gname][fname] = params[f"{gname}.{fname}"] = (
                v.detach().requires_grad_(True)
            )
    s = dataclasses.replace(scene, **{
        g: dataclasses.replace(getattr(scene, g), **kw) for g, kw in swaps.items()
    })
    return s, params


def image_loss_and_grads(
    scene: Scene,
    frame: FrameInputs,
    width: int,
    height: int,
    loss_fn: Callable[[torch.Tensor], torch.Tensor] | None = None,
    target: torch.Tensor | None = None,
    device: str | torch.device | None = None,
    **render_kwargs,
) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """Gradient of a scalar image loss w.r.t. every floating scene leaf
    (diff.py:215 of the JAX package). Default loss: L2 against ``target``,
    or the mean radiance without one.

    Returns ``(loss, grads)``: ``grads`` maps ``"<group>.<field>"`` (the
    bridge's keys, e.g. ``"materials.albedo"``, ``"tris.v0"``) to a
    gradient of the leaf's shape and dtype (f16 leaves get f16 gradients).
    Leaves the step does not read get zeros; integer leaves are absent."""
    s, params = grad_leaves(scene)
    img = render_image_diff(s, frame, width, height, device=device,
                            **render_kwargs)
    if loss_fn is not None:
        loss = loss_fn(img)
    elif target is not None:
        loss = torch.mean((img - target) ** 2)
    else:
        loss = torch.mean(img)
    keys = list(params)
    got = torch.autograd.grad(loss, [params[k] for k in keys], allow_unused=True)
    computed = dict(zip(keys, got))
    grads = {}
    for gname, fname, leaf in _float_leaves(scene):
        g = computed.get(f"{gname}.{fname}")
        grads[f"{gname}.{fname}"] = torch.zeros_like(leaf) if g is None else g
    return loss.detach(), grads
