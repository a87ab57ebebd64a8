"""Row sharding over ``torch.distributed``: each rank renders a window of
image rows from a replicated scene (the JAX package's
``parallel/sharding.py``).

* **Forward** (``render_sharded``): the frame's rows are dealt to the
  ranks in equal windows of ``ceil(H / n)`` rows. Each rank generates and
  traces its own window: one launch of the fused frame kernel (K2.2) in
  camera mode on the window where the scene and tracer allow it, else the
  window's planar rays through ``render.trace_planar``. The windows are
  all-gathered, cut to ``H`` rows, and the post chain runs on the whole
  frame.
* **Training** (``train_step_sharded``): each rank differentiates the L2
  loss of its own rows (K2.1 finds the hits, K2.3 gathers the triangle
  rows forward and K2.4 scatters their gradients back), then one sum
  all-reduce of loss and gradients, and every rank applies the same SGD
  update to its replica.

A ``DeviceMesh`` is one process group (a world of one without an
initialised group) and the card this rank renders on. NCCL carries the
collectives between CUDA tensors, one rank per card; gloo carries them on
the CPU, and on CUDA where a caller asks for it (several ranks sharing one
card): gloo takes CUDA tensors in each collective used here (broadcast,
sum and min all-reduce, all-gather into one tensor), so nothing is staged
through host memory. All collectives of the layer are the private helpers
below.
"""

from __future__ import annotations

import dataclasses
import datetime
import os

import torch
import torch.distributed as dist

from clraytracer_tpu_torch.camera import ray_directions_planar
from clraytracer_tpu_torch.config import RenderConfig
from clraytracer_tpu_torch.device import resolve_device
from clraytracer_tpu_torch.diff import grad_leaves, make_differentiable_tracer
from clraytracer_tpu_torch.ops import planar
from clraytracer_tpu_torch.ops import render_fused as rf
from clraytracer_tpu_torch.ops.post import post_process
from clraytracer_tpu_torch.ops.trace import trace
from clraytracer_tpu_torch.render import (
    FrameInputs,
    Tracer,
    resolve_tracer,
    trace_best,
    trace_planar,
)
from clraytracer_tpu_torch.scene.types import Scene

#: the name of the row axis, along which a ``DeviceMesh`` of
#: ``make_device_mesh`` deals the image rows (the JAX package's mesh axis)
AXIS = "devices"

#: the timeout a process group is created with by this package's entry
#: points (the CLI's ``sweep``): a rank that never arrives fails the run
INIT_TIMEOUT = datetime.timedelta(seconds=300)

#: torch's all-gather into one tensor (named ``all_gather_single`` from
#: PyTorch 2.13 on, ``all_gather_into_tensor`` before)
_all_gather_into = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor


@dataclasses.dataclass(frozen=True)
class DeviceMesh:
    """A 1-D mesh: ``size`` ranks of ``group`` (None: a world of one, no
    collective), this process's ``rank`` in it and its ``device``."""

    group: object
    rank: int
    size: int
    device: torch.device


def local_device(device: str | torch.device | None = None) -> torch.device:
    """``resolve_device(device)``; a CUDA device without an index becomes
    this process's card, ``cuda:{LOCAL_RANK}`` (as torchrun sets it) or
    ``cuda:{rank % device_count}``."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        rank = dist.get_rank() if dist.is_initialized() else 0
        local = os.environ.get("LOCAL_RANK")
        index = int(local) if local is not None else rank % torch.cuda.device_count()
        dev = torch.device("cuda", index)
    return dev


def make_device_mesh(group=None, device: str | torch.device | None = None) -> DeviceMesh:
    """The mesh over ``group`` (None: the default group when one is
    initialised, else a world of one) on this rank's card
    (``local_device``), or the CPU with ``device="cpu"``."""
    dev = local_device(device)
    if not dist.is_initialized():
        if group is not None:
            raise ValueError("a process group was given, but torch.distributed is "
                             "not initialised")
        return DeviceMesh(None, 0, 1, dev)
    group = group if group is not None else dist.group.WORLD
    rank = dist.get_rank(group)
    if rank < 0:
        raise ValueError("this process is not a member of the mesh's group")
    return DeviceMesh(group, rank, dist.get_world_size(group), dev)


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------


def _all_gather_rows(mesh: DeviceMesh, local: torch.Tensor) -> torch.Tensor:
    """[rows, ...] on each rank → [size * rows, ...], the ranks' blocks in
    rank order."""
    if mesh.group is None:
        return local
    local = local.contiguous()
    out = local.new_empty((mesh.size * local.shape[0],) + tuple(local.shape[1:]))
    _all_gather_into(out, local, group=mesh.group)
    return out


def _all_reduce(mesh: DeviceMesh, t: torch.Tensor, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """``t`` reduced over the mesh with ``op`` (SUM or MIN), in place."""
    if mesh.group is not None:
        dist.all_reduce(t, op=op, group=mesh.group)
    return t


def _broadcast(mesh: DeviceMesh, t: torch.Tensor) -> torch.Tensor:
    """Rank 0's ``t`` on every rank, in place."""
    if mesh.group is not None:
        dist.broadcast(t, src=dist.get_global_rank(mesh.group, 0), group=mesh.group)
    return t


# ---------------------------------------------------------------------------
# scene and frame
# ---------------------------------------------------------------------------


def _tensor_leaves(scene: Scene):
    """(group, field, tensor) of every tensor leaf, in field order."""
    for g in dataclasses.fields(scene):
        group = getattr(scene, g.name)
        if not dataclasses.is_dataclass(group):
            continue
        for f in dataclasses.fields(group):
            v = getattr(group, f.name)
            if isinstance(v, torch.Tensor):
                yield g.name, f.name, v


def _with_leaves(scene: Scene, leaves: dict[tuple[str, str], torch.Tensor]) -> Scene:
    """``scene`` with the tensors of ``leaves`` ({(group, field): tensor})
    in place of its own."""
    swaps: dict[str, dict] = {}
    for (g, f), v in leaves.items():
        swaps.setdefault(g, {})[f] = v
    return dataclasses.replace(scene, **{
        g: dataclasses.replace(getattr(scene, g), **kw) for g, kw in swaps.items()
    })


def replicate_scene(scene: Scene, mesh: DeviceMesh) -> Scene:
    """Rank 0's scene on every rank of the mesh (sharding.py:175 of the JAX
    package; the reference's PushMeshesToGPU): every tensor leaf, as bytes
    in one buffer, broadcast from rank 0 onto the mesh's device. Every rank
    passes a scene of the same structure (the same recipe or file)."""
    scene = scene.to(mesh.device)
    if mesh.group is None:
        return scene
    leaves = list(_tensor_leaves(scene))
    flat = [v.contiguous().reshape(-1).view(torch.uint8) for _, _, v in leaves]
    n = sum(x.numel() for x in flat)
    # every rank learns the largest and the smallest size, so all of them
    # raise together on a mismatch and none waits in the broadcast
    sizes = _all_reduce(mesh, torch.tensor([n, -n], dtype=torch.int64, device=mesh.device),
                        dist.ReduceOp.MAX).tolist()
    if sizes[0] != -sizes[1]:
        raise ValueError(f"the ranks' scenes differ: {-sizes[1]} to {sizes[0]} bytes "
                         "of tensors")
    buf = _broadcast(mesh, torch.cat(flat))
    out, at = {}, 0
    for (g, f, v), x in zip(leaves, flat):
        out[(g, f)] = buf[at:at + x.numel()].view(v.dtype).reshape(v.shape)
        at += x.numel()
    return _with_leaves(scene, out)


def _frame_on(frame: FrameInputs, dev: torch.device) -> FrameInputs:
    return FrameInputs(*(torch.as_tensor(x, dtype=torch.float32).to(dev) for x in frame))


def _pad_rows(height: int, n: int) -> int:
    return (height + n - 1) // n * n


def _shade_rows(
    scene: Scene,
    frame: FrameInputs,
    width: int,
    height: int,
    row_start: int,
    local_rows: int,
    bounces: int,
    tracer: Tracer,
    reference_parity: bool,
    integer_colors: bool,
) -> torch.Tensor:
    """The row window [row_start, row_start + local_rows) of the frame →
    [local_rows, W, 3] radiance (sharding.py:52 of the JAX package)."""
    dev = scene.device
    frame = _frame_on(frame, dev)
    dirs = ray_directions_planar(
        frame.inverse_view, frame.inverse_projection, width, height,
        row_start=row_start, num_rows=local_rows,
    )
    origin = frame.camera_position[:, None, None].expand(dirs.shape)
    result = trace_planar(
        scene, origin, dirs, frame.sun_angle, bounces, tracer,
        reference_parity, integer_colors,
    )
    return planar.to_last(result, (local_rows, width))


def _check_device(scene: Scene, mesh: DeviceMesh) -> None:
    if scene.device != mesh.device:
        raise ValueError(f"scene is on {scene.device}, the mesh renders on {mesh.device}")


def render_sharded(
    scene: Scene,
    frame: FrameInputs,
    config: RenderConfig,
    mesh: DeviceMesh | None = None,
    tracer: Tracer = trace_best,
) -> torch.Tensor:
    """The whole frame, its rows sharded over the mesh → [H, W, 3] on every
    rank (sharding.py:84 of the JAX package). The scene lies on the mesh's
    device on every rank (``replicate_scene``).

    Each rank renders rows ``[rank * r, (rank + 1) * r)``, ``r = ceil(H /
    n)``; the last window may run past ``H``. Where the tracer resolves to
    K2.1 and the fused kernel covers the scene, the window is one K2.2
    launch in camera mode (``render_fused_camera`` with ``row0`` and
    ``local_height``); the port always prefers the fused kernel where it
    is available, as ``render.render_frame`` does. Otherwise the window's
    planar rays go through ``trace_planar`` with the tracer. Only the
    JAX function's options apply: ``bounces``,
    ``reference_parity_shading``, ``integer_colors``, and the post chain
    (``enable_post``, ``enable_fxaa``) on the gathered frame."""
    mesh = mesh or make_device_mesh()
    _check_device(scene, mesh)
    w, h = config.width, config.height
    local_rows = _pad_rows(h, mesh.size) // mesh.size
    row0 = mesh.rank * local_rows
    use_fused = resolve_tracer(tracer, scene) is trace and rf.fused_path_available(
        scene, config.reference_parity_shading, config.integer_colors
    )
    if use_fused:
        result, (trows, tiles_x, tiles_y) = rf.render_fused_camera(
            scene, frame, w, h, config.bounces, row0=row0, local_height=local_rows,
        )
        img = rf.untile(result, ("strip", trows, tiles_x, tiles_y), local_rows, w)
        local = planar.to_last(img, (local_rows, w))
    else:
        local = _shade_rows(
            scene, frame, w, h, row0, local_rows, config.bounces, tracer,
            config.reference_parity_shading, config.integer_colors,
        )
    img = _all_gather_rows(mesh, local)[:h]
    if config.enable_post:
        img = post_process(img, enable_fxaa=config.enable_fxaa)
    return img


def _train_step(
    scene: Scene,
    frame: FrameInputs,
    target: torch.Tensor,
    mesh: DeviceMesh,
    lr: float,
    width: int,
    height: int,
    bounces: int,
    tracer: Tracer,
) -> tuple[torch.Tensor, Scene]:
    """One SGD step of the L2 loss over the mesh's row windows: each rank's
    rows through the differentiable ``tracer``, one sum all-reduce of
    [loss, gradients] over ``mesh``, the same update on every rank."""
    _check_device(scene, mesh)
    if target.shape[0] % mesh.size:
        raise ValueError("pad the target's rows to a multiple of the mesh size")
    local_rows = target.shape[0] // mesh.size
    row0 = mesh.rank * local_rows
    target_local = torch.as_tensor(target, dtype=torch.float32)[row0:row0 + local_rows]
    target_local = target_local.to(mesh.device)
    s, params = grad_leaves(scene)
    img = _shade_rows(
        s, frame, width, height, row0, local_rows, bounces, tracer,
        reference_parity=True, integer_colors=False,
    )
    loss = torch.sum((img - target_local) ** 2)
    keys = list(params)
    got = torch.autograd.grad(loss, [params[k] for k in keys], allow_unused=True)
    grads = [torch.zeros_like(params[k]) if g is None else g for k, g in zip(keys, got)]
    # ---- one all-reduce of the loss and every gradient, flattened
    flat = torch.cat([loss.detach().reshape(1).float()]
                     + [g.reshape(-1).float() for g in grads])
    flat = _all_reduce(mesh, flat)
    denom = 1.0 / (height * width * 3)
    new, at = {}, 1
    for k, g in zip(keys, grads):
        p = params[k].detach()
        g = flat[at:at + g.numel()].reshape(g.shape).to(p.dtype)
        at += g.numel()
        group, field = k.split(".")
        new[(group, field)] = p - lr * g * denom
    return flat[0] * denom, _with_leaves(scene, new)


def train_step_sharded(
    scene: Scene,
    frame: FrameInputs,
    target: torch.Tensor,  # [H, W, 3], H a multiple of the mesh size
    mesh: DeviceMesh | None = None,
    lr: float = 1e-2,
    width: int | None = None,
    height: int | None = None,
    bounces: int = 2,
    base_tracer: Tracer = trace_best,
) -> tuple[torch.Tensor, Scene]:
    """One inverse-rendering SGD step, data-parallel over the mesh's rows
    (sharding.py:205 of the JAX package): each rank differentiates
    ``sum((img - target) ** 2)`` over its rows, with reference-parity
    float-colour shading through ``make_differentiable_tracer(
    base_tracer)``; one sum all-reduce of loss and gradients; every float
    leaf of the differentiable groups (``diff.DIFF_GROUPS``) steps by
    ``-lr * g / (H * W * 3)``, the others stay as they are (their
    gradients are zero). Returns (loss / (H * W * 3), the updated scene),
    the same on every rank."""
    mesh = mesh or make_device_mesh()
    height = height or target.shape[0]
    width = width or target.shape[1]
    return _train_step(scene, frame, target, mesh, lr, width, height, bounces,
                       make_differentiable_tracer(base_tracer))

