"""Single-ray scene raycast and picking: the reference's CPU ray-trace path
(``CPU_RayCast(RaySSE) -> HitRecord``, CPURayTrace.cpp:186,
CPURayTrace.hpp:5-18), which it drives from mouse clicks
(Engine.cpp:112-126); the JAX package's ``raycast.py``.

The same tracers and shading tables serve the frame and the pick. The
default tracer is ``trace_bvh`` as in the JAX package, plain torch on any
device; ``tracer=render.trace_best`` (what ``engine.Engine`` and the live
viewer pass for ``"best"``) is K2.1 on the card. ``trace_bvh`` keeps the
reference's inside-box rule: from a camera inside an instance's boxes it
misses (ops/trace_ref.py), as the JAX function does.

A pick comes back as one packed record (``pack_record``) in one copy. On
the card, where the tracer resolves to K2.1 and the scene has its packed
tables, the record is one launch of ``ops.trace.pick_cuda``: K2.1's walk
and the record's shading in one thread, bit-equal to ``raycast`` and
``pack_record``, which every other pick runs.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from clraytracer_tpu_torch.camera import Camera, screen_point_to_ray
from clraytracer_tpu_torch.ops import gather, planar
from clraytracer_tpu_torch.ops import trace
from clraytracer_tpu_torch.ops.shade import (
    _OFF_SHIFT,
    _modulate_bytes,
    _shading_tables,
    sample_pool_planar,
)
from clraytracer_tpu_torch.ops.trace_ref import trace_bvh
from clraytracer_tpu_torch.render import Tracer, resolve_tracer
from clraytracer_tpu_torch.scene.types import MISS_DISTANCE, Scene
from clraytracer_tpu_torch.utils.timer import ScopeTimer

#: Reference RayacastMissDistance (CPURayTrace.hpp:14).
MISS = float(MISS_DISTANCE)


class HitRecord(NamedTuple):
    """Reference HitRecord (CPURayTrace.hpp:5-12) plus the instance index."""

    normal: torch.Tensor  # [..., 3] world-space interpolated normal
    uv: torch.Tensor  # [..., 2]
    distance: torch.Tensor  # [...] object-space t; MISS on a miss
    color: torch.Tensor  # [..., 3] texture-modulated surface colour
    index: torch.Tensor  # [...] i32 triangle index
    instance: torch.Tensor  # [...] i32
    hit: torch.Tensor  # [...] bool


def raycast(
    scene: Scene,
    origin: torch.Tensor,  # [..., 3]
    direction: torch.Tensor,  # [..., 3]
    tracer: Tracer = trace_bvh,
) -> HitRecord:
    """Closest hit with the shading attributes reconstructed
    (CPURayTrace.cpp:186-249), for any batch shape, a single ray included.
    The rays must lie on the scene's device."""
    o_p = planar.from_last(origin)
    d_p = planar.from_last(direction)
    hit = tracer(scene, o_p, d_p)
    tables = _shading_tables(scene, prefer_packed=scene.packed is not None)

    attr = gather.take_rows(tables.tri_attr, hit.tri)  # [16, ...]
    inst = gather.take_rows(tables.inst_rows, hit.instance)  # [17, ...]

    w0 = 1.0 - hit.u - hit.v
    n_obj = torch.stack(
        [attr[c] * w0 + attr[3 + c] * hit.u + attr[6 + c] * hit.v for c in range(3)]
    )
    normal = planar.normalize(
        torch.stack(
            [
                n_obj[0] * inst[0] + n_obj[1] * inst[4] + n_obj[2] * inst[8],
                n_obj[0] * inst[1] + n_obj[1] * inst[5] + n_obj[2] * inst[9],
                n_obj[0] * inst[2] + n_obj[1] * inst[6] + n_obj[2] * inst[10],
            ]
        )
    )
    uu = attr[9] * w0 + attr[11] * hit.u + attr[13] * hit.v
    vv = attr[10] * w0 + attr[12] * hit.u + attr[14] * hit.v

    mat_id = inst[16].to(torch.int32) + attr[15].to(torch.int32)
    mat = gather.take_rows(tables.mat_rows, mat_id)
    aw, ah = mat[8], mat[9]
    aoff = mat[10].to(torch.int32) * (1 << _OFF_SHIFT) + mat[11].to(torch.int32)
    texel = sample_pool_planar(scene.atlas, aw, ah, aoff, uu, vv)
    color = _modulate_bytes(texel, mat[0:3])  # the reference's byte modulate

    shape = tuple(hit.t.shape)
    return HitRecord(
        normal=planar.to_last(normal, shape),
        uv=torch.stack([uu, vv], dim=-1),
        distance=torch.where(hit.hit, hit.t, torch.full_like(hit.t, MISS)),
        color=planar.to_last(color, shape),
        index=hit.tri,
        instance=hit.instance,
        hit=hit.hit,
    )


def pack_record(rec: HitRecord) -> torch.Tensor:
    """One ray's record → [PICK_WORDS] f32 on its device, csrc/trace.cu's
    layout (``ops.trace.PICK_WORDS``): the bits of every field kept."""
    return torch.cat([
        rec.hit.reshape(-1).to(torch.float32), rec.distance.reshape(-1),
        rec.index.reshape(-1).view(torch.float32), rec.instance.reshape(-1).view(torch.float32),
        rec.normal.reshape(-1), rec.uv.reshape(-1), rec.color.reshape(-1),
    ])


def unpack_record(words: np.ndarray) -> HitRecord:
    """A [PICK_WORDS] f32 host record → ``pick``'s ``HitRecord`` of numpy
    values: f32 normal [3], uv [2], colour [3] and distance, i32 index and
    instance, bool hit."""
    bits = words.view(np.int32)
    return HitRecord(
        normal=words[4:7],
        uv=words[7:9],
        distance=words[1],
        color=words[9:12],
        index=bits[2],
        instance=bits[3],
        hit=np.bool_(words[0] != 0.0),
    )


def _on_card(scene: Scene, tracer: Tracer) -> bool:
    """Does this pick take ``ops.trace.pick_cuda``: a scene on the card with
    packed tables whose tracer resolves to K2.1?"""
    return (scene.packed is not None and scene.device.type == "cuda"
            and resolve_tracer(tracer, scene) is trace.trace)


def pick(
    scene: Scene, camera: Camera, x: float, y: float, tracer: Tracer = trace_bvh
) -> HitRecord:
    """Mouse picking: unproject a screen point (Camera::ScreenPointToRaySSE,
    Math/Camera.hpp:121) and raycast it, the reference's LMB flow
    (Engine.cpp:112-126). Returns one ray's HitRecord as host numpy
    values, through one packed record and one copy."""
    with ScopeTimer("pick.trace", log=False):
        o, d = screen_point_to_ray(camera, x, y)
        if _on_card(scene, tracer):
            record = trace.pick_cuda(scene, o, d)
        else:
            dev = scene.device
            record = pack_record(raycast(
                scene, torch.from_numpy(o)[None].to(dev), torch.from_numpy(d)[None].to(dev),
                tracer,
            ))
    with ScopeTimer("pick.readback", log=False):
        return unpack_record(record.cpu().numpy())
