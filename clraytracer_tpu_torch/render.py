"""The frame pipeline: fused trace (K2.2) → deferred sky → post chain, and
the two-phase bounce loop of the differentiable path.

``render_frame`` runs the default frame of the JAX package's
``render.render_frame`` (render.py:503): 2 bounces of reference-parity
integer-colour Phong over an all-procedural scene, post on, FXAA off, one
sample. On a CUDA scene the frame is one launch of the fused kernel; on a
CPU scene it is the kernel's plain version. Every other option raises
``NotImplementedError`` rather than taking another computation.

``trace_planar``/``bounce_loop`` (render.py:102-326 of the JAX package)
trace and shade bounce by bounce on the float colour path with
reference-parity shading, with a pluggable tracer:
``diff.render_image_diff`` passes its differentiable one. The integer-
colour two-phase path is not ported yet.
"""

from __future__ import annotations

import struct
import zlib
from typing import Callable, NamedTuple

import numpy as np
import torch

from clraytracer_tpu_torch.camera import Camera
from clraytracer_tpu_torch.config import RenderConfig
from clraytracer_tpu_torch.device import resolve_device
from clraytracer_tpu_torch.ops import gather
from clraytracer_tpu_torch.ops import render_fused as rf
from clraytracer_tpu_torch.ops.post import post_process_tiled
from clraytracer_tpu_torch.ops.shade import (
    _all_procedural,
    initial_bounce_state,
    shade_hits,
)
from clraytracer_tpu_torch.ops.trace import SceneHit
from clraytracer_tpu_torch.scene.types import Scene

#: A tracer maps (scene, origins [3, ...], directions [3, ...], live=None)
#: → SceneHit with [...]-shaped fields; ``live`` is a [...] bool mask of the
#: rays still bouncing, or None on bounce 0.
Tracer = Callable[..., SceneHit]

#: test hook: False makes imported-texture scenes gather their texels in
#: every bounce instead of once after the loop
_DEFER_TEXELS = True


class FrameInputs(NamedTuple):
    """Per-frame inputs (the reference's TraceArgs + matrices). Host-side
    f32 tensors: the kernel takes them as launch parameters."""

    inverse_view: torch.Tensor  # [4, 4]
    inverse_projection: torch.Tensor  # [4, 4]
    camera_position: torch.Tensor  # [3]
    sun_angle: torch.Tensor  # []


def frame_inputs_from_camera(camera: Camera, sun_angle: float) -> FrameInputs:
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32))
    return FrameInputs(
        inverse_view=f32(camera.inverse_view),
        inverse_projection=f32(camera.inverse_projection),
        camera_position=f32(camera.position),
        sun_angle=f32(sun_angle),
    )


def _unsupported(scene: Scene, config: RenderConfig) -> str | None:
    """Why this slice cannot render the frame, or None."""
    if config.samples > 1:
        return "samples > 1"
    for name in ("enable_fxaa", "enable_shadows", "enable_gi", "enable_refraction"):
        if getattr(config, name):
            return name
    if not config.reference_parity_shading:
        return "reference_parity_shading=False"
    if not config.integer_colors:
        return "integer_colors=False"
    if not _all_procedural(scene):
        return "imported (non-procedural) textures"
    if scene.materials.count > rf.MAX_FUSED_MATERIALS:
        return f"more than {rf.MAX_FUSED_MATERIALS} materials"
    if not rf.fused_path_available(scene):
        return "scene without cluster or packed tables"
    return None


def _trace_tiled(
    scene: Scene, frame: FrameInputs, width: int, height: int, bounces: int
) -> tuple[torch.Tensor, tuple]:
    """The fused branch of the JAX ``_trace_tiled`` (render.py:409): raw
    ``[3, rows, 128]`` radiance plus its ``("strip", trows, tiles_x,
    tiles_y)`` layout."""
    result, (trows, tiles_x, tiles_y) = rf.render_fused_camera(
        scene, frame, width, height, bounces
    )
    return result, ("strip", trows, tiles_x, tiles_y)


def _untile(result: torch.Tensor, layout: tuple, height: int, width: int) -> torch.Tensor:
    """[3, rows, 128] screen-tile order → [3, H, W] planar image."""
    _kind, rows, nx, ny = layout
    return (
        result.reshape(3, ny, nx, rows, 128)
        .permute(0, 1, 3, 2, 4)
        .reshape(3, ny * rows, nx * 128)[:, :height, :width]
    )


def render_frame(
    scene: Scene,
    frame: FrameInputs,
    config: RenderConfig,
    device: str | torch.device | None = None,
) -> torch.Tensor:
    """Full frame: trace + post chain → [H, W, 3] on the scene's device.
    ``device`` (None = the CUDA card) must be where the scene lies."""
    dev = resolve_device(device)
    if scene.device.type != dev.type:
        raise ValueError(f"scene is on {scene.device}, frame asked for {dev}")
    why = _unsupported(scene, config)
    if why is not None:
        raise NotImplementedError(f"render_frame: {why} is not ported yet")
    result, layout = _trace_tiled(
        scene, frame, config.width, config.height, config.bounces
    )
    if config.enable_post:
        result = post_process_tiled(result, config.width, config.height, layout)
    img = _untile(result, layout, config.height, config.width)
    return img.permute(1, 2, 0)


def trace_planar(
    scene: Scene,
    origin: torch.Tensor,  # [3, *spatial]
    direction: torch.Tensor,  # [3, *spatial]
    sun_angle: torch.Tensor,  # [] f32
    bounces: int,
    tracer: Tracer,
) -> torch.Tensor:
    """N-bounce trace + shade over planar rays → [3, *spatial] radiance.
    The loop runs on ``[3, rows, 128]`` rays padded to a whole strip of
    ``render_fused.tile_rows`` rows, pad rays with origin 0 and direction
    1 (render.py:102 of the JAX package)."""
    spatial = tuple(direction.shape[1:])
    n = 1
    for s in spatial:
        n *= s
    tile = rf.tile_rows(n) * 128
    n_pad = -(-n // tile) * tile
    rows = n_pad // 128

    def to_linear(x: torch.Tensor, pad_value: float) -> torch.Tensor:
        flat = x.reshape(3, -1)
        if n_pad != n:
            pad = torch.full((3, n_pad - n), pad_value, dtype=flat.dtype,
                             device=flat.device)
            flat = torch.cat([flat, pad], dim=1)
        return flat.reshape(3, rows, 128)

    result = bounce_loop(
        scene, to_linear(origin, 0.0), to_linear(direction, 1.0), sun_angle,
        bounces, tracer,
    )
    return result.reshape(3, -1)[:, :n].reshape((3,) + spatial)


def bounce_loop(
    scene: Scene,
    origin: torch.Tensor,  # [3, rows, 128]
    direction: torch.Tensor,  # [3, rows, 128]
    sun_angle: torch.Tensor,
    bounces: int,
    tracer: Tracer,
) -> torch.Tensor:
    """The two-phase bounce loop (render.py:155 of the JAX package): trace,
    then shade, per bounce. Bounce 0 traces every ray; later bounces pass
    the alive mask, so dead lanes cost no traversal. Imported-texture
    scenes gather every bounce's texels in one combined gather after the
    loop (render.py:306-325)."""
    state = initial_bounce_state(origin, direction, sun_angle)
    defer_list: list | None = [] if _DEFER_TEXELS else None
    for b in range(bounces):
        if b == 0:
            hit = tracer(scene, state.origin, state.direction)
        else:
            hit = tracer(scene, state.origin, state.direction, live=state.alive)
        state = shade_hits(
            scene, state, t=hit.t, hit=hit.hit, instance_idx=hit.instance,
            attrs=(hit.attr_normal, hit.attr_uu, hit.attr_vv, hit.attr_mat),
            deferred=defer_list,
        )
    if not defer_list:
        return state.result
    idx_all = torch.stack([d[0] for d in defer_list])  # [B, rows, 128]
    tex_all = gather.take_rgb(scene.atlas.texels, idx_all)  # [3, B, rows, 128]
    res = state.result
    for b, (_idx, f1, f2) in enumerate(defer_list):
        tx = tex_all[:, b]
        res = res + tx * f1 + tx * f2
    return res


def render(
    scene: Scene,
    camera: Camera,
    config: RenderConfig,
    device: str | torch.device | None = None,
) -> np.ndarray:
    """Convenience entry: an [H, W, 3] float numpy image."""
    frame = frame_inputs_from_camera(camera, config.sun_angle)
    return render_frame(scene, frame, config, device).cpu().numpy()


def to_srgb_u8(img: np.ndarray) -> np.ndarray:
    return (np.clip(np.asarray(img), 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)


def save_png(path: str, img: np.ndarray) -> None:
    """Write the frame as an 8-bit RGB PNG (zlib + struct only), row-flipped
    for display: the frame buffer is bottom-up like the reference's
    (kernel_main.cl:280-281), PNG row 0 is the top."""
    px = to_srgb_u8(img)[::-1]
    h, w, _ = px.shape
    raw = b"".join(b"\x00" + px[y].tobytes() for y in range(h))

    def chunk(tag: bytes, data: bytes) -> bytes:
        body = tag + data
        return (
            struct.pack(">I", len(data)) + body
            + struct.pack(">I", zlib.crc32(body) & 0xFFFFFFFF)
        )

    png = (
        b"\x89PNG\r\n\x1a\n"
        + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
        + chunk(b"IDAT", zlib.compress(raw, 6))
        + chunk(b"IEND", b"")
    )
    with open(path, "wb") as f:
        f.write(png)
