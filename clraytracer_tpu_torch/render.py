"""The frame pipeline: fused trace (K2.2) → deferred sky → post chain.

``render_frame`` runs the default frame of the JAX package's
``render.render_frame`` (render.py:503): 2 bounces of reference-parity
integer-colour Phong over an all-procedural scene, post on, FXAA off, one
sample. On a CUDA scene the frame is one launch of the fused kernel; on a
CPU scene it is the kernel's plain version. Every other option raises
``NotImplementedError`` rather than taking another computation.
"""

from __future__ import annotations

import struct
import zlib
from typing import NamedTuple

import numpy as np
import torch

from clraytracer_tpu_torch.camera import Camera
from clraytracer_tpu_torch.config import RenderConfig
from clraytracer_tpu_torch.device import resolve_device
from clraytracer_tpu_torch.ops import render_fused as rf
from clraytracer_tpu_torch.ops.post import post_process_tiled
from clraytracer_tpu_torch.ops.shade import _all_procedural
from clraytracer_tpu_torch.scene.types import Scene


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
