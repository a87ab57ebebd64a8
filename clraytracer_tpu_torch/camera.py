"""Camera matrices and primary-ray generation.

``Camera`` is host-side state with numpy matrices (reference
Math/Camera.hpp). ``ray_directions_tiled`` is the RayGen unprojection
(kernel_main.cl:277-287) in the render loop's screen-tile order; the fused
frame kernel computes the same expressions per ray itself, and the plain
frame uses this function. ``ray_directions_planar`` gives the same rays as
an ``[3, H, W]`` image grid for the differentiable path.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from clraytracer_tpu_torch import math3d
from clraytracer_tpu_torch.config import CameraConfig
from clraytracer_tpu_torch.device import const

_DEG2RAD = np.pi / 180.0


@dataclasses.dataclass(frozen=True)
class Camera:
    """Host-side camera state; matrices are plain numpy."""

    config: CameraConfig
    width: int
    height: int
    position: np.ndarray
    yaw_deg: float
    pitch_deg: float

    @classmethod
    def create(cls, config: CameraConfig, width: int, height: int) -> "Camera":
        return cls(
            config=config,
            width=width,
            height=height,
            position=np.asarray(config.position, np.float32),
            yaw_deg=config.yaw_deg,
            pitch_deg=config.pitch_deg,
        )

    @property
    def front(self) -> np.ndarray:
        """Forward vector from yaw/pitch (reference Camera.hpp:74-77)."""
        yaw = self.yaw_deg * _DEG2RAD
        pitch = self.pitch_deg * _DEG2RAD
        f = np.array(
            [
                np.cos(yaw) * np.cos(pitch),
                np.sin(pitch),
                np.sin(yaw) * np.cos(pitch),
            ],
            np.float32,
        )
        return f / np.linalg.norm(f)

    @property
    def projection(self) -> np.ndarray:
        return math3d.perspective_fov_rh(
            self.config.vertical_fov_deg * _DEG2RAD,
            float(self.width),
            float(self.height),
            self.config.near_clip,
            self.config.far_clip,
        )

    @property
    def view(self) -> np.ndarray:
        return math3d.look_at_rh(
            self.position, self.front, np.array([0.0, 1.0, 0.0], np.float32)
        )

    @property
    def inverse_projection(self) -> np.ndarray:
        return np.linalg.inv(self.projection).astype(np.float32)

    @property
    def inverse_view(self) -> np.ndarray:
        return np.linalg.inv(self.view).astype(np.float32)


def unproject(
    inverse_view: torch.Tensor,
    inverse_projection: torch.Tensor,
    px: torch.Tensor,
    py: torch.Tensor,
    width: int,
    height: int,
) -> torch.Tensor:
    """Pixel coordinates (f32 tensors) → normalized world directions
    ``[3, *px.shape]``. The expression order is the JAX package's
    ``camera._unproject_grid`` and the fused kernel's in-kernel raygen."""
    cx = (px / const(width, px)) * 2.0 - 1.0
    cy = (py / const(height, py)) * 2.0 - 1.0
    return _unproject_grid(inverse_view, inverse_projection, cx, cy)


def _unproject_grid(
    inverse_view: torch.Tensor,
    inverse_projection: torch.Tensor,
    cx: torch.Tensor,
    cy: torch.Tensor,
) -> torch.Tensor:
    """NDC grids → normalized world directions ``[3, *cx.shape]`` (the
    RayGen unprojection, kernel_main.cl:277-287, as explicit sums of
    products; the JAX package's camera.py:162)."""
    ip = inverse_projection
    tx = cx * ip[0, 0] + cy * ip[1, 0] + ip[2, 0] + ip[3, 0]
    ty = cx * ip[0, 1] + cy * ip[1, 1] + ip[2, 1] + ip[3, 1]
    tz = cx * ip[0, 2] + cy * ip[1, 2] + ip[2, 2] + ip[3, 2]
    tw = cx * ip[0, 3] + cy * ip[1, 3] + ip[2, 3] + ip[3, 3]
    inv_w = 1.0 / tw
    tx, ty, tz = tx * inv_w, ty * inv_w, tz * inv_w
    iv = inverse_view
    wx = tx * iv[0, 0] + ty * iv[1, 0] + tz * iv[2, 0] + iv[3, 0]
    wy = tx * iv[0, 1] + ty * iv[1, 1] + tz * iv[2, 1] + iv[3, 1]
    wz = tx * iv[0, 2] + ty * iv[1, 2] + tz * iv[2, 2] + iv[3, 2]
    rn = 1.0 / torch.sqrt(wx * wx + wy * wy + wz * wz)
    return torch.stack([wx * rn, wy * rn, wz * rn])


def ray_directions_planar(
    inverse_view: torch.Tensor,
    inverse_projection: torch.Tensor,
    width: int,
    height: int,
) -> torch.Tensor:
    """Planar ``[3, H, W]`` normalized primary-ray directions on the
    matrices' device (the JAX package's ``camera.ray_directions_planar``,
    camera.py:132): ray ``j * W + i`` is pixel (i, j),
    ``coord = (i/W, j/H) * 2 - 1``."""
    dev = inverse_view.device
    xs = torch.arange(width, dtype=torch.float32, device=dev)
    ys = torch.arange(height, dtype=torch.float32, device=dev)
    xs = (xs / const(width, xs)) * 2.0 - 1.0
    ys = (ys / const(height, ys)) * 2.0 - 1.0
    cx, cy = torch.meshgrid(xs, ys, indexing="xy")  # [H, W]
    return _unproject_grid(inverse_view, inverse_projection, cx, cy)


def tile_pixels(
    width: int, tile_rows: int, rows: int, device: torch.device, row0: float = 0.0
) -> tuple[torch.Tensor, torch.Tensor]:
    """(px, py) f32 ``[rows, 128]`` pixel coordinates of the screen-tile
    order: row block ``t*tile_rows..(t+1)*tile_rows`` covers the pixel
    rectangle ``[ty*tile_rows, +tile_rows) x [tx*128, +128)`` with
    ``t = ty*tiles_x + tx``. ``row0`` offsets py (a row window's first
    global row)."""
    tiles_x = -(-width // 128)
    r = torch.arange(rows, dtype=torch.int32, device=device)[:, None]
    lane = torch.arange(128, dtype=torch.int32, device=device)[None, :]
    tile = torch.div(r, tile_rows, rounding_mode="floor")
    px = ((tile % tiles_x) * 128 + lane).to(torch.float32)
    py = (tile // tiles_x) * tile_rows + r % tile_rows
    py = py.expand(rows, 128).to(torch.float32) + row0
    return px, py


def ray_directions_tiled(
    inverse_view: torch.Tensor,
    inverse_projection: torch.Tensor,
    width: int,
    height: int,
    tile_rows: int,
) -> torch.Tensor:
    """Screen-tile-ordered ``[3, rows, 128]`` primary-ray directions (the JAX
    package's ``camera.ray_directions_tiled``, camera.py:211). Pad lanes get
    valid off-screen directions."""
    tiles_x = -(-width // 128)
    rows = -(-height // tile_rows) * tile_rows * tiles_x
    px, py = tile_pixels(width, tile_rows, rows, inverse_view.device)
    return unproject(inverse_view, inverse_projection, px, py, width, height)
