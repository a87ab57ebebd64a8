"""Runtime configuration (a copy of ``clraytracer_tpu.config``'s frame and
pool settings: the port imports nothing of the JAX package).

Reference constants: window 1249x720 (Window.cpp:15), camera defaults
(Camera.hpp:15-26), pool sizes (ResourceManager.cpp:32-40), ``SunAngle =
-1.96f`` (Engine.cpp:18).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class CameraConfig:
    """FPS camera parameters (reference Math/Camera.hpp:15-34)."""

    position: Tuple[float, float, float] = (0.0, 4.0, 15.0)
    yaw_deg: float = -90.0
    pitch_deg: float = 0.0
    vertical_fov_deg: float = 65.0
    near_clip: float = 0.01
    far_clip: float = 500.0


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Frame/render parameters; the same fields and defaults as the JAX
    package's ``RenderConfig``. This package renders the default frame
    (reference-parity integer-colour shading, post on, FXAA off, one sample);
    ``render.render_frame`` raises ``NotImplementedError`` for the other
    options."""

    width: int = 1249
    height: int = 720
    bounces: int = 2
    sun_angle: float = -1.96
    enable_post: bool = True
    enable_fxaa: bool = False
    samples: int = 1
    enable_shadows: bool = False
    enable_refraction: bool = False
    refraction_ior: float = 1.45
    reference_parity_shading: bool = True
    integer_colors: bool = True
    frame_watchdog_ms: float | None = None
    enable_gi: bool = False
    gi_seed: int = 0


@dataclasses.dataclass(frozen=True)
class PoolConfig:
    """Capacity plan for the scene pools (reference arena sizes,
    ResourceManager.cpp:32-40, Renderer.hpp:16)."""

    max_triangles: int = 2_400_000
    max_bvh_nodes: int = 2_400_000
    max_textures: int = 32
    max_texel_bytes: int = 100 * 1024 * 1024
    max_materials: int = 256
    max_meshes: int = 128
    max_instances: int = 401
