"""The benchmark's scene description: what both sides are handed.

A ``SceneSpec`` holds the triangle soups, textures, materials and instances
as plain numpy values. The program gets them through its public
``SceneBuilder`` (``rtbench.port``); the plain reference builds its own
tables from the same values (``rtbench.reference``). Texture and material
handles follow the program's builder: textures 0 and 1 are its 1x1 white
and black, material 0 its prepared default (the upstream's
ResourceManager.cpp:168-177, 224-232).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from rtbench.scenes.geometry import Mesh


@dataclasses.dataclass
class Texture:
    """An [H, W, 3] u8 ``image``, or a closed-form ``procedural``
    descriptor (the fields of the program's ``ProceduralTexture``)."""

    image: np.ndarray | None = None
    procedural: dict | None = None

    @property
    def size(self) -> tuple[int, int]:
        """(width, height) in texels."""
        if self.image is not None:
            return int(self.image.shape[1]), int(self.image.shape[0])
        return int(self.procedural["width"]), int(self.procedural["height"])


@dataclasses.dataclass
class Material:
    albedo: tuple
    specular: tuple = (1.0, 1.0, 1.0)
    albedo_tex: int = 0
    specular_tex: int = 0
    shininess: float = 2.2
    roughness: float = 0.6


@dataclasses.dataclass
class Instance:
    mesh: int
    transform: np.ndarray  # [4, 4] f32, row-vector convention (v @ M)
    material_start: int


@dataclasses.dataclass
class SceneSpec:
    meshes: list[Mesh]
    textures: list[Texture]
    materials: list[Material]
    instances: list[Instance]
    max_textures: int = 32

    @property
    def sky(self) -> int:
        """The skybox texture: the program's rule, texture 2 when there is
        one (scene/builder.py ``build``)."""
        return 2 if len(self.textures) > 2 else 0


def constant(rgb) -> dict:
    return dict(kind="constant", width=1, height=1, rgb0=tuple(rgb), rgb1=(0, 0, 0),
                cells=8, ground=(90, 70, 55), sun_center=(0, 0), sun_radius=0)


def checker(size: int, cells: int, color_a=(255, 255, 255), color_b=(40, 40, 40)) -> dict:
    return dict(kind="checker", width=size, height=size, rgb0=tuple(color_a),
                rgb1=tuple(color_b), cells=cells, ground=(90, 70, 55), sun_center=(0, 0),
                sun_radius=0)


def sky_gradient(width: int, height: int, zenith=(60, 90, 170), horizon=(200, 210, 235),
                 ground=(90, 70, 55)) -> dict:
    return dict(kind="sky_gradient", width=width, height=height, rgb0=tuple(zenith),
                rgb1=tuple(horizon), cells=8, ground=tuple(ground),
                sun_center=(width // 4, (3 * height) // 10), sun_radius=max(1, height // 32))


def base_spec(max_textures: int, sky: tuple[int, int]) -> SceneSpec:
    """Textures 0, 1 (white, black), the procedural sky as texture 2, and
    the default material 0, as the program's builder starts a scene."""
    return SceneSpec(
        meshes=[],
        textures=[Texture(procedural=constant((255, 255, 255))),
                  Texture(procedural=constant((0, 0, 0))),
                  Texture(procedural=sky_gradient(*sky))],
        materials=[Material(albedo=tuple(np.array([55, 0, 255], np.float32) / 255.0),
                            specular=tuple(np.array([250, 228, 210], np.float32) / 255.0),
                            albedo_tex=0, specular_tex=1, shininess=1.2, roughness=0.8)],
        instances=[],
        max_textures=max_textures,
    )


def translation(x: float, y: float, z: float) -> np.ndarray:
    m = np.eye(4, dtype=np.float32)
    m[3, :3] = (x, y, z)
    return m


def rotation_y(angle_rad: float) -> np.ndarray:
    """Rotation about +Y for the row-vector convention."""
    c, s = np.cos(angle_rad), np.sin(angle_rad)
    m = np.eye(4, dtype=np.float32)
    m[0, 0], m[0, 2] = c, -s
    m[2, 0], m[2, 2] = s, c
    return m
