"""Packed texel-pool assembly (numpy).

The reference appends every RGB8 image to one texel pool and keeps
{width, height, texel_offset} per texture (ResourceManager.cpp:180-222).
Texture 0 is 1x1 white and texture 1 is 1x1 black
(ResourceManager.cpp:168-177). ``load_image`` decodes a file with PIL
where it can be imported, as the JAX package does, else with the port's
own decoder (scene/imagefile.py). ``checkerboard`` and ``gradient_sky``
are images for ``SceneBuilder.import_texture``: the bakes of the
procedural descriptors, as the JAX package's ``scene/textures.py`` makes
them.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np

from clraytracer_tpu_torch.scene import imagefile
from clraytracer_tpu_torch.scene import procedural_tex as ptex


def image_decoder() -> str:
    """Which decoder ``load_image`` takes here: ``"PIL"`` or ``"port"``."""
    try:
        from PIL import Image  # noqa: F401
    except ImportError:
        return "port"
    return "PIL"


def decode_rgb8(path: str | Path) -> np.ndarray:
    """An image file → [H, W, 3] uint8: PIL's ``convert("RGB")`` where PIL
    can be imported (the JAX package's decode), else ``imagefile``'s."""
    try:
        from PIL import Image
    except ImportError:
        return imagefile.decode_image(path)
    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"), np.uint8)


def checkerboard(
    size: int = 64,
    cells: int = 8,
    color_a: tuple[int, int, int] = (255, 255, 255),
    color_b: tuple[int, int, int] = (40, 40, 40),
) -> np.ndarray:
    """[size, size, 3] u8 checker image: the bake of ``ptex.checker``, so
    imported and procedural checkers are texel-identical."""
    return ptex.bake(ptex.checker(size, cells, color_a, color_b))


def gradient_sky(width: int = 256, height: int = 128) -> np.ndarray:
    """[height, width, 3] u8 equirect sky image: the bake of
    ``ptex.sky_gradient``."""
    return ptex.bake(ptex.sky_gradient(width, height))


@dataclasses.dataclass
class AtlasBuilder:
    """Accumulates RGB8 images into a flat texel pool."""

    max_texels: int | None = None
    _pool: list[np.ndarray] = dataclasses.field(default_factory=list)
    _width: list[int] = dataclasses.field(default_factory=list)
    _height: list[int] = dataclasses.field(default_factory=list)
    _offset: list[int] = dataclasses.field(default_factory=list)
    _cursor: int = 0

    def __post_init__(self) -> None:
        if not self._pool:
            self.add_image(np.full((1, 1, 3), 255, np.uint8))
            self.add_image(np.zeros((1, 1, 3), np.uint8))

    def add_image(self, rgb8: np.ndarray) -> int:
        """Append an [H, W, 3] uint8 image; returns its texture handle."""
        rgb8 = np.ascontiguousarray(rgb8, np.uint8)
        if rgb8.ndim != 3 or rgb8.shape[2] != 3:
            raise ValueError(f"expected [H, W, 3] RGB8, got {rgb8.shape}")
        h, w = rgb8.shape[:2]
        n = h * w
        if self.max_texels is not None and self._cursor + n > self.max_texels:
            raise MemoryError(
                f"texel pool overflow: {self._cursor + n} > {self.max_texels}"
            )
        handle = len(self._width)
        self._pool.append(rgb8.reshape(n, 3))
        self._width.append(w)
        self._height.append(h)
        self._offset.append(self._cursor)
        self._cursor += n
        return handle

    def load_image(self, path: str | Path) -> int:
        """Decode an image file to RGB8 and append it (stb_image's role in
        the reference); returns its texture handle."""
        return self.add_image(decode_rgb8(path))

    @property
    def num_textures(self) -> int:
        return len(self._width)

    def build(self) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        """Returns (texels_u8 [P,3], width [K], height [K], offset [K])."""
        return (
            np.concatenate(self._pool, axis=0),
            np.asarray(self._width, np.int32),
            np.asarray(self._height, np.int32),
            np.asarray(self._offset, np.int32),
        )
