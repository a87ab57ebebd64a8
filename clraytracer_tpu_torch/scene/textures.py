"""Packed texel-pool assembly (numpy).

The reference appends every RGB8 image to one texel pool and keeps
{width, height, texel_offset} per texture (ResourceManager.cpp:180-222).
Texture 0 is 1x1 white and texture 1 is 1x1 black
(ResourceManager.cpp:168-177). Image files are not decoded here: the
procedural scenes bake their textures, and file import comes with a later
part of the port.
"""

from __future__ import annotations

import dataclasses

import numpy as np


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
