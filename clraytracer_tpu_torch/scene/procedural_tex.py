"""Procedural textures: closed-form texel functions.

A copy of the JAX package's descriptor families (``constant``, ``checker``,
``sky_gradient``) and their one shared formula ``_eval(desc, xp, i, j)``,
here with a numpy front-end (``bake``, for the texel pool) and a torch one
(``eval_texel``, for the skybox and the plain frame). The fused frame
kernel (csrc/render.cu) evaluates the same formula per ray.

Parity contract: ``eval_texel(desc, i, j)`` equals ``bake(desc)[j, i]``
bit-exactly. Every arithmetic result is an integer below 2^24 held in f32,
and the only divisions are by powers of two, so no rounding differs between
machines.
"""

from __future__ import annotations

import dataclasses
import types

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class ProceduralTexture:
    """Static descriptor of a closed-form texture.

    kind:
      - "constant": rgb0 everywhere (the reference's default white/black
        1x1 textures, ResourceManager.cpp:168-177)
      - "checker":  cells x cells checkerboard of rgb0/rgb1
      - "sky_gradient": vertical zenith→horizon gradient over the upper
        half, ground color below, plus a circular sun disc
    """

    kind: str
    width: int
    height: int
    rgb0: tuple[int, int, int] = (255, 255, 255)
    rgb1: tuple[int, int, int] = (0, 0, 0)
    cells: int = 8
    ground: tuple[int, int, int] = (90, 70, 55)
    sun_center: tuple[int, int] = (0, 0)  # (i, j)
    sun_radius: int = 0


KINDS = ("constant", "checker", "sky_gradient")


def constant(rgb: tuple[int, int, int]) -> ProceduralTexture:
    return ProceduralTexture(kind="constant", width=1, height=1, rgb0=rgb)


def checker(
    size: int = 64,
    cells: int = 8,
    color_a: tuple[int, int, int] = (255, 255, 255),
    color_b: tuple[int, int, int] = (40, 40, 40),
) -> ProceduralTexture:
    """``size`` and ``cells`` must be powers of two (the cell index is then
    ``floor(i * (cells/size))`` with an exactly representable ratio)."""
    if size & (size - 1) or cells & (cells - 1):
        raise ValueError("checker size and cells must be powers of two")
    return ProceduralTexture(
        kind="checker", width=size, height=size,
        rgb0=tuple(color_a), rgb1=tuple(color_b), cells=cells,
    )


def sky_gradient(
    width: int = 256,
    height: int = 128,
    zenith: tuple[int, int, int] = (60, 90, 170),
    horizon: tuple[int, int, int] = (200, 210, 235),
    ground: tuple[int, int, int] = (90, 70, 55),
) -> ProceduralTexture:
    """Equirect sky: gradient upper hemisphere + ground + sun disc.
    ``height`` must be a power of two."""
    if height & (height - 1):
        raise ValueError("sky_gradient height must be a power of two")
    return ProceduralTexture(
        kind="sky_gradient", width=width, height=height,
        rgb0=tuple(zenith), rgb1=tuple(horizon), ground=tuple(ground),
        sun_center=(width // 4, (3 * height) // 10),
        sun_radius=max(1, height // 32),
    )


#: torch front-end of ``_eval`` (numpy's names, torch's functions)
_TORCH = types.SimpleNamespace(
    floor=torch.floor,
    where=torch.where,
    minimum=lambda a, b: torch.clamp(a, max=b),
    full_like=torch.full_like,
    stack=torch.stack,
)


def eval_texel(
    desc: ProceduralTexture, i: torch.Tensor, j: torch.Tensor
) -> torch.Tensor:
    """Byte values ``[3, *S]`` f32 in [0, 255] at integer texel coords
    (f32 tensors holding exact integers)."""
    return _eval(desc, _TORCH, i, j)


def bake(desc: ProceduralTexture) -> np.ndarray:
    """Render the descriptor to an [H, W, 3] u8 image for the texel pool."""
    jj, ii = np.meshgrid(
        np.arange(desc.height, dtype=np.float32),
        np.arange(desc.width, dtype=np.float32),
        indexing="ij",
    )
    rgb = _eval(desc, np, ii, jj)  # [3, H, W] f32 bytes
    return np.moveaxis(rgb, 0, -1).astype(np.uint8)


def _eval(desc: ProceduralTexture, xp, i, j):
    """The formula both front-ends share (procedural_tex.py:129 of the JAX
    package). ``i``/``j`` are f32 arrays of exact integers; returns
    ``[3, *S]`` f32 bytes."""
    stack = xp.stack
    if desc.kind == "constant":
        r, g, b = (xp.full_like(i, float(c)) for c in desc.rgb0)
        return stack([r, g, b])

    if desc.kind == "checker":
        ratio = float(desc.cells) / float(desc.width)
        ci = xp.floor(i * ratio)
        cj = xp.floor(j * ratio)
        odd = xp.floor((ci + cj) * 0.5) * 2.0 != (ci + cj)  # parity, exact
        r = xp.where(odd, float(desc.rgb1[0]), float(desc.rgb0[0]))
        g = xp.where(odd, float(desc.rgb1[1]), float(desc.rgb0[1]))
        b = xp.where(odd, float(desc.rgb1[2]), float(desc.rgb0[2]))
        return stack([r, g, b])

    if desc.kind == "sky_gradient":
        half = float(desc.height // 2)  # power of two → /half exact
        upper = j < half
        jj = xp.minimum(j, half - 1.0)
        out = []
        for c in range(3):
            z, h = float(desc.rgb0[c]), float(desc.rgb1[c])
            grad = xp.floor((z * (half - jj) + h * jj) * (1.0 / half))
            out.append(xp.where(upper, grad, float(desc.ground[c])))
        ci, cj = desc.sun_center
        dx = i - float(ci)
        dy = j - float(cj)
        sun = dx * dx + dy * dy < float(desc.sun_radius * desc.sun_radius)
        return stack([xp.where(sun, 255.0, ch) for ch in out])

    raise ValueError(f"unknown procedural texture kind: {desc.kind}")


def descriptor_row(off_hi: int, off_lo: int, desc: ProceduralTexture) -> list[float]:
    """One row of the fused kernel's texture table (csrc/render.cu
    ``TEX_*`` columns): selection offsets, kind, size and the constants of
    ``_eval`` as the f32 values the formula multiplies by."""
    return [
        float(off_hi), float(off_lo), float(KINDS.index(desc.kind)),
        float(desc.width), float(desc.height),
        *(float(c) for c in desc.rgb0), *(float(c) for c in desc.rgb1),
        float(np.float32(float(desc.cells) / float(desc.width))),
        float(desc.height // 2),
        float(np.float32(1.0 / float(desc.height // 2 or 1))),
        *(float(c) for c in desc.ground),
        float(desc.sun_center[0]), float(desc.sun_center[1]),
        float(desc.sun_radius * desc.sun_radius),
    ]


#: columns of ``descriptor_row``
TEX_COLS = 20
