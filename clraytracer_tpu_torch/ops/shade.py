"""Skybox sampling and texture-registry helpers of the shading step (the
parts of the JAX package's ``ops/shade.py`` the fused frame needs).

The equirect skybox (MathAndSTL.cl:253-258) stays outside the frame kernel,
as in the reference package: its ``atan2``/``acos`` come from torch here,
on whichever device the frame runs.
"""

from __future__ import annotations

import math

import torch

from clraytracer_tpu_torch.device import const

_U8 = 1.0 / 255.0

#: texel-pool offsets can exceed 2^24 (f32 integer exactness), so packed
#: tables carry them split as (off >> _OFF_SHIFT, off & _OFF_MASK)
_OFF_SHIFT = 12
_OFF_MASK = (1 << _OFF_SHIFT) - 1


def _skybox_index(w: int, h: int, off: int, d: torch.Tensor) -> torch.Tensor:
    """Flat texel index (i32) of an equirect skybox sample for planar
    directions ``d`` [3, ...] (shade.py:169 of the JAX package)."""
    pi = const(math.pi, d)
    theta = (
        torch.atan2(d[0], -d[2]) / pi * (0.5 * float(w))
    ).to(torch.int32)
    phi = (
        torch.acos(torch.clamp(d[1], -1.0, 1.0)) / pi * float(h)
    ).to(torch.int32)
    return phi * int(w) + theta + int(off)


def _all_procedural(scene) -> bool:
    """Does every texture in the scene have a procedural descriptor?"""
    handles = {h for h, _, _ in scene.procedural_tex}
    return handles >= set(range(scene.atlas.num_textures))


def _eval_skybox_inline(
    scene, sky_flat: torch.Tensor, skw: int, skoff: int
) -> torch.Tensor:
    """Equirect skybox texel ``[3, ...]`` in [0, 1] from the flat index,
    evaluated from the sky's procedural descriptor (theta may be negative:
    the floor-divmod reproduces the flat form's row wrap)."""
    from clraytracer_tpu_torch.scene.procedural_tex import eval_texel

    desc = next(
        d for h, _o, d in scene.procedural_tex if h == scene.skybox_tex
    )
    rel = sky_flat - skoff
    i = torch.remainder(rel, skw).to(torch.float32)
    j = torch.clamp(
        torch.div(rel, skw, rounding_mode="floor"), 0, desc.height - 1
    ).to(torch.float32)
    return eval_texel(desc, i, j) * _U8
