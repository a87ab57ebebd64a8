"""Per-ray random streams of the Monte-Carlo GI continuation: Wang-hash
seeding, xorshift32 steps, 24-bit uniform floats, the tangent frame and
uniform hemisphere sampling (MathAndSTL.cl:173-215; the JAX package's
``ops/rng.py``), and the per-bounce seed bases of the fused frame
(``render_pallas._gi_seed_rows``).

torch has no uint32 arithmetic, so a stream state is an int64 tensor that
holds the uint32 value: every multiply and left shift is masked back to 32
bits, and every intermediate stays below 2^63 (the largest is a 32-bit
state times the 30-bit Wang constant). The bits equal the JAX package's
uint32 and the CUDA kernel's ``uint32_t``.
"""

from __future__ import annotations

import math

import torch

_MASK = 0xFFFFFFFF
#: float multiplier for 24-bit mantissa uniforms (MathAndSTL.cl:127)
_FMUL = 1.0 / 16777216.0


def _u32(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.int64) & _MASK


def wang_hash(seed: torch.Tensor) -> torch.Tensor:
    """Wang integer hash (MathAndSTL.cl:189-195) of uint32 values held in
    an integer tensor → int64 tensor of uint32 values."""
    s = _u32(seed)
    s = (s ^ 61) ^ (s >> 16)
    s = (s * 9) & _MASK
    s = s ^ (s >> 4)
    s = (s * 0x27D4EB2D) & _MASK
    return s ^ (s >> 15)


def xorshift32(state: torch.Tensor) -> torch.Tensor:
    """One xorshift32 step: the new state, which is also the sample
    (MathAndSTL.cl:197-202)."""
    s = _u32(state)
    s = s ^ ((s << 13) & _MASK)
    s = s ^ (s >> 17)
    return s ^ ((s << 5) & _MASK)


def next_float01(state: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(uniform f32 in [0, 1) with 24-bit granularity, advanced state)
    (MathAndSTL.cl:204-206)."""
    s = xorshift32(state)
    return (s >> 8).to(torch.float32) * _FMUL, s


def tangent_space(normal: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(tangent, binormal) around planar normals [3, *S] (GetTangentSpace,
    MathAndSTL.cl:173-185): helper +X, or +Z where the normal is nearly +X.
    In csrc/render.cu's expression order: the cross products without their
    zero terms, each scaled by the reciprocal of its length."""
    nx, ny, nz = normal[0], normal[1], normal[2]
    near_x = nx.abs() > 0.99
    one, zero = torch.ones_like(nx), torch.zeros_like(nx)
    hx = torch.where(near_x, zero, one)
    hz = torch.where(near_x, one, zero)
    tx, ty, tz = ny * hz, nz * hx - nx * hz, -ny * hx
    tn = 1.0 / torch.sqrt(tx * tx + ty * ty + tz * tz)
    tx, ty, tz = tx * tn, ty * tn, tz * tn
    bx, by, bz = ny * tz - nz * ty, nz * tx - nx * tz, nx * ty - ny * tx
    bn = 1.0 / torch.sqrt(bx * bx + by * by + bz * bz)
    return torch.stack([tx, ty, tz]), torch.stack([bx * bn, by * bn, bz * bn])


def hemisphere_sample(
    state: torch.Tensor, normal: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Uniform-in-cosTheta hemisphere directions about planar normals
    [3, *S] (HemisphereSample, MathAndSTL.cl:208-215) → ([3, *S]
    directions, advanced state), in csrc/render.cu's expression order."""
    cos_theta, state = next_float01(state)
    u, state = next_float01(state)
    sin_theta = torch.sqrt(torch.clamp(1.0 - cos_theta * cos_theta, min=0.0))
    phi = (2.0 * math.pi) * u
    px = torch.cos(phi) * sin_theta
    py = torch.sin(phi) * sin_theta
    tangent, binormal = tangent_space(normal)
    d = torch.stack(
        [tangent[c] * px + binormal[c] * py + normal[c] * cos_theta for c in range(3)]
    )
    return d, state


def gi_seed_rows(gi_seed: int, bounces: int) -> list[int]:
    """Per-bounce seed bases ``1 + gi_seed*7919 + b*1237`` in wrapping
    32-bit arithmetic, as uint32 values (render_pallas._gi_seed_rows; its
    i32 wrap has the same bits). The CUDA kernel takes bounce 0's base and
    adds 1237 per bounce in ``uint32_t``, which wraps the same way."""
    return [(1 + gi_seed * 7919 + b * 1237) & _MASK for b in range(bounces)]


def ray_streams(ray_index: torch.Tensor, seed_base: int) -> torch.Tensor:
    """The GI stream state of each ray at one bounce:
    ``wang_hash(i * 9999 + base)`` of its strip-order index ``i``
    (render.py:255-261 of the JAX package, the fused kernel's
    ``row*128 + lane``)."""
    return wang_hash((_u32(ray_index) * 9999 + seed_base) & _MASK)
