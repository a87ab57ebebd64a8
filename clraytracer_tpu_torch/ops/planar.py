"""Planar (channel-major) vector math of the differentiable path.

Every per-ray vector travels as ``[3, *spatial]``, as in the JAX package's
``ops/planar.py``; the expressions keep its order term for term, so the
float results agree with it (``normalize`` divides by ``sqrt(dot)``, not a
reciprocal square root).
"""

from __future__ import annotations

import torch


def from_last(v: torch.Tensor) -> torch.Tensor:
    """[..., 3] → [3, ...] (channel-major)."""
    return torch.movedim(v, -1, 0)


def to_last(p: torch.Tensor, shape: tuple[int, ...]) -> torch.Tensor:
    """[3, ...] → shape + [3]."""
    return torch.movedim(p, 0, -1).reshape(*shape, p.shape[0])


def dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[3, N] · [3, N] → [N]."""
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.stack(
        [
            a[1] * b[2] - a[2] * b[1],
            a[2] * b[0] - a[0] * b[2],
            a[0] * b[1] - a[1] * b[0],
        ]
    )


def normalize(v: torch.Tensor) -> torch.Tensor:
    return v / torch.sqrt(dot(v, v))[None]


def reflect(v: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """v - n * dot(n, v) * 2 (reference MathAndSTL.cl:117-119)."""
    return v - n * (2.0 * dot(n, v))[None]


def transform_point(p: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """Row-vector affine transform of planar points: [3, N] x [4, 4]."""
    return torch.stack(
        [p[0] * m[0, j] + p[1] * m[1, j] + p[2] * m[2, j] + m[3, j] for j in range(3)]
    )


def transform_vector(d: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """The linear part of ``transform_point``: [3, N] x [4, 4]."""
    return torch.stack([d[0] * m[0, j] + d[1] * m[1, j] + d[2] * m[2, j] for j in range(3)])


def transform_point_batched(p: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """Per-ray matrices: [3, N] x [N, 4, 4] (gathered instance transforms)."""
    return torch.stack(
        [p[0] * m[:, 0, j] + p[1] * m[:, 1, j] + p[2] * m[:, 2, j] + m[:, 3, j]
         for j in range(3)]
    )


def transform_vector_batched(d: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """The linear part of ``transform_point_batched``: [3, N] x [N, 4, 4]."""
    return torch.stack(
        [d[0] * m[:, 0, j] + d[1] * m[:, 1, j] + d[2] * m[:, 2, j] for j in range(3)]
    )


def where(mask: torch.Tensor, a, b) -> torch.Tensor:
    """Select on a [N] mask between [3, N] (or scalar-broadcast) values."""
    return torch.where(mask[None], a, b)


def scale(v: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """[3, N] * [N]."""
    return v * s[None]
