"""Table gathers of the differentiable path (the JAX package's
``ops/gather.py``): planar ``[W, *idx.shape]`` out, clip-mode indices,
gradients by row scatter-add.

``wide_rows_diff`` is the tracer's [S, 25] triangle-table gather: on a
CUDA table it is always ``TakeRows`` (K2.3 forward, K2.4 backward), with
no size threshold and no fallback; on a CPU table it is the same function
with the kernels' plain versions. The other gathers are plain torch
indexing: the JAX package's select chains, one-hot matmuls and sorted
VJPs for them work around the TPU's serialised gathers and scatters and
compute the same values.
"""

from __future__ import annotations

import torch

from clraytracer_tpu_torch.ops.gather_rows import TakeRows


def take_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rows of ``table [R, W]`` at ``idx [...]`` (clamped) → ``[W, ...]``.
    Differentiable w.r.t. the table (``index_select``'s scatter-add)."""
    flat = idx.reshape(-1).long().clamp(0, table.shape[0] - 1)
    rows = table.index_select(0, flat)  # [N, W]
    return rows.t().reshape((table.shape[1],) + tuple(idx.shape))


def take_rgb(pool: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """RGB rows of a texel pool ``[P, 3|4]`` at ``idx [...]`` → ``[3, ...]``."""
    return take_rows(pool, idx)[:3]


def small_rows_diff(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The material and instance gathers (a few rows): a row gather."""
    return take_rows(table, idx)


def wide_rows_diff(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The differentiable tracer's wide-row gather, ``table [T, W]`` f32 →
    ``[W, ...]``, through ``TakeRows``."""
    flat = idx.reshape(-1).to(torch.int32).contiguous()
    out = TakeRows.apply(table.contiguous(), flat)
    return out.reshape((table.shape[1],) + tuple(idx.shape))
