"""Post chain on the render loop's tile layout: saturation → Reinhard
tone map → merged gamma pow → vignette (MathAndSTL.cl:143-169).

Plain torch: in the JAX package this chain is XLA elementwise code, not a
kernel. FXAA and the untiled ``post_process`` come with a later part of
the port.
"""

from __future__ import annotations

import torch

from clraytracer_tpu_torch.device import const

_MAX_WHITE = 0.8


def _post_core(p: torch.Tensor, vig: torch.Tensor) -> torch.Tensor:
    """saturation → Reinhard → merged pow → vignette over planar
    [3, *spatial] pixels (post.py:136 of the JAX package, same expression
    tree)."""
    piv = torch.sqrt(
        p[0] * p[0] * 0.299 + p[1] * p[1] * 0.587 + p[2] * p[2] * 0.114
    )
    p = piv[None] + (p - piv[None]) * 1.2

    l_old = p[0] * 0.2126 + p[1] * 0.7152 + p[2] * 0.0722
    l_new = l_old * (
        1.0 + l_old / const(_MAX_WHITE * _MAX_WHITE, l_old)
    ) / (1.0 + l_old)
    p = p * (l_new / torch.where(l_old == 0.0, torch.ones_like(l_old), l_old))[None]

    p = torch.pow(torch.clamp(p, min=0.0), 1.0 / (1.55 * 1.2))
    return p * vig[None]


def vignette_mask_tiled(
    width: int, height: int, layout: tuple, rows_total: int, device: torch.device
) -> torch.Tensor:
    """[rows_total, 128] vignette mask in the screen-tile layout
    (``("strip", trows, tiles_x, _)``). Pad lanes get mask 0."""
    _kind, rows, nx, _ny = layout
    r = torch.arange(rows_total, dtype=torch.int32, device=device)[:, None]
    lane = torch.arange(128, dtype=torch.int32, device=device)[None, :]
    tile = r // rows
    px = ((tile % nx) * 128 + lane).to(torch.float32)
    py = ((tile // nx) * rows + r % rows).expand(rows_total, 128).to(torch.float32)
    u = px / const(width, px)
    v = py / const(height, py)
    s15 = torch.sqrt(torch.tensor(15.0, dtype=torch.float32)).item()
    fu = torch.pow(torch.clamp(u * (1.0 - u) * s15, min=0.0), 0.15)
    fv = torch.pow(torch.clamp(v * (1.0 - v) * s15, min=0.0), 0.15)
    return fu * fv


def post_process_tiled(
    p: torch.Tensor,  # [3, rows_total, 128] screen-tile-ordered radiance
    width: int,
    height: int,
    layout: tuple,
) -> torch.Tensor:
    """Post chain directly on the render loop's [3, rows, 128] tile layout."""
    vig = vignette_mask_tiled(width, height, layout, p.shape[1], p.device)
    return _post_core(p, vig)
