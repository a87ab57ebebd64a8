"""Post chain: saturation → Reinhard tone map → merged gamma pow →
vignette (MathAndSTL.cl:143-169), on the render loop's tile layout
(``post_process_tiled``) or on an [H, W, 3] image (``post_process``), and
FXAA (kernel_main.cl:294-340), which the untiled chain runs first when
asked. The standalone steps (``saturation``, ``reinhard``,
``gamma_correct``, ``vignette_mask``) are the JAX package's, over
``[..., 3]`` images; the chains merge them into one pass.

Plain torch: in the JAX package this chain is XLA code, not a kernel. Its
array shifts (``jnp.roll``) are ``torch.roll``.
"""

from __future__ import annotations

import torch

from clraytracer_tpu_torch.device import const

_MAX_WHITE = 0.8
#: the f32 luma weights: Reinhard's, and FXAA's
_LUMA_R = tuple(torch.tensor([0.2126, 0.7152, 0.0722], dtype=torch.float32).tolist())
_FXAA_LUMA = tuple(torch.tensor([0.299, 0.587, 0.114], dtype=torch.float32).tolist())
_FXAA_SPAN_MAX = 8.0
_FXAA_REDUCE_MUL = 1.0 / 8.0
_FXAA_REDUCE_MIN = 1.0 / 128.0


def _fma_luma(a: torch.Tensor, weights: tuple) -> torch.Tensor:
    """``einsum("...c,c->...")`` over [..., 3] as XLA evaluates the JAX
    package's: fused multiply-adds in channel order, each product and sum
    rounded once (f64 holds the f32 product exactly)."""
    acc = a[..., 0] * weights[0]
    for c in (1, 2):
        acc = (a[..., c].double() * weights[c] + acc.double()).float()
    return acc


def _luminance(rgb: torch.Tensor) -> torch.Tensor:
    return _fma_luma(rgb, _LUMA_R)


def saturation(rgb: torch.Tensor, change: float = 1.2) -> torch.Tensor:
    """Luma-sqrt pivot saturation (MathAndSTL.cl:154-158)."""
    p = torch.sqrt(
        rgb[..., 0] ** 2 * 0.299 + rgb[..., 1] ** 2 * 0.587 + rgb[..., 2] ** 2 * 0.114
    )[..., None]
    return p + (rgb - p) * change


def reinhard(rgb: torch.Tensor) -> torch.Tensor:
    """Extended Reinhard, max white 0.8, then pow(1/1.55)
    (MathAndSTL.cl:143-152)."""
    l_old = _luminance(rgb)
    numerator = l_old * (1.0 + l_old / const(_MAX_WHITE * _MAX_WHITE, l_old))
    l_new = numerator / (1.0 + l_old)
    scale = l_new / torch.where(l_old == 0.0, torch.ones_like(l_old), l_old)
    return torch.pow(torch.clamp(rgb * scale[..., None], min=0.0), 1.0 / 1.55)


def gamma_correct(rgb: torch.Tensor) -> torch.Tensor:
    """pow(1/1.2) (MathAndSTL.cl:160)."""
    return torch.pow(torch.clamp(rgb, min=0.0), 1.0 / 1.2)


def vignette_mask(height: int, width: int, device=None) -> torch.Tensor:
    """[H, W] multiplicative vignette (MathAndSTL.cl:163-169)."""
    u = torch.arange(width, dtype=torch.float32, device=device)
    v = torch.arange(height, dtype=torch.float32, device=device)
    u, v = u / const(width, u), v / const(height, v)
    uu, vv = torch.meshgrid(u, v, indexing="xy")
    vig = uu * (1.0 - uu) * (vv * (1.0 - vv)) * 15.0
    return torch.pow(torch.clamp(vig, min=0.0), 0.15)


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


def _vignette_factors(n: int, size: int, device=None) -> torch.Tensor:
    """Per-coordinate separable vignette factor
    ``(x*(1-x)*sqrt(15))^0.15`` for ``x = arange(n)/size``."""
    x = torch.arange(n, dtype=torch.float32, device=device)
    x = x / const(size, x)
    s15 = torch.sqrt(torch.tensor(15.0, dtype=torch.float32)).item()
    return torch.pow(torch.clamp(x * (1.0 - x) * s15, min=0.0), 0.15)


def fxaa(img: torch.Tensor) -> torch.Tensor:
    """FXAA over an [H, W, 3] image (kernel_main.cl:294-340; post.py:67 of
    the JAX package): neighbour fetches are array shifts, the sub-texel
    taps along ``dir`` at +-1/6 and +-1/2 texels are bilinear."""
    h, w = img.shape[:2]

    def shift2(a, dy, dx):
        return torch.roll(a, shifts=(-dy, -dx), dims=(0, 1))

    def luma(a):
        return _fma_luma(a, _FXAA_LUMA)

    l_nw, l_ne, l_sw, l_se, l_m = (
        luma(a) for a in (shift2(img, -1, -1), shift2(img, -1, 1),
                          shift2(img, 1, -1), shift2(img, 1, 1), img)
    )
    dir_x = -((l_nw + l_ne) - (l_sw + l_se))
    dir_y = (l_nw + l_sw) - (l_ne + l_se)
    luma_sum = l_nw + l_ne + l_sw + l_se
    dir_reduce = torch.clamp(luma_sum * 0.25 * _FXAA_REDUCE_MUL, min=_FXAA_REDUCE_MIN)
    rcp_dir_min = 1.0 / (torch.minimum(dir_x.abs(), dir_y.abs()) + dir_reduce)
    dx = torch.clamp(dir_x * rcp_dir_min, -_FXAA_SPAN_MAX, _FXAA_SPAN_MAX)
    dy = torch.clamp(dir_y * rcp_dir_min, -_FXAA_SPAN_MAX, _FXAA_SPAN_MAX)

    ys, xs = torch.meshgrid(
        torch.arange(h, dtype=torch.float32, device=img.device),
        torch.arange(w, dtype=torch.float32, device=img.device),
        indexing="ij",
    )

    def bilinear(oy, ox):
        fy = torch.clamp(ys + oy, 0.0, h - 1.0)
        fx = torch.clamp(xs + ox, 0.0, w - 1.0)
        y0 = torch.floor(fy).to(torch.int64)
        x0 = torch.floor(fx).to(torch.int64)
        y1 = torch.clamp(y0 + 1, max=h - 1)
        x1 = torch.clamp(x0 + 1, max=w - 1)
        wy = (fy - y0)[..., None]
        wx = (fx - x0)[..., None]
        return (
            img[y0, x0] * (1 - wy) * (1 - wx)
            + img[y0, x1] * (1 - wy) * wx
            + img[y1, x0] * wy * (1 - wx)
            + img[y1, x1] * wy * wx
        )

    rgb_a = 0.5 * (
        bilinear(dy * -0.166667, dx * -0.166667) + bilinear(dy * 0.166667, dx * 0.166667)
    )
    rgb_b = rgb_a * 0.5 + 0.25 * (
        bilinear(dy * -0.5, dx * -0.5) + bilinear(dy * 0.5, dx * 0.5)
    )
    l_b = luma(rgb_b)
    l_min = torch.minimum(l_m, torch.minimum(torch.minimum(l_nw, l_ne), torch.minimum(l_sw, l_se)))
    l_max = torch.maximum(l_m, torch.maximum(torch.maximum(l_nw, l_ne), torch.maximum(l_sw, l_se)))
    use_a = (l_b < l_min) | (l_b > l_max)
    return torch.where(use_a[..., None], rgb_a, rgb_b)


def post_process(img: torch.Tensor, enable_fxaa: bool = False) -> torch.Tensor:
    """The chain over an [H, W, 3] linear image (kernel_main.cl:342-359;
    post.py:211 of the JAX package): optional FXAA, then the planar core
    with the separable vignette of one row and one column."""
    h, w = img.shape[:2]
    if enable_fxaa:
        img = fxaa(img)
    p = img.reshape(-1, 3).T
    fu = _vignette_factors(w, w, img.device)
    fv = _vignette_factors(h, h, img.device)
    vig = (fv[:, None] * fu[None, :]).reshape(-1)
    return _post_core(p, vig).T.reshape(h, w, 3)
