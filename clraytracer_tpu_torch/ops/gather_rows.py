"""The differentiable tracer's row gather (K2.3) and its transpose (K2.4),
each beside its plain version, and ``TakeRows``, the autograd function
that joins them.

* ``gather_rows_cuda`` launches the hand-written CUDA kernel
  ``clrt_gather_rows`` (csrc/gather.cu), a port of the TPU kernel
  ``clraytracer_tpu/ops/gather_pallas.py`` ``_gather_kernel``:
  ``out[w, p] = table[clip(idx[p]), w]``, bit-exact, field-planar out.
* ``scatter_rows_cuda`` launches ``clrt_scatter_rows``, the port of
  ``_scatter_kernel``: ``d[t, w] = sum_p [clip(idx[p]) == t] * g[w, p]``.
  Each thread loads 4 neighbouring rays' index and cotangents as 16-byte
  loads (one ray a thread where N % 4 != 0), 8 columns at a time; a warp
  whose cotangents in a chunk are all zero skips it, and the others sum
  over the lanes that share a row (``__match_any_sync`` and shuffles) and
  add one atomic per distinct (row, column). Its order of summation, and
  with it the rounding, varies from run to run: on the card it is held to
  the plain version within ``1e-5 * sum_p |g| + 1e-7`` per element.
* ``gather_rows_plain`` (``index_select``) and ``scatter_rows_plain``
  (``index_add_``) are the plain versions. The tests use them, and
  ``gather_rows``/``scatter_rows`` take them only for CPU tensors.

Both kernels are bound by bytes, ``4 N + 4 N W + 4 T W`` (idx, the [W, N]
plane, the table): 0.0648 ms at 3.35 TB/s at the 1920x1080 step's shapes
(csrc/gather.cu).
"""

from __future__ import annotations

import torch

#: the ray count passes through ctypes as a C int
_MAX_N = 2**31 - 1


def gather_rows_plain(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table [T, W], idx [N] → [W, N]: rows at ``idx`` clamped to [0, T)."""
    rows = table.index_select(0, idx.long().clamp(0, table.shape[0] - 1))
    return rows.t().contiguous()


def scatter_rows_plain(
    g: torch.Tensor, idx: torch.Tensor, t_rows: int
) -> torch.Tensor:
    """g [W, N], idx [N] → [T, W]: each ``g[:, p]`` added to row
    ``clip(idx[p])``."""
    d = torch.zeros((t_rows, g.shape[0]), dtype=g.dtype, device=g.device)
    return d.index_add_(0, idx.long().clamp(0, t_rows - 1), g.t())


def _check_idx(idx: torch.Tensor, dev: torch.device) -> int:
    if idx.device != dev or idx.dtype != torch.int32 or idx.dim() != 1:
        raise ValueError("idx must be an [N] i32 tensor on the same CUDA device")
    if not idx.is_contiguous():
        raise ValueError("idx must be contiguous")
    n = idx.shape[0]
    if n > _MAX_N:
        raise ValueError(f"{n} rows exceed the kernels' C int count")
    return n


def gather_rows_cuda(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Launch K2.3 on CUDA tensors: table [T, W] f32, idx [N] i32 → [W, N]."""
    from clraytracer_tpu_torch.runtime import kernels

    dev = table.device
    if dev.type != "cuda":
        raise ValueError("gather_rows_cuda needs CUDA tensors")
    if table.dtype != torch.float32 or table.dim() != 2 or not table.is_contiguous():
        raise ValueError("table must be a contiguous [T, W] f32 tensor")
    t_rows, w = table.shape
    if t_rows == 0 or w == 0:
        raise ValueError("table must have rows and columns")
    n = _check_idx(idx, dev)
    lib = kernels.build_all()["gather.cu"]
    out = torch.empty((w, n), dtype=torch.float32, device=dev)
    code = lib.clrt_gather_rows(
        table.data_ptr(), t_rows, w, idx.data_ptr(), n, out.data_ptr(),
        kernels.stream_handle(dev),
    )
    kernels.check(code, "clrt_gather_rows")
    gather_rows_cuda.launches += 1
    return out


gather_rows_cuda.launches = 0


def scatter_rows_cuda(
    g: torch.Tensor, idx: torch.Tensor, t_rows: int
) -> torch.Tensor:
    """Launch K2.4 on CUDA tensors: g [W, N] f32, idx [N] i32 → [T, W]."""
    from clraytracer_tpu_torch.runtime import kernels

    dev = g.device
    if dev.type != "cuda":
        raise ValueError("scatter_rows_cuda needs CUDA tensors")
    if g.dtype != torch.float32 or g.dim() != 2 or not g.is_contiguous():
        raise ValueError("g must be a contiguous [W, N] f32 tensor")
    n = _check_idx(idx, dev)
    w = g.shape[0]
    if g.shape[1] != n or w == 0 or t_rows <= 0:
        raise ValueError("g must be [W, N] with N = len(idx), and T > 0")
    lib = kernels.build_all()["gather.cu"]
    d = torch.zeros((t_rows, w), dtype=torch.float32, device=dev)
    code = lib.clrt_scatter_rows(
        g.data_ptr(), idx.data_ptr(), n, t_rows, w, d.data_ptr(),
        kernels.stream_handle(dev),
    )
    kernels.check(code, "clrt_scatter_rows")
    scatter_rows_cuda.launches += 1
    return d


scatter_rows_cuda.launches = 0


def gather_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """K2.3 on a CUDA table, its plain version on a CPU one."""
    if table.device.type == "cuda":
        return gather_rows_cuda(table, idx)
    return gather_rows_plain(table, idx)


def scatter_rows(g: torch.Tensor, idx: torch.Tensor, t_rows: int) -> torch.Tensor:
    """K2.4 on a CUDA cotangent, its plain version on a CPU one."""
    if g.device.type == "cuda":
        return scatter_rows_cuda(g, idx, t_rows)
    return scatter_rows_plain(g, idx, t_rows)


class TakeRows(torch.autograd.Function):
    """Differentiable row gather ``table [T, W]``, ``idx [N] i32`` →
    ``[W, N]``: K2.3 forward, K2.4 backward (the JAX package's
    ``gather_pallas.take_rows_mxu``). ``idx`` gets no gradient."""

    @staticmethod
    def forward(ctx, table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
        ctx.save_for_backward(idx)
        ctx.t_rows = table.shape[0]
        return gather_rows(table, idx)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        (idx,) = ctx.saved_tensors
        return scatter_rows(g.contiguous(), idx, ctx.t_rows), None
