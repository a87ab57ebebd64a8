"""Fused forward frame: kernel K2.2 and its plain version.

* ``render_cuda`` launches the hand-written CUDA kernel (csrc/render.cu), a
  port of the TPU kernel ``clraytracer_tpu/ops/render_pallas.py``
  (``_make_render_kernel``) in camera mode, atlas mode 0 (every texture
  procedural), without shadows, GI or the split-rebin carry.
* ``render_fused_plain`` is the plain PyTorch version: the same raygen,
  ``trace_plain`` per bounce and the same shading expressions. The tests
  use it, and ``render_fused_camera`` takes it only for a scene on the CPU.
* ``render_fused_camera`` is the frame entry (render_pallas.py:1204): one
  kernel launch, then ``_finish_frame``'s deferred sky add.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import numpy as np
import torch

from clraytracer_tpu_torch.camera import tile_pixels, unproject
from clraytracer_tpu_torch.ops.shade import (
    _OFF_SHIFT,
    _U8,
    _eval_skybox_inline,
    _skybox_index,
)
from clraytracer_tpu_torch.ops.trace import BIG, KernelTables, kernel_tables, trace_plain
from clraytracer_tpu_torch.scene import procedural_tex as ptex
from clraytracer_tpu_torch.scene.types import Scene

#: the TPU kernel selects material rows with a static loop, bounded here;
#: scenes with more materials take a path this package does not port yet
MAX_FUSED_MATERIALS = 64

#: screen-tile strip height limit (trace_pallas.MAX_ROWS)
MAX_ROWS = 64


def tile_rows(n_rays: int) -> int:
    """Strip height in rows of 128 pixels: MAX_ROWS for real frames, shrunk
    (multiple of 8) for small ones (trace_pallas._tile_rows)."""
    rows = -(-n_rays // 128)
    rows = -(-rows // 8) * 8
    return max(8, min(MAX_ROWS, rows))


def fused_path_available(scene: Scene) -> bool:
    """The scene has the tables the fused frame reads (render_pallas.py:909
    less the TPU's VMEM budget: the CUDA kernel reads global memory at any
    scene size). ``render._unsupported`` checks the options and materials."""
    return scene.packed is not None and scene.clusters is not None


@dataclasses.dataclass(frozen=True)
class FrameTables:
    """Per-scene shading tables of the fused frame, on the scene's device."""

    mat_rows: torch.Tensor  # [M, 16] f32
    tex: torch.Tensor  # [D, TEX_COLS] f32 procedural descriptors
    descs: tuple  # ((off_hi, off_lo, ProceduralTexture), ...)


def frame_tables(scene: Scene) -> FrameTables:
    """Built on first use and kept with the scene's ``packed`` object, so
    scenes that share it share the tables."""
    cached = scene.packed.__dict__.get("_frame_tables")
    if cached is not None:
        return cached
    descs = tuple(
        (off >> _OFF_SHIFT, off & ((1 << _OFF_SHIFT) - 1), desc)
        for _h, off, desc in scene.procedural_tex
    )
    dev = scene.packed.mat_rows.device
    rows = [ptex.descriptor_row(hi, lo, d) for hi, lo, d in descs]
    tex = torch.tensor(
        np.asarray(rows, np.float32).reshape(-1, ptex.TEX_COLS), device=dev
    )
    ft = FrameTables(
        mat_rows=scene.packed.mat_rows.float().contiguous(), tex=tex, descs=descs
    )
    scene.packed.__dict__["_frame_tables"] = ft
    return ft


def atm_table(bounces: int) -> np.ndarray:
    """Per-bounce atmospheric constants [bounces, 3]: the f32 chain
    ``[0.255, 0.25, 0.27] * 0.4^b`` by iterated f32 multiplies
    (render_pallas.py:304-310)."""
    atm = np.asarray([0.255, 0.25, 0.27], np.float32)
    out = []
    for _ in range(bounces):
        out.append(atm)
        atm = atm * np.float32(0.4)
    return np.stack(out).astype(np.float32)


@functools.lru_cache(maxsize=16)
def _atm_tensor(bounces: int, device: str) -> torch.Tensor:
    return torch.tensor(atm_table(bounces), device=device)


@dataclasses.dataclass(frozen=True)
class CameraRow:
    """The kernel's per-frame camera state (host floats): invProj (16) |
    invView (16) | position (3) | row0, plus the sun's (sin, cos)."""

    cam: tuple[float, ...]
    sun: tuple[float, float]


def camera_row(frame) -> CameraRow:
    cam = torch.cat(
        [
            torch.as_tensor(frame.inverse_projection, dtype=torch.float32).reshape(-1),
            torch.as_tensor(frame.inverse_view, dtype=torch.float32).reshape(-1),
            torch.as_tensor(frame.camera_position, dtype=torch.float32).reshape(-1),
            torch.zeros(1),
        ]
    ).cpu()
    angle = torch.as_tensor(frame.sun_angle, dtype=torch.float32).cpu()
    sun = torch.stack([torch.sin(angle), torch.cos(angle)])
    return CameraRow(cam=tuple(cam.tolist()), sun=tuple(sun.tolist()))


# ---------------------------------------------------------------------------
# plain version
# ---------------------------------------------------------------------------


def render_fused_plain(
    kt: KernelTables,
    ft: FrameTables,
    cr: CameraRow,
    width: int,
    height: int,
    trows: int,
    rows_total: int,
    bounces: int,
    device: torch.device,
) -> torch.Tensor:
    """The plain version of K2.2 → [9, rows_total*128] f32 (result rgb |
    miss energy rgb | miss dir xyz), op for op the kernel's expressions."""
    n = rows_total * 128
    cam = torch.tensor(cr.cam, dtype=torch.float32, device=device)
    px, py = tile_pixels(width, trows, rows_total, device, row0=cr.cam[35])
    d = unproject(
        cam[16:32].reshape(4, 4), cam[0:16].reshape(4, 4), px, py, width, height
    ).reshape(3, n)
    d = [d[0], d[1], d[2]]
    o = [cam[32 + c].expand(n) for c in range(3)]
    zero = torch.zeros(n, device=device)
    light = [zero, zero + cr.sun[0], zero + cr.sun[1]]
    result = [zero, zero, zero]
    energy = [zero + 1.0, zero + 1.0, zero + 1.0]
    men = [zero, zero, zero]
    mdir = [zero, zero, zero]
    alive = torch.ones(n, dtype=torch.bool, device=device)
    atm = atm_table(bounces)
    n_mat = ft.mat_rows.shape[0]
    for b in range(bounces):
        rays = torch.stack(o + d).contiguous()
        hs = trace_plain(kt, rays, None if b == 0 else alive.float())
        t = hs[0]
        binst = hs[4].view(torch.int32).long()
        n_obj = hs[5:8]
        uu, vv, matl = hs[8], hs[9], hs[10]
        hit = t < BIG
        live = alive & hit
        miss_now = alive & ~hit
        for c in range(3):
            men[c] = torch.where(miss_now, energy[c], men[c])
            mdir[c] = torch.where(miss_now, d[c], mdir[c])

        m = kt.inst[binst].T  # [17, n]
        nw = [n_obj[0] * m[c] + n_obj[1] * m[4 + c] + n_obj[2] * m[8 + c]
              for c in range(3)]
        mo = [o[0] * m[c] + o[1] * m[4 + c] + o[2] * m[8 + c] + m[12 + c]
              for c in range(3)]
        md = [d[0] * m[c] + d[1] * m[4 + c] + d[2] * m[8 + c] for c in range(3)]
        s = torch.sqrt(nw[0] * nw[0] + nw[1] * nw[1] + nw[2] * nw[2])
        nn = [nw[0] / s, nw[1] / s, nw[2] / s]

        # material row by index (mat id is an f32-exact integer)
        mat_idf = m[16] + matl
        in_range = (mat_idf >= 0.0) & (mat_idf < float(n_mat))
        mi = torch.where(in_range, mat_idf, zero).long()
        valid = in_range & (mi.float() == mat_idf)
        row = ft.mat_rows[mi].T  # [16, n]
        alb = [torch.where(valid, row[c], zero) for c in range(3)]
        ahi = torch.where(valid, row[10], zero)
        alo = torch.where(valid, row[11], zero)

        texel = [zero, zero, zero]
        for off_hi, off_lo, desc in ft.descs:
            uw = uu - torch.floor(uu)
            ui = torch.floor(uw * float(desc.width))
            vw = vv - torch.floor(vv)
            vi = torch.floor(vw * float(desc.height))
            rgb = ptex.eval_texel(desc, ui, vi)
            selt = (ahi == float(off_hi)) & (alo == float(off_lo))
            for c in range(3):
                texel[c] = torch.where(selt, rgb[c], texel[c])
        color = []
        for c in range(3):
            mat_b = torch.round(torch.clamp(alb[c], 0.0, 1.0) * 255.0)
            color.append(torch.floor(mat_b * texel[c] * (1.0 / 256.0)) * _U8)

        ndl_raw = nn[0] * (-light[0]) + nn[1] * (-light[1]) + nn[2] * (-light[2])
        amb_m = torch.clamp(-ndl_raw, min=0.1)
        ndl = torch.clamp(ndl_raw, min=0.0)
        spec_s = (0.5 * ndl) * ndl
        rl = [(-light[c]) - nn[c] * (2.0 * ndl_raw) for c in range(3)]
        rdm = torch.clamp(rl[0] * md[0] + rl[1] * md[1] + rl[2] * md[2], min=0.0)
        spec_light = (ndl * rdm) * 0.2
        ndd = nn[0] * d[0] + nn[1] * d[1] + nn[2] * d[2]
        dif = ndl
        for c in range(3):
            contrib = (
                (energy[c] * color[c]) * dif + (float(atm[b, c]) * color[c]) * amb_m
            ) + spec_light
            result[c] = torch.where(live, result[c] + contrib, result[c])
            energy[c] = torch.where(live, energy[c] * (0.2 * spec_s), energy[c])
            new_o = (mo[c] + md[c] * t) + nn[c] * 0.01
            new_d = d[c] - nn[c] * (2.0 * ndd)
            o[c] = torch.where(live, new_o, o[c])
            d[c] = torch.where(live, new_d, d[c])
            light[c] = torch.where(live, new_d, light[c])
        alive = live
    return torch.stack(result + men + mdir)


# ---------------------------------------------------------------------------
# kernel wrapper
# ---------------------------------------------------------------------------


def render_cuda(
    kt: KernelTables,
    ft: FrameTables,
    cr: CameraRow,
    width: int,
    height: int,
    trows: int,
    rows_total: int,
    bounces: int,
    counters: torch.Tensor | None = None,
) -> torch.Tensor:
    """Launch K2.2 (csrc/render.cu) → [9, rows_total*128] f32 on the
    tables' CUDA device. ``counters``: optional int64 [4] device tensor
    that receives the box tests, triangle tests, per-instance ray transforms
    and interpolated (shaded) hits the launch ran."""
    from clraytracer_tpu_torch.runtime import kernels

    dev = kt.planes.device
    if dev.type != "cuda":
        raise ValueError("render_cuda needs the scene on a CUDA device")
    if len(cr.cam) != 36:
        raise ValueError("camera row must hold 36 floats")
    lib = kernels.build_all()["render.cu"]
    n = rows_total * 128
    out = torch.empty((9, n), dtype=torch.float32, device=dev)
    atm = _atm_tensor(bounces, str(dev))
    params = kernels.RenderParamsC(
        (ctypes.c_float * 36)(*cr.cam), cr.sun[0], cr.sun[1],
        atm.data_ptr(), ft.mat_rows.data_ptr(), ft.tex.data_ptr(),
        ft.mat_rows.shape[0], ft.tex.shape[0],
        trows, -(-width // 128), width, height, n, bounces,
    )
    tables = kt.as_c()
    code = lib.clrt_render(
        ctypes.byref(tables), ctypes.byref(params), out.data_ptr(),
        kernels.ptr(counters), kernels.stream_handle(dev),
    )
    kernels.check(code, "clrt_render")
    render_cuda.launches += 1
    return out


render_cuda.launches = 0


def _finish_frame(scene: Scene, res, men, mdir) -> torch.Tensor:
    """Deferred sky add of atlas mode 0 (render_pallas.py:1084-1085): a
    ray's first miss ends it, so one ``sky(miss_dir) * miss_energy`` add
    reproduces the in-loop sum."""
    pk = scene.packed
    sky_idx = _skybox_index(pk.skybox_w, pk.skybox_h, pk.skybox_off, mdir)
    sky = _eval_skybox_inline(scene, sky_idx, pk.skybox_w, pk.skybox_off)
    return res + sky * men


def render_fused_camera(
    scene: Scene,
    frame,  # render.FrameInputs
    width: int,
    height: int,
    bounces: int,
) -> tuple[torch.Tensor, tuple[int, int, int]]:
    """Fused frame with in-kernel raygen → ([3, rows_total, 128] radiance in
    trows x 128 screen-strip order, (trows, tiles_x, tiles_y)). Callers
    check ``render._unsupported`` first."""
    trows = tile_rows(width * height)
    tiles_x = -(-width // 128)
    tiles_y = -(-height // trows)
    rows_total = tiles_y * tiles_x * trows
    kt = kernel_tables(scene)
    ft = frame_tables(scene)
    cr = camera_row(frame)
    dev = kt.planes.device
    if dev.type == "cuda":
        out = render_cuda(kt, ft, cr, width, height, trows, rows_total, bounces)
    else:
        out = render_fused_plain(
            kt, ft, cr, width, height, trows, rows_total, bounces, dev
        )
    out = out.reshape(9, rows_total, 128)
    img = _finish_frame(scene, out[0:3], out[3:6], out[6:9])
    return img, (trows, tiles_x, tiles_y)
