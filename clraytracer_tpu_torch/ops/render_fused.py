"""Fused forward frame: kernel K2.2 and its plain version.

* ``render_cuda`` launches the hand-written CUDA kernel (csrc/render.cu), a
  port of the TPU kernel ``clraytracer_tpu/ops/render_pallas.py``
  (``_make_render_kernel``) in camera mode with its options: atlas modes 0
  (every texture procedural), 1 and 2 (imported textures, deferred
  texels), sun shadows on bounce 0 and Monte-Carlo GI. Ray mode and the
  split-rebin carry are not ported.
* ``render_fused_plain`` is the plain PyTorch version: the same raygen,
  ``trace_plain`` per bounce (and for the shadow ray) and the same shading
  expressions. The tests use it, and ``render_fused_camera`` takes it only
  for a scene on the CPU.
* ``render_fused_camera`` is the frame entry (render_pallas.py:1204): one
  kernel launch, then ``_finish_frame``: the deferred sky add, and in the
  atlas modes the one combined texel gather of every bounce.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import numpy as np
import torch

from clraytracer_tpu_torch.camera import tile_pixels, unproject
from clraytracer_tpu_torch.ops import gather, rng
from clraytracer_tpu_torch.ops.shade import (
    _OFF_SHIFT,
    _U8,
    _all_procedural,
    _eval_skybox_inline,
    _skybox_index,
)
from clraytracer_tpu_torch.ops.trace import (
    BIG,
    KernelTables,
    check_counters,
    kernel_tables,
    trace_plain,
)
from clraytracer_tpu_torch.scene import procedural_tex as ptex
from clraytracer_tpu_torch.scene.types import Scene

#: the TPU kernel selects material rows with a static loop, bounded here:
#: imported-texture scenes with more materials take atlas mode 2, which
#: reads no material row in the kernel; all-procedural scenes with more
#: take a path this package does not port yet
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
    scene size). ``render._unsupported`` checks the options and materials.
    Every such scene takes the fused frame: the JAX package's
    ``fused_path_preferred`` exception for museum-class streamed atlas
    scenes is a TPU speed choice between two paths that agree to float
    precision, and is not copied."""
    return scene.packed is not None and scene.clusters is not None


def atlas_mode_of(scene: Scene) -> int:
    """The kernel's texture mode (render_pallas.py:1266-1268): 0 when every
    texture is procedural, else 1 (material row read in the kernel) for at
    most ``MAX_FUSED_MATERIALS`` materials and 2 (material id emitted) for
    more."""
    if _all_procedural(scene):
        return 0
    return 1 if scene.materials.count <= MAX_FUSED_MATERIALS else 2


def deferred_planes(mode: int, gi: bool) -> int:
    """Deferred planes per bounce of atlas mode ``mode`` (csrc/render.cu's
    header): 7 (mode 1) or 6 (mode 2), 3 more with GI; none in mode 0."""
    if mode == 0:
        return 0
    return (7 if mode == 1 else 6) + (3 if gi else 0)


def variant(mode: int, shadows: bool, gi: bool) -> str:
    """Name of a K2.2 instantiation, as ``render_cuda.variant_launches``
    counts them: "default", or its options joined by "+"."""
    parts = ([f"atlas{mode}"] if mode else []) + (["shadows"] if shadows else []) + (
        ["gi"] if gi else [])
    return "+".join(parts) or "default"


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


def _gi_sample(nn: list, state: torch.Tensor) -> tuple[list, torch.Tensor]:
    """The kernel's GI continuation (csrc/render.cu ``gi_sample``,
    render_pallas.py:565-604): the uniform hemisphere sample of the ray's
    stream (``rng.hemisphere_sample``, the kernel's expression order), the
    flip to the normal's side → (direction xyz, weight 2 |cos theta|)."""
    g, _ = rng.hemisphere_sample(state, torch.stack(nn))
    dot = g[0] * nn[0] + g[1] * nn[1] + g[2] * nn[2]
    flip = dot < 0.0
    return [torch.where(flip, -x, x) for x in g], 2.0 * dot.abs()


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
    *,
    atlas_mode: int = 0,
    shadows: bool = False,
    gi_seed: int | None = None,
) -> torch.Tensor:
    """The plain version of K2.2 → [9 + K*bounces, rows_total*128] f32
    (result rgb | miss energy rgb | miss dir xyz | K deferred planes per
    bounce, csrc/render.cu's layout), op for op the kernel's expressions."""
    n = rows_total * 128
    gi = gi_seed is not None
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
    deferred = []
    alive = torch.ones(n, dtype=torch.bool, device=device)
    atm = atm_table(bounces)
    seeds = rng.gi_seed_rows(gi_seed, bounces) if gi else None
    ray_index = torch.arange(n, device=device)
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
        new_o = [(mo[c] + md[c] * t) + nn[c] * 0.01 for c in range(3)]

        # sun shadow on bounce 0: the shadow ray from the next origin
        # toward the sun, traced for the shaded rays only
        shadow = None
        if shadows and b == 0:
            srays = torch.stack(new_o + [zero, zero - cr.sun[0], zero - cr.sun[1]])
            occ = trace_plain(kt, srays.contiguous(), live.float())[0] < BIG
            shadow = torch.where(live & occ, zero, zero + 1.0)

        # material row by index (mat id is an f32-exact integer)
        mat_idf = m[16] + matl
        in_range = (mat_idf >= 0.0) & (mat_idf < float(n_mat))
        mi = torch.where(in_range, mat_idf, zero).long()
        valid = in_range & (mi.float() == mat_idf)
        row = ft.mat_rows[mi].T  # [16, n]
        col = lambda k: torch.where(valid, row[k], zero)
        alb = [col(0), col(1), col(2)]
        ahi, alo = col(10), col(11)

        color = None
        if atlas_mode == 0:
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
        spec_s = (0.5 * ndl) * ndl if shadow is None else ((0.5 * ndl) * shadow) * ndl
        rl = [(-light[c]) - nn[c] * (2.0 * ndl_raw) for c in range(3)]
        rdm = torch.clamp(rl[0] * md[0] + rl[1] * md[1] + rl[2] * md[2], min=0.0)
        spec_light = (ndl * rdm) * 0.2
        if shadow is not None:
            spec_light = spec_light * shadow
        ndd = nn[0] * d[0] + nn[1] * d[1] + nn[2] * d[2]
        dif = ndl if shadow is None else ndl * shadow
        if gi:
            gdir, gi_weight = _gi_sample(nn, rng.ray_streams(ray_index, seeds[b]))

        if atlas_mode:
            if gi:
                coefs = [energy[c] * dif for c in range(3)] + [
                    float(atm[b, c]) * amb_m for c in range(3)]
            else:
                coefs = [energy[c] * dif + float(atm[b, c]) * amb_m for c in range(3)]
            if atlas_mode == 1:
                # shade._pool_index's op sequence, in i32
                i32 = lambda x: x.to(torch.int32)
                aw, ah = col(8), col(9)
                ui = i32((uu - torch.floor(uu)) * aw)
                vi = i32((vv - torch.floor(vv)) * ah)
                off_i = i32(ahi) * (1 << _OFF_SHIFT) + i32(alo)
                sentinel = torch.where(miss_now, -1, 0).to(torch.int32)
                idx = torch.where(live, vi * i32(aw) + ui + off_i, sentinel)
                head = [idx.view(torch.float32)] + [
                    torch.round(torch.clamp(alb[c], 0.0, 1.0) * 255.0) for c in range(3)]
            else:
                head = [torch.where(miss_now, zero - 1.0, zero - 2.0), uu, vv]
                head[0] = torch.where(live, mat_idf, head[0])
            planes = head + coefs
            for k in range(1, len(planes)):
                planes[k] = torch.where(live, planes[k], zero)
            deferred += planes

        for c in range(3):
            if atlas_mode:
                contrib = spec_light
            else:
                contrib = (
                    (energy[c] * color[c]) * dif + (float(atm[b, c]) * color[c]) * amb_m
                ) + spec_light
            result[c] = torch.where(live, result[c] + contrib, result[c])
            if gi:
                carry = gi_weight if atlas_mode else color[c] * gi_weight
            else:
                carry = 0.2 * spec_s
            energy[c] = torch.where(live, energy[c] * carry, energy[c])
            new_d = gdir[c] if gi else d[c] - nn[c] * (2.0 * ndd)
            o[c] = torch.where(live, new_o[c], o[c])
            d[c] = torch.where(live, new_d, d[c])
            light[c] = torch.where(live, new_d, light[c])
        alive = live
    return torch.stack(result + men + mdir + deferred)


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
    *,
    atlas_mode: int = 0,
    shadows: bool = False,
    gi_seed: int | None = None,
    shadow_counters: torch.Tensor | None = None,
) -> torch.Tensor:
    """Launch K2.2 (csrc/render.cu) → [9 + K*bounces, rows_total*128] f32
    on the tables' CUDA device (K = ``deferred_planes(atlas_mode, gi)``).
    ``gi_seed`` None turns GI off; the seed is a launch parameter, so every
    seed runs the same compiled instantiation. ``counters``: optional int64
    [6] device tensor the launch adds its work to, in
    ``ops.trace.COUNTER_NAMES`` order (its hits are the shaded hits; the
    shadow walk adds its boxes, triangles and transforms).
    ``shadow_counters``: optional int64 [6] device tensor that only the
    shadow walk adds to (needs ``shadows``), so that its share of
    ``counters`` can be read apart."""
    from clraytracer_tpu_torch.runtime import kernels

    dev = kt.planes.device
    if shadow_counters is not None and not shadows:
        raise ValueError("shadow_counters count the shadow walk: pass shadows=True")
    check_counters(counters, dev)
    check_counters(shadow_counters, dev)
    if dev.type != "cuda":
        raise ValueError("render_cuda needs the scene on a CUDA device")
    if len(cr.cam) != 36:
        raise ValueError("camera row must hold 36 floats")
    if atlas_mode not in (0, 1, 2):
        raise ValueError(f"atlas_mode must be 0, 1 or 2, not {atlas_mode}")
    lib = kernels.build_all()["render.cu"]
    n = rows_total * 128
    gi = gi_seed is not None
    out = torch.empty(
        (9 + deferred_planes(atlas_mode, gi) * bounces, n),
        dtype=torch.float32, device=dev,
    )
    atm = _atm_tensor(bounces, str(dev))
    params = kernels.RenderParamsC(
        (ctypes.c_float * 36)(*cr.cam), cr.sun[0], cr.sun[1],
        atm.data_ptr(), ft.mat_rows.data_ptr(), ft.tex.data_ptr(),
        ft.mat_rows.shape[0], ft.tex.shape[0],
        trows, -(-width // 128), width, height, n, bounces,
        atlas_mode, int(shadows), int(gi),
        rng.gi_seed_rows(gi_seed, 1)[0] if gi else 0,
    )
    tables = kt.as_c()
    code = lib.clrt_render(
        ctypes.byref(tables), ctypes.byref(params), out.data_ptr(),
        kernels.ptr(counters), kernels.ptr(shadow_counters), kernels.stream_handle(dev),
    )
    kernels.check(code, "clrt_render")
    render_cuda.launches += 1
    name = variant(atlas_mode, shadows, gi)
    render_cuda.variant_launches[name] = render_cuda.variant_launches.get(name, 0) + 1
    return out


render_cuda.launches = 0
#: launches per instantiation (``variant``'s names)
render_cuda.variant_launches = {}


def _finish_frame(
    scene: Scene, out: torch.Tensor, atlas_mode: int = 0, gi: bool = False
) -> torch.Tensor:
    """The XLA tail of the fused frame (render_pallas.py:936-1085) on the
    kernel's [9 + K*B, rows, 128] output → [3, rows, 128] radiance.

    Atlas mode 0: the deferred sky add; a ray's first miss ends it, so one
    ``sky(miss_dir) * miss_energy`` add reproduces the in-loop sum. Atlas
    modes: one combined texel gather serves every bounce and the sky (lanes
    that missed at a bounce substitute their skybox index), then the
    integer modulate ``floor(mat_b * round(texel*255) / 256) / 255``, the
    coefficient sum and, with GI, the running colour product. Mode 2 reads
    the material rows here, by direct index; the JAX package's one-hot
    gather is a TPU device choice and is not copied."""
    pk = scene.packed
    res, men, mdir = out[0:3], out[3:6], out[6:9]
    sky_idx = _skybox_index(pk.skybox_w, pk.skybox_h, pk.skybox_off, mdir)
    if atlas_mode == 0:
        sky = _eval_skybox_inline(scene, sky_idx, pk.skybox_w, pk.skybox_off)
        return res + sky * men
    k = deferred_planes(atlas_mode, gi)
    bounces = (out.shape[0] - 9) // k
    blocks = out[9:].reshape((bounces, k) + tuple(out.shape[1:]))
    if atlas_mode == 1:
        tex_idx = blocks[:, 0].view(torch.int32)  # [B, rows, 128]
        miss_all = tex_idx < 0
        hit_all = tex_idx >= 0  # dead lanes carry 0 and zero coefficients
        mats = blocks[:, 1:4]  # [B, 3, rows, 128]
        coefs, coefs_a = blocks[:, 4:7], blocks[:, 7:10]
    else:
        mid = blocks[:, 0]
        n_mat = pk.mat_rows.shape[0]
        # material rows by direct index; -1 (miss) / -2 (dead) and ids out
        # of range read zeros, which their zero coefficients discard
        cols = pk.mat_rows[:, [0, 1, 2, 8, 9, 10, 11]].float()
        mat = gather.take_rows(cols, mid.long())  # [7, B, rows, 128]
        mat = torch.where((mid >= 0.0) & (mid < float(n_mat)), mat, 0.0)
        i32 = lambda x: x.to(torch.int32)
        aw, ah = mat[3], mat[4]
        off_i = i32(mat[5]) * (1 << _OFF_SHIFT) + i32(mat[6])
        uu, vv = blocks[:, 1], blocks[:, 2]
        ui = i32((uu - torch.floor(uu)) * aw)
        vi = i32((vv - torch.floor(vv)) * ah)
        miss_all = mid == -1.0
        hit_all = mid >= 0.0
        tex_idx = torch.where(hit_all, vi * i32(aw) + ui + off_i, 0).to(torch.int32)
        mats = torch.round(torch.clamp(mat[0:3], 0.0, 1.0) * 255.0).movedim(0, 1)
        coefs, coefs_a = blocks[:, 3:6], blocks[:, 6:9]
    idx_all = torch.where(miss_all, sky_idx[None], tex_idx)  # [B, rows, 128]
    if pk.texels_u32 is not None:
        # flat packed-RGB8 gather + byte unpack: texel = byte * (1/255) is
        # the pool's own construction, so values equal the row gather's
        word = pk.texels_u32[idx_all.long().clamp(0, pk.texels_u32.shape[0] - 1)]
        tex_all = torch.stack(
            [((word >> s) & 0xFF).to(torch.float32) * _U8 for s in (0, 8, 16)]
        )
    else:
        tex_all = gather.take_rgb(scene.atlas.texels, idx_all)  # [3, B, rows, 128]
    tex_b = torch.round(tex_all * 255.0)
    colors = [
        torch.floor(mats[b] * tex_b[:, b] * (1.0 / 256.0)) * _U8 for b in range(bounces)
    ]
    sky = torch.zeros_like(res)
    if gi:
        # the GI throughput is texel-dependent: the kernel's energy carried
        # only the 2 cos(theta) weights, the running colour product P
        # multiplies the E*dif coefficients and the sky a lane saw
        prod = torch.ones_like(res)
        for b in range(bounces):
            res = res + coefs[b] * colors[b] * prod + coefs_a[b] * colors[b]
            sky = torch.where(miss_all[b][None], sky + tex_all[:, b] * prod, sky)
            prod = torch.where(hit_all[b][None], prod * colors[b], prod)
    else:
        for b in range(bounces):
            res = res + coefs[b] * colors[b]
            sky = torch.where(miss_all[b][None], sky + tex_all[:, b], sky)
    return res + sky * men


def render_fused_camera(
    scene: Scene,
    frame,  # render.FrameInputs
    width: int,
    height: int,
    bounces: int,
    enable_shadows: bool = False,
    gi_seed: int | None = None,
) -> tuple[torch.Tensor, tuple[int, int, int]]:
    """Fused frame with in-kernel raygen → ([3, rows_total, 128] radiance in
    trows x 128 screen-strip order, (trows, tiles_x, tiles_y)): one kernel
    launch, then ``_finish_frame``. ``gi_seed`` None turns GI off. Callers
    check ``render._unsupported`` first."""
    trows = tile_rows(width * height)
    tiles_x = -(-width // 128)
    tiles_y = -(-height // trows)
    rows_total = tiles_y * tiles_x * trows
    kt = kernel_tables(scene)
    ft = frame_tables(scene)
    cr = camera_row(frame)
    dev = kt.planes.device
    mode = atlas_mode_of(scene)
    opts = dict(atlas_mode=mode, shadows=enable_shadows, gi_seed=gi_seed)
    if dev.type == "cuda":
        out = render_cuda(kt, ft, cr, width, height, trows, rows_total, bounces, **opts)
    else:
        out = render_fused_plain(
            kt, ft, cr, width, height, trows, rows_total, bounces, dev, **opts
        )
    out = out.reshape(-1, rows_total, 128)
    img = _finish_frame(scene, out, mode, gi_seed is not None)
    return img, (trows, tiles_x, tiles_y)
