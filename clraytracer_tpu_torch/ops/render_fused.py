"""Fused forward frame: kernel K2.2 and its plain version.

* ``render_cuda`` launches the hand-written CUDA kernel (csrc/render.cu), a
  port of the TPU kernel ``clraytracer_tpu/ops/render_pallas.py``
  (``_make_render_kernel``) with its options: atlas modes 0 (every
  texture procedural), 1 and 2 (imported textures, deferred texels), sun
  shadows on bounce 0, Monte-Carlo GI, its two ray sources: camera
  mode (in-kernel raygen) and ray mode (given rays), and the split-rebin
  carry (``carry_out`` / ``carry`` and ``start_bounce``).
* ``render_fused_plain`` is the plain PyTorch version: the same raygen (or
  the given rays), ``trace_plain`` per bounce (and for the shadow ray)
  and the same shading expressions. The tests use it, and the frame
  entries take it only for a scene on the CPU.
* ``render_fused_camera`` (render_pallas.py:1204) and ``render_fused``
  (render_pallas.py:1115, ray mode) are the frame entries: one kernel
  launch, then the frame finish: the deferred sky add, and in the atlas
  modes the one combined texel gather of every bounce; on request (the
  camera entry's ``post``) the post chain and the untiling too. On the
  card the finish is one launch of ``finish_cuda`` (csrc/render.cu
  ``clrt_finish``); its plain version is the torch tail, ``_finish_frame``,
  then ``post_image``, which the CPU runs. With
  ``split_rebin`` the camera entry makes two: bounce 0 in camera mode with
  the continuation of the live rays and a per-ray ``rebin_key`` carried
  out, one stable sort of the keys (``sort_keys``), the remaining bounces
  in ray mode over the live rays in key order, resumed from the carried
  state and written back in place.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import threading

import numpy as np
import torch

from clraytracer_tpu_torch.camera import tile_pixels, unproject
from clraytracer_tpu_torch.ops import gather, rng
from clraytracer_tpu_torch.ops.post import post_process_tiled
from clraytracer_tpu_torch.ops.shade import (
    _OFF_SHIFT,
    _U8,
    _all_procedural,
    _eval_skybox_inline,
    _skybox_index,
)
from clraytracer_tpu_torch.ops.trace import (
    BIG,
    FrameTables,
    KernelTables,
    check_counters,
    frame_tables,
    kept_tables,
    kernel_tables,
    trace_plain,
)
from clraytracer_tpu_torch.scene import procedural_tex as ptex
from clraytracer_tpu_torch.scene.types import Scene
from clraytracer_tpu_torch.utils.timer import ScopeTimer

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


def untile(result: torch.Tensor, layout: tuple, height: int, width: int) -> torch.Tensor:
    """[3, rows, 128] screen-tile order (``layout`` = ("strip", trows,
    tiles_x, tiles_y)) → [3, H, W] planar image."""
    _kind, rows, nx, ny = layout
    return (
        result.reshape(3, ny, nx, rows, 128)
        .permute(0, 1, 3, 2, 4)
        .reshape(3, ny * rows, nx * 128)[:, :height, :width]
    )


def post_image(radiance: torch.Tensor, width: int, height: int, layout: tuple) -> torch.Tensor:
    """The post chain on the tile layout, then one relayout → the finished
    [H, W, 3] frame (a permuted view): the plain version of
    ``finish_cuda``'s ``image``."""
    with ScopeTimer("render.post", log=False):
        p = post_process_tiled(radiance, width, height, layout)
    with ScopeTimer("render.untile", log=False):
        return untile(p, layout, height, width).permute(1, 2, 0)


def fused_path_available(scene: Scene, reference_parity: bool,
                         integer_colors: bool) -> bool:
    """Does the fused kernel cover this scene and shading
    (render_pallas.py:909)? Reference-parity integer-colour shading, the
    cluster and packed tables, and at most ``MAX_FUSED_MATERIALS``
    materials when every texture is procedural (the atlas modes read any
    number). The TPU's VMEM budget is not a condition here: the CUDA
    kernel reads global memory at any scene size. Refraction is the
    caller's condition (render.py)."""
    return (
        reference_parity
        and integer_colors
        and scene.packed is not None
        and scene.clusters is not None
        and (scene.materials.count <= MAX_FUSED_MATERIALS or not _all_procedural(scene))
    )


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


def variant(mode: int, shadows: bool, gi: bool, rays: bool = False,
            carry: str | None = None) -> str:
    """Name of a K2.2 instantiation, as ``render_cuda.variant_launches``
    counts them: "default", or its options joined by "+" ("rays" first in
    ray mode, then "carry_out" or "carry_in" for ``carry`` "out" or
    "in")."""
    parts = (["rays"] if rays else []) + ([f"carry_{carry}"] if carry else []) + (
        [f"atlas{mode}"] if mode else []) + (["shadows"] if shadows else []) + (
        ["gi"] if gi else [])
    return "+".join(parts) or "default"


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


def _sun(sun_angle) -> tuple[float, float]:
    """(sin, cos) of the sun angle in f32, computed on the host."""
    angle = torch.as_tensor(sun_angle, dtype=torch.float32).cpu()
    return tuple(torch.stack([torch.sin(angle), torch.cos(angle)]).tolist())


@functools.lru_cache(maxsize=16)
def sun_row(sun_angle: float) -> tuple[float, float]:
    """``_sun`` of a host angle, kept per angle."""
    return _sun(sun_angle)


def ray_row(sun_angle) -> CameraRow:
    """The per-frame state of ray mode: the sun alone (the camera part is
    not read when the rays are given)."""
    return CameraRow(cam=(0.0,) * 36, sun=_sun(sun_angle))


def camera_row(frame, row0=None) -> CameraRow:
    """The camera row of ``frame``; ``row0``: the first global pixel row of
    a row window (cam[35], 0 for a whole frame; render_pallas.py:1270-1280)."""
    cam = torch.cat(
        [
            torch.as_tensor(x, dtype=torch.float32).reshape(-1).cpu()
            for x in (frame.inverse_projection, frame.inverse_view,
                      frame.camera_position, 0.0 if row0 is None else row0)
        ]
    )
    return CameraRow(cam=tuple(cam.tolist()), sun=_sun(frame.sun_angle))


def check_rays(rays: torch.Tensor, rows_total: int) -> int:
    """Ray mode's input: a contiguous [6, n] f32 tensor (origin xyz |
    direction xyz planes, ray i = row i // 128, lane i % 128) of
    ``rows_total`` rows of 128 rays, the last maybe ragged. Returns n."""
    if rays.dtype != torch.float32 or rays.dim() != 2 or rays.shape[0] != 6 or (
            not rays.is_contiguous()):
        raise ValueError("rays must be a contiguous [6, n] f32 tensor")
    n = rays.shape[1]
    if n == 0 or -(-n // 128) != rows_total:
        raise ValueError(f"{n} rays do not fill {rows_total} rows of 128")
    return n


#: the carry-out launch's planes, [19, n] (csrc/render.cu's header): the
#: frame's 9 (result rgb | miss energy rgb | miss dir xyz), the
#: continuation o xyz | d xyz | energy rgb of the rays still alive (a dead
#: ray's are not written) and, last, every ray's i32 sort key in the
#: launch's thread order (``thread_rays``)
CARRY_PLANES = 19
#: the sort key of a ray that is dead after bounce 0: it sorts last
#: (render_pallas.py:1347)
KEY_DEAD = 0x7FFFFFFF


def thread_rays(n: int, device) -> torch.Tensor:
    """The strip index of each of a launch's n threads, [n] int64
    (csrc/render.cu ``strip_ray``): thread t of block t // 128 is lane
    t % 32 of warp (t % 128) // 32, and block b takes strip rows 4 (b // 4)
    .. + 3, columns 32 (b % 4) .. + 31, its warp w one 8 x 4 tile of them
    at columns + 8 w .. + 8 w + 7. A bijection of range(n) when n is a
    multiple of 512."""
    t = torch.arange(n, device=device)
    b, warp, wl = t >> 7, (t & 127) >> 5, t & 31
    return ((b >> 2) * 4 + (wl >> 3)) * 128 + (b & 3) * 32 + warp * 8 + (wl & 7)


def keys_by_ray(first: torch.Tensor) -> torch.Tensor:
    """The carry-out buffer's key plane (its last, in thread order) in ray
    order, [n] i32."""
    n = first.shape[1]
    key = torch.empty(n, dtype=torch.int32, device=first.device)
    key[thread_rays(n, first.device)] = first[CARRY_PLANES - 1].view(torch.int32)
    return key


def sorted_rays(keys: torch.Tensor, order: torch.Tensor) -> torch.Tensor:
    """The strip index of the ray of each live sorted key (``sort_keys``'
    keys and order), in key order: the rays a carry-in walks."""
    return thread_rays(keys.numel(), keys.device)[order[keys != KEY_DEAD]]


def check_carry(n: int, atlas_mode: int, gi: bool, rays, carry_out: bool, carry,
                start_bounce: int, keys=None, order=None) -> None:
    """The carry's arguments (render_pallas.py:121-123): ``carry_out`` in
    camera mode at bounce 0; ``carry``, the carry-out's [19, n] buffer, with
    its sorted ``keys`` [n] i32 and their ``order`` [n] int64
    (``sort_keys``), at global bounce ``start_bounce`` >= 1, its rays the
    carry's own planes (no ``rays``); both in atlas mode 0 without GI (the
    split's gate, render_pallas.py:1290-1291, and the kernel's
    instantiations) over n a multiple of 512 (whole blocks, so that the key
    plane's thread order covers every ray)."""
    if not (carry_out or carry is not None or start_bounce or keys is not None
            or order is not None):
        return
    if atlas_mode != 0 or gi:
        raise ValueError("the carry takes atlas mode 0 without GI")
    if n % 512:
        raise ValueError(f"the carry takes whole blocks of 512 rays, not {n}")
    if carry is None:
        if start_bounce != 0 or rays is not None or keys is not None or order is not None:
            raise ValueError("carry_out is camera mode from bounce 0; start_bounce, "
                             "keys and order need a carry")
        return
    if carry_out or rays is not None or start_bounce < 1:
        raise ValueError("a carry resumes from its own rays at start_bounce >= 1")
    if carry.dtype != torch.float32 or tuple(carry.shape) != (CARRY_PLANES, n) or (
            not carry.is_contiguous()):
        raise ValueError(f"carry must be a contiguous [{CARRY_PLANES}, {n}] f32 tensor")
    for t, dtype, name in ((keys, torch.int32, "keys"), (order, torch.int64, "order")):
        if t is None or t.dtype != dtype or tuple(t.shape) != (n,) or (
                not t.is_contiguous()) or t.device != carry.device:
            raise ValueError(f"{name} must be a contiguous [{n}] {dtype} tensor "
                             "beside the carry")


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
    rays: torch.Tensor | None = None,
    carry_out: bool = False,
    carry: torch.Tensor | None = None,
    start_bounce: int = 0,
    keys: torch.Tensor | None = None,
    order: torch.Tensor | None = None,
) -> torch.Tensor:
    """The plain version of K2.2 → [9 + K*bounces, n] f32 (result rgb |
    miss energy rgb | miss dir xyz | K deferred planes per bounce,
    csrc/render.cu's layout), op for op the kernel's expressions. Camera
    mode: n = rows_total*128 rays of the camera row's raygen. Ray mode
    (``rays`` [6, n], ``check_rays``): the given rays; of ``cr`` only the
    sun is read. ``carry_out`` appends the live rays' continuation and the
    key plane (``CARRY_PLANES``: [19, n]; a dead ray's continuation is
    zero here). ``carry`` (the carry-out's [19, n], with ``keys`` and
    ``order``, ``check_carry``) resumes the live rays, in sorted order, at
    global bounce ``start_bounce`` and writes their 9 planes back into
    ``carry`` in place → ``carry[:9]``."""
    gi = gi_seed is not None
    n = rows_total * 128 if rays is None else check_rays(rays, rows_total)
    check_carry(n, atlas_mode, gi, rays, carry_out, carry, start_bounce, keys, order)
    ray_index = torch.arange(n, device=device)  # the rays walked, by strip index
    if carry is not None:
        # the live carried rays in key order
        ray_index = sorted_rays(keys, order)
        o = [carry[9 + c, ray_index] for c in range(3)]
        d = [carry[12 + c, ray_index] for c in range(3)]
    elif rays is None:
        cam = torch.tensor(cr.cam, dtype=torch.float32, device=device)
        px, py = tile_pixels(width, trows, rows_total, device, row0=cr.cam[35])
        d = unproject(
            cam[16:32].reshape(4, 4), cam[0:16].reshape(4, 4), px, py, width, height
        ).reshape(3, n)
        d = [d[0], d[1], d[2]]
        o = [cam[32 + c].expand(n) for c in range(3)]
    else:
        o = [rays[c] for c in range(3)]
        d = [rays[3 + c] for c in range(3)]
    walked = ray_index.numel()
    zero = torch.zeros(walked, device=device)
    if carry is None:
        light = [zero, zero + cr.sun[0], zero + cr.sun[1]]
        result = [zero, zero, zero]
        energy = [zero + 1.0, zero + 1.0, zero + 1.0]
    else:
        # a live ray left bounce 0 with light == direction and no miss yet
        light = list(d)
        result = [carry[c, ray_index] for c in range(3)]
        energy = [carry[15 + c, ray_index] for c in range(3)]
    men = [zero, zero, zero]
    mdir = [zero, zero, zero]
    alive = torch.ones(walked, dtype=torch.bool, device=device)
    deferred = []
    # the global bounce's atmospheric constants: the chain's iterated f32
    # multiplies from bounce 0 (render_pallas.py:304-310)
    atm = atm_table(start_bounce + bounces)[start_bounce:]
    seeds = rng.gi_seed_rows(gi_seed, bounces) if gi else None
    n_mat = ft.mat_rows.shape[0]
    for b in range(bounces if walked else 0):
        gb = b + start_bounce  # the global bounce
        hs = trace_plain(kt, torch.stack(o + d).contiguous(),
                         None if gb == 0 else alive.float())
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
        if shadows and gb == 0:
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
                gain = gi_weight if atlas_mode else color[c] * gi_weight
            else:
                gain = 0.2 * spec_s
            energy[c] = torch.where(live, energy[c] * gain, energy[c])
            new_d = gdir[c] if gi else d[c] - nn[c] * (2.0 * ndd)
            o[c] = torch.where(live, new_o[c], o[c])
            d[c] = torch.where(live, new_d, d[c])
            light[c] = torch.where(live, new_d, light[c])
        alive = live
    planes = result + men + mdir + deferred
    if carry is not None:
        carry[:9, ray_index] = torch.stack(planes)
        return carry[:9]
    if carry_out:
        planes += [torch.where(alive, x, zero) for x in o + d + energy]
        planes.append(ray_keys(o, d, alive)[thread_rays(n, device)].view(torch.float32))
    return torch.stack(planes)


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
    rays: torch.Tensor | None = None,
    carry_out: bool = False,
    carry: torch.Tensor | None = None,
    start_bounce: int = 0,
    keys: torch.Tensor | None = None,
    order: torch.Tensor | None = None,
) -> torch.Tensor:
    """Launch K2.2 (csrc/render.cu) → [9 + K*bounces, n] f32 on the
    tables' CUDA device (K = ``deferred_planes(atlas_mode, gi)``). Camera
    mode: n = rows_total*128 rays of the in-kernel raygen. Ray mode
    (``rays`` [6, n] on the device, ``check_rays``): the given rays, and
    of ``cr`` only the sun is read. ``carry_out``, ``carry``, ``keys``,
    ``order`` and ``start_bounce`` as ``render_fused_plain``'s: the
    carry-out launch ([19, n]; a dead ray's continuation planes are left
    unwritten) and the carry-in launch, in ray mode over the carry's own
    planes, in place (→ ``carry[:9]``), which has no shadow walk (shadows
    are gated to global bounce 0), so ``shadows`` is dropped there.
    ``gi_seed`` None turns GI off; the seed is a launch parameter, so every
    seed runs the same compiled instantiation. ``counters``: optional int64
    [6] device tensor the launch adds its work to, in
    ``ops.trace.COUNTER_NAMES`` order (its hits are the shaded hits; the
    shadow walk adds its boxes, triangles and transforms).
    ``shadow_counters``: optional int64 [6] device tensor that only the
    shadow walk adds to (needs ``shadows``), so that its share of
    ``counters`` can be read apart."""
    from clraytracer_tpu_torch.runtime import kernels

    params, shape, name = _render_params(
        kt, ft, cr, width, height, trows, rows_total, bounces, counters,
        atlas_mode=atlas_mode, shadows=shadows, gi_seed=gi_seed,
        shadow_counters=shadow_counters, rays=rays, carry_out=carry_out, carry=carry,
        start_bounce=start_bounce, keys=keys, order=order,
    )
    dev = kt.planes.device
    # a carry-in launch writes into the carry, its rays its planes 9..14
    out = carry if shape is None else torch.empty(shape, dtype=torch.float32, device=dev)
    lib = kernels.build_all()["render.cu"]
    tables = kt.as_c()
    code = lib.clrt_render(
        ctypes.byref(tables), ctypes.byref(params), out.data_ptr(),
        kernels.ptr(counters), kernels.ptr(shadow_counters), kernels.stream_handle(dev),
    )
    kernels.check(code, "clrt_render")
    render_cuda.launches += 1
    render_cuda.variant_launches[name] = render_cuda.variant_launches.get(name, 0) + 1
    return out if carry is None else out[:9]


def _render_params(
    kt: KernelTables, ft: FrameTables, cr: CameraRow, width: int, height: int, trows: int,
    rows_total: int, bounces: int, counters: torch.Tensor | None, *, atlas_mode: int,
    shadows: bool, gi_seed: int | None, shadow_counters: torch.Tensor | None,
    rays: torch.Tensor | None, carry_out: bool, carry: torch.Tensor | None,
    start_bounce: int, keys: torch.Tensor | None, order: torch.Tensor | None,
) -> tuple:
    """``render_cuda``'s checks and launch parameters → (its
    ``RenderParamsC``, the shape of the planes it writes, None for a
    carry-in launch, which writes into the carry, and its instantiation's
    ``variant`` name)."""
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
    n = rows_total * 128
    if rays is not None:
        n = check_rays(rays, rows_total)
        if rays.device != dev:
            raise ValueError("rays must lie on the tables' device")
    gi = gi_seed is not None
    check_carry(n, atlas_mode, gi, rays, carry_out, carry, start_bounce, keys, order)
    if carry is not None:
        if carry.device != dev:
            raise ValueError("the carry must lie on the tables' device")
        if shadow_counters is not None:
            raise ValueError("a carry-in launch walks no shadow ray")
        shadows = False
        shape = None
        rays_ptr = carry[9].data_ptr()
    else:
        shape = (9 + deferred_planes(atlas_mode, gi) * bounces
                 + (CARRY_PLANES - 9 if carry_out else 0), n)
        rays_ptr = kernels.ptr(rays)
    # the kernel indexes the constants by its own bounce: start at the
    # global bounce's
    atm = _atm_tensor(start_bounce + bounces, str(dev))[start_bounce:]
    params = kernels.RenderParamsC(
        (ctypes.c_float * 36)(*cr.cam), cr.sun[0], cr.sun[1],
        atm.data_ptr(), ft.mat_rows.data_ptr(), ft.tex.data_ptr(),
        ft.mat_rows.shape[0], ft.tex.shape[0],
        trows, -(-width // 128), width, height, n, bounces,
        atlas_mode, int(shadows), int(gi),
        rng.gi_seed_rows(gi_seed, 1)[0] if gi else 0, rays_ptr,
        kernels.ptr(carry), start_bounce, int(carry_out), kernels.ptr(keys),
        kernels.ptr(order),
    )
    name = variant(atlas_mode, shadows, gi, rays is not None or carry is not None,
                   "in" if carry is not None else "out" if carry_out else None)
    return params, shape, name


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


def finish_variant(mode: int, gi: bool, post: bool) -> str:
    """Name of a finish instantiation, as ``finish_cuda.variant_launches``
    counts them: "default", or "atlas<mode>", "gi" and "post" joined by "+"
    (atlas mode 0 reads no deferred plane and has no "gi")."""
    parts = ([f"atlas{mode}"] if mode else []) + (["gi"] if gi and mode else []) + (
        ["post"] if post else [])
    return "+".join(parts) or "default"


def finish_cuda(
    scene: Scene,
    ft: FrameTables,
    out: torch.Tensor,
    atlas_mode: int = 0,
    gi: bool = False,
    image: tuple | None = None,
) -> torch.Tensor:
    """Launch the frame finish (csrc/render.cu ``clrt_finish``) on K2.2's
    output ``out`` ([9 + K*B, rows, 128] f32, contiguous, on the tables'
    CUDA device; K = ``deferred_planes(atlas_mode, gi)``) → [3, rows, 128]
    radiance in strip order, as ``_finish_frame`` returns it; with
    ``image`` = (width, height, layout), layout ("strip", trows, tiles_x,
    tiles_y) the strip layout of ``out``, the finished [H, W, 3] frame
    (contiguous), as ``post_image`` returns it. The texels come from the
    packed-RGB8 words where the scene has them, else from the f32 pool; on
    the same planes the result equals the torch tail's bit for bit."""
    from clraytracer_tpu_torch.runtime import kernels

    dev = ft.mat_rows.device
    if dev.type != "cuda":
        raise ValueError("finish_cuda needs the scene on a CUDA device")
    if out.dtype != torch.float32 or not out.is_contiguous() or out.device != dev:
        raise ValueError("out must be a contiguous f32 tensor on the tables' device")
    params, shape, name, _pool = _finish_params(scene, ft, tuple(out.shape), atlas_mode, gi,
                                                image)
    params.planes = out.data_ptr()
    res = torch.empty(shape, dtype=torch.float32, device=dev)
    lib = kernels.build_all()["render.cu"]
    code = lib.clrt_finish(ctypes.byref(params), res.data_ptr(), kernels.stream_handle(dev))
    kernels.check(code, "clrt_finish")
    finish_cuda.launches += 1
    finish_cuda.variant_launches[name] = finish_cuda.variant_launches.get(name, 0) + 1
    return res


def _finish_params(scene: Scene, ft: FrameTables, planes: tuple, atlas_mode: int, gi: bool,
                   image: tuple | None) -> tuple:
    """``finish_cuda``'s checks and launch parameters for K2.2's planes of
    shape ``planes`` on the card → (its ``FinishParamsC``, whose planes
    pointer the launch fills in, the shape of what it writes, its
    instantiation's ``finish_variant`` name, and the f32 texel pool it
    points into, or None)."""
    from clraytracer_tpu_torch.runtime import kernels

    if atlas_mode not in (0, 1, 2):
        raise ValueError(f"atlas_mode must be 0, 1 or 2, not {atlas_mode}")
    k = deferred_planes(atlas_mode, gi)
    n = 1
    for d in planes[1:]:
        n *= d
    if planes[0] < 9 or (k and (planes[0] - 9) % k) or n == 0:
        raise ValueError(f"out must hold 9 + {k} * bounces planes of rays")
    pk = scene.packed
    pool_u32, pool = pk.texels_u32, None
    if atlas_mode and pool_u32 is None:
        pool = scene.atlas.texels.contiguous()
        if pool.dtype != torch.float32 or pool.dim() != 2 or pool.shape[1] < 3:
            raise ValueError("the texel pool must be [P, >= 3] f32")
    table = pool_u32 if pool is None else pool
    sky_desc = None
    if atlas_mode == 0:  # the sky's descriptor row (``_eval_skybox_inline``'s)
        row = next(i for i, (h, _o, _d) in enumerate(scene.procedural_tex)
                   if h == scene.skybox_tex)
        sky_desc = ft.tex[row].data_ptr()
    if image is None:
        dims = (0, 0, 0, 0)
        shape = (3,) + tuple(planes[1:])
    else:
        width, height, (_kind, trows, tiles_x, tiles_y) = image
        if n != tiles_y * tiles_x * trows * 128 or width > tiles_x * 128 or (
                height > tiles_y * trows):
            raise ValueError("the image's strip layout must cover the planes' rays")
        dims = (trows, tiles_x, width, height)
        shape = (height, width, 3)
    params = kernels.FinishParamsC(
        None, n, (planes[0] - 9) // k if k else 0, atlas_mode, int(gi),
        int(image is not None), int(pk.skybox_w), int(pk.skybox_h), int(pk.skybox_off),
        sky_desc, kernels.ptr(pool_u32), kernels.ptr(pool),
        0 if table is None else table.shape[0], 0 if pool is None else pool.shape[1],
        ft.mat_rows.data_ptr(), ft.mat_rows.shape[0], *dims,
    )
    return params, shape, finish_variant(atlas_mode, gi, image is not None), pool


finish_cuda.launches = 0
#: launches per instantiation (``finish_variant``'s names)
finish_cuda.variant_launches = {}


def _finish(
    scene: Scene,
    ft: FrameTables,
    out: torch.Tensor,
    atlas_mode: int,
    gi: bool,
    image: tuple | None = None,
) -> torch.Tensor:
    """The frame finish, ``finish_cuda``'s contract: one launch for tables
    on a CUDA device; the plain tail (``_finish_frame``, then with
    ``image`` ``post_image``) for tables on the CPU."""
    if ft.mat_rows.device.type == "cuda":
        return finish_cuda(scene, ft, out, atlas_mode, gi, image)
    res = _finish_frame(scene, out, atlas_mode, gi)
    return res if image is None else post_image(res, *image)


def rebin_key(dm: torch.Tensor, om: torch.Tensor) -> torch.Tensor:
    """i32 row re-bin sort key (render_pallas.py:850): direction octant in
    bits 18-20, then three 6-bit wrapped coarse origin cells
    ``floor(om * 0.25) & 63``, x highest. ``dm``, ``om``: per-row means of
    sign(d) and of o, [3, rows]. Built in integers, so large |origin| can
    neither cross octant strata nor lose exactness."""
    up = (dm > 0).to(torch.int32)
    cell = torch.floor(om * 0.25).to(torch.int32) & 63
    return ((up[0] << 20) | (up[1] << 19) | (up[2] << 18)
            | (cell[0] << 12) | (cell[1] << 6) | cell[2])


def ray_keys(o: list, d: list, live: torch.Tensor) -> torch.Tensor:
    """Per-ray sort keys [n] i32 in ray order: ``rebin_key`` of each live
    ray's own direction (its octant) and origin xyz planes, ``KEY_DEAD``
    for the others (csrc/render.cu ``ray_key``)."""
    return torch.where(live, rebin_key(torch.stack(d), torch.stack(o)), KEY_DEAD)


def sort_keys(first: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The glue between the split's launches: one stable sort of the
    carry-out's key plane (its last, in thread order) → (the sorted keys
    [n] i32, the thread index each came from [n] int64). Ties keep thread
    order, so rays of one key stay in their bounce-0 tiles; dead rays sort
    last. The JAX package's argsort is XLA outside its kernel too
    (render_pallas.py:1345-1346)."""
    return torch.sort(first[CARRY_PLANES - 1].view(torch.int32), stable=True)


def split_rebin_preferred(scene: Scene) -> bool:
    """The default of ``render_fused_camera``'s ``split_rebin``
    (render_pallas.py:889): off for every scene, as in the JAX package."""
    del scene
    return False


def _launch(dev: torch.device, *args, **opts) -> torch.Tensor:
    """One K2.2 launch: the kernel for tables on a CUDA device, its plain
    version for tables on the CPU."""
    if dev.type == "cuda":
        return render_cuda(*args, **opts)
    return render_fused_plain(*args, dev, **opts)


def render_fused_camera(
    scene: Scene,
    frame,  # render.FrameInputs
    width: int,
    height: int,
    bounces: int,
    enable_shadows: bool = False,
    gi_seed: int | None = None,
    row0=None,
    local_height: int | None = None,
    split_rebin: bool | None = None,
    post: bool = False,
) -> tuple[torch.Tensor, tuple[int, int, int]]:
    """Fused frame with in-kernel raygen → ([3, rows_total, 128] radiance in
    trows x 128 screen-strip order, (trows, tiles_x, tiles_y)): one kernel
    launch, then the finish (``_finish``). ``gi_seed`` None turns GI off.
    Callers check ``fused_path_available`` first.

    ``post``: the finished [H, W, 3] frame in place of the radiance, the
    post chain and the untiling in the finish (one launch on the card); a
    whole frame only.

    ``row0``/``local_height``: only the ``local_height``-row window from
    global pixel row ``row0`` (render_pallas.py:1227-1231); the
    unprojection keeps the whole ``height``, so the window's pixels equal
    the whole frame's.

    ``split_rebin`` (None: ``split_rebin_preferred``; taken only for
    ``bounces >= 2`` in atlas mode 0 without GI, render_pallas.py:1288-1291):
    bounce 0 as one camera-mode launch that carries out the live rays'
    state and every ray's sort key, ``sort_keys``, the remaining bounces as
    one ray-mode launch over the live rays in key order from global bounce
    1, written back in place into the first launch's frame planes. The
    JAX package re-bins whole 128-ray rows instead (the TPU's vector
    width); the frame is the same."""
    if post and (row0 is not None or local_height is not None):
        raise ValueError("post takes a whole frame, not a row window")
    with ScopeTimer("render.prepare", log=False):
        win_height = local_height if local_height is not None else height
        trows = tile_rows(width * win_height)
        tiles_x = -(-width // 128)
        tiles_y = -(-win_height // trows)
        rows_total = tiles_y * tiles_x * trows
        kt = kernel_tables(scene)
        ft = frame_tables(scene)
        dev = kt.planes.device
        mode = atlas_mode_of(scene)
        if split_rebin is None:
            split_rebin = split_rebin_preferred(scene)
        split_rebin = split_rebin and bounces >= 2 and mode == 0 and gi_seed is None
        args = (kt, ft, camera_row(frame, row0), width, height, trows, rows_total)
        opts = dict(atlas_mode=mode, shadows=enable_shadows, gi_seed=gi_seed)
    with ScopeTimer("render.k22", log=False):
        if split_rebin:
            first = _launch(dev, *args, 1, carry_out=True, **opts)
            keys, order = sort_keys(first)
            _launch(dev, *args, bounces - 1, carry=first, keys=keys, order=order,
                    start_bounce=1, **opts)
            out = first[:9].reshape(9, rows_total, 128)
        else:
            out = _launch(dev, *args, bounces, **opts).reshape(-1, rows_total, 128)
    with ScopeTimer("render.finish", log=False):
        image = (width, height, ("strip", trows, tiles_x, tiles_y)) if post else None
        img = _finish(scene, ft, out, mode, gi_seed is not None, image)
    return img, (trows, tiles_x, tiles_y)


class FramePlan:
    """A whole camera-mode K2.2 frame and its finish on the card, over one
    scene's tables and one set of frame options, with all that depends on
    nothing else made once (``render_plan``): the two launches' parameter
    blocks (``_render_params``, ``_finish_params``: the tables' pointers,
    the strip geometry, the flags, the atmospheric constants), the
    traversal tables' block, the kernels' entries and their variant names.
    A frame (a call) writes its camera row and sun into the kept
    parameters, then allocates fresh planes and a fresh image and makes
    the launches ``render_cuda`` and ``finish_cuda`` make, counted as
    theirs, under the plan's lock: the blocks are shared until the launch
    copies them. The tables of an instance edit give the kept traversal
    block their instance pointers and counts, and nothing else."""

    def __init__(self, scene: Scene, kept, width: int, height: int, bounces: int,
                 shadows: bool, gi: bool, post: bool) -> None:
        from clraytracer_tpu_torch.runtime import kernels

        kt, ft, pk = kept.kernel, kept.frame, scene.packed
        mode = atlas_mode_of(scene)
        trows = tile_rows(width * height)
        tiles_x = -(-width // 128)
        tiles_y = -(-height // trows)
        rows_total = tiles_y * tiles_x * trows
        self.layout = (trows, tiles_x, tiles_y)
        self.gi_seed = 0 if gi else None
        self.params, shape, self.k22 = _render_params(
            kt, ft, CameraRow(cam=(0.0,) * 36, sun=(0.0, 0.0)), width, height, trows,
            rows_total, bounces, None, atlas_mode=mode, shadows=shadows, gi_seed=self.gi_seed,
            shadow_counters=None, rays=None, carry_out=False, carry=None, start_bounce=0,
            keys=None, order=None,
        )
        self.planes = (shape[0], rows_total, 128)
        image = (width, height, ("strip",) + self.layout) if post else None
        self.fparams, self.shape, self.finish, pool = _finish_params(
            scene, ft, self.planes, mode, gi, image)
        self.tables = kt.as_c()
        self.kernel = kt
        self.device = kt.planes.device
        lib = kernels.build_all()["render.cu"]
        self._render, self._finish = lib.clrt_render, lib.clrt_finish
        self._check, self._stream = kernels.check, kernels.stream_handle
        self._lock = threading.Lock()
        self._refs = (ctypes.byref(self.tables), ctypes.byref(self.params),
                      ctypes.byref(self.fparams))
        # what the parameters point into, and the scene's state they were
        # read from besides the kept tables
        self._held = (_atm_tensor(bounces, str(self.device)), ft, pool)
        self._state = (scene.atlas, scene.materials, scene.procedural_tex, scene.skybox_tex,
                       pk.texels_u32, pk.skybox_w, pk.skybox_h, pk.skybox_off, MAX_FUSED_MATERIALS)

    def holds(self, scene: Scene) -> bool:
        """Was the plan made from this scene's textures, materials and sky
        (and the atlas modes' material bound as it stands)?"""
        a, pk = self._state, scene.packed
        return (scene.atlas is a[0] and scene.materials is a[1] and scene.procedural_tex is a[2]
                and scene.skybox_tex == a[3] and pk.texels_u32 is a[4] and pk.skybox_w == a[5]
                and pk.skybox_h == a[6] and pk.skybox_off == a[7]
                and MAX_FUSED_MATERIALS == a[8])

    def __call__(self, kt: KernelTables, cr: CameraRow, gi_seed: int | None) -> torch.Tensor:
        """The frame over the tables ``kt`` with the camera row ``cr``: K2.2
        into fresh planes, then the finish into a fresh image."""
        dev = self.device
        stream = self._stream(dev)
        tables, params, fparams = self._refs
        with self._lock:
            with ScopeTimer("render.k22", log=False):
                self._write(kt, cr, gi_seed)
                out = torch.empty(self.planes, dtype=torch.float32, device=dev)
                self._check(self._render(tables, params, out.data_ptr(), None, None, stream),
                            "clrt_render")
                render_cuda.launches += 1
                counts = render_cuda.variant_launches
                counts[self.k22] = counts.get(self.k22, 0) + 1
            with ScopeTimer("render.finish", log=False):
                img = torch.empty(self.shape, dtype=torch.float32, device=dev)
                self.fparams.planes = out.data_ptr()
                self._check(self._finish(fparams, img.data_ptr(), stream), "clrt_finish")
                finish_cuda.launches += 1
                counts = finish_cuda.variant_launches
                counts[self.finish] = counts.get(self.finish, 0) + 1
        return img

    def _write(self, kt: KernelTables, cr: CameraRow, gi_seed: int | None) -> None:
        """The frame's camera row, sun and GI seed, and the instance part of
        ``kt`` where the tables changed, into the kept blocks."""
        if kt is not self.kernel:
            t = self.tables
            if (kt.inst_box.data_ptr() | kt.chunk_box.data_ptr()) % 16:
                raise ValueError("box and plane tables must be 16-byte aligned")
            t.inst, t.ranges, t.n_inst = kt.inst.data_ptr(), kt.ranges.data_ptr(), kt.n_inst
            t.inst_box, t.chunk_box = kt.inst_box.data_ptr(), kt.chunk_box.data_ptr()
            t.n_chunks = kt.n_chunks
            self.kernel = kt
        p = self.params
        p.cam[:] = cr.cam
        p.sun_sin, p.sun_cos = cr.sun
        if gi_seed != self.gi_seed:
            p.gi_base = rng.gi_seed_rows(gi_seed, 1)[0]
            self.gi_seed = gi_seed


def plan_key(width: int, height: int, bounces: int, shadows: bool = False,
             gi_seed: int | None = None, post: bool = False) -> tuple:
    """The frame options a ``FramePlan`` is made for (the GI seed is a
    parameter it writes, so a new seed needs no new plan)."""
    return (width, height, bounces, bool(shadows), gi_seed is not None, bool(post))


def render_plan(
    scene: Scene,
    frame,  # render.FrameInputs or render.CameraFrame
    width: int,
    height: int,
    bounces: int,
    enable_shadows: bool = False,
    gi_seed: int | None = None,
    post: bool = False,
) -> tuple[torch.Tensor, tuple[int, int, int]] | None:
    """A whole camera-mode frame on the card through the ``FramePlan`` kept
    with the scene's tables for these options, made at its first use →
    what ``render_fused_camera`` returns for the same arguments, bit for
    bit; None, having done nothing, where the frame is not K2.2's on the
    card (tables on the CPU, a scene the fused kernel does not cover).
    ``frame.kernel_row()`` gives the camera row. Counters:
    ``render_plan.builds`` (plans made) and ``render_plan.frames`` (frames
    served by a plan already kept)."""
    key = plan_key(width, height, bounces, enable_shadows, gi_seed, post)
    kept = kept_tables(scene, build=False)
    plan = None if kept is None else kept.plans.get(key)
    if plan is None or not plan.holds(scene):
        if scene.device.type != "cuda" or not fused_path_available(scene, True, True):
            return None
        plan = None
    with ScopeTimer("render.prepare", log=False):
        if plan is None:
            kept = kept_tables(scene)
            plan = kept.plans[key] = FramePlan(scene, kept, *key)
            render_plan.builds += 1
        else:
            render_plan.frames += 1
        cr = frame.kernel_row()
    return plan(kept.kernel, cr, gi_seed), plan.layout


render_plan.builds = 0
render_plan.frames = 0


def render_fused(
    scene: Scene,
    origin: torch.Tensor,  # [3, rows, 128] ray-linear
    direction: torch.Tensor,  # [3, rows, 128]
    sun_angle,
    bounces: int,
    enable_shadows: bool = False,
    gi_seed: int | None = None,
) -> torch.Tensor:
    """Fused frame over given rays (render_pallas.py:1115, ray mode) →
    [3, rows, 128] radiance: one kernel launch in ray mode, then the
    finish (``_finish``). Ray i is row i // 128, lane i % 128, and its GI
    stream is seeded by i, as in camera mode. ``gi_seed`` None turns GI
    off. Callers check ``fused_path_available`` first."""
    rows_total = origin.shape[1]
    kt = kernel_tables(scene)
    ft = frame_tables(scene)
    dev = kt.planes.device
    rays = torch.cat([origin.reshape(3, -1), direction.reshape(3, -1)]).to(
        device=dev, dtype=torch.float32).contiguous()
    mode = atlas_mode_of(scene)
    opts = dict(atlas_mode=mode, shadows=enable_shadows, gi_seed=gi_seed, rays=rays)
    # ray mode reads no camera: the strip geometry below is the rays' own
    # grid (width 128, one strip of rows_total rows) and is not read
    args = (kt, ft, ray_row(sun_angle), 128, rows_total, rows_total, rows_total, bounces)
    out = _launch(dev, *args, **opts).reshape(-1, rows_total, 128)
    return _finish(scene, ft, out, mode, gi_seed is not None)
