"""The shading step of the two-phase path (the JAX package's
``ops/shade.py``: ``shade_hits`` with every flag), and the skybox sampling
and texture helpers the fused frame shares.

The equirect skybox (MathAndSTL.cl:253-258) stays outside the frame kernel,
as in the reference package: its ``atan2``/``acos`` come from torch here,
on whichever device the frame runs.

Two colour paths. Integer colours read the scene's packed tables and
modulate texels as bytes (``_modulate_bytes``), as the reference does. The
float path builds its gather tables from the canonical scene leaves on
every call (``build_shading_tables``), so gradients reach the material
colours, the instance inverse transforms, and the triangles' f16 normals
and uvs (through the tracer's attributes); imported-texture scenes sample
the texel pool, so the texels get gradients too. All-procedural scenes
evaluate their descriptors in place in both paths, and their texel
gradients are zero by design. Either path takes reference-parity or
material shading, sun shadows through a shadow tracer, Monte-Carlo GI and
refraction.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

from clraytracer_tpu_torch.device import const
from clraytracer_tpu_torch.ops import gather, planar
from clraytracer_tpu_torch.utils.timer import ScopeTimer

_U8 = 1.0 / 255.0

#: texel-pool offsets can exceed 2^24 (f32 integer exactness), so packed
#: tables carry them split as (off >> _OFF_SHIFT, off & _OFF_MASK)
_OFF_SHIFT = 12
_OFF_MASK = (1 << _OFF_SHIFT) - 1


def _as_f32(x):
    return float(x) if isinstance(x, (int, float)) else x.to(torch.float32)


def _as_i32(x):
    return int(x) if isinstance(x, (int, float)) else x.to(torch.int32)


def _skybox_index(w, h, off, d: torch.Tensor) -> torch.Tensor:
    """Flat texel index (i32) of an equirect skybox sample for planar
    directions ``d`` [3, ...] (shade.py:169 of the JAX package). ``w/h/off``
    are ints (the packed sky record) or 0-dim int tensors (the atlas
    record)."""
    pi = const(math.pi, d)
    theta = (
        torch.atan2(d[0], -d[2]) / pi * (0.5 * _as_f32(w))
    ).to(torch.int32)
    phi = (
        torch.acos(torch.clamp(d[1], -1.0, 1.0)) / pi * _as_f32(h)
    ).to(torch.int32)
    return phi * _as_i32(w) + theta + _as_i32(off)


def _wrap_scale(u: torch.Tensor, w) -> torch.Tensor:
    """UV wrap + truncating scale (reference MathAndSTL.cl:262-264)."""
    uw = u - torch.floor(u)
    return (uw * w).to(torch.int32)


def _pool_index(w, h, off, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Flat texel index of a UV point sample; ``w/h/off`` per-ray tensors
    (gathered records) or ints."""
    us = _wrap_scale(u, _as_f32(w))
    vs = _wrap_scale(v, _as_f32(h))
    return vs * _as_i32(w) + us + _as_i32(off)


def _all_procedural(scene) -> bool:
    """Does every texture in the scene have a procedural descriptor?"""
    handles = {h for h, _, _ in scene.procedural_tex}
    return handles >= set(range(scene.atlas.num_textures))


def _eval_skybox_inline(scene, sky_flat: torch.Tensor, skw, skoff) -> torch.Tensor:
    """Equirect skybox texel ``[3, ...]`` in [0, 1] from the flat index,
    evaluated from the sky's procedural descriptor (theta may be negative:
    the floor-divmod reproduces the flat form's row wrap). ``skw/skoff``
    are ints or 0-dim int tensors, as for ``_skybox_index``."""
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


def _eval_tex_inline(
    scene, off: torch.Tensor, uu: torch.Tensor, vv: torch.Tensor
) -> torch.Tensor:
    """Texture fetch for all-procedural scenes → [3, *S] in [0, 1]: each
    ray's texture is the descriptor whose texel offset equals its gathered
    ``off``; the wrap and truncation are the pool index's, so the values
    equal a gather of the baked images."""
    from clraytracer_tpu_torch.scene.procedural_tex import eval_texel

    out = None
    for _handle, t_off, desc in scene.procedural_tex:
        ui = _wrap_scale(uu, float(desc.width)).to(torch.float32)
        vi = _wrap_scale(vv, float(desc.height)).to(torch.float32)
        rgb = eval_texel(desc, ui, vi) * _U8
        out = rgb if out is None else planar.where(off == t_off, rgb, out)
    return out


# ---------------------------------------------------------------------------
# the shading tables and the shading step
# ---------------------------------------------------------------------------


class ShadingTables(NamedTuple):
    """Gather-ready tables: the scene's packed ones, or built from the
    canonical leaves."""

    tri_attr: torch.Tensor  # [T, 16] f32: n0 n1 n2 (9) | uv0 uv1 uv2 (6) | mat
    inst_rows: torch.Tensor  # [I, 17] f32: inverse transform (16) | material_start
    mat_rows: torch.Tensor  # [M, 16] f32: albedo(3) specular(3) shin rough |
    #                         aw ah aoff_hi aoff_lo | sw sh soff_hi soff_lo


def _inst_rows(scene) -> torch.Tensor:
    inst = scene.instances
    return torch.cat(
        [
            inst.inverse_transform.reshape(-1, 16),
            inst.material_start.to(torch.float32)[:, None],
        ],
        dim=1,
    )


def build_shading_tables(scene) -> ShadingTables:
    """The packed tables from the canonical scene leaves (shade.py:62 of
    the JAX package), differentiable w.r.t. normals/uvs, instance
    transforms and material colours."""
    tris = scene.tris
    f32 = lambda a: a.to(torch.float32)
    tri_attr = torch.cat(
        [
            f32(tris.n0), f32(tris.n1), f32(tris.n2),
            f32(tris.uv0), f32(tris.uv1), f32(tris.uv2),
            f32(tris.mat_idx)[:, None],
        ],
        dim=1,
    )
    mats = scene.materials
    atlas = scene.atlas

    def texrec(tex_idx: torch.Tensor) -> torch.Tensor:
        k = tex_idx.long().clamp(0, atlas.num_textures - 1)
        w, h, off = atlas.width[k], atlas.height[k], atlas.offset[k]
        return torch.stack(
            [w, h, off >> _OFF_SHIFT, off & _OFF_MASK], dim=1
        ).to(torch.float32)

    mat_rows = torch.cat(
        [
            mats.albedo,
            mats.specular,
            mats.shininess[:, None],
            mats.roughness[:, None],
            texrec(mats.albedo_tex),
            texrec(mats.specular_tex),
        ],
        dim=1,
    )
    return ShadingTables(
        tri_attr=tri_attr, inst_rows=_inst_rows(scene), mat_rows=mat_rows
    )


def _shading_tables(scene, prefer_packed: bool) -> ShadingTables:
    """The packed tables where asked for and built, else the tables from
    the canonical leaves (shade.py:133 of the JAX package)."""
    pk = scene.packed
    if prefer_packed and pk is not None:
        return ShadingTables(
            tri_attr=pk.tri_attr, inst_rows=pk.inst_rows, mat_rows=pk.mat_rows
        )
    return build_shading_tables(scene)


def refresh_packed(scene):
    """The packed gather tables recomputed from the (possibly edited)
    canonical leaves (shade.py:114 of the JAX package; the reference's
    re-push after a live material edit, ResourceManager.cpp:102-128). The
    skybox record and the packed texel words are build-time constants and
    carry over. The kernels' tables come from the scene's
    (``ops.trace.carry``): their instance and material rows and world
    boxes are new, the geometry and descriptor rows the same tensors."""
    from clraytracer_tpu_torch.ops import trace  # ops.trace imports this module

    if scene.packed is None:
        return scene
    with ScopeTimer("tables.shading", log=False):
        packed = dataclasses.replace(scene.packed, **build_shading_tables(scene)._asdict())
        return trace.carry(scene, dataclasses.replace(scene, packed=packed))


def sample_pool_planar(atlas, w, h, off, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Point-sample RGB from the texel pool → planar [3, *S]; ``w/h/off``
    per-ray records or ints (shade.py:223 of the JAX package)."""
    return gather.take_rgb(atlas.texels, _pool_index(w, h, off, u, v))


def _texture_record(atlas, tex_idx: torch.Tensor):
    """(width, height, offset) of each texture index, clamped to the
    atlas's textures as ``jnp.take(..., mode="clip")`` clamps."""
    k = torch.as_tensor(tex_idx, device=atlas.width.device).long().clamp(
        0, atlas.num_textures - 1)
    return atlas.width[k], atlas.height[k], atlas.offset[k]


def sample_texture_planar(atlas, tex_idx: torch.Tensor, u: torch.Tensor,
                          v: torch.Tensor) -> torch.Tensor:
    """Point samples of per-ray textures → planar [3, *S] (shade.py:264 of
    the JAX package)."""
    w, h, off = _texture_record(atlas, tex_idx)
    return sample_pool_planar(atlas, w, h, off, u, v)


def sample_texture(atlas, tex_idx: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """Point samples at ``uv`` [..., 2] → [..., 3] (shade.py:255 of the JAX
    package)."""
    out = sample_texture_planar(atlas, tex_idx, uv[..., 0], uv[..., 1])
    return planar.to_last(out, tuple(uv.shape[:-1]))


def sample_skybox_static(atlas, w: int, h: int, off: int, d: torch.Tensor) -> torch.Tensor:
    """Equirect skybox sample with a fixed texture record, planar
    directions ``d`` [3, *S] → [3, *S] (MathAndSTL.cl:253-258)."""
    return gather.take_rgb(atlas.texels, _skybox_index(w, h, off, d))


def sample_skybox_planar(atlas, tex_idx: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """Equirect skybox sample with a per-ray texture index → [3, *S]."""
    w, h, off = _texture_record(atlas, tex_idx)
    return gather.take_rgb(atlas.texels, _skybox_index(w, h, off, d))


def sample_skybox(atlas, tex_idx, direction: torch.Tensor) -> torch.Tensor:
    """Equirect skybox sample of directions [..., 3] → [..., 3]
    (shade.py:275 of the JAX package)."""
    shape = tuple(direction.shape[:-1])
    idx = torch.as_tensor(tex_idx, device=direction.device).expand(shape)
    out = sample_skybox_planar(atlas, idx, planar.from_last(direction))
    return planar.to_last(out, shape)


def _modulate_bytes(texel: torch.Tensor, mat_rgb: torch.Tensor) -> torch.Tensor:
    """The reference's integer colour modulate ``((mat_u8 * texel_u8) >> 8)
    / 255`` (MathAndSTL.cl:243-249) in float arithmetic, exact: u8 * u8 <
    2^24 (shade.py:283 of the JAX package). ``texel`` [3, *S] from the u8
    pool, ``mat_rgb`` the canonical float colour."""
    mat_b = torch.round(torch.clamp(mat_rgb, 0.0, 1.0) * 255.0)
    tex_b = torch.round(texel * 255.0)
    return torch.floor(mat_b * tex_b * (1.0 / 256.0)) * _U8


def _pow_fast(x: torch.Tensor, e: torch.Tensor) -> torch.Tensor:
    """``x ** e`` by exp2/log2, 0 where x <= 0 (shade.py:296 of the JAX
    package)."""
    safe = torch.clamp(x, min=1e-30)
    out = torch.exp2(e * torch.log2(safe))
    return torch.where(x > 0.0, out, torch.zeros_like(out))


def _transform_rays(
    m: torch.Tensor, origin: torch.Tensor, direction: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Row-vector transform by per-ray matrix entries ``m`` [17, *S]."""
    o = torch.stack(
        [
            origin[0] * m[0] + origin[1] * m[4] + origin[2] * m[8] + m[12],
            origin[0] * m[1] + origin[1] * m[5] + origin[2] * m[9] + m[13],
            origin[0] * m[2] + origin[1] * m[6] + origin[2] * m[10] + m[14],
        ]
    )
    d = torch.stack(
        [
            direction[0] * m[0] + direction[1] * m[4] + direction[2] * m[8],
            direction[0] * m[1] + direction[1] * m[5] + direction[2] * m[9],
            direction[0] * m[2] + direction[1] * m[6] + direction[2] * m[10],
        ]
    )
    return o, d


def object_space_rays(
    scene, instance_idx: torch.Tensor, origin: torch.Tensor,
    direction: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Planar object-space rays of each ray's instance (kernel_main.cl:
    205-207), differentiable w.r.t. the inverse transforms."""
    m = gather.small_rows_diff(_inst_rows(scene), instance_idx)
    return _transform_rays(m, origin, direction)


class BounceState(NamedTuple):
    """Per-ray accumulation state across the bounce loop
    (kernel_main.cl:183-186). Vectors planar [3, *spatial]."""

    result: torch.Tensor
    energy: torch.Tensor
    atmospheric: torch.Tensor
    light_dir: torch.Tensor
    origin: torch.Tensor
    direction: torch.Tensor
    alive: torch.Tensor  # [*spatial] bool


def initial_bounce_state(
    origin: torch.Tensor, direction: torch.Tensor, sun_angle: torch.Tensor
) -> BounceState:
    """``origin``/``direction``: planar [3, *spatial]; ``sun_angle`` a
    0-dim f32 tensor on their device."""
    spatial = tuple(direction.shape[1:])
    dev = direction.device
    sun = torch.stack(
        [torch.zeros_like(sun_angle), torch.sin(sun_angle), torch.cos(sun_angle)]
    )
    expand = (...,) + (None,) * len(spatial)
    # filled on the device: a copy from host memory would wait for the stream
    atm = torch.stack([sun_angle.new_full((), c) for c in (0.255, 0.25, 0.27)])
    return BounceState(
        result=torch.zeros((3,) + spatial, dtype=torch.float32, device=dev),
        energy=torch.ones((3,) + spatial, dtype=torch.float32, device=dev),
        atmospheric=atm[expand].expand((3,) + spatial),
        light_dir=sun[expand].expand((3,) + spatial),
        origin=origin,
        direction=direction,
        alive=torch.ones(spatial, dtype=torch.bool, device=dev),
    )




def _max(x: torch.Tensor, c: float) -> torch.Tensor:
    """``jnp.maximum(x, c)``, whose gradient splits in half at a tie."""
    return torch.maximum(x, x.new_full((), c))


def shade_hits(
    scene,
    state: BounceState,
    t: torch.Tensor,  # [*S] hit distance (object space, as the reference)
    u: torch.Tensor,  # [*S] barycentrics of the hit
    v: torch.Tensor,
    tri_idx: torch.Tensor,  # [*S] i32 arena triangle index
    instance_idx: torch.Tensor,  # [*S] i32
    hit: torch.Tensor,  # [*S] bool
    reference_parity: bool = True,
    integer_colors: bool = True,
    attrs: tuple | None = None,
    shadow_tracer=None,
    enable_refraction: bool = False,
    refraction_ior: float = 1.45,
    gi_state: torch.Tensor | None = None,
    deferred: list | None = None,
) -> BounceState:
    """One bounce of shading (shade.py:374 of the JAX package): misses add
    the sky and end (kernel_main.cl:219-224), hits add Phong
    (kernel_main.cl:226-271) and continue.

    ``reference_parity`` keeps the reference kernel's specular (0.2),
    roughness (0.5) and shininess (1.0) overrides (kernel_main.cl:248-250);
    without it the material's specular texture and colour, roughness and
    shininess shade. ``integer_colors`` reads the packed tables and
    modulates colours as bytes; otherwise the float, differentiable path.
    ``attrs``: the tracer's interpolated (object-space normal [3, *S], uu,
    vv, mat_local); None gathers the triangle rows and interpolates here.
    ``shadow_tracer``: a tracer (taking ``live``) for one occlusion ray
    from each hit toward the sun, which kills the direct terms and the
    specular carry of an occluded hit. ``gi_state``: per-ray uint32
    streams (int64 tensor, ops/rng.py); the continuation then samples the
    hemisphere about the normal with throughput colour * 2 cos(theta).
    ``enable_refraction``: hits on a material with transmission > 0
    continue by Snell refraction behind the surface (the mirror ray on
    total internal reflection), carry the transmission and pass (1 -
    transmission) of their direct terms.

    ``deferred`` (reference parity, float colours, no refraction): when a
    list, the texel-pool gather is skipped and ``(pool idx, F1, F2, albP,
    live)`` is appended; ``render.bounce_loop`` fetches every bounce's
    texels with one gather after the loop (radiance += texel * (F1 * P +
    F2), P the GI colour product)."""
    atlas = scene.atlas
    fast = integer_colors and scene.packed is not None
    tables = _shading_tables(scene, prefer_packed=fast)

    if fast:
        pk = scene.packed
        skw, skh, skoff = pk.skybox_w, pk.skybox_h, pk.skybox_off
    else:
        kb = scene.skybox_tex
        skw, skh, skoff = atlas.width[kb], atlas.height[kb], atlas.offset[kb]
    sky_idx = _skybox_index(skw, skh, skoff, state.direction)

    miss_now = state.alive & ~hit
    live = state.alive & hit

    if attrs is not None:
        attr = None
        mat_local = attrs[3].to(torch.int32)
    else:
        # miss and dead lanes carry no triangle: pin them to row 0
        attr = gather.take_rows(
            tables.tri_attr, torch.where(hit, tri_idx, torch.zeros_like(tri_idx))
        )  # [16, *S]
        mat_local = attr[15].to(torch.int32)
    inst = gather.small_rows_diff(tables.inst_rows, instance_idx)  # [17, *S]
    mat_id = inst[16].to(torch.int32) + mat_local
    mat = gather.small_rows_diff(tables.mat_rows, mat_id)  # [16, *S]
    alb_rgb, spec_rgb = mat[0:3], mat[3:6]

    def rec(base: int):
        off = mat[base + 2].to(torch.int32) * (1 << _OFF_SHIFT) + mat[base + 3].to(
            torch.int32)
        return mat[base], mat[base + 1], off

    # the reference reuses the object-space hit point as the next world
    # origin (kernel_main.cl:246-253)
    mesh_origin, mesh_direction = _transform_rays(inst, state.origin, state.direction)

    if attrs is not None:
        n_obj, uu, vv = attrs[0], attrs[1], attrs[2]
    else:
        w0 = 1.0 - u - v
        n_obj = torch.stack(
            [attr[c] * w0 + attr[3 + c] * u + attr[6 + c] * v for c in range(3)]
        )
        uu = attr[9] * w0 + attr[11] * u + attr[13] * v
        vv = attr[10] * w0 + attr[12] * u + attr[14] * v
    normal = planar.normalize(
        torch.stack(
            [
                n_obj[0] * inst[0] + n_obj[1] * inst[4] + n_obj[2] * inst[8],
                n_obj[0] * inst[1] + n_obj[1] * inst[5] + n_obj[2] * inst[9],
                n_obj[0] * inst[2] + n_obj[1] * inst[6] + n_obj[2] * inst[10],
            ]
        )
    )

    # ---- texels: all-procedural scenes evaluate their descriptors in place
    # (in every colour mode); the others gather albedo (hit lanes) and sky
    # (miss lanes) from the pool in one gather, dead lanes pinned to texel 0
    aw, ah, aoff = rec(8)
    inline = _all_procedural(scene)
    if inline:
        sky = _eval_skybox_inline(scene, sky_idx, skw, skoff)
        texel = planar.where(hit, _eval_tex_inline(scene, aoff, uu, vv), sky)
    else:
        alb_idx = _pool_index(aw, ah, aoff, uu, vv)
        idx = torch.where(hit, alb_idx, sky_idx)
        idx = torch.where(state.alive, idx, torch.zeros_like(idx))
        if deferred is None:
            pk_tex = scene.packed.texels_u32 if fast else None
            if pk_tex is not None:
                # flat packed-RGB8 pool: texel = byte / 255 is the pool's
                # own construction, so the values equal the row gather's
                word = pk_tex[idx.long().clamp(0, pk_tex.shape[0] - 1)]
                texel = torch.stack(
                    [((word >> s) & 0xFF).to(torch.float32) * _U8 for s in (0, 8, 16)]
                )
            else:
                texel = gather.take_rgb(atlas.texels, idx)
            sky = texel  # valid on miss lanes only
        else:
            if not reference_parity or integer_colors or enable_refraction:
                raise ValueError(
                    "texel deferral needs reference parity, float colours and "
                    "no refraction")
            texel = sky = None
    use_defer = deferred is not None and not inline
    if use_defer:
        result = state.result  # the sky rides the deferred gather
        color = None
    else:
        result = planar.where(miss_now, state.result + sky * state.energy, state.result)
        color = _modulate_bytes(texel, alb_rgb) if integer_colors else texel * alb_rgb

    if reference_parity:
        specular_color = torch.full_like(state.energy, 0.2)
        roughness = torch.full_like(t, 0.5)
        shininess = None  # the constant 1.0: the power is the identity
    else:
        sw, sh, soff = rec(12)
        if inline:
            spec_texel = _eval_tex_inline(scene, soff, uu, vv)
        else:
            spec_texel = sample_pool_planar(atlas, sw, sh, soff, uu, vv)
        specular_color = (
            _modulate_bytes(spec_texel, spec_rgb) if integer_colors
            else spec_texel * spec_rgb
        )
        roughness = mat[7]
        shininess = mat[6]

    point = mesh_origin + planar.scale(mesh_direction, t)
    new_origin = point + normal * 0.01
    new_direction = planar.reflect(state.direction, normal)
    if gi_state is not None:
        # Monte-Carlo diffuse GI: a uniform hemisphere sample about the
        # shading normal, kept on its side; the estimator weight of the
        # uniform sampler is albedo * 2 cos(theta)
        from clraytracer_tpu_torch.ops import rng

        gi_dir, _ = rng.hemisphere_sample(gi_state, normal)
        gi_dot = planar.dot(gi_dir, normal)
        new_direction = planar.where(gi_dot < 0.0, -gi_dir, gi_dir)
        gi_weight = 2.0 * gi_dot.abs()

    use_refr = None
    if enable_refraction:
        trans = scene.materials.transmission[
            mat_id.long().clamp(0, scene.materials.count - 1)]
        cos_i = -planar.dot(state.direction, normal)
        n_eff = planar.where(cos_i >= 0.0, normal, -normal)
        ci = cos_i.abs()
        eta = torch.where(
            cos_i >= 0.0, cos_i.new_full((), 1.0 / refraction_ior),
            cos_i.new_full((), refraction_ior),
        )
        kk = 1.0 - eta * eta * (1.0 - ci * ci)
        refr_dir = planar.normalize(
            planar.scale(state.direction, eta)
            + planar.scale(n_eff, eta * ci - torch.sqrt(torch.clamp(kk, min=0.0)))
        )
        use_refr = hit & (trans > 0.0) & (kk >= 0.0)
        new_direction = planar.where(use_refr, refr_dir, new_direction)
        # a refracted continuation starts just behind the surface
        new_origin = planar.where(use_refr, point - n_eff * 0.01, new_origin)

    # ``shadow`` is the reference's declared but unimplemented sun-shadow
    # factor (kernel_main.cl:258): one occlusion ray from the offset hit
    # point toward the sun, traced for the shaded lanes only
    shadow = 1.0
    if shadow_tracer is not None:
        to_sun = -state.light_dir
        sh_origin = planar.where(hit, new_origin, torch.zeros_like(new_origin))
        occ = shadow_tracer(scene, sh_origin, to_sun, live=live)
        shadow = torch.where(hit & occ.hit, 0.0, 1.0)
    ndl_raw = planar.dot(normal, -state.light_dir)
    amb_m = _max(-ndl_raw, 0.1)
    ndl = _max(ndl_raw, 0.0)
    specular = planar.scale(specular_color, (1.0 - roughness) * ndl * shadow * ndl)
    if gi_state is not None:
        # the deferred path carries the weight alone: the colour joins
        # through the P product of render.bounce_loop
        specular = (gi_weight[None].expand_as(state.energy) if use_defer
                    else planar.scale(color, gi_weight))
    refl_light = planar.reflect(-state.light_dir, normal)
    rdm = _max(planar.dot(refl_light, mesh_direction), 0.0)
    spec_pow = rdm if shininess is None else _pow_fast(rdm, shininess)
    spec_light = ndl * spec_pow * 0.2 * shadow

    if use_defer:
        # texel-blind terms: contribution = texel * (F1 * P + F2); F1 is
        # E * dif * albedo (the plain energy on a miss lane, whose sky
        # texel rides the same gather), F2 the ambient coefficient
        dif = ndl * shadow
        zero3 = torch.zeros_like(state.energy)
        f1 = planar.where(
            live,
            planar.scale(state.energy * alb_rgb, dif),
            planar.where(miss_now, state.energy, zero3),
        )
        f2 = planar.where(live, planar.scale(state.atmospheric * alb_rgb, amb_m), zero3)
        deferred.append((idx, f1, f2, alb_rgb if gi_state is not None else None, live))
        result = planar.where(live, result + spec_light[None], result)
    else:
        ambient = planar.scale(state.atmospheric * color, amb_m)
        contrib = (
            planar.scale(state.energy * color, ndl * shadow) + ambient + spec_light[None]
        )
        if use_refr is not None:
            contrib = planar.where(use_refr, planar.scale(contrib, 1.0 - trans), contrib)
            specular = planar.where(use_refr, trans[None].expand_as(specular), specular)
        result = planar.where(live, result + contrib, result)

    return BounceState(
        result=result,
        energy=planar.where(live, state.energy * specular, state.energy),
        atmospheric=planar.where(live, state.atmospheric * 0.4, state.atmospheric),
        light_dir=planar.where(live, new_direction, state.light_dir),
        origin=planar.where(live, new_origin, state.origin),
        direction=planar.where(live, new_direction, state.direction),
        alive=live,
    )
