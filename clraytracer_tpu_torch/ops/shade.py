"""The shading step: skybox sampling and texture helpers, which the fused
frame shares, and the differentiable float path of the JAX package's
``ops/shade.py`` (``shade_hits`` with reference-parity Phong and float
colours, the path ``diff.render_image_diff`` takes).

The equirect skybox (MathAndSTL.cl:253-258) stays outside the frame kernel,
as in the reference package: its ``atan2``/``acos`` come from torch here,
on whichever device the frame runs.

The float path builds its gather tables from the canonical scene leaves on
every call (``build_shading_tables``), so gradients reach the material
colours, the instance inverse transforms, and the triangles' f16 normals
and uvs (through the tracer's attributes); imported-texture scenes sample
the texel pool, so the texels get gradients too. All-procedural scenes
evaluate their descriptors in place, and their texel gradients are zero by
design. Only reference-parity shading is ported; shadows, GI, refraction
and the integer-colour two-phase path are not.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from clraytracer_tpu_torch.device import const
from clraytracer_tpu_torch.ops import gather, planar

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
# the float (differentiable) shading path
# ---------------------------------------------------------------------------


class ShadingTables(NamedTuple):
    """Gather-ready tables, built from the canonical leaves."""

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
    hit: torch.Tensor,  # [*S] bool
    instance_idx: torch.Tensor,  # [*S] i32
    attrs: tuple,  # (object-space normal [3, *S], uu, vv, mat_local)
    deferred: list | None = None,
) -> BounceState:
    """One bounce of shading on the float path (shade.py:374 of the JAX
    package): misses add the sky and end (kernel_main.cl:219-224), hits add
    reference-parity Phong (kernel_main.cl:226-271) and continue along the
    mirror direction. ``attrs`` are the differentiable tracer's
    interpolated attributes.

    ``deferred`` (imported-texture scenes): when a list, the texel-pool
    gather is skipped and ``(pool idx, F1, F2)`` is appended;
    ``render.bounce_loop`` fetches every bounce's texels with one gather
    after the loop (radiance += texel * F1 + texel * F2)."""
    atlas = scene.atlas
    tables = build_shading_tables(scene)

    kb = scene.skybox_tex
    skw, skh, skoff = atlas.width[kb], atlas.height[kb], atlas.offset[kb]
    sky_idx = _skybox_index(skw, skh, skoff, state.direction)

    miss_now = state.alive & ~hit
    live = state.alive & hit

    mat_local = attrs[3].to(torch.int32)
    inst = gather.small_rows_diff(tables.inst_rows, instance_idx)  # [17, *S]
    mat_id = inst[16].to(torch.int32) + mat_local
    mat = gather.small_rows_diff(tables.mat_rows, mat_id)  # [16, *S]
    alb_rgb = mat[0:3]
    aoff = mat[10].to(torch.int32) * (1 << _OFF_SHIFT) + mat[11].to(torch.int32)

    # the reference reuses the object-space hit point as the next world
    # origin (kernel_main.cl:246-253)
    mesh_origin, mesh_direction = _transform_rays(
        inst, state.origin, state.direction
    )
    n_obj, uu, vv = attrs[0], attrs[1], attrs[2]
    normal = planar.normalize(
        torch.stack(
            [
                n_obj[0] * inst[0] + n_obj[1] * inst[4] + n_obj[2] * inst[8],
                n_obj[0] * inst[1] + n_obj[1] * inst[5] + n_obj[2] * inst[9],
                n_obj[0] * inst[2] + n_obj[1] * inst[6] + n_obj[2] * inst[10],
            ]
        )
    )

    inline = _all_procedural(scene)
    if inline:
        sky = _eval_skybox_inline(scene, sky_idx, skw, skoff)
        texel = planar.where(hit, _eval_tex_inline(scene, aoff, uu, vv), sky)
    else:
        alb_idx = _pool_index(mat[8], mat[9], aoff, uu, vv)
        # dead lanes fetch texel 0
        idx = torch.where(hit, alb_idx, sky_idx)
        idx = torch.where(state.alive, idx, torch.zeros_like(idx))
        if deferred is None:
            texel = sky = gather.take_rgb(atlas.texels, idx)
        else:
            texel = sky = None
    use_defer = deferred is not None and not inline
    if use_defer:
        result = state.result  # the sky rides the deferred gather
        color = None
    else:
        result = planar.where(
            miss_now, state.result + sky * state.energy, state.result
        )
        color = texel * alb_rgb

    # kernel_main.cl:248-250 overrides specular (0.2), roughness (0.5) and
    # shininess (1.0, so the power is the identity)
    specular_color = torch.full_like(state.energy, 0.2)
    roughness = torch.full_like(t, 0.5)

    point = mesh_origin + planar.scale(mesh_direction, t)
    new_origin = point + normal * 0.01
    new_direction = planar.reflect(state.direction, normal)

    shadow = 1.0  # the reference's unimplemented sun-shadow factor
    ndl_raw = planar.dot(normal, -state.light_dir)
    amb_m = _max(-ndl_raw, 0.1)
    ndl = _max(ndl_raw, 0.0)
    specular = planar.scale(specular_color, (1.0 - roughness) * ndl * shadow * ndl)
    refl_light = planar.reflect(-state.light_dir, normal)
    rdm = _max(planar.dot(refl_light, mesh_direction), 0.0)
    spec_light = ndl * rdm * 0.2 * shadow

    if use_defer:
        dif = ndl * shadow
        zero3 = torch.zeros_like(state.energy)
        f1 = planar.where(
            live,
            planar.scale(state.energy * alb_rgb, dif),
            planar.where(miss_now, state.energy, zero3),
        )
        f2 = planar.where(
            live, planar.scale(state.atmospheric * alb_rgb, amb_m), zero3
        )
        deferred.append((idx, f1, f2))
        result = planar.where(live, result + spec_light[None], result)
    else:
        ambient = planar.scale(state.atmospheric * color, amb_m)
        contrib = (
            planar.scale(state.energy * color, ndl * shadow)
            + ambient
            + spec_light[None]
        )
        result = planar.where(live, result + contrib, result)

    return BounceState(
        result=result,
        energy=planar.where(live, state.energy * specular, state.energy),
        atmospheric=planar.where(
            live, state.atmospheric * 0.4, state.atmospheric
        ),
        light_dir=planar.where(live, new_direction, state.light_dir),
        origin=planar.where(live, new_origin, state.origin),
        direction=planar.where(live, new_direction, state.direction),
        alive=live,
    )
