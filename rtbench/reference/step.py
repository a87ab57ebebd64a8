"""The reference differentiable step: the L2 loss of a two-bounce float
colour render (reference-parity Phong, no post chain) against a target, and
its gradient with respect to every float leaf of the scene.

Hits are found without gradients (``hits.Geometry.closest``, a piecewise
constant choice); (t, u, v) are recomputed by Möller–Trumbore from the hit
triangle's vertices and the object-space ray, and autograd flows through
it, the attribute interpolation, the shading, the texel fetches and the
reflection bounce. Silhouettes are not differentiated.

The leaves carry the program's names (``"tris.v0"``, ``"materials.albedo"``,
``"atlas.texels"``, ``"instances.inverse_transform"``, ...); each holds the
same values as the program's leaf of that name, in the benchmark's own
order, so a gradient's norm is comparable whatever the order.
"""

from __future__ import annotations

import numpy as np
import torch

from rtbench.reference import camera
from rtbench.reference.frame import U8, Scene
from rtbench.reference.textures import eval_procedural

MISS = 1e30
TRI_FIELDS = ("v0", "v1", "v2", "n0", "n1", "n2", "uv0", "uv1", "uv2")
#: the leaves the scene stores as IEEE half (the upstream's vertex format)
HALF_LEAVES = tuple(f"tris.{k}" for k in TRI_FIELDS[3:])


def _baked(tex, device) -> torch.Tensor:
    """A texture's texels as [w * h, 3] values in [0, 1]."""
    if tex.image is not None:
        b = torch.as_tensor(tex.image.reshape(-1, 3)).to(device=device, dtype=torch.float32)
    else:
        w, h = tex.size
        jj, ii = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=device),
                                torch.arange(w, dtype=torch.float32, device=device),
                                indexing="ij")
        b = eval_procedural(tex.procedural, ii, jj).reshape(3, -1).T
    return b * U8


class Leaves:
    """The step's float leaves, fresh autograd leaves of the scene's values:
    the geometry's (vertices, instance transforms) in float32, the others in
    ``dtype``."""

    def __init__(self, ref: Scene, dtype=torch.float32) -> None:
        spec, dev = ref.spec, ref.device
        f = lambda a, dt=dtype: torch.as_tensor(np.ascontiguousarray(a, np.float32)).to(dev, dt)
        half = lambda a: f(np.asarray(a, np.float32).astype(np.float16).astype(np.float32))
        self.params: dict[str, torch.Tensor] = {}
        for name in TRI_FIELDS:
            cat = np.concatenate([getattr(m, name) for m in spec.meshes])
            self.params[f"tris.{name}"] = (half(cat) if f"tris.{name}" in HALF_LEAVES
                                           else f(cat, torch.float32))
        mats = spec.materials
        self.params["materials.albedo"] = f([m.albedo for m in mats])
        self.params["materials.specular"] = f([m.specular for m in mats])
        self.params["materials.shininess"] = f([m.shininess for m in mats])
        self.params["materials.roughness"] = f([m.roughness for m in mats])
        self.params["materials.transmission"] = f(np.zeros(len(mats)))
        baked = [_baked(t, dev) for t in spec.textures]
        self.tex_offset = np.concatenate([[0], np.cumsum([b.shape[0] for b in baked])[:-1]])
        self.params["atlas.texels"] = torch.cat(baked).to(dtype)
        self.params["instances.inverse_transform"] = f(np.stack(ref.geo.inverse), torch.float32)
        for p in self.params.values():
            p.requires_grad_(True)
        self.mesh_start = np.concatenate([[0], np.cumsum([m.count for m in spec.meshes])[:-1]])

    def __getitem__(self, k: str) -> torch.Tensor:
        return self.params[k]


def _transform(m, o, d):
    """Rays [3, n] through per-ray row-vector matrices m [n, 4, 4]."""
    mo = torch.stack([o[0] * m[:, 0, c] + o[1] * m[:, 1, c] + o[2] * m[:, 2, c] + m[:, 3, c]
                      for c in range(3)])
    md = torch.stack([d[0] * m[:, 0, c] + d[1] * m[:, 1, c] + d[2] * m[:, 2, c]
                      for c in range(3)])
    return mo, md


def _dot(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def _cross(a, b):
    return torch.stack([a[1] * b[2] - a[2] * b[1], a[2] * b[0] - a[0] * b[2],
                        a[0] * b[1] - a[1] * b[0]])


def _reflect(v, n):
    return v - n * (2.0 * _dot(n, v))[None]


def _max(x, c: float):
    return torch.maximum(x, x.new_full((), c))


def loss_and_grads(ref: Scene, pose, config: dict, target: torch.Tensor,
                   dtype=torch.float32, hit_scene: Scene | None = None
                   ) -> tuple[float, dict[str, torch.Tensor]]:
    """(loss, {leaf: gradient}) of the view ``pose`` against ``target``
    [H, W, 3]. The geometry (rays, the recompute of the hits, the next
    rays) is float32; ``dtype`` is the precision of the shading, the loss's
    image and their gradients (the control's bfloat16: in it the
    1M-triangle sphere's vertices collapse). ``hit_scene`` (default
    ``ref``) finds the hits."""
    w, h = int(config["width"]), int(config["height"])
    dev = ref.device
    lv = Leaves(ref, dtype)
    spec = ref.spec
    ys, xs = torch.meshgrid(torch.arange(h, device=dev), torch.arange(w, device=dev),
                            indexing="ij")
    origin, direction = camera.pixel_rays(pose, w, h, xs.reshape(-1).float(),
                                          ys.reshape(-1).float())
    n = origin.shape[1]
    sun = torch.tensor(float(config["sun_angle"]), dtype=torch.float32)
    light = torch.stack([torch.zeros(n, device=dev),
                         torch.full((n,), float(torch.sin(sun)), device=dev),
                         torch.full((n,), float(torch.cos(sun)), device=dev)])
    sd = lambda x: x.to(dtype)  # geometry to the shading's precision
    result = torch.zeros((3, n), device=dev, dtype=dtype)
    energy = torch.ones((3, n), device=dev, dtype=dtype)
    atm = torch.tensor([0.255, 0.25, 0.27], device=dev, dtype=dtype)[:, None].expand(3, n)
    alive = torch.ones(n, dtype=torch.bool, device=dev)
    inline = not ref.image_textures
    mesh_of = torch.tensor([i.mesh for i in spec.instances], device=dev)
    start_of = torch.as_tensor(lv.mesh_start, device=dev)
    mat_start = ref.mat_start
    tri_mat = torch.cat(ref.mat_local)
    alb_tex = ref.albedo_tex
    sky = spec.sky
    deferred = []
    for _b in range(int(config["bounces"])):
        with torch.no_grad():
            geo = (hit_scene or ref).geo
            hits = geo.closest(origin.detach().to(geo.dtype), direction.detach().to(geo.dtype))
        hit = hits.hit & alive
        inst = torch.where(hit, hits.instance, 0)
        # miss and dead lanes carry no triangle: pinned to the first one
        g = torch.where(hit, start_of[mesh_of[inst]] + hits.tri, 0)
        m = lv["instances.inverse_transform"][inst]
        o, d = _transform(m, origin, direction)
        v0, v1, v2 = (lv[f"tris.{k}"][g].T for k in ("v0", "v1", "v2"))
        e1, e2 = v1 - v0, v2 - v0
        hh = _cross(d, e2)
        f = 1.0 / _dot(e1, hh)
        s = o - v0
        u = f * _dot(s, hh)
        q = _cross(s, e1)
        v = f * _dot(d, q)
        t = f * _dot(e2, q)
        w0, su, sv = sd(1.0 - u - v), sd(u), sd(v)
        n_obj = torch.stack([lv["tris.n0"][g, c] * w0 + lv["tris.n1"][g, c] * su
                             + lv["tris.n2"][g, c] * sv for c in range(3)])
        uu = lv["tris.uv0"][g, 0] * w0 + lv["tris.uv1"][g, 0] * su + lv["tris.uv2"][g, 0] * sv
        vv = lv["tris.uv0"][g, 1] * w0 + lv["tris.uv1"][g, 1] * su + lv["tris.uv2"][g, 1] * sv
        t = torch.where(hit, t, torch.full_like(t, MISS))

        miss_now = alive & ~hit
        live = hit
        mat_id = mat_start[inst] + tri_mat[g]
        alb = lv["materials.albedo"][mat_id].T
        ms = sd(m)
        normal = torch.stack([n_obj[0] * ms[:, 0, c] + n_obj[1] * ms[:, 1, c]
                              + n_obj[2] * ms[:, 2, c] for c in range(3)])
        normal = normal / torch.sqrt(_dot(normal, normal))[None]
        tex_k = alb_tex[mat_id]
        if inline:
            sky_t = sd(ref.tex.sky(sky, direction.detach()) * U8)
            texel = torch.where(hit[None],
                                sd(ref.tex.sample(tex_k, uu.detach(), vv.detach()) * U8), sky_t)
            result = torch.where(miss_now[None], result + sky_t * energy, result)
            color = texel * alb
        else:
            idx = _pool_index(ref, lv, tex_k, uu.detach(), vv.detach())
            sky_idx = _sky_index(ref, lv, direction.detach())
            idx = torch.where(alive, torch.where(hit, idx, sky_idx), 0)
        point = o + d * t[None]
        new_origin = point + normal.float() * 0.01
        new_direction = _reflect(direction, normal.float())
        ndl_raw = _dot(normal, sd(-light))
        amb_m = _max(-ndl_raw, 0.1)
        ndl = _max(ndl_raw, 0.0)
        specular = torch.full_like(energy, 0.2) * (((1.0 - 0.5) * ndl * 1.0) * ndl)[None]
        refl_light = _reflect(sd(-light), normal)
        rdm = _max(_dot(refl_light, sd(d)), 0.0)
        spec_light = ndl * rdm * 0.2 * 1.0
        if inline:
            ambient = (atm * color) * amb_m[None]
            contrib = (energy * color) * (ndl * 1.0)[None] + ambient + spec_light[None]
            result = torch.where(live[None], result + contrib, result)
        else:
            dif = ndl * 1.0
            zero3 = torch.zeros_like(energy)
            f1 = torch.where(live[None], (energy * alb) * dif[None],
                             torch.where(miss_now[None], energy, zero3))
            f2 = torch.where(live[None], (atm * alb) * amb_m[None], zero3)
            deferred.append((idx, f1, f2))
            result = torch.where(live[None], result + spec_light[None], result)
        energy = torch.where(live[None], energy * specular, energy)
        atm = torch.where(live[None], atm * 0.4, atm)
        light = torch.where(live[None], new_direction, light)
        origin = torch.where(live[None], new_origin, origin)
        direction = torch.where(live[None], new_direction, direction)
        alive = live
    for idx, f1, f2 in deferred:
        tx = lv["atlas.texels"][idx].T
        result = result + tx * f1 + tx * f2
    img = result.T.reshape(h, w, 3)
    loss = torch.mean((img - target) ** 2)
    keys = list(lv.params)
    got = torch.autograd.grad(loss, [lv[k] for k in keys], allow_unused=True)
    grads = {k: torch.zeros_like(lv[k]) if gk is None else gk for k, gk in zip(keys, got)}
    # a leaf stored as IEEE half has a gradient of that type
    for k in HALF_LEAVES:
        grads[k] = grads[k].half().to(grads[k].dtype)
    return float(loss.detach()), grads


def _pool_index(ref: Scene, lv: Leaves, tex_k, uu, vv):
    """Flat index into ``atlas.texels`` of per-ray textures at (uu, vv)."""
    out = torch.zeros_like(tex_k)
    for k in torch.unique(tex_k).tolist():
        sel = tex_k == k
        i, j = ref.tex.texel_index(k, uu[sel], vv[sel])
        out[sel] = j.long() * ref.tex.size[k][0] + i.long() + int(lv.tex_offset[k])
    return out


def _sky_index(ref: Scene, lv: Leaves, d):
    """Flat index into ``atlas.texels`` of the skybox in directions d."""
    k = ref.spec.sky
    w, h = ref.tex.size[k]
    pi = torch.tensor(np.pi, dtype=d.dtype, device=d.device)
    theta = (torch.atan2(d[0], -d[2]) / pi * (0.5 * float(w))).to(torch.int32)
    phi = (torch.acos(torch.clamp(d[1], -1.0, 1.0)) / pi * float(h)).to(torch.int32)
    rel = torch.clamp(phi.long() * w + theta.long(), 0, w * h - 1)
    return rel + int(lv.tex_offset[k])
