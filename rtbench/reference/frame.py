"""The reference frame: the upstream's two-bounce Phong path tracer with
reference-parity integer colours (kernel_main.cl:183-287), its skybox
(MathAndSTL.cl:253-258) and its post chain (MathAndSTL.cl:143-169), at any
sample of a frame's pixels, and its mouse pick (CPURayTrace.cpp:186-249).

Plain PyTorch over the benchmark's own scene description: its own hit
query (``hits``), its own texture set (``textures``), its own camera
(``camera``). ``dtype`` is the precision of the geometry and shading (the
control computes in bfloat16).
"""

from __future__ import annotations

import numpy as np
import torch

from rtbench.reference import camera
from rtbench.reference.hits import Geometry
from rtbench.reference.textures import TextureSet

U8 = 1.0 / 255.0
MISS_DISTANCE = 1e30


def atm_table(bounces: int) -> np.ndarray:
    """[0.255, 0.25, 0.27] * 0.4^b by iterated f32 multiplies."""
    atm = np.asarray([0.255, 0.25, 0.27], np.float32)
    out = []
    for _ in range(bounces):
        out.append(atm)
        atm = atm * np.float32(0.4)
    return np.stack(out)


class Scene:
    """The reference's tables of a ``SceneSpec`` on a device."""

    def __init__(self, spec, device: torch.device, dtype=torch.float32) -> None:
        self.spec = spec
        self.dtype = dtype
        self.device = device
        self.geo = Geometry(spec, device, dtype)
        self.tex = TextureSet(spec.textures, device)
        half = lambda a: torch.as_tensor(
            np.asarray(a, np.float32).astype(np.float16).astype(np.float32)).to(device, dtype)
        # attributes stored as IEEE half, the upstream's vertex format
        self.normals = [torch.stack([half(m.n0), half(m.n1), half(m.n2)]) for m in spec.meshes]
        self.uvs = [torch.stack([half(m.uv0), half(m.uv1), half(m.uv2)]) for m in spec.meshes]
        self.mat_local = [torch.as_tensor(m.mat).to(device).long() for m in spec.meshes]
        self.albedo = torch.tensor([m.albedo for m in spec.materials], dtype=dtype, device=device)
        self.albedo_tex = torch.tensor([m.albedo_tex for m in spec.materials], device=device)
        self.mat_start = torch.tensor([i.material_start for i in spec.instances], device=device)
        self.image_textures = any(t.image is not None for t in spec.textures)

    def set_transform(self, instance: int, transform: np.ndarray) -> None:
        self.geo.set_transform(instance, transform)

    def inverse(self) -> torch.Tensor:
        """[I, 4, 4] inverse transforms."""
        return torch.as_tensor(np.stack(self.geo.inverse), dtype=self.dtype, device=self.device)

    def surface(self, hits):
        """Per hit ray: object-space normal [3, n], uu, vv, material [n]."""
        n = hits.t.shape[0]
        nrm = torch.zeros((3, n), dtype=self.dtype, device=self.device)
        uu = torch.zeros(n, dtype=self.dtype, device=self.device)
        vv = torch.zeros_like(uu)
        mat = torch.zeros(n, dtype=torch.long, device=self.device)
        hit = hits.hit
        w0 = 1.0 - hits.u - hits.v
        for k, ins in enumerate(self.spec.instances):
            sel = hit & (hits.instance == k)
            j = hits.tri[sel]
            a, b, c = w0[sel], hits.u[sel], hits.v[sel]
            nn, uv = self.normals[ins.mesh], self.uvs[ins.mesh]
            nrm[:, sel] = (nn[0][j] * a[:, None] + nn[1][j] * b[:, None] + nn[2][j] * c[:, None]).T
            uu[sel] = uv[0][j, 0] * a + uv[1][j, 0] * b + uv[2][j, 0] * c
            vv[sel] = uv[0][j, 1] * a + uv[1][j, 1] * b + uv[2][j, 1] * c
            mat[sel] = self.mat_start[k] + self.mat_local[ins.mesh][j]
        return nrm, uu, vv, mat

    def radiance(self, o: torch.Tensor, d: torch.Tensor, sun_angle: float,
                 bounces: int, record: list | None = None) -> torch.Tensor:
        """Linear radiance [3, n] of world rays o, d [3, n]. ``record``, a
        list, gets each bounce's shaded hits: (instance, triangle,
        material, uu, vv) of the rays that hit."""
        n = o.shape[1]
        dt, dev = self.dtype, self.device
        zero = torch.zeros(n, dtype=dt, device=dev)
        sun = torch.tensor(sun_angle, dtype=torch.float32)
        light = [zero, zero + float(torch.sin(sun)), zero + float(torch.cos(sun))]
        result = [zero, zero, zero]
        energy = [zero + 1.0, zero + 1.0, zero + 1.0]
        men = [zero, zero, zero]
        mdir = [zero, zero, zero]
        alive = torch.ones(n, dtype=torch.bool, device=dev)
        o, d = list(o), list(d)
        atm = atm_table(bounces)
        inverse = self.inverse()
        deferred = []
        for b in range(bounces):
            hits = self.geo.closest(torch.stack(o), torch.stack(d))
            t = torch.where(hits.hit, hits.t, zero)
            live = alive & hits.hit
            miss_now = alive & ~hits.hit
            for c in range(3):
                men[c] = torch.where(miss_now, energy[c], men[c])
                mdir[c] = torch.where(miss_now, d[c], mdir[c])
            n_obj, uu, vv, mat = self.surface(hits)
            if record is not None:
                record.append(tuple(x[live] for x in (hits.instance, hits.tri, mat, uu, vv)))
            m = inverse[hits.instance].reshape(n, 16).T  # [16, n]
            nw = [n_obj[0] * m[c] + n_obj[1] * m[4 + c] + n_obj[2] * m[8 + c] for c in range(3)]
            mo = [o[0] * m[c] + o[1] * m[4 + c] + o[2] * m[8 + c] + m[12 + c] for c in range(3)]
            md = [d[0] * m[c] + d[1] * m[4 + c] + d[2] * m[8 + c] for c in range(3)]
            s = torch.sqrt(nw[0] * nw[0] + nw[1] * nw[1] + nw[2] * nw[2])
            s = torch.where(live, s, zero + 1.0)
            nn = [nw[0] / s, nw[1] / s, nw[2] / s]
            new_o = [(mo[c] + md[c] * t) + nn[c] * 0.01 for c in range(3)]
            alb = self.albedo[mat].T
            tex = self.tex.sample(torch.where(live, self.albedo_tex[mat], 0), uu, vv)
            color = [torch.floor(torch.round(torch.clamp(alb[c], 0.0, 1.0) * 255.0) * tex[c]
                                 * (1.0 / 256.0)) * U8 for c in range(3)]
            ndl_raw = nn[0] * (-light[0]) + nn[1] * (-light[1]) + nn[2] * (-light[2])
            amb_m = torch.clamp(-ndl_raw, min=0.1)
            ndl = torch.clamp(ndl_raw, min=0.0)
            spec_s = (0.5 * ndl) * ndl
            rl = [(-light[c]) - nn[c] * (2.0 * ndl_raw) for c in range(3)]
            rdm = torch.clamp(rl[0] * md[0] + rl[1] * md[1] + rl[2] * md[2], min=0.0)
            spec_light = (ndl * rdm) * 0.2
            ndd = nn[0] * d[0] + nn[1] * d[1] + nn[2] * d[2]
            for c in range(3):
                if self.image_textures:
                    # the texel joins after the loop: coefficient * colour
                    coef = energy[c] * ndl + float(atm[b, c]) * amb_m
                    deferred.append(torch.where(live, coef * color[c], zero))
                    contrib = spec_light
                else:
                    contrib = ((energy[c] * color[c]) * ndl
                               + (float(atm[b, c]) * color[c]) * amb_m) + spec_light
                result[c] = torch.where(live, result[c] + contrib, result[c])
                energy[c] = torch.where(live, energy[c] * (0.2 * spec_s), energy[c])
                new_d = d[c] - nn[c] * (2.0 * ndd)
                o[c] = torch.where(live, new_o[c], o[c])
                d[c] = torch.where(live, new_d, d[c])
                light[c] = torch.where(live, new_d, light[c])
            alive = live
        res = torch.stack(result)
        for b in range(len(deferred) // 3):
            res = res + torch.stack(deferred[3 * b:3 * b + 3])
        sky = self.tex.sky(self.spec.sky, torch.stack(mdir)) * U8
        return res + sky * torch.stack(men)

    def frame_pixels(self, pose, config: dict, px: torch.Tensor, py: torch.Tensor) -> torch.Tensor:
        """The post-processed colours [n, 3] of pixels (px, py) of the frame
        at ``pose``."""
        w, h = int(config["width"]), int(config["height"])
        o, d = camera.pixel_rays(pose, w, h, px, py, self.dtype)
        p = self.radiance(o, d, float(config["sun_angle"]), int(config["bounces"]))
        return post(p, px, py, w, h).T

    def pick(self, pose, config: dict, x: float, y: float) -> dict:
        """The hit record of the mouse point (x, y): host numpy values."""
        o, d = camera.pick_ray(pose, int(config["width"]), int(config["height"]), x, y)
        o = torch.as_tensor(o, dtype=self.dtype, device=self.device)[:, None]
        d = torch.as_tensor(d, dtype=self.dtype, device=self.device)[:, None]
        hits = self.geo.closest(o, d)
        n_obj, uu, vv, mat = self.surface(hits)
        m = self.inverse()[hits.instance].reshape(1, 16).T
        nw = torch.stack([n_obj[0] * m[c] + n_obj[1] * m[4 + c] + n_obj[2] * m[8 + c]
                          for c in range(3)])
        normal = nw / torch.sqrt((nw * nw).sum(0))
        tex = self.tex.sample(self.albedo_tex[mat], uu, vv)
        alb = self.albedo[mat].T
        color = torch.floor(torch.round(torch.clamp(alb, 0.0, 1.0) * 255.0) * tex
                            * (1.0 / 256.0)) * U8
        hit = bool(hits.hit[0])
        f = lambda a: a.float().cpu().numpy()
        return dict(hit=hit, instance=int(hits.instance[0]),
                    distance=float(hits.t[0]) if hit else MISS_DISTANCE,
                    normal=f(normal[:, 0]), uv=f(torch.stack([uu, vv])[:, 0]), color=f(color[:, 0]))


def post(p: torch.Tensor, px: torch.Tensor, py: torch.Tensor, w: int, h: int) -> torch.Tensor:
    """Saturation, Reinhard (max white 0.8), the merged gamma pow and the
    vignette over radiance [3, n] at pixels (px, py)."""
    piv = torch.sqrt(p[0] * p[0] * 0.299 + p[1] * p[1] * 0.587 + p[2] * p[2] * 0.114)
    p = piv[None] + (p - piv[None]) * 1.2
    l_old = p[0] * 0.2126 + p[1] * 0.7152 + p[2] * 0.0722
    l_new = l_old * (1.0 + l_old / torch.tensor(0.8 * 0.8, dtype=p.dtype, device=p.device)) / (
        1.0 + l_old)
    p = p * (l_new / torch.where(l_old == 0.0, torch.ones_like(l_old), l_old))[None]
    p = torch.pow(torch.clamp(p, min=0.0), 1.0 / (1.55 * 1.2))
    s15 = torch.sqrt(torch.tensor(15.0, dtype=torch.float32)).item()

    def factor(x, size):
        x = x.to(p.dtype) / torch.tensor(float(size), dtype=p.dtype, device=p.device)
        return torch.pow(torch.clamp(x * (1.0 - x) * s15, min=0.0), 0.15)

    return p * (factor(px, w) * factor(py, h))[None]


def sample_pixels(seed: int, n: int, width: int, height: int, device) -> tuple:
    """``n`` distinct pixels (px, py) drawn from ``seed``."""
    g = np.random.default_rng([seed, 7])
    idx = g.choice(width * height, size=min(n, width * height), replace=False)
    t = torch.as_tensor(idx, device=device)
    return (t % width).float(), torch.div(t, width, rounding_mode="floor").float()

