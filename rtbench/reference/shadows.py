"""The reference frame with sun shadows: ``frame.Scene``'s two-bounce
Phong path tracer with one more ray on bounce 0, from each hit toward the
sun. The upstream declares the shadow factor and never applies it (its
README.md:11-15 lists shadows as to do), so the semantics are the JAX
package's (render_pallas.py:476-515), in the same order of operations:

- the shadow ray starts at the bounce's next origin, the offset
  object-space hit point that the upstream reuses as the next world origin
  (kernel_main.cl:246-253), and points at the sun, (0, -sin(sun),
  -cos(sun));
- it is occluded where the reference's own hit query (``hits.Geometry``)
  finds any hit with t > 0;
- an occluded hit multiplies its diffuse factor, its specular weight (and
  with it the next bounce's energy) and its specular light by 0, and keeps
  its ambient term.

The pick is ``frame.Scene``'s: no shadow ray.

Departures from the program that the cell's limits allow for: the program
walks the shadow ray in any-hit mode, which accepts exactly where a nearest
walk hits but for a grazing hit behind a box that a float slab test culls
(the frame rule of its kernels: at most 16 rays a frame); its triangle test
is not Möller–Trumbore, so a shadow ray through a shared edge or grazing a
face may pass in one and be blocked in the other.

Plain PyTorch; ``dtype`` is the precision of the geometry and shading (the
control computes in bfloat16). ``shadows`` False gives ``frame.Scene``'s
frame.
"""

from __future__ import annotations

import torch

from rtbench.reference import frame
from rtbench.reference.frame import U8, atm_table


class Scene(frame.Scene):
    """The reference's tables of a ``SceneSpec`` on a device, with the sun
    shadow ray on bounce 0 where ``shadows``."""

    def __init__(self, spec, device: torch.device, dtype=torch.float32,
                 shadows: bool = True) -> None:
        super().__init__(spec, device, dtype)
        self.shadows = shadows

    def radiance(self, o: torch.Tensor, d: torch.Tensor, sun_angle: float,
                 bounces: int, record: list | None = None,
                 occluders: list | None = None) -> torch.Tensor:
        """Linear radiance [3, n] of world rays o, d [3, n]. ``record`` as
        ``frame.Scene.radiance``'s; ``occluders``, a list, gets the
        (instance, triangle) that the reference's query finds nearest along
        each occluded shadow ray."""
        n = o.shape[1]
        dt, dev = self.dtype, self.device
        zero = torch.zeros(n, dtype=dt, device=dev)
        sun = torch.tensor(sun_angle, dtype=torch.float32)
        light = [zero, zero + float(torch.sin(sun)), zero + float(torch.cos(sun))]
        to_sun = torch.stack([zero, zero - float(torch.sin(sun)), zero - float(torch.cos(sun))])
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
            # the sun shadow on bounce 0, of the hits alone
            shadow = None
            if self.shadows and b == 0:
                sh = self.geo.closest(torch.stack(new_o)[:, live], to_sun[:, live])
                occ = torch.zeros(n, dtype=torch.bool, device=dev)
                occ[live] = sh.hit
                shadow = torch.where(occ, zero, zero + 1.0)
                if occluders is not None:
                    occluders.append((sh.instance[sh.hit], sh.tri[sh.hit]))
            alb = self.albedo[mat].T
            tex = self.tex.sample(torch.where(live, self.albedo_tex[mat], 0), uu, vv)
            color = [torch.floor(torch.round(torch.clamp(alb[c], 0.0, 1.0) * 255.0) * tex[c]
                                 * (1.0 / 256.0)) * U8 for c in range(3)]
            ndl_raw = nn[0] * (-light[0]) + nn[1] * (-light[1]) + nn[2] * (-light[2])
            amb_m = torch.clamp(-ndl_raw, min=0.1)
            ndl = torch.clamp(ndl_raw, min=0.0)
            spec_s = (0.5 * ndl) * ndl if shadow is None else ((0.5 * ndl) * shadow) * ndl
            rl = [(-light[c]) - nn[c] * (2.0 * ndl_raw) for c in range(3)]
            rdm = torch.clamp(rl[0] * md[0] + rl[1] * md[1] + rl[2] * md[2], min=0.0)
            spec_light = (ndl * rdm) * 0.2
            if shadow is not None:
                spec_light = spec_light * shadow
            dif = ndl if shadow is None else ndl * shadow
            ndd = nn[0] * d[0] + nn[1] * d[1] + nn[2] * d[2]
            for c in range(3):
                if self.image_textures:
                    # the texel joins after the loop: coefficient * colour
                    coef = energy[c] * dif + float(atm[b, c]) * amb_m
                    deferred.append(torch.where(live, coef * color[c], zero))
                    contrib = spec_light
                else:
                    contrib = ((energy[c] * color[c]) * dif
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
