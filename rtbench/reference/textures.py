# Frozen copy of clraytracer_tpu_torch/scene/procedural_tex.py (_eval) at commit c1cdb28.
"""The reference's textures: the closed-form procedural texels, and the
point samples of image and procedural textures from the benchmark's own
texture list, each texture held by itself (no shared pool)."""

from __future__ import annotations

import math

import torch


def eval_procedural(desc: dict, i: torch.Tensor, j: torch.Tensor) -> torch.Tensor:
    """Byte values [3, *S] f32 at integer texel coords (f32 tensors of
    exact integers)."""
    if desc["kind"] == "constant":
        return torch.stack([torch.full_like(i, float(c)) for c in desc["rgb0"]])
    if desc["kind"] == "checker":
        ratio = float(desc["cells"]) / float(desc["width"])
        ci = torch.floor(i * ratio)
        cj = torch.floor(j * ratio)
        odd = torch.floor((ci + cj) * 0.5) * 2.0 != (ci + cj)
        return torch.stack([
            torch.where(odd, float(desc["rgb1"][c]), float(desc["rgb0"][c])) for c in range(3)])
    if desc["kind"] == "sky_gradient":
        half = float(desc["height"] // 2)
        upper = j < half
        jj = torch.clamp(j, max=half - 1.0)
        out = []
        for c in range(3):
            z, h = float(desc["rgb0"][c]), float(desc["rgb1"][c])
            grad = torch.floor((z * (half - jj) + h * jj) * (1.0 / half))
            out.append(torch.where(upper, grad, float(desc["ground"][c])))
        ci, cj = desc["sun_center"]
        dx = i - float(ci)
        dy = j - float(cj)
        sun = dx * dx + dy * dy < float(desc["sun_radius"] ** 2)
        return torch.stack([torch.where(sun, 255.0, ch) for ch in out])
    raise ValueError(f"unknown procedural texture kind: {desc['kind']}")


class TextureSet:
    """The scene's textures on a device: image bytes in one flat [N, 3] f32
    tensor of byte values, each texture at its own offset, and the
    procedural descriptors."""

    def __init__(self, textures, device: torch.device) -> None:
        self.textures = textures
        self.size = [t.size for t in textures]
        offs, chunks, at = [], [], 0
        for t in textures:
            offs.append(at)
            if t.image is not None:
                chunks.append(torch.as_tensor(t.image.reshape(-1, 3)))
                at += chunks[-1].shape[0]
        self.offset = offs
        self.bytes = (torch.cat(chunks).to(device=device, dtype=torch.float32) if chunks
                      else torch.zeros((1, 3), device=device))
        self.device = device

    def texel_index(self, k: int, uu: torch.Tensor, vv: torch.Tensor):
        """(i, j) f32 texel coordinates of a point sample at (uu, vv) of
        texture ``k``: wrap, scale, truncate (MathAndSTL.cl:262-264)."""
        w, h = self.size[k]
        i = ((uu - torch.floor(uu)) * float(w)).to(torch.int32).to(torch.float32)
        j = ((vv - torch.floor(vv)) * float(h)).to(torch.int32).to(torch.float32)
        return i, j

    def fetch(self, k: int, i: torch.Tensor, j: torch.Tensor) -> torch.Tensor:
        """Byte values [3, *S] of texture ``k`` at integer (i, j)."""
        t = self.textures[k]
        if t.procedural is not None:
            return eval_procedural(t.procedural, i, j)
        w, _h = self.size[k]
        idx = j.long() * w + i.long() + self.offset[k]
        return self.bytes[idx.reshape(-1)].T.reshape((3,) + tuple(i.shape))

    def sample(self, tex: torch.Tensor, uu: torch.Tensor, vv: torch.Tensor) -> torch.Tensor:
        """Byte values [3, n] of per-ray textures ``tex`` [n] at (uu, vv)."""
        out = torch.zeros((3,) + tuple(uu.shape), device=uu.device)
        for k in torch.unique(tex).tolist():
            sel = tex == k
            i, j = self.texel_index(k, uu[sel], vv[sel])
            out[:, sel] = self.fetch(k, i, j)
        return out

    def sky(self, k: int, d: torch.Tensor) -> torch.Tensor:
        """Byte values [3, n] of the equirect skybox ``k`` in directions
        ``d`` [3, n] (MathAndSTL.cl:253-258), rows clamped to the map."""
        w, h = self.size[k]
        pi = torch.tensor(math.pi, dtype=d.dtype, device=d.device)
        theta = (torch.atan2(d[0], -d[2]) / pi * (0.5 * float(w))).to(torch.int32)
        phi = (torch.acos(torch.clamp(d[1], -1.0, 1.0)) / pi * float(h)).to(torch.int32)
        rel = phi * w + theta
        i = torch.remainder(rel, w).to(torch.float32)
        j = torch.clamp(torch.div(rel, w, rounding_mode="floor"), 0, h - 1).to(torch.float32)
        return self.fetch(k, i, j)
