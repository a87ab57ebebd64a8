"""The frame's bandwidth roofline: the bytes that a frame's inputs need,
counted from what the frame samples, never from the program's own counters,
so the count is the same whatever implements the frame.

Counted once each: the image written ([H, W, 3] f32), the camera's inputs,
the distinct triangles the frame's rays hit (vertices and attributes as
the scene's inputs hold them), their materials' rows and the image texels
the hits sample. Left out: any acceleration structure and intermediate
plane, choices of an implementation, and an operations side, which a ray
tracer's acceleration structure sets. The hits come from the reference's
own hit query on a fixed strided sample of the rays, which can only count
fewer of them: the share reads low, never high.
"""

from __future__ import annotations

import torch

#: H100 SXM HBM3 bandwidth (NVIDIA's data sheet), bytes/s
PEAK_BYTES_PER_S = 3.35e12
#: bytes of one triangle as the scene's inputs hold it: 3 f32 positions,
#: 3 IEEE-half normals and uvs, an i32 material index
TRIANGLE_BYTES = 3 * 3 * 4 + 3 * 3 * 2 + 3 * 2 * 2 + 4
#: a material row the frame reads: f32 albedo and a texture handle
MATERIAL_BYTES = 3 * 4 + 4
#: an RGB8 texel
TEXEL_BYTES = 3
#: inverse view and projection [4, 4] f32, position [3] and sun angle f32
CAMERA_BYTES = (16 + 16 + 3 + 1) * 4
#: the sample: every STRIDE-th pixel in x and in y
STRIDE = 8


def counted_bytes(width: int, height: int, records: list, texel_key) -> int:
    """Bytes of one frame from its ``records`` (per bounce: instance,
    triangle, material, uu, vv of the rays that hit; ``Scene.radiance``).
    ``texel_key(material, uu, vv)`` gives each hit's image texel as a
    unique integer key, -1 where the texture is not an image."""
    tris, mats, texels = [], [], []
    for inst, tri, mat, uu, vv in records:
        tris.append(inst.long() * (1 << 40) + tri.long())
        mats.append(mat.long())
        texels.append(texel_key(mat, uu, vv))
    cat = lambda xs: torch.cat(xs) if xs else torch.zeros(0, dtype=torch.long)
    n_tris = int(torch.unique(cat(tris)).numel())
    n_mats = int(torch.unique(cat(mats)).numel())
    tk = torch.unique(cat(texels))
    n_texels = int((tk >= 0).sum())
    return (width * height * 3 * 4 + CAMERA_BYTES + TRIANGLE_BYTES * n_tris
            + MATERIAL_BYTES * n_mats + TEXEL_BYTES * n_texels)


def frame_bytes(ref, config: dict, poses: list, transforms: list, instance: int,
                frames: int = 4) -> float:
    """The mean counted bytes of ``frames`` of the traced poses, evenly
    spaced, through the reference ``ref`` (``reference.frame.Scene``)."""
    from rtbench.reference import camera

    w, h = int(config["width"]), int(config["height"])
    dev = ref.device
    ys, xs = torch.meshgrid(torch.arange(0, h, STRIDE, device=dev),
                            torch.arange(0, w, STRIDE, device=dev), indexing="ij")
    px, py = xs.reshape(-1).float(), ys.reshape(-1).float()
    tex = ref.tex

    def texel_key(mat, uu, vv):
        k = ref.albedo_tex[mat]
        key = torch.full_like(k, -1)
        for t in torch.unique(k).tolist():
            if tex.textures[t].image is None:
                continue
            sel = k == t
            i, j = tex.texel_index(t, uu[sel], vv[sel])
            key[sel] = tex.offset[t] + j.long() * tex.size[t][0] + i.long()
        return key

    total = 0
    picks = [round(q * (len(poses) - 1) / max(1, frames - 1)) for q in range(frames)]
    for q in picks:
        ref.set_transform(instance, transforms[q])
        o, d = camera.pixel_rays(poses[q], w, h, px, py, ref.dtype)
        records: list = []
        ref.radiance(o, d, float(config["sun_angle"]), int(config["bounces"]), records)
        total += counted_bytes(w, h, records, texel_key)
    return total / len(picks)
