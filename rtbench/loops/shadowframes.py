"""The editor's frame loop with sun shadows: ``frames``' loop, window,
samples and control, compared with the reference frame that walks the sun
shadow ray (``reference.shadows``), switched by the configuration's
``render.enable_shadows`` as the program's ``RenderConfig`` is.

``frames`` builds its reference where it compares, from
``rtbench.reference.frame.Scene``, and counts a traced run's bytes through
``rtbench.roofline.frame_bytes``; while this loop runs, both names stand for
the shadowed ones. The traced run's count (``shadow_frame_bytes`` in the
context, read by ``frame_roofline.shadows``) adds each distinct triangle
that the reference's shadow rays hit to ``roofline``'s: an occluder is read
as a triangle, and adds no material row and no texel.
"""

from __future__ import annotations

import contextlib
import functools

import torch

from rtbench import roofline
from rtbench.loops import Outcome, Run, frames
from rtbench.reference import camera
from rtbench.reference import frame as frame_ref
from rtbench.reference import shadows as shadow_ref


def shadows_on(config: dict) -> bool:
    return bool(config.get("render", {}).get("enable_shadows", False))


def frame_bytes(ref, config: dict, poses: list, transforms: list, instance: int,
                n_frames: int = 4) -> float:
    """``roofline.frame_bytes`` through the shadowed reference ``ref``, with
    the distinct triangles its shadow rays hit counted once each with the
    frame's others, at ``roofline.TRIANGLE_BYTES``."""
    w, h = int(config["width"]), int(config["height"])
    dev = ref.device
    ys, xs = torch.meshgrid(torch.arange(0, h, roofline.STRIDE, device=dev),
                            torch.arange(0, w, roofline.STRIDE, device=dev), indexing="ij")
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

    tri_key = lambda inst, tri: inst.long() * (1 << 40) + tri.long()
    total = 0
    picks = [round(q * (len(poses) - 1) / max(1, n_frames - 1)) for q in range(n_frames)]
    for q in picks:
        ref.set_transform(instance, transforms[q])
        o, d = camera.pixel_rays(poses[q], w, h, px, py, ref.dtype)
        records, occluders = [], []
        ref.radiance(o, d, float(config["sun_angle"]), int(config["bounces"]), records,
                     occluders)
        hit = torch.cat([tri_key(r[0], r[1]) for r in records])
        occ = torch.cat([tri_key(*x) for x in occluders]) if occluders else hit[:0]
        added = torch.unique(torch.cat([hit, occ])).numel() - torch.unique(hit).numel()
        total += (roofline.counted_bytes(w, h, records, texel_key)
                  + roofline.TRIANGLE_BYTES * int(added))
    return total / len(picks)


@contextlib.contextmanager
def shadowed(config: dict, counted: dict):
    """``frames``' reference and byte count, shadowed as ``config`` says,
    while the block runs; the count it makes goes into ``counted``."""
    scene, count = frame_ref.Scene, roofline.frame_bytes

    def bytes_of(*args, **kwargs):
        counted["shadow_frame_bytes"] = frame_bytes(*args, **kwargs)
        return counted["shadow_frame_bytes"]

    frame_ref.Scene = functools.partial(shadow_ref.Scene, shadows=shadows_on(config))
    roofline.frame_bytes = bytes_of
    try:
        yield
    finally:
        frame_ref.Scene, roofline.frame_bytes = scene, count


def measure(run: Run) -> Outcome:
    counted = {}
    with shadowed(run.config, counted):
        out = frames.measure(run)
    out.context.update(counted)
    return out


def control(run: Run, low=torch.bfloat16) -> dict:
    with shadowed(run.config, {}):
        return frames.control(run, low)
