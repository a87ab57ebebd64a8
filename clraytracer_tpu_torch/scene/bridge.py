"""Carrying a scene across: the port's ``Scene`` from the JAX package's
scene leaves, given as numpy arrays, plus its static fields as plain
Python values. No JAX is imported here; the caller flattens.

Keys are ``"<group>.<field>"`` with the field names both packages share
(``"tris.v0"``, ``"clusters.tri_a"``, ``"packed.inst_rows"``, ...); an
optional leaf that is None is simply absent from ``arrays``. Static keys
are ``"bvh.roots"``, ``"bvh.mesh_tri_start"``, ``"bvh.mesh_tri_count"``,
``"bvh.max_leaf_size"``, ``"instances.mesh_index"``,
``"clusters.mesh_ranges"``, ``"packed.skybox_w"``, ``"packed.skybox_h"``,
``"packed.skybox_off"``, ``"skybox_tex"`` and ``"procedural_tex"``: a
tuple of ``(handle, texel_offset, descriptor_fields)`` with the
descriptor's fields in ``ProceduralTexture`` order. Every leaf keeps its
layout and dtype (the kernels re-lay the cluster tables on first use).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping

import numpy as np
import torch

from clraytracer_tpu_torch.device import resolve_device
from clraytracer_tpu_torch.scene.procedural_tex import ProceduralTexture
from clraytracer_tpu_torch.scene.types import (
    BVH,
    Clusters,
    Instances,
    Materials,
    PackedTables,
    Scene,
    TextureAtlas,
    Triangles,
)

_GROUPS = {
    "tris": Triangles,
    "bvh": BVH,
    "materials": Materials,
    "atlas": TextureAtlas,
    "instances": Instances,
    "clusters": Clusters,
    "packed": PackedTables,
}


def _plain(v: Any) -> Any:
    """Nested lists/tuples → nested tuples of Python ints (hashable)."""
    if isinstance(v, (list, tuple)):
        return tuple(_plain(x) for x in v)
    if isinstance(v, np.generic):
        return v.item()
    return v


def scene_from_numpy(
    arrays: Mapping[str, np.ndarray],
    static: Mapping[str, Any],
    device: str | torch.device | None = None,
) -> Scene:
    """Build the port's Scene on ``device`` (None = the CUDA card)."""
    dev = resolve_device(device)
    groups = {}
    for name, cls in _GROUPS.items():
        kw = {}
        for f in dataclasses.fields(cls):
            key = f"{name}.{f.name}"
            if key in arrays:
                kw[f.name] = torch.from_numpy(np.array(arrays[key], copy=True))
            elif key in static:
                kw[f.name] = _plain(static[key])
        groups[name] = cls(**kw) if kw else None
    procedural = tuple(
        (int(h), int(off), ProceduralTexture(*_plain(tuple(fields))))
        for h, off, fields in static.get("procedural_tex", ())
    )
    scene = Scene(
        **groups,
        skybox_tex=int(static.get("skybox_tex", 2)),
        procedural_tex=procedural,
    )
    return scene.to(dev)
