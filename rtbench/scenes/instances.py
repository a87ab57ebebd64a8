"""The upstream's instance pool full: the museum's three meshes, 42
materials and 45 maps (``scenes/museum.py``), with the atrium and the
gallery at the museum's offsets and the figure registered 399 times, a
crowd on a grid over the atrium's floor: 401 instances, the upstream's
``MaxNumInstances`` (Renderer.hpp:16), 15,922,160 instanced triangles."""

from __future__ import annotations

import math

import numpy as np

from rtbench.scenes import museum
from rtbench.scenes.spec import Instance, SceneSpec, rotation_y, translation


def build(config: dict, seed: int) -> SceneSpec:
    """The scene of ``config``; the maps' contents come from ``seed``, the
    geometry, the crowd and every size from ``config``."""
    crowd = config["crowd"]
    # the museum's build with the figure at the origin: its mesh and its
    # material block, one instance of it, which the crowd replaces
    spec = museum.build(dict(config, offsets={**config["offsets"], crowd["mesh"]: [0.0] * 3}),
                        seed)
    figure = spec.instances.pop(config["meshes"].index(crowd["mesh"]))
    step = float(crowd["spacing"])
    for j in range(int(crowd["rows"])):
        for i in range(int(crowd["columns"])):
            k = len(spec.instances)
            turn = rotation_y(math.radians(float(crowd["turn_deg"]) * k))
            at = translation(float(crowd["x0"]) + step * i, float(crowd["y"]),
                             float(crowd["z0"]) + step * j)
            spec.instances.append(Instance(mesh=figure.mesh,
                                           transform=(turn @ at).astype(np.float32),
                                           material_start=figure.material_start))
    return spec
