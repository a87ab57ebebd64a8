"""The checkered uv-sphere of the JAX bench matrix's ``1M-tri`` row
(bench.py:281-288): one instance of a radius-2 sphere of ``n_lat`` x
``2 n_lat`` quads under the procedural sky, its one material on a
procedural checker."""

from __future__ import annotations

import numpy as np

from rtbench.scenes import geometry
from rtbench.scenes.spec import Instance, Material, SceneSpec, Texture, base_spec, checker


def build(config: dict, seed: int) -> SceneSpec:
    """The scene of ``config``; nothing in it depends on ``seed``."""
    del seed
    n_lat = int(config["n_lat"])
    spec = base_spec(int(config["texture_pool"]), tuple(config["sky_size"]))
    spec.textures.append(Texture(procedural=checker(*config["checker"])))
    spec.materials.append(Material(albedo=(0.9, 0.6, 0.3), albedo_tex=len(spec.textures) - 1,
                                   shininess=1.0, roughness=0.4))
    spec.meshes.append(geometry.uv_sphere(float(config["radius"]), n_lat, 2 * n_lat))
    spec.instances.append(Instance(mesh=0, transform=np.eye(4, dtype=np.float32),
                                   material_start=1))
    return spec
