"""The museum-class interior: three meshes of 161,360 triangles, 42
materials and 45 RGB8 maps imported as images, under the procedural sky,
built in memory from the seed (the JAX package's ``museum`` scene, cli.py:75-94,
with its assets replaced by ``geometry.museum_meshes``)."""

from __future__ import annotations

import numpy as np

from rtbench.scenes import geometry
from rtbench.scenes.spec import Instance, Material, SceneSpec, Texture, base_spec, translation


def build(config: dict, seed: int) -> SceneSpec:
    """The scene of ``config``; the maps' contents come from ``seed``, the
    geometry and every size from ``config``."""
    size = int(config["texture_size"])
    spec = base_spec(int(config["texture_pool"]), tuple(config["sky_size"]))
    meshes = geometry.museum_meshes()
    k = 0
    for name in config["meshes"]:
        mesh = meshes[name]
        start = len(spec.materials)
        for _ in range(int(mesh.mat.max()) + 1):
            k += 1
            spec.textures.append(Texture(image=geometry.museum_texture([seed, k], size)))
            albedo_tex = len(spec.textures) - 1
            specular_tex = 0
            if k % 14 == 0:
                spec.textures.append(Texture(image=geometry.museum_texture([seed, 1000 + k], size)))
                specular_tex = len(spec.textures) - 1
            # the MTL the reference's importer reads: Kd, Ks 0.5, Ns -> /50, d -> roughness
            spec.materials.append(Material(
                albedo=(float(np.float32(0.5 + 0.5 * (k % 3) / 2)), 0.9, 0.8),
                specular=(0.5, 0.5, 0.5), albedo_tex=albedo_tex, specular_tex=specular_tex,
                shininess=min(20 + k % 60, 100) / 50.0, roughness=0.6))
        spec.meshes.append(mesh)
        spec.instances.append(Instance(mesh=len(spec.meshes) - 1,
                                       transform=translation(*config["offsets"][name]),
                                       material_start=start))
    return spec
