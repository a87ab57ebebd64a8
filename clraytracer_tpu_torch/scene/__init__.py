"""Scene layer: tensor dataclasses, the procedural SceneBuilder, and the
bridge that carries a scene across from the JAX package's arrays."""

from clraytracer_tpu_torch.scene.types import (  # noqa: F401
    BVH,
    Instances,
    Materials,
    Scene,
    TextureAtlas,
    Triangles,
)
from clraytracer_tpu_torch.scene.builder import SceneBuilder  # noqa: F401
