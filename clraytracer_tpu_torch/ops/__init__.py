"""Frame operations: traversal (K2.1), the fused frame (K2.2), the row
gather and scatter of the differentiable step (K2.3, K2.4), shading,
planar vector math, skybox and post chain, each kernel beside its plain
PyTorch version."""

from clraytracer_tpu_torch.ops.intersect import intersect_aabb, intersect_tris  # noqa: F401
from clraytracer_tpu_torch.ops.shade import sample_skybox, sample_texture, shade_hits  # noqa: F401
from clraytracer_tpu_torch.ops.post import post_process  # noqa: F401
