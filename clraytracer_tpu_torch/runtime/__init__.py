"""Native code: the g++ BVH builder and the nvcc-built CUDA kernels."""

from clraytracer_tpu_torch.runtime.build import native_available, native_lib  # noqa: F401
