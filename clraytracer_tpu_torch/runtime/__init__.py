"""Native code: the g++ BVH builder and the nvcc-built CUDA kernels."""
