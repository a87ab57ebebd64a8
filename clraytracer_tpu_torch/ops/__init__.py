"""Frame operations: traversal (K2.1), the fused frame (K2.2), the row
gather and scatter of the differentiable step (K2.3, K2.4), shading,
planar vector math, skybox and post chain, each kernel beside its plain
PyTorch version."""
