"""Frame operations: traversal (K2.1), the fused frame (K2.2), skybox and
post chain, each kernel beside its plain PyTorch version."""
