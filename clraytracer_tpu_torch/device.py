"""Device selection for the package's public entry points.

``device=None`` means the CUDA card. Asking for CUDA where there is none
raises: nothing falls back to the CPU unless the caller passes
``device="cpu"`` (the tests do).
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain "
            "PyTorch versions on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def const(value: float, like: torch.Tensor) -> torch.Tensor:
    """A 0-dim f32 tensor on ``like``'s device. Dividing by it is an IEEE
    division on every device; dividing a CUDA tensor by a Python float is
    computed as a product with the reciprocal, which can differ by one ulp.
    Made by a fill on the device: a copy from host memory would wait for
    the stream to drain."""
    return torch.full((), value, dtype=torch.float32, device=like.device)
