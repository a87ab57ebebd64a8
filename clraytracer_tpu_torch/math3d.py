"""Vector and matrix math and colour packing (the JAX package's
``math3d.py``).

The same conventions as the reference's math library (Math/Matrix.hpp):
``[4, 4]`` row-major matrices with the row-vector convention
``transform(v, M) == v @ M``. The functions the JAX package writes in
``jnp`` take tensors here; those that build host matrices take and return
numpy, as there.
"""

from __future__ import annotations

import numpy as np
import torch

# ---------------------------------------------------------------------------
# vectors ([..., 3] tensors)
# ---------------------------------------------------------------------------


def normalize(v: torch.Tensor, dim: int = -1, eps: float = 0.0) -> torch.Tensor:
    """L2-normalise; with ``eps=0`` the reference's raw rsqrt normalise."""
    return v / torch.sqrt(torch.sum(v * v, dim=dim, keepdim=True) + eps)


def dot(a: torch.Tensor, b: torch.Tensor, dim: int = -1, keepdim: bool = False) -> torch.Tensor:
    return torch.sum(a * b, dim=dim, keepdim=keepdim)


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.linalg.cross(a, b, dim=-1)


def reflect(v: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """Mirror reflection (reference MathAndSTL.cl:117-119)."""
    return v - n * dot(n, v, keepdim=True) * 2.0


# ---------------------------------------------------------------------------
# matrices (row-vector convention: p' = p @ M), as explicit sums of
# products like the JAX package's
# ---------------------------------------------------------------------------


def matvec(v: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """Row-vector transform ``v @ m`` for [..., K] x [..., K, N]."""
    return torch.sum(v[..., :, None] * m, dim=-2)


def transform_point(p: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """A position (w = 1): reference MatMul(m, (p, 1)).xyz."""
    return matvec(p, m[..., :3, :3]) + m[..., 3, :3]


def transform_vector(v: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """A direction (w = 0): reference MatMul(m, (v, 0)).xyz."""
    return matvec(v, m[..., :3, :3])


def transform_h(v: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """Full homogeneous transform ``v @ M``."""
    return matvec(v, m)


def inverse(m: torch.Tensor) -> torch.Tensor:
    """General 4x4 inverse (reference Matrix.hpp:292-431)."""
    return torch.linalg.inv(m)


def perspective_fov_rh(
    fov_rad: float, width: float, height: float, z_near: float, z_far: float
) -> np.ndarray:
    """Right-handed perspective projection (reference Matrix.hpp:237-252)."""
    h = np.cos(0.5 * fov_rad) / np.sin(0.5 * fov_rad)
    w = h * height / width
    m = np.zeros((4, 4), np.float32)
    m[0, 0] = w
    m[1, 1] = h
    m[2, 2] = -(z_far + z_near) / (z_far - z_near)
    m[2, 3] = -1.0
    m[3, 2] = -(2.0 * z_far * z_near) / (z_far - z_near)
    return m


def look_at_rh(eye: np.ndarray, front: np.ndarray, up: np.ndarray) -> np.ndarray:
    """Right-handed view matrix (reference Matrix.hpp:211-235); ``front``
    must be normalized."""
    eye = np.asarray(eye, np.float32)
    eye_dir = -np.asarray(front, np.float32)
    r0 = np.cross(np.asarray(up, np.float32), eye_dir)
    r0 /= np.linalg.norm(r0)
    r1 = np.cross(eye_dir, r0)
    r1 /= np.linalg.norm(r1)
    m_pre = np.zeros((4, 4), np.float32)
    m_pre[0, :3] = r0
    m_pre[0, 3] = np.dot(r0, -eye)
    m_pre[1, :3] = r1
    m_pre[1, 3] = np.dot(r1, -eye)
    m_pre[2, :3] = eye_dir
    m_pre[2, 3] = np.dot(eye_dir, -eye)
    m_pre[3, 3] = 1.0
    return m_pre.T.copy()


def translation(x: float, y: float, z: float) -> np.ndarray:
    m = np.eye(4, dtype=np.float32)
    m[3, :3] = (x, y, z)  # row-vector convention: translation in last row
    return m


def scale_matrix(sx: float, sy: float, sz: float) -> np.ndarray:
    return np.diag(np.array([sx, sy, sz, 1.0], np.float32))


def rotation_y(angle_rad: float) -> np.ndarray:
    """Rotation about +Y for the row-vector convention."""
    c, s = np.cos(angle_rad), np.sin(angle_rad)
    m = np.eye(4, dtype=np.float32)
    m[0, 0], m[0, 2] = c, -s
    m[2, 0], m[2, 2] = s, c
    return m


def euler_to_matrix(ex: float, ey: float, ez: float) -> np.ndarray:
    """Euler XYZ rotation composed for the row-vector convention (reference
    Math/Quaternion.hpp)."""
    cx, sx = np.cos(ex), np.sin(ex)
    cy, sy = np.cos(ey), np.sin(ey)
    cz, sz = np.cos(ez), np.sin(ez)
    rx = np.array(
        [[1, 0, 0, 0], [0, cx, sx, 0], [0, -sx, cx, 0], [0, 0, 0, 1]], np.float32
    )
    ry = np.array(
        [[cy, 0, -sy, 0], [0, 1, 0, 0], [sy, 0, cy, 0], [0, 0, 0, 1]], np.float32
    )
    rz = np.array(
        [[cz, sz, 0, 0], [-sz, cz, 0, 0], [0, 0, 1, 0], [0, 0, 0, 1]], np.float32
    )
    return rx @ ry @ rz


def compose_trs(
    position: np.ndarray, rotation: np.ndarray | None = None, scale: float = 1.0
) -> np.ndarray:
    """Transform.GetMatrix equivalent (reference Math/Transform.hpp:45-63)."""
    m = np.eye(4, dtype=np.float32) * np.array(
        [scale, scale, scale, 1.0], np.float32)[:, None]
    if rotation is not None:
        m = m @ rotation
    m[3, :3] = np.asarray(position, np.float32)
    return m


def to_half(x: np.ndarray) -> np.ndarray:
    """Quantize to IEEE float16 (attribute storage dtype of the reference)."""
    return np.asarray(x, np.float32).astype(np.float16)


def half_to_float(x: np.ndarray) -> np.ndarray:
    return np.asarray(x, np.float16).astype(np.float32)


def pack_rgb_u32(rgb: np.ndarray) -> np.ndarray:
    """Pack float RGB in [0,1] into u32 0x00BBGGRR, rounding to nearest."""
    rgb = np.clip(np.asarray(rgb, np.float32), 0.0, 1.0)
    b = (rgb * 255.0 + 0.5).astype(np.uint32)
    return b[..., 0] | (b[..., 1] << 8) | (b[..., 2] << 16)


_U8_TO_F32 = float(np.float32(1.0 / 255.0))


def _bytes_of(u: torch.Tensor) -> torch.Tensor:
    """The three low bytes of packed u32 colours ``[...]`` → int64
    ``[..., 3]`` (R, G, B)."""
    u = u.to(torch.int64) & 0xFFFFFFFF
    return torch.stack([u & 0xFF, (u >> 8) & 0xFF, (u >> 16) & 0xFF], dim=-1)


def unpack_rgb_u32(u: torch.Tensor) -> torch.Tensor:
    """u32 0x00BBGGRR → float3 (reference UnpackRGB8u)."""
    return _bytes_of(u).to(torch.float32) * _U8_TO_F32


def multiply_color_u32(texel_rgb8: torch.Tensor, color_u32: torch.Tensor) -> torch.Tensor:
    """``(material byte * texel byte) >> 8``, then / 255: the reference's
    integer colour modulate (MathAndSTL.cl:243-249). ``texel_rgb8`` [..., 3]
    bytes, ``color_u32`` packed material colours → float3 in [0, 1]."""
    prod = (_bytes_of(color_u32) * texel_rgb8.to(torch.int64)) >> 8
    return prod.to(torch.float32) * _U8_TO_F32
