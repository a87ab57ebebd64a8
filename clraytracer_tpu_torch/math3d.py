"""Host-side matrix helpers and colour packing (numpy).

The same conventions as the reference's math library (Math/Matrix.hpp):
``[4, 4]`` row-major matrices with the row-vector convention
``transform(v, M) == v @ M``.
"""

from __future__ import annotations

import numpy as np


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


def rotation_y(angle_rad: float) -> np.ndarray:
    """Rotation about +Y for the row-vector convention."""
    c, s = np.cos(angle_rad), np.sin(angle_rad)
    m = np.eye(4, dtype=np.float32)
    m[0, 0], m[0, 2] = c, -s
    m[2, 0], m[2, 2] = s, c
    return m


def to_half(x: np.ndarray) -> np.ndarray:
    """Quantize to IEEE float16 (attribute storage dtype of the reference)."""
    return np.asarray(x, np.float32).astype(np.float16)


def pack_rgb_u32(rgb: np.ndarray) -> np.ndarray:
    """Pack float RGB in [0,1] into u32 0x00BBGGRR, rounding to nearest."""
    rgb = np.clip(np.asarray(rgb, np.float32), 0.0, 1.0)
    b = (rgb * 255.0 + 0.5).astype(np.uint32)
    return b[..., 0] | (b[..., 1] << 8) | (b[..., 2] << 16)
