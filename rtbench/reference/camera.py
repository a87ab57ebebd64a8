# Frozen copy of clraytracer_tpu_torch/camera.py (Camera.front, projection, view, _unproject_grid, screen_point_to_ray) and math3d.py (perspective_fov_rh, look_at_rh) at commit c1cdb28.
"""The reference's camera: the upstream's FPS camera (Math/Camera.hpp) and
RayGen unprojection (kernel_main.cl:277-287), from a pose."""

from __future__ import annotations

import numpy as np
import torch

_DEG2RAD = np.pi / 180.0
FOV_DEG, NEAR, FAR = 65.0, 0.01, 500.0  # the upstream's defaults (Camera.hpp:15-26)


def _perspective_fov_rh(fov_rad, width, height, z_near, z_far) -> np.ndarray:
    h = np.cos(0.5 * fov_rad) / np.sin(0.5 * fov_rad)
    w = h * height / width
    m = np.zeros((4, 4), np.float32)
    m[0, 0] = w
    m[1, 1] = h
    m[2, 2] = -(z_far + z_near) / (z_far - z_near)
    m[2, 3] = -1.0
    m[3, 2] = -(2.0 * z_far * z_near) / (z_far - z_near)
    return m


def _look_at_rh(eye, front, up) -> np.ndarray:
    eye = np.asarray(eye, np.float32)
    eye_dir = -np.asarray(front, np.float32)
    r0 = np.cross(np.asarray(up, np.float32), eye_dir)
    r0 /= np.linalg.norm(r0)
    r1 = np.cross(eye_dir, r0)
    r1 /= np.linalg.norm(r1)
    m = np.zeros((4, 4), np.float32)
    m[0, :3], m[0, 3] = r0, np.dot(r0, -eye)
    m[1, :3], m[1, 3] = r1, np.dot(r1, -eye)
    m[2, :3], m[2, 3] = eye_dir, np.dot(eye_dir, -eye)
    m[3, 3] = 1.0
    return m.T.copy()


def matrices(pose, width: int, height: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(inverse view, inverse projection, position) of ``pose``, f32."""
    yaw, pitch = pose.yaw_deg * _DEG2RAD, pose.pitch_deg * _DEG2RAD
    f = np.array([np.cos(yaw) * np.cos(pitch), np.sin(pitch), np.sin(yaw) * np.cos(pitch)],
                 np.float32)
    f = f / np.linalg.norm(f)
    pos = np.asarray(pose.position, np.float32)
    view = _look_at_rh(pos, f, np.array([0.0, 1.0, 0.0], np.float32))
    proj = _perspective_fov_rh(FOV_DEG * _DEG2RAD, float(width), float(height), NEAR, FAR)
    return (np.linalg.inv(view).astype(np.float32), np.linalg.inv(proj).astype(np.float32), pos)


def pixel_rays(pose, width: int, height: int, px: torch.Tensor, py: torch.Tensor,
               dtype=torch.float32):
    """World rays (origin [3, n], direction [3, n]) through integer pixel
    coordinates ``px``, ``py`` (row py of the frame, bottom-up), in
    ``dtype``. The unprojection itself is float32, as the camera's
    matrices are: in bfloat16 its homogeneous divide cancels to zero."""
    f32 = torch.float32
    iv, ip, pos = (torch.as_tensor(a, dtype=f32, device=px.device)
                   for a in matrices(pose, width, height))
    cx = (px.to(f32) / torch.tensor(float(width), dtype=f32, device=px.device)) * 2.0 - 1.0
    cy = (py.to(f32) / torch.tensor(float(height), dtype=f32, device=px.device)) * 2.0 - 1.0
    tx = cx * ip[0, 0] + cy * ip[1, 0] + ip[2, 0] + ip[3, 0]
    ty = cx * ip[0, 1] + cy * ip[1, 1] + ip[2, 1] + ip[3, 1]
    tz = cx * ip[0, 2] + cy * ip[1, 2] + ip[2, 2] + ip[3, 2]
    tw = cx * ip[0, 3] + cy * ip[1, 3] + ip[2, 3] + ip[3, 3]
    inv_w = 1.0 / tw
    tx, ty, tz = tx * inv_w, ty * inv_w, tz * inv_w
    wx = tx * iv[0, 0] + ty * iv[1, 0] + tz * iv[2, 0] + iv[3, 0]
    wy = tx * iv[0, 1] + ty * iv[1, 1] + tz * iv[2, 1] + iv[3, 1]
    wz = tx * iv[0, 2] + ty * iv[1, 2] + tz * iv[2, 2] + iv[3, 2]
    rn = 1.0 / torch.sqrt(wx * wx + wy * wy + wz * wz)
    d = torch.stack([wx * rn, wy * rn, wz * rn])
    return pos[:, None].expand_as(d).to(dtype), d.to(dtype)


def pick_ray(pose, width: int, height: int, x: float, y: float) -> tuple[np.ndarray, np.ndarray]:
    """The upstream's mouse picking unprojection (Camera.hpp:109-135):
    mouse y runs top-down → (origin, direction), f32."""
    iv, ip, pos = matrices(pose, width, height)
    cx = (x / width) * 2.0 - 1.0
    cy = (1.0 - y / height) * 2.0 - 1.0
    target = np.array([cx, cy, 1.0, 1.0], np.float32) @ ip
    target /= target[3]
    world = target @ iv
    d = world[:3] / np.linalg.norm(world[:3])
    return pos.copy(), d.astype(np.float32)
