"""The port's camera against the JAX camera on the CPU: ``right``, ``up``
and ``updated`` (numpy, exact), the ray generators ``ray_directions``,
``ray_directions_planar`` with a row window and ``ray_directions_linear``
(within 1e-6), ``screen_point_to_ray`` (numpy, exact), and
``RenderConfig.resolution`` / ``num_pixels``."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from clraytracer_tpu import camera as jcam
from clraytracer_tpu.config import CameraConfig as JCameraConfig
from clraytracer_tpu.config import RenderConfig as JRenderConfig
from clraytracer_tpu_torch import camera as tcam
from clraytracer_tpu_torch.config import CameraConfig as TCameraConfig
from clraytracer_tpu_torch.config import RenderConfig as TRenderConfig
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

#: camera placements: the default, the smoke camera, a pitched one
POSES = {
    "default": {},
    "smoke": dict(position=(0.13, 0.21, 10.0)),
    "pitched": dict(position=(0.3, 4.0, 7.0), yaw_deg=-70.0, pitch_deg=-28.0),
}
RAY_ATOL = 1e-6


def _cams(pose, w=64, h=48):
    return (jcam.Camera.create(JCameraConfig(**POSES[pose]), w, h),
            tcam.Camera.create(TCameraConfig(**POSES[pose]), w, h))


@pytest.mark.parametrize("pose", list(POSES))
def test_orientation_matches_jax(pose):
    j, t = _cams(pose)
    for name in ("front", "right", "up", "view", "projection", "inverse_view",
                 "inverse_projection"):
        np.testing.assert_array_equal(getattr(t, name), getattr(j, name), err_msg=name)


@pytest.mark.parametrize(
    "kw",
    [dict(mouse_delta=(40.0, 10.0), move=(0.5, 0.0, 0.0)),
     dict(move=(0.0, 0.0, 1.0), dt=0.5),
     dict(mouse_delta=(0.0, 1e5), dt=1.0),  # pitch clamps at -89
     dict(mouse_delta=(-3.0, -2.0), move=(1.0, -1.0, 1.0), dt=0.1, sensitivity=5.0)],
    ids=["look+strafe", "forward", "clamp", "all"],
)
def test_updated_matches_jax(kw):
    j, t = _cams("smoke")
    for _ in range(3):  # a few ticks in a row
        j, t = j.updated(**kw), t.updated(**kw)
        assert t.yaw_deg == j.yaw_deg and t.pitch_deg == j.pitch_deg
        np.testing.assert_array_equal(t.position, j.position)
        assert t.position.dtype == np.float32
    if kw.get("mouse_delta") == (0.0, 1e5):
        assert t.pitch_deg == -89.0


def _mats(j):
    return jnp.asarray(j.inverse_view), jnp.asarray(j.inverse_projection)


def _tmats(t):
    return torch.from_numpy(t.inverse_view), torch.from_numpy(t.inverse_projection)


@pytest.mark.parametrize("pose", list(POSES))
def test_ray_directions_match_jax(pose):
    j, t = _cams(pose)
    ref = np.asarray(jcam.ray_directions(*_mats(j), 64, 48))
    got = tcam.ray_directions(*_tmats(t), 64, 48).numpy()
    assert got.shape == (48, 64, 3)
    np.testing.assert_allclose(got, ref, rtol=0, atol=RAY_ATOL)


@pytest.mark.parametrize("window", [(0, None), (8, 16), (40, 8)])
def test_ray_directions_planar_row_window_matches_jax(window):
    j, t = _cams("pitched")
    r0, n = window
    ref = np.asarray(jcam.ray_directions_planar(*_mats(j), 64, 48, r0, n))
    got = tcam.ray_directions_planar(*_tmats(t), 64, 48, r0, n).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=RAY_ATOL)
    # a window's rows are the whole frame's rows
    whole = tcam.ray_directions_planar(*_tmats(t), 64, 48).numpy()
    np.testing.assert_array_equal(got, whole[:, r0 : r0 + got.shape[1]])


@pytest.mark.parametrize("wh", [(64, 48), (200, 30)])
def test_ray_directions_linear_matches_jax(wh):
    """The JAX [3, rows, 128] order (tests/test_camera.py:98), over-padded:
    pad lanes finite and normalised."""
    w, h = wh
    j, t = _cams("smoke", w, h)
    rows = -(-w * h // 128) + 8
    ref = np.asarray(jcam.ray_directions_linear(*_mats(j), w, h, rows))
    got = tcam.ray_directions_linear(*_tmats(t), w, h, rows).numpy()
    assert got.shape == (3, rows, 128)
    np.testing.assert_allclose(got, ref, rtol=0, atol=RAY_ATOL)
    planar = tcam.ray_directions_planar(*_tmats(t), w, h).numpy()
    np.testing.assert_array_equal(got.reshape(3, -1)[:, : w * h].reshape(3, h, w), planar)
    tail = got.reshape(3, -1)[:, w * h :]
    assert np.isfinite(tail).all()
    np.testing.assert_allclose((tail * tail).sum(axis=0), 1.0, atol=1e-5)


@pytest.mark.parametrize("pose", list(POSES))
def test_screen_point_to_ray_matches_jax(pose):
    j, t = _cams(pose, 32, 24)
    pts = np.random.default_rng(3).uniform(0, 1, (8, 2)) * (32, 24)
    for x, y in pts:
        jo, jd = jcam.screen_point_to_ray(j, float(x), float(y))
        to, td = tcam.screen_point_to_ray(t, float(x), float(y))
        np.testing.assert_array_equal(to, jo)
        np.testing.assert_array_equal(td, jd)
        assert td.dtype == np.float32


def test_picking_matches_raygen_with_y_flip():
    """tests/test_camera.py:60's rule on the port: picking at (x, H - y)
    gives RayGen's direction of row y."""
    t = tcam.Camera.create(TCameraConfig(), 32, 24)
    dirs = tcam.ray_directions(*_tmats(t), 32, 24).numpy()
    origin, d = tcam.screen_point_to_ray(t, 10.0, float(24 - 7))
    np.testing.assert_allclose(origin, t.position, atol=1e-6)
    np.testing.assert_allclose(d, dirs[7, 10], atol=1e-5)


@pytest.mark.parametrize("wh", [(1249, 720), (32, 24)])
def test_resolution_and_num_pixels(wh):
    w, h = wh
    t, j = TRenderConfig(width=w, height=h), JRenderConfig(width=w, height=h)
    assert t.resolution == j.resolution == (w, h)
    assert t.num_pixels == j.num_pixels == w * h
    assert TRenderConfig().resolution == JRenderConfig().resolution
