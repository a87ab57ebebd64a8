"""The port's differentiable step (plain versions, on the CPU) against the
JAX package's ``diff.render_image_diff`` and ``diff.image_loss_and_grads``
(Pallas interpret mode) on the same scenes, camera and numpy weights; the
shading tables and planar camera rays it starts from.
tests/test_torch_diff_checks.py holds the port's own checks."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from clraytracer_tpu.camera import Camera as JCamera
from clraytracer_tpu.camera import ray_directions_planar as j_rays
from clraytracer_tpu.config import CameraConfig as JCameraConfig
from clraytracer_tpu.diff import render_image_diff as j_render_diff
from clraytracer_tpu.ops.shade import build_shading_tables as j_tables
from clraytracer_tpu.render import frame_inputs_from_camera as j_frame_inputs
from clraytracer_tpu_torch import camera as tcam
from clraytracer_tpu_torch import diff as tdiff
from clraytracer_tpu_torch import render as trender
from clraytracer_tpu_torch.config import CameraConfig as TCameraConfig
from clraytracer_tpu_torch.ops import shade
from clraytracer_tpu_torch.scene.bridge import scene_from_numpy
from test_torch_scene import flatten

CAMERA = (0.13, 0.21, 10.0)
W, H = 32, 24
SCENES = ("procedural_scene", "flagship_scene", "sphere_scene")
#: groups whose gradients sum over pixels into a few entries
AGGREGATED = ("materials", "instances")
#: groups with one gradient row per triangle or texel
PER_ROW = ("tris", "atlas")


@pytest.fixture(scope="module")
def flagship_scene():
    from __graft_entry__ import _flagship_scene

    return _flagship_scene()


def _weights(h=H, w=W):
    return np.random.default_rng(0).uniform(0.0, 1.0, (h, w, 3)).astype(np.float32)


def _port_frame(w=W, h=H):
    cam = tcam.Camera.create(TCameraConfig(position=CAMERA), w, h)
    return trender.frame_inputs_from_camera(cam, -1.96)


def _port(jscene):
    return scene_from_numpy(*flatten(jscene), device="cpu")


_JAX_REFS: dict = {}


def _jax_ref(name, request):
    """(image, {key: gradient}) of the JAX step with loss sum(img * weights),
    one jitted VJP per scene, kept for the module."""
    if name not in _JAX_REFS:
        jscene = request.getfixturevalue(name)
        frame = j_frame_inputs(JCamera.create(JCameraConfig(position=CAMERA), W, H), -1.96)

        @jax.jit
        def step(s, w):
            img, vjp = jax.vjp(lambda q: j_render_diff(q, frame, W, H), s)
            return img, vjp(w)[0]

        img, g = step(jscene, jnp.asarray(_weights()))
        grads = {}
        for f in dataclasses.fields(g):
            group = getattr(g, f.name)
            if not dataclasses.is_dataclass(group):
                continue
            for leaf in dataclasses.fields(group):
                v = getattr(group, leaf.name)
                if hasattr(v, "dtype") and jnp.issubdtype(v.dtype, jnp.floating):
                    grads[f"{f.name}.{leaf.name}"] = np.asarray(v)
        _JAX_REFS[name] = (np.asarray(img), grads)
    return _JAX_REFS[name]


def _port_loss_grads(scene, weights=None, w=W, h=H):
    wt = torch.from_numpy(_weights(h, w) if weights is None else weights)
    return tdiff.image_loss_and_grads(
        scene, _port_frame(w, h), w, h,
        loss_fn=lambda img: torch.sum(img * wt), device="cpu",
    )


@pytest.mark.parametrize("name", SCENES)
def test_render_image_diff_matches_jax(name, request):
    """At least 99% of pixels within 1e-5 (the seam-tie allowance of
    tests/test_torch_render.py)."""
    ref, _ = _jax_ref(name, request)
    got = tdiff.render_image_diff(
        _port(request.getfixturevalue(name)), _port_frame(), W, H, device="cpu"
    ).detach().numpy()
    assert got.shape == ref.shape == (H, W, 3)
    assert np.isfinite(got).all()
    bad = (np.abs(got - ref) > 1e-5).any(axis=-1)
    print(f"{name}: {int(bad.sum())} of {bad.size} pixels differ by > 1e-5")
    assert bad.mean() <= 0.01


@pytest.mark.parametrize("name", SCENES)
def test_image_loss_and_grads_match_jax(name, request):
    """Every floating leaf: same key, shape and dtype (f16 leaves get f16
    gradients). Aggregated leaves agree to rtol 1e-3; per-row leaves have
    >= 99% of rows within 1e-3 |g| + 1e-4 max |g_jax| (sums over pixels in
    another order, and seam ties may move a pixel to a neighbouring
    triangle); leaves the step does not read are zero in both."""
    _, ref = _jax_ref(name, request)
    _, got = _port_loss_grads(_port(request.getfixturevalue(name)))
    assert set(got) == set(ref)
    for key, g in got.items():
        a, b = ref[key], g.numpy()
        assert b.dtype == a.dtype and b.shape == a.shape, key
        assert np.isfinite(b).all(), key
        a, b = a.astype(np.float64), b.astype(np.float64)
        group = key.split(".")[0]
        scale = np.abs(a).max()
        if group in AGGREGATED:
            np.testing.assert_allclose(b, a, rtol=1e-3, atol=1e-6 * scale, err_msg=key)
        elif group in PER_ROW:
            ok = np.abs(b - a) <= 1e-3 * np.abs(a) + 1e-4 * scale
            rows = ok.reshape(ok.shape[0], -1).all(axis=1)
            assert rows.mean() >= 0.99, (key, int((~rows).sum()))
        else:
            assert not a.any() and not b.any(), key
    for key in ("materials.albedo", "tris.v0", "instances.inverse_transform"):
        assert np.abs(ref[key]).max() > 0.0 and got[key].abs().max() > 0.0, key
    if name == "sphere_scene":  # imported textures: texel gradients
        assert got["atlas.texels"].abs().max() > 0.0


def test_planar_rays_and_shading_tables_match_jax(sphere_scene):
    jcam = JCamera.create(JCameraConfig(position=CAMERA), W, H)
    ref = j_rays(jnp.asarray(jcam.inverse_view), jnp.asarray(jcam.inverse_projection), W, H)
    cam = tcam.Camera.create(TCameraConfig(position=CAMERA), W, H)
    got = tcam.ray_directions_planar(
        torch.from_numpy(cam.inverse_view), torch.from_numpy(cam.inverse_projection), W, H
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=1e-6)
    jt = j_tables(sphere_scene)
    tt = shade.build_shading_tables(_port(sphere_scene))
    for name in ("tri_attr", "inst_rows", "mat_rows"):
        np.testing.assert_array_equal(getattr(tt, name).numpy(), np.asarray(getattr(jt, name)))
