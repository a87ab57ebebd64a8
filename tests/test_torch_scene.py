"""The port's scene layer against the JAX package's: the bridge carries
every leaf across unchanged, the port's SceneBuilder builds the same leaves
as the JAX SceneBuilder, and the camera matrices and tiled primary rays
agree. Everything runs on the CPU."""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from clraytracer_tpu import camera as jcam
from clraytracer_tpu.config import CameraConfig as JCameraConfig
from clraytracer_tpu_torch import camera as tcam
from clraytracer_tpu_torch.config import CameraConfig as TCameraConfig
from clraytracer_tpu_torch.scene.bridge import scene_from_numpy


def flatten(scene):
    """A JAX scene → (arrays, static) in the bridge's key format."""
    arrays, static = {}, {}
    for f in dataclasses.fields(scene):
        group = getattr(scene, f.name)
        if not dataclasses.is_dataclass(group):
            continue
        for g in dataclasses.fields(group):
            key = f"{f.name}.{g.name}"
            value = getattr(group, g.name)
            if g.metadata.get("clraytracer_static", False):
                static[key] = value
            elif value is not None:
                arrays[key] = np.asarray(value)
    static["skybox_tex"] = scene.skybox_tex
    static["procedural_tex"] = tuple(
        (h, off, dataclasses.astuple(desc)) for h, off, desc in scene.procedural_tex
    )
    return arrays, static


def port_leaves(scene):
    """The port scene → (arrays, static) in the same key format."""
    arrays, static = {}, {}
    for f in dataclasses.fields(scene):
        group = getattr(scene, f.name)
        if not dataclasses.is_dataclass(group):
            continue
        for g in dataclasses.fields(group):
            value = getattr(group, g.name)
            key = f"{f.name}.{g.name}"
            if isinstance(value, torch.Tensor):
                arrays[key] = value.numpy()
            elif value is not None:
                static[key] = value
    return arrays, static


def assert_leaves_equal(jax_arrays, jax_static, port_scene):
    arrays, static = port_leaves(port_scene)
    assert set(arrays) == set(jax_arrays)
    for key, src in jax_arrays.items():
        got = arrays[key]
        assert got.dtype == src.dtype, (key, got.dtype, src.dtype)
        assert got.shape == src.shape, (key, got.shape, src.shape)
        np.testing.assert_array_equal(got, src, err_msg=key)
    for key, src in jax_static.items():
        if key in ("skybox_tex", "procedural_tex"):
            continue
        assert static[key] == src, key
    assert port_scene.skybox_tex == jax_static["skybox_tex"]
    assert tuple(
        (h, off, dataclasses.astuple(d)) for h, off, d in port_scene.procedural_tex
    ) == jax_static["procedural_tex"]


@pytest.fixture(scope="module")
def flagship_scene():
    from __graft_entry__ import _flagship_scene

    return _flagship_scene()


@pytest.mark.parametrize(
    "fixture", ["procedural_scene", "sphere_scene", "flagship_scene"]
)
def test_bridge_leaves_equal_source(fixture, request):
    scene = request.getfixturevalue(fixture)
    arrays, static = flatten(scene)
    port = scene_from_numpy(arrays, static, device="cpu")
    assert_leaves_equal(arrays, static, port)
    assert port.device.type == "cpu"


def _procedural_recipe(pkg):
    """tests/conftest.py::procedural_scene's recipe for either package."""
    b = pkg.SceneBuilder()
    b.import_procedural(pkg.ptex.sky_gradient(256, 128))
    checker = b.import_procedural(pkg.ptex.checker(64, 8))
    m1 = b.create_material(albedo=(0.9, 0.2, 0.2), albedo_tex=checker)
    m2 = b.create_material(albedo=(0.2, 0.9, 0.2))
    s1 = b.add_mesh(pkg.uv_sphere(1.5, 8, 12), materials_start=m1)
    s2 = b.add_mesh(pkg.cube(1.0), materials_start=m2)
    b.add_instance(s1, pkg.math3d.translation(-2.0, 1.0, 0.0))
    b.add_instance(
        s2,
        pkg.math3d.rotation_y(0.7) @ pkg.math3d.translation(2.5, 0.5, -1.0),
    )
    return b


def _package(name):
    import importlib
    import types

    mod = lambda sub: importlib.import_module(f"{name}.{sub}")
    return types.SimpleNamespace(
        SceneBuilder=mod("scene").SceneBuilder,
        ptex=mod("scene.procedural_tex"),
        uv_sphere=mod("scene.procedural").uv_sphere,
        cube=mod("scene.procedural").cube,
        math3d=mod("math3d"),
    )


def test_builder_matches_jax_builder_procedural_recipe():
    jax_scene = _procedural_recipe(_package("clraytracer_tpu")).build()
    port = _procedural_recipe(_package("clraytracer_tpu_torch")).build(device="cpu")
    assert_leaves_equal(*flatten(jax_scene), port)


def test_builder_matches_jax_builder_two_scene():
    from clraytracer_tpu.cli import build_scene as jax_build
    from clraytracer_tpu_torch.cli import build_scene as port_build

    assert_leaves_equal(*flatten(jax_build("two")), port_build("two", device="cpu"))


def test_builder_numpy_fallback_matches_jax_builder(monkeypatch):
    """Without the native BVH library both builders take their numpy
    level-synchronous build (builder.py's fallback) and still agree."""
    import clraytracer_tpu.runtime.fastobj as jax_fastobj
    import clraytracer_tpu_torch.runtime.fastobj as port_fastobj

    calls = []

    def no_native(*args, **kwargs):
        calls.append(1)
        return None

    monkeypatch.setattr(jax_fastobj, "build_bvh_native", no_native)
    monkeypatch.setattr(port_fastobj, "build_bvh_native", no_native)
    jax_scene = _procedural_recipe(_package("clraytracer_tpu")).build()
    port = _procedural_recipe(_package("clraytracer_tpu_torch")).build(device="cpu")
    assert len(calls) == 2
    assert_leaves_equal(*flatten(jax_scene), port)


def test_builder_matches_jax_builder_multi_hyper():
    """A 70k-triangle sphere: three hyper groups of superclusters."""
    from clraytracer_tpu.cli import build_scene as jax_build
    from clraytracer_tpu_torch.cli import build_scene as port_build

    port = port_build("sphere", 70000, device="cpu")
    assert len(port.clusters.mesh_ranges) == 1
    assert port.clusters.mesh_ranges[0][1] > 64
    assert_leaves_equal(*flatten(jax_build("sphere", 70000)), port)


@pytest.mark.parametrize("size", [(64, 48), (1249, 720)])
def test_camera_and_tiled_rays_match(size):
    from clraytracer_tpu.ops.trace_pallas import _tile_rows
    from clraytracer_tpu_torch.ops.render_fused import tile_rows

    w, h = size
    kw = dict(position=(0.13, 0.21, 10.0), yaw_deg=-80.0, pitch_deg=5.0)
    jc = jcam.Camera.create(JCameraConfig(**kw), w, h)
    tc = tcam.Camera.create(TCameraConfig(**kw), w, h)
    for name in ("projection", "view", "inverse_projection", "inverse_view"):
        np.testing.assert_array_equal(getattr(tc, name), getattr(jc, name), name)
    trows = _tile_rows(w * h)
    assert tile_rows(w * h) == trows
    ref = np.asarray(
        jcam.ray_directions_tiled(
            jnp.asarray(jc.inverse_view), jnp.asarray(jc.inverse_projection),
            w, h, trows,
        )
    )
    got = tcam.ray_directions_tiled(
        torch.from_numpy(tc.inverse_view), torch.from_numpy(tc.inverse_projection),
        w, h, trows,
    ).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
