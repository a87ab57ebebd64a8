"""The port's helpers against the JAX package's on the CPU: the math3d
helpers (tensors within 1e-6, numpy exact), ``validate_bvh``, the post
steps (within 1e-6), the texture and skybox samplers (exact),
``refresh_packed`` and the builder's ``edit_material`` /
``set_instance_transform`` / ``instance_arrays`` (exact leaves), a live
material edit that the next frame shows (the frame rule: at least 99% of
pixels within 1e-5 of the JAX frame), the geometry tables kept across the
edit; and that no module of the port, nor chip_smoke.py, imports JAX or
the JAX package (read from the sources)."""

import dataclasses
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from clraytracer_tpu import bvh as jbvh
from clraytracer_tpu import math3d as jm
from clraytracer_tpu.ops import post as jpost
from clraytracer_tpu.ops import shade as jshade
from clraytracer_tpu_torch import bvh as tbvh
from clraytracer_tpu_torch import math3d as tm
from clraytracer_tpu_torch.ops import post as tpost
from clraytracer_tpu_torch.ops import shade as tshade
from clraytracer_tpu_torch.scene.bridge import scene_from_numpy
from _torch_ties import package
from test_torch_scene import _procedural_recipe, assert_leaves_equal, flatten
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

ROOT = Path(__file__).resolve().parent.parent
ATOL = 1e-6


def _np(x):
    return np.asarray(x)


@pytest.fixture(scope="module")
def vecs():
    rng = np.random.default_rng(11)
    a = rng.normal(size=(64, 3)).astype(np.float32)
    b = rng.normal(size=(64, 3)).astype(np.float32)
    m = rng.normal(size=(64, 4, 4)).astype(np.float32)
    return a, b, m


@pytest.mark.parametrize("name", ["normalize", "dot", "cross", "reflect"])
def test_vector_helpers_match_jax(name, vecs):
    a, b, _ = vecs
    args = (a,) if name == "normalize" else (a, b)
    ref = _np(getattr(jm, name)(*(jnp.asarray(x) for x in args)))
    got = getattr(tm, name)(*(torch.from_numpy(x) for x in args)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=ATOL)


@pytest.mark.parametrize("name", ["matvec", "transform_point", "transform_vector",
                                  "transform_h", "inverse"])
def test_matrix_helpers_match_jax(name, vecs):
    a, _, m = vecs
    v4 = np.concatenate([a, np.ones((64, 1), np.float32)], axis=1)
    args = {"matvec": (v4, m), "transform_point": (a, m), "transform_vector": (a, m),
            "transform_h": (v4, m), "inverse": (m,)}[name]
    ref = _np(getattr(jm, name)(*(jnp.asarray(x) for x in args)))
    got = getattr(tm, name)(*(torch.from_numpy(x) for x in args)).numpy()
    tol = 1e-4 if name == "inverse" else ATOL  # inverse: LU in each library
    np.testing.assert_allclose(got, ref, rtol=tol, atol=tol)


@pytest.mark.parametrize("call", [
    ("scale_matrix", (2.0, 0.5, 3.0)),
    ("euler_to_matrix", (0.3, -1.1, 2.0)),
    ("compose_trs", (np.array([1.0, -2.0, 0.5]), None, 2.0)),
    ("compose_trs", (np.array([0.0, 1.0, 0.0]), np.eye(4, dtype=np.float32) * 0.5, 1.5)),
    ("half_to_float", (np.array([0.1, 65504.0, -3.25], np.float16),)),
], ids=lambda c: c[0] if isinstance(c, tuple) else None)
def test_host_matrix_helpers_equal_jax(call):
    name, args = call
    got, ref = getattr(tm, name)(*args), getattr(jm, name)(*args)
    assert got.dtype == ref.dtype
    np.testing.assert_array_equal(got, ref)


def test_colour_unpack_and_modulate_equal_jax():
    rng = np.random.default_rng(5)
    packed = rng.integers(0, 1 << 24, size=50, dtype=np.uint32)
    tex = rng.integers(0, 256, size=(50, 3), dtype=np.uint8)
    np.testing.assert_array_equal(
        tm.unpack_rgb_u32(torch.from_numpy(packed)).numpy(),
        _np(jm.unpack_rgb_u32(jnp.asarray(packed))))
    np.testing.assert_array_equal(
        tm.multiply_color_u32(torch.from_numpy(tex), torch.from_numpy(packed)).numpy(),
        _np(jm.multiply_color_u32(jnp.asarray(tex), jnp.asarray(packed))))


# ---------------------------------------------------------------------------
# validate_bvh
# ---------------------------------------------------------------------------


def _mesh_build(pkg_bvh, pkg):
    mesh = pkg.uv_sphere(1.0, 12, 24)
    c = pkg.cube(0.5)
    return pkg_bvh.build_bvh(
        np.concatenate([mesh.v0, c.v0]), np.concatenate([mesh.v1, c.v1]),
        np.concatenate([mesh.v2, c.v2]), [mesh.count, c.count]), mesh.count + c.count


def _broken(build, how):
    b = dataclasses.replace(
        build, node_min=build.node_min.copy(), node_max=build.node_max.copy(),
        tri_count=build.tri_count.copy(), left_first=build.left_first.copy())
    if how == "uncovered":
        leaf = int(np.nonzero(b.tri_count > 1)[0][0])
        b.tri_count[leaf] -= 1
    elif how == "child_outside":
        inner = int(np.nonzero(b.tri_count == 0)[0][0])
        b.node_max[b.left_first[inner]] += 1.0
    else:  # children past the node pool
        inner = int(np.nonzero(b.tri_count == 0)[0][-1])
        b.left_first[inner] = len(b.tri_count)
    return b


@pytest.mark.parametrize("how", [None, "uncovered", "child_outside", "children_outside"])
def test_validate_bvh_agrees_with_jax(how):
    """Both validators pass the builders' trees and reject the same broken
    ones."""
    tb, n = _mesh_build(tbvh, package("clraytracer_tpu_torch"))
    jb, _ = _mesh_build(jbvh, package("clraytracer_tpu"))
    if how is None:
        tbvh.validate_bvh(tb, n)
        jbvh.validate_bvh(jb, n)
        return
    with pytest.raises(AssertionError):
        tbvh.validate_bvh(_broken(tb, how), n)
    with pytest.raises(AssertionError):
        jbvh.validate_bvh(_broken(jb, how), n)


# ---------------------------------------------------------------------------
# post steps
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["_luminance", "saturation", "reinhard", "gamma_correct"])
def test_post_steps_match_jax(name):
    img = np.random.default_rng(2).uniform(0, 2, (12, 16, 3)).astype(np.float32)
    img[0, 0] = 0.0  # Reinhard's zero-luminance guard
    ref = _np(getattr(jpost, name)(jnp.asarray(img)))
    got = getattr(tpost, name)(torch.from_numpy(img)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=ATOL)


@pytest.mark.parametrize("hw", [(48, 64), (720, 1249)])
def test_vignette_mask_matches_jax(hw):
    ref = _np(jpost.vignette_mask(*hw))
    got = tpost.vignette_mask(*hw).numpy()
    assert got.shape == hw
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=ATOL)
    assert got[hw[0] // 2, hw[1] // 2] > got[1, 1]


# ---------------------------------------------------------------------------
# samplers, refresh_packed, builder edits
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def scenes(sphere_scene):
    return sphere_scene, scene_from_numpy(*flatten(sphere_scene), device="cpu")


def test_texture_samplers_equal_jax(scenes):
    js, ts = scenes
    rng = np.random.default_rng(7)
    n = 200
    tex = rng.integers(-1, 6, size=n).astype(np.int32)  # out-of-range indices clamp
    uv = rng.uniform(-2, 3, size=(n, 2)).astype(np.float32)
    ref = _np(jshade.sample_texture(js.atlas, jnp.asarray(tex), jnp.asarray(uv)))
    got = tshade.sample_texture(ts.atlas, torch.from_numpy(tex), torch.from_numpy(uv))
    np.testing.assert_array_equal(got.numpy(), ref)
    ref = _np(jshade.sample_texture_planar(
        js.atlas, jnp.asarray(tex), jnp.asarray(uv[:, 0]), jnp.asarray(uv[:, 1])))
    got = tshade.sample_texture_planar(
        ts.atlas, torch.from_numpy(tex), torch.from_numpy(uv[:, 0]), torch.from_numpy(uv[:, 1]))
    np.testing.assert_array_equal(got.numpy(), ref)


def test_skybox_samplers_equal_jax(scenes):
    js, ts = scenes
    d = np.random.default_rng(8).normal(size=(100, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    ref = _np(jshade.sample_skybox(js.atlas, jnp.int32(2), jnp.asarray(d)))
    got = tshade.sample_skybox(ts.atlas, torch.tensor(2, dtype=torch.int32), torch.from_numpy(d))
    np.testing.assert_array_equal(got.numpy(), ref)
    dp = np.ascontiguousarray(d.T)
    idx = np.full(100, 2, np.int32)
    ref = _np(jshade.sample_skybox_planar(js.atlas, jnp.asarray(idx), jnp.asarray(dp)))
    got = tshade.sample_skybox_planar(ts.atlas, torch.from_numpy(idx), torch.from_numpy(dp))
    np.testing.assert_array_equal(got.numpy(), ref)
    w, h, off = (int(js.atlas.width[2]), int(js.atlas.height[2]), int(js.atlas.offset[2]))
    ref = _np(jshade.sample_skybox_static(js.atlas, w, h, off, jnp.asarray(dp)))
    got = tshade.sample_skybox_static(ts.atlas, w, h, off, torch.from_numpy(dp))
    np.testing.assert_array_equal(got.numpy(), ref)


def _edit_albedo_jax(scene, i, rgb):
    alb = scene.materials.albedo.at[i].set(jnp.asarray(rgb, jnp.float32))
    return jshade.refresh_packed(
        dataclasses.replace(scene, materials=dataclasses.replace(scene.materials, albedo=alb)))


def _edit_albedo_port(scene, i, rgb):
    alb = scene.materials.albedo.clone()
    alb[i] = torch.tensor(rgb, dtype=alb.dtype)
    return tshade.refresh_packed(
        dataclasses.replace(scene, materials=dataclasses.replace(scene.materials, albedo=alb)))


def test_refresh_packed_equals_jax(scenes):
    js, ts = scenes
    ref = _edit_albedo_jax(js, 1, (0.1, 0.2, 0.9))
    got = _edit_albedo_port(ts, 1, (0.1, 0.2, 0.9))
    assert_leaves_equal(*flatten(ref), got)
    assert got.packed.skybox_off == ts.packed.skybox_off


def _frame(pkg, scene, tracer_name, w=32, h=24):
    import importlib

    cam_mod = importlib.import_module(f"{pkg}.camera")
    cfg_mod = importlib.import_module(f"{pkg}.config")
    render = importlib.import_module(f"{pkg}.render")
    cam = cam_mod.Camera.create(cfg_mod.CameraConfig(position=(0.13, 0.21, 10.0)), w, h)
    frame = render.frame_inputs_from_camera(cam, -1.96)
    cfg = cfg_mod.RenderConfig(width=w, height=h)
    if pkg == "clraytracer_tpu":
        return _np(render.render_frame(scene, frame, cfg, tracer=render.TRACERS[tracer_name]))
    return render.render_frame(scene, frame, cfg, device="cpu",
                               tracer=render.TRACERS[tracer_name]).numpy()


def _close_share(got, ref):
    return 1.0 - (np.abs(got - ref) > 1e-5).any(axis=-1).mean()


def test_material_edit_shows_in_the_next_frame(scenes):
    """A live albedo edit (the live viewer's ``/material``): the port's
    frame after ``refresh_packed`` shows it, and agrees with the JAX frame
    after the same edit; the traversal's geometry tables survive the edit,
    its descriptor rows too, while the material and instance rows are the
    new ones."""
    from clraytracer_tpu_torch.ops import trace as tr

    js, ts = scenes
    before = _frame("clraytracer_tpu_torch", ts, "wavefront")
    kt0, ft0 = tr.kernel_tables(ts), tr.frame_tables(ts)
    edited = _edit_albedo_port(ts, 1, (0.1, 0.2, 0.9))
    got = _frame("clraytracer_tpu_torch", edited, "wavefront")
    ref = _frame("clraytracer_tpu", _edit_albedo_jax(js, 1, (0.1, 0.2, 0.9)), "wavefront")
    assert np.abs(got - before).max() > 0.05
    assert _close_share(got, ref) >= 0.99
    kt1, ft1 = tr.kernel_tables(edited), tr.frame_tables(edited)
    for f in ("planes", "attrs", "hyper_box", "super_box", "cluster_box", "tri_gid", "ranges"):
        assert getattr(kt1, f).data_ptr() == getattr(kt0, f).data_ptr(), f
    assert ft1.tex.data_ptr() == ft0.tex.data_ptr()
    assert torch.equal(ft1.mat_rows, edited.packed.mat_rows)
    assert not torch.equal(ft1.mat_rows, ft0.mat_rows)
    assert ft1.descs is ft0.descs
    assert kt1.inst is not kt0.inst and torch.equal(kt1.inst, edited.packed.inst_rows)
    # the fused frame (K2.2's plain version) shows the edit too
    fused = _frame("clraytracer_tpu_torch", edited, "best")
    assert _close_share(fused, ref) >= 0.99


def test_builder_edits_equal_jax():
    """``edit_material``, ``set_instance_transform`` and ``instance_arrays``
    on both builders: the same instance arrays and rebuilt leaves."""
    jb = _procedural_recipe(package("clraytracer_tpu"))
    tb = _procedural_recipe(package("clraytracer_tpu_torch"))
    move = jm.rotation_y(0.3) @ jm.translation(0.5, -1.0, 2.0)
    for b in (jb, tb):
        b.edit_material(1, albedo=(0.3, 0.3, 0.8), shininess=3.0)
        b.set_instance_transform(1, move)
    with pytest.raises(AttributeError):
        tb.edit_material(1, glossiness=1.0)
    ji, ti = jb.instance_arrays(), tb.instance_arrays(device="cpu")
    np.testing.assert_array_equal(ti.inverse_transform.numpy(), _np(ji.inverse_transform))
    np.testing.assert_array_equal(ti.material_start.numpy(), _np(ji.material_start))
    assert ti.mesh_index == ji.mesh_index
    assert_leaves_equal(*flatten(jb.build()), tb.build(device="cpu"))


def test_timers_and_logger_match_jax():
    """``ScopeTimer`` records into ``profiler_stats`` under the same name
    in both packages; the JAX package's ``timed`` returns the call's value
    (the port has no ``timed``: ``test_torch_surface.MISSING_ON_PURPOSE``);
    the logger is the ``clraytracer`` one."""
    from clraytracer_tpu.utils import timer as jtimer
    from clraytracer_tpu_torch.utils import get_logger, log_info
    from clraytracer_tpu_torch.utils import timer as ttimer

    for mod in (jtimer, ttimer):
        with mod.ScopeTimer("scope.test", log=False):
            sum(range(1000))
        assert mod.profiler_stats["scope.test"] >= 0.0
    fn = jtimer.timed("timed.test")(lambda x: x * 2)
    assert int(fn(21)) == 42
    assert jtimer.profiler_stats["timed.test"] >= 0.0
    assert get_logger().name == "clraytracer"
    assert get_logger("clraytracer.engine").parent.name == "clraytracer"
    log_info("logged %d", 7)  # the stream handler writes it without raising


# ---------------------------------------------------------------------------
# no JAX in the port
# ---------------------------------------------------------------------------

_JAX_IMPORT = re.compile(
    r"^\s*(?:import|from)\s+(?:jax|clraytracer_tpu)(?:\.|\s|$)", re.MULTILINE)


def test_port_sources_import_no_jax():
    """Every module of clraytracer_tpu_torch/ (utils/, raycast.py,
    engine.py, bench.py and tools/ included) and chip_smoke.py: no
    ``import jax`` and nothing of ``clraytracer_tpu``, at any depth."""
    files = sorted((ROOT / "clraytracer_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    names = {p.relative_to(ROOT).as_posix() for p in files}
    for need in ("clraytracer_tpu_torch/engine.py", "clraytracer_tpu_torch/raycast.py",
                 "clraytracer_tpu_torch/bench.py", "clraytracer_tpu_torch/utils/timer.py",
                 "clraytracer_tpu_torch/tools/live_viewer.py"):
        assert need in names
    bad = [p.relative_to(ROOT).as_posix() for p in files if _JAX_IMPORT.search(p.read_text())]
    assert not bad, bad
