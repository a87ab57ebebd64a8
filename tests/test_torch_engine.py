"""The port's ``Engine`` against the JAX ``Engine`` on the CPU:
tests/test_engine.py's scene at 24x16 through ``tracer="wavefront"``, the
frame before and after ``set_instance_transform`` + ``tick`` and after
``update_camera`` (the frame rule: at least 99% of pixels within 1e-5);
the port's ``tracer="best"`` frames (K2.2's plain version) against its
own ``"wavefront"`` frames by the same rule; events, ``close``, ``stats``
and the frame watchdog; and that a tick keeps the traversal's geometry
tables (the same tensors) with the new instance rows, builds no triangle
or material row, and leaves tables equal to a fresh build's."""

import dataclasses

import numpy as np
import pytest
import torch

from clraytracer_tpu import math3d as jm
from clraytracer_tpu.config import CameraConfig as JCameraConfig
from clraytracer_tpu.config import RenderConfig as JRenderConfig
from clraytracer_tpu.engine import Engine as JEngine
from clraytracer_tpu.scene import SceneBuilder as JSceneBuilder
from clraytracer_tpu.scene.procedural import uv_sphere as j_uv_sphere
from clraytracer_tpu.scene.textures import gradient_sky as j_gradient_sky
from clraytracer_tpu_torch import math3d as tm
from clraytracer_tpu_torch.config import CameraConfig, RenderConfig
from clraytracer_tpu_torch.engine import Engine, FrameWatchdogError
from clraytracer_tpu_torch.ops import shade
from clraytracer_tpu_torch.ops import trace as tr
from clraytracer_tpu_torch.ops.shade import build_shading_tables
from clraytracer_tpu_torch.scene import SceneBuilder
from clraytracer_tpu_torch.scene.bridge import scene_from_numpy
from clraytracer_tpu_torch.scene.procedural import uv_sphere
from clraytracer_tpu_torch.scene.textures import gradient_sky
from test_torch_scene import flatten
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

W, H = 24, 16
MOVE = dict(mouse_delta=(40.0, 10.0), move=(0.5, 0.0, 0.0))


def _recipe(builder_cls, sphere, sky):
    """tests/test_engine.py::_engine's scene."""
    b = builder_cls()
    b.import_texture(sky(32, 16))
    mat = b.create_material(albedo=(0.8, 0.3, 0.2))
    b.add_instance(b.add_mesh(sphere(1.5, n_lat=7, n_lon=14), materials_start=mat))
    return b


def _port_engine(tracer="wavefront"):
    return Engine(_recipe(SceneBuilder, uv_sphere, gradient_sky),
                  RenderConfig(width=W, height=H), CameraConfig(position=(0.0, 0.0, 8.0)),
                  tracer=tracer, device="cpu")


def _run(eng, np_img, transform):
    """The three frames: as started, after an instance move and tick, after
    a camera update."""
    eng.start()
    frames = [np_img(eng.render())]
    eng.set_instance_transform(0, transform)
    eng.tick()
    frames.append(np_img(eng.render()))
    eng.update_camera(**MOVE)
    frames.append(np_img(eng.render()))
    return frames


def _assert_frame_rule(got, ref, label):
    assert got.shape == ref.shape == (H, W, 3) and np.isfinite(got).all()
    bad = (np.abs(got - ref) > 1e-5).any(axis=-1)
    assert bad.mean() <= 0.01, f"{label}: {int(bad.sum())} of {bad.size} pixels"


@pytest.fixture(scope="module")
def frames():
    jeng = JEngine(_recipe(JSceneBuilder, j_uv_sphere, j_gradient_sky),
                   JRenderConfig(width=W, height=H), JCameraConfig(position=(0.0, 0.0, 8.0)),
                   tracer="wavefront")
    ref = _run(jeng, np.asarray, jm.rotation_y(0.8) @ jm.translation(1.2, 0.0, 0.0))
    move = tm.rotation_y(0.8) @ tm.translation(1.2, 0.0, 0.0)
    wave = _run(_port_engine("wavefront"), lambda t: t.numpy(), move)
    best = _run(_port_engine("best"), lambda t: t.numpy(), move)
    return ref, wave, best


@pytest.mark.parametrize("i", [0, 1, 2], ids=["start", "after_tick", "after_camera"])
def test_engine_frames_match_jax(frames, i):
    ref, wave, _ = frames
    _assert_frame_rule(wave[i], ref[i], "port wavefront vs JAX wavefront")


@pytest.mark.parametrize("i", [0, 1, 2], ids=["start", "after_tick", "after_camera"])
def test_engine_best_matches_wavefront(frames, i):
    _, wave, best = frames
    _assert_frame_rule(best[i], wave[i], "port best vs port wavefront")


def test_edits_change_the_frame(frames):
    _, wave, best = frames
    for seq in (wave, best):
        assert np.abs(seq[1] - seq[0]).max() > 0.05  # the sphere moved
        assert np.abs(seq[2] - seq[1]).max() > 0.01  # the camera turned


def test_frame_loop_and_events():
    eng = _port_engine()
    eng.start()
    fired = []
    eng.add_end_of_frame_event(lambda: fired.append("eof"))
    eng.add_on_exit_event(lambda: fired.append("exit"))
    img = eng.render()
    assert isinstance(img, torch.Tensor) and img.device.type == "cpu"
    assert img.shape == (H, W, 3) and torch.isfinite(img).all()
    assert eng.frame_index == 1 and fired == []  # deferred until end_frame
    eng.end_frame()
    assert fired == ["eof"]
    eng.end_frame()  # drained: no second call
    assert fired == ["eof"]
    eng.close()
    assert fired == ["eof", "exit"]
    eng.close()
    assert fired == ["eof", "exit"]
    assert "engine.render" in eng.stats and "engine.start" in eng.stats


def test_frame_watchdog(sphere_scene):
    """tests/test_engine.py::test_frame_watchdog on the port: a generous
    budget never raises; at 1e-6 ms the first two frames are exempt and
    the third raises."""
    scene = scene_from_numpy(*flatten(sphere_scene), device="cpu")
    eng = Engine(scene=scene, config=RenderConfig(width=16, height=12, frame_watchdog_ms=1e9),
                 tracer="bvh", device="cpu")
    for _ in range(3):
        eng.render()
    eng2 = Engine(scene=scene, config=RenderConfig(width=16, height=12, frame_watchdog_ms=1e-6),
                  tracer="bvh", device="cpu")
    eng2.render()
    eng2.render()
    with pytest.raises(FrameWatchdogError):
        eng2.render()


def test_tick_keeps_geometry_tables():
    """After a tick the packed instance rows track the canonical instance
    table (``build_shading_tables``), and ``kernel_tables`` hands the same
    geometry tensors with the new instance rows; the packed ``tri_attr``
    and ``mat_rows`` and the frame tables, descriptor rows and all, are
    the same tensors."""
    eng = _port_engine("best")
    eng.start()
    kt0, ft0 = tr.kernel_tables(eng.scene), tr.frame_tables(eng.scene)
    pk0 = eng.scene.packed
    eng.render()
    eng.set_instance_transform(0, tm.rotation_y(0.4) @ tm.translation(0.3, 0.0, 0.0))
    eng.tick()
    np.testing.assert_array_equal(eng.scene.packed.inst_rows.numpy(),
                                  build_shading_tables(eng.scene).inst_rows.numpy())
    kt1, ft1 = tr.kernel_tables(eng.scene), tr.frame_tables(eng.scene)
    assert kt1 is not kt0
    for f in ("planes", "attrs", "hyper_box", "super_box", "cluster_box", "tri_gid", "ranges"):
        assert getattr(kt1, f).data_ptr() == getattr(kt0, f).data_ptr(), f
    assert torch.equal(kt1.inst, eng.scene.packed.inst_rows)
    assert not torch.equal(kt1.inst, kt0.inst)
    assert ft1.tex.data_ptr() == ft0.tex.data_ptr()
    assert ft1 is ft0
    assert eng.scene.packed is not pk0
    assert eng.scene.packed.tri_attr is pk0.tri_attr
    assert eng.scene.packed.mat_rows is pk0.mat_rows
    eng.tick()  # nothing dirty: the scene stays
    assert tr.kernel_tables(eng.scene) is kt1


def _pool_builder(n: int = 40) -> SceneBuilder:
    """``n`` small spheres on a grid, more than ``tr.INSTANCE_CHUNK``:
    the instance level's chunk boxes too."""
    b = _recipe(SceneBuilder, uv_sphere, gradient_sky)
    mesh = b.add_mesh(uv_sphere(0.3, n_lat=4, n_lon=6), materials_start=0)
    for k in range(n - 1):
        b.add_instance(mesh, tm.translation(0.7 * (k % 8) - 2.5, 0.7 * (k // 8) - 1.5, 1.0))
    return b


def test_edited_tables_equal_a_fresh_build():
    """After instance edits and ticks, with frames between them, the
    engine's tables equal field for field and bit for bit those of a scene
    built afresh from the same builder, and its packed rows those of the
    fresh build and of the canonical leaves (``build_shading_tables``)."""
    eng = Engine(_pool_builder(), RenderConfig(width=W, height=H),
                 CameraConfig(position=(0.0, 0.0, 8.0)), tracer="best", device="cpu")
    eng.start()
    eng.render()
    assert tr.kernel_tables(eng.scene).n_chunks == tr.chunk_count(40) > 0
    for i, k in enumerate((3, 37, 3, 0)):
        eng.set_instance_transform(k, tm.rotation_y(0.3 * (i + 1)) @ tm.translation(0.1 * i, 0.2, -0.5))
        eng.tick()
        eng.render()
    fresh = eng.builder.build(device="cpu")
    pairs = ((tr.kernel_tables(eng.scene), tr.kernel_tables(fresh)),
             (tr.frame_tables(eng.scene), tr.frame_tables(fresh)))
    for got, want in pairs:
        for f in dataclasses.fields(got):
            a, b = getattr(got, f.name), getattr(want, f.name)
            assert torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b, f.name
    leaves = build_shading_tables(fresh)
    for f in ("tri_attr", "inst_rows", "mat_rows"):
        assert torch.equal(getattr(eng.scene.packed, f), getattr(fresh.packed, f)), f
        assert torch.equal(getattr(eng.scene.packed, f), getattr(leaves, f)), f


def test_an_instance_edit_builds_no_triangle_or_material_row(monkeypatch):
    """The tick after an instance edit calls no ``build_shading_tables``:
    it builds no ``tri_attr`` and no ``mat_rows`` row, and hands the old
    tensors on."""
    eng = _port_engine("best")
    eng.start()
    eng.render()
    pk0, ft0 = eng.scene.packed, tr.frame_tables(eng.scene)

    def refuse(scene):
        raise AssertionError("an instance edit built the packed rows")

    monkeypatch.setattr(shade, "build_shading_tables", refuse)
    eng.set_instance_transform(0, tm.translation(0.2, -0.1, 0.0))
    eng.tick()
    assert eng.scene.packed is not pk0
    assert eng.scene.packed.tri_attr is pk0.tri_attr and eng.scene.packed.mat_rows is pk0.mat_rows
    assert tr.frame_tables(eng.scene) is ft0
    assert not torch.equal(eng.scene.packed.inst_rows, pk0.inst_rows)
    eng.render()


def test_engine_refuses_what_it_cannot_run():
    with pytest.raises(ValueError):
        Engine(config=RenderConfig(width=W, height=H), device="cpu")
    with pytest.raises(ValueError):
        Engine(_recipe(SceneBuilder, uv_sphere, gradient_sky), tracer="nope", device="cpu")
    if torch.cuda.is_available():
        pytest.skip("a card is present: device=None is the card")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Engine(_recipe(SceneBuilder, uv_sphere, gradient_sky))


@pytest.mark.parametrize("n", [3, 40])
def test_builder_rows_equal_a_fresh_builds(n):
    """The builder's kept instance rows (``instance_rows``, the tick's one
    upload) after transform edits and an ``add_instance`` equal bit for
    bit the instance rows of a scene built afresh from the same builder
    (``shade._inst_rows`` of its leaves, and its packed rows); the tick
    hands them to the packed object, the kernel tables and, as a view, the
    instance table, whose material starts stay the same tensor until a new
    instance comes."""
    b = _pool_builder(n) if n > 3 else _recipe(SceneBuilder, uv_sphere, gradient_sky)
    while len(b.mesh_index) < n:
        b.add_instance(0, tm.translation(1.0 * len(b.mesh_index), 0.0, 0.0))
    eng = Engine(b, RenderConfig(width=W, height=H), CameraConfig(position=(0.0, 0.0, 8.0)),
                 tracer="best", device="cpu")
    eng.start()
    for step, k in enumerate((1, n - 1, 1)):
        eng.set_instance_transform(k, tm.rotation_y(0.2 * step) @ tm.translation(0.1, step, 0.0))
        starts = eng.scene.instances.material_start
        eng.tick()
        pk, inst = eng.scene.packed, eng.scene.instances
        assert tr.kernel_tables(eng.scene).inst is pk.inst_rows
        assert inst.inverse_transform.data_ptr() == pk.inst_rows.data_ptr()
        assert inst.material_start is starts and inst.mesh_index is b.mesh_index
        fresh = b.build(device="cpu")
        for rows in (b.instance_rows(device="cpu"), pk.inst_rows):
            assert rows.numpy().tobytes() == shade._inst_rows(fresh).numpy().tobytes()
            assert rows.numpy().tobytes() == fresh.packed.inst_rows.numpy().tobytes()
    b.add_instance(0, tm.translation(0.0, -2.0, 1.0))
    eng._instances_dirty = True
    eng.tick()
    fresh = b.build(device="cpu")
    assert eng.scene.instances.mesh_index == fresh.instances.mesh_index
    assert torch.equal(eng.scene.instances.material_start, fresh.instances.material_start)
    assert eng.scene.packed.inst_rows.numpy().tobytes() == shade._inst_rows(fresh).numpy().tobytes()
    assert torch.equal(tr.kernel_tables(eng.scene).ranges, tr.kernel_tables(fresh).ranges)


@pytest.mark.parametrize("size", [(1920, 1080), (1249, 720)])
def test_kept_projection_camera_row_bit_equal(size):
    """``Engine``'s frame (a ``render.CameraFrame``: the projection's
    inverse kept for the camera's configuration and size) gives the fused
    kernel's camera row bit-equal to ``camera_row(frame_inputs_from_camera
    (camera, sun))`` at each of the museum walk's 240 poses; the kept
    inverse is one array over the walk."""
    import json

    from clraytracer_tpu_torch.ops import render_fused as rf
    from clraytracer_tpu_torch.render import frame_inputs_from_camera
    from rtbench import port
    from rtbench.cells import HERE
    from rtbench.poses import path

    cfg = json.loads((HERE / "configs" / "museum160k.json").read_text())
    w, h = size
    eng = Engine(_recipe(SceneBuilder, uv_sphere, gradient_sky),
                 RenderConfig(width=w, height=h, sun_angle=float(cfg["sun_angle"])),
                 device="cpu")
    kept = eng._frame().inverse_projection
    for pose in path(cfg["path"], 240):
        port.set_pose(eng, pose)
        frame = eng._frame()
        assert frame.inverse_projection is kept
        got = frame.kernel_row()
        want = rf.camera_row(frame_inputs_from_camera(eng.camera, eng.sun_angle))
        assert np.array(got.cam, np.float64).tobytes() == np.array(want.cam, np.float64).tobytes()
        assert got.sun == want.sun


def test_frame_plans_kept_across_instance_edits_alone():
    """The frame plans (``render_fused.render_plan``) are kept with the
    frame tables: an instance edit hands the same plans on, a material edit
    (``refresh_packed``) starts none; the options make the key, a new GI
    seed does not."""
    from clraytracer_tpu_torch.ops import render_fused as rf

    eng = _port_engine("best")
    eng.start()
    eng.render()
    plans = tr.kept_tables(eng.scene).plans
    eng.set_instance_transform(0, tm.translation(0.2, 0.1, 0.0))
    eng.tick()
    assert tr.kept_tables(eng.scene).plans is plans
    assert tr.kept_tables(eng.scene, build=False).plans is plans
    mats = eng.scene.materials
    eng.scene = shade.refresh_packed(dataclasses.replace(
        eng.scene, materials=dataclasses.replace(mats, albedo=mats.albedo * 0.5)))
    assert tr.kept_tables(eng.scene).plans is not plans
    key = rf.plan_key(W, H, 2, post=True)
    assert rf.plan_key(W, H, 2, gi_seed=3) == rf.plan_key(W, H, 2, gi_seed=4)
    others = [rf.plan_key(W + 8, H, 2, post=True), rf.plan_key(W, H + 8, 2, post=True),
              rf.plan_key(W, H, 1, post=True), rf.plan_key(W, H, 2, True, post=True),
              rf.plan_key(W, H, 2, gi_seed=0, post=True), rf.plan_key(W, H, 2)]
    assert key not in others and len(set(others)) == len(others)
    # the CPU runs the plain versions: no plan is made there
    counts = (rf.render_plan.builds, rf.render_plan.frames)
    assert rf.render_plan(eng.scene, None, W, H, 2) is None
    assert (rf.render_plan.builds, rf.render_plan.frames) == counts
