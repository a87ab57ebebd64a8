"""The port's multi-device layer (``clraytracer_tpu_torch.parallel``) on the
CPU: ranks are gloo processes (tests/_torch_dist_worker.py, which imports
no JAX), started once for the module as worlds of 2, 4 and 8 ranks; the
JAX side runs on the conftest's 8 virtual devices.

* the planar path of ``render_sharded`` (``trace_wavefront``) over 2
  ranks against the JAX ``render_sharded`` over 2 devices;
* the fused branch (K2.2's plain version on each rank's row window) over
  2 and 4 ranks bit-equal to 1 rank, and against the JAX ``render_frame``;
* uneven heights (30 rows over 4 ranks, 10 over 8) bit-equal to 1 rank;
* ``make_geo_sharded_tracer`` over 4 ranks: the port's
  ``trace_wavefront``'s hit records bit for bit, and the JAX one's winners
  (ties included), with more shards than instances too; ``render_sharded_2d`` on a 2x2 mesh bit-equal to the
  port's ``render_frame(tracer=trace_wavefront)``;
* ``train_step_sharded`` and ``train_step_sharded_2d`` over 2 and 4 ranks
  against the JAX ``image_loss_and_grads`` and the port's 1-rank step;
* ``cli sweep --device cpu`` as 2 processes.

Frames compare by the frame rule (at least 99% of pixels within 1e-5),
steps at the JAX tests' rtol 2e-2 / atol 1e-5 (tests/test_sharding.py).
Every rendezvous is a file under the test's temporary directory, and
every process and process group has a timeout of its own.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from clraytracer_tpu import math3d as jm
from clraytracer_tpu.camera import Camera as JCamera
from clraytracer_tpu.camera import ray_directions_planar as j_rays
from clraytracer_tpu.config import CameraConfig as JCameraConfig
from clraytracer_tpu.config import RenderConfig as JRenderConfig
from clraytracer_tpu.diff import image_loss_and_grads as j_loss_and_grads
from clraytracer_tpu.ops.trace_wavefront import trace_wavefront as j_trace_wavefront
from clraytracer_tpu.parallel.sharding import make_device_mesh as j_mesh
from clraytracer_tpu.parallel.sharding import render_sharded as j_render_sharded
from clraytracer_tpu.parallel.sharding import train_step_sharded as j_train_step_sharded
from clraytracer_tpu.render import frame_inputs_from_camera as j_frame_inputs
from clraytracer_tpu.render import render_frame as j_render_frame
from clraytracer_tpu.scene import SceneBuilder as JSceneBuilder
from clraytracer_tpu.scene import procedural_tex as j_ptex
from clraytracer_tpu.scene.procedural import cube as j_cube
from clraytracer_tpu.scene.procedural import uv_sphere as j_uv_sphere
from clraytracer_tpu_torch.config import RenderConfig
from clraytracer_tpu_torch.diff import make_differentiable_tracer
from clraytracer_tpu_torch.ops.trace_wavefront import trace_wavefront
from clraytracer_tpu_torch.parallel import sharding as sh
from clraytracer_tpu_torch.render import TRACERS, render_frame
from clraytracer_tpu_torch.scene.bridge import scene_from_numpy
from test_torch_scene import flatten
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)
import _torch_dist_worker as worker

W, H = 32, 24
ROOT = Path(__file__).resolve().parent.parent
#: seconds a world of ranks may take, start-up included
WORLD_TIMEOUT_S = 300
LR = 1.0


def _multi_instance(jb):
    """tests/test_geometry_sharding.py's 5-instance scene (a sphere and
    cubes, overlapping, so equal-t ties at seams)."""
    b = jb()
    b.import_procedural(j_ptex.sky_gradient(32, 16))
    checker = b.import_procedural(j_ptex.checker(16, 4))
    m0 = b.create_material(albedo=(0.9, 0.3, 0.2), albedo_tex=checker)
    m1 = b.create_material(albedo=(0.2, 0.8, 0.3), shininess=1.5)
    sphere = b.add_mesh(j_uv_sphere(1.0, n_lat=6, n_lon=10), materials_start=m0)
    cube_m = b.add_mesh(j_cube(0.9), materials_start=m1)
    b.add_instance(sphere)
    b.add_instance(cube_m, jm.translation(1.2, 0.1, -0.5))
    b.add_instance(cube_m, jm.translation(-1.4, -0.2, 0.6))
    b.add_instance(sphere, jm.translation(0.6, 0.9, -1.0))
    b.add_instance(cube_m, jm.translation(-0.3, -1.0, -0.2))
    return b.build()


def _single_instance(jb):
    """tests/test_geometry_sharding.py::test_geo_shards_exceed_instances's
    one-sphere scene."""
    b = jb()
    b.import_procedural(j_ptex.sky_gradient(32, 16))
    m = b.create_material(albedo=(0.8, 0.5, 0.2))
    b.add_instance(b.add_mesh(j_uv_sphere(1.5, n_lat=6, n_lon=10), materials_start=m))
    return b.build()


def _target(h=H, w=W, seed=0):
    return np.random.default_rng(seed).uniform(0.0, 1.0, (h, w, 3)).astype(np.float32)


#: per world size, the cases its ranks run (tests/_torch_dist_worker.py)
CASES = {
    2: [
        dict(kind="render", name="wf2", scene="sphere", tracer="wavefront", wh=(W, H)),
        dict(kind="render", name="fused2", scene="procedural", tracer="best", wh=(W, H)),
        dict(kind="train", name="train2", scene="sphere", tracer="best", wh=(W, H),
             target=_target(), lr=LR),
    ],
    4: [
        dict(kind="render", name="fused4", scene="procedural", tracer="best", wh=(W, H)),
        dict(kind="render", name="uneven30", scene="sphere", tracer="best", wh=(W, 30)),
        dict(kind="render", name="wf_uneven30", scene="sphere", tracer="wavefront",
             wh=(W, 30)),
        dict(kind="geo_trace", name="geo5", scene="multi", wh=(40, 24)),
        dict(kind="geo_trace", name="geo1", scene="single", wh=(32, 16)),
        dict(kind="render_2d", name="r2d", scene="multi", wh=(W, H), mesh=(2, 2), sun=-1.8),
        dict(kind="train_2d", name="t2d", scene="multi", wh=(W, H), mesh=(2, 2),
             target=_target(seed=3), lr=LR),
    ],
    8: [
        dict(kind="render", name="uneven10", scene="sphere", tracer="best", wh=(16, 10)),
    ],
}


class Worlds:
    """The worlds' processes, started together; ``get(n)`` waits for the
    world of n ranks and returns each rank's arrays."""

    def __init__(self, tmp: Path, scenes: dict):
        self.procs, self.dirs, self.done = {}, {}, {}
        for n, cases in CASES.items():
            d = self.dirs[n] = tmp / f"world{n}"
            d.mkdir()
            self.procs[n] = worker.start(n, d, {"scenes": scenes, "cases": cases})

    def get(self, n: int) -> list[dict]:
        if n not in self.done:
            self.done[n] = worker.wait(self.procs[n], self.dirs[n], WORLD_TIMEOUT_S)
        return self.done[n]

    def stop(self):
        for procs in self.procs.values():
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()


@pytest.fixture(scope="module")
def jscenes(sphere_scene, procedural_scene):
    return {"sphere": sphere_scene, "procedural": procedural_scene,
            "multi": _multi_instance(JSceneBuilder),
            "single": _single_instance(JSceneBuilder)}


@pytest.fixture(scope="module")
def pscenes(jscenes):
    return {k: scene_from_numpy(*flatten(v), device="cpu") for k, v in jscenes.items()}


@pytest.fixture(scope="module")
def worlds(jscenes, tmp_path_factory):
    w = Worlds(tmp_path_factory.mktemp("worlds"),
               {k: flatten(v) for k, v in jscenes.items()})
    yield w
    w.stop()


def _ranks_agree(ranks: list[dict], key: str) -> np.ndarray:
    """Rank 0's array of ``key``, after checking every rank holds it bit for
    bit (the results are replicated)."""
    for r in ranks[1:]:
        np.testing.assert_array_equal(r[key], ranks[0][key])
    return ranks[0][key]


def _frame_rule(got, ref, what):
    close = np.isclose(got, ref, rtol=0.0, atol=1e-5).all(axis=-1)
    assert got.shape == ref.shape and close.mean() >= 0.99, (what, close.mean())


def _port_one_rank(pscenes, name, w, h, tracer="best"):
    """The port's ``render_sharded`` on a world of one."""
    _, frame = worker.frame_of(w, h)
    mesh = sh.make_device_mesh(device="cpu")
    return sh.render_sharded(pscenes[name], frame, RenderConfig(width=w, height=h), mesh,
                             tracer=TRACERS[tracer]).numpy()


def _jax_frame(w=W, h=H, position=worker.CAMERA, sun=-1.96):
    cam = JCamera.create(JCameraConfig(position=position), w, h)
    return j_frame_inputs(cam, sun)


def test_fused_branch_over_2_and_4_ranks(worlds, jscenes, pscenes):
    """K2.2's plain version on each rank's row window: 2 and 4 ranks
    bit-equal to 1 rank, and the frame rule against the JAX
    ``render_frame`` (its fused kernel in interpret mode)."""
    cfg = JRenderConfig(width=W, height=H)
    ref = np.asarray(jax.jit(lambda s, f: j_render_frame(s, f, cfg))(
        jscenes["procedural"], _jax_frame()))
    one = _port_one_rank(pscenes, "procedural", W, H)
    for n, key in ((2, "fused2"), (4, "fused4")):
        got = _ranks_agree(worlds.get(n), key)
        np.testing.assert_array_equal(got, one)
        _frame_rule(got, ref, key)


def test_planar_path_matches_jax_render_sharded(worlds, jscenes, pscenes):
    """``trace_wavefront`` through ``_shade_rows`` over 2 ranks against the
    JAX ``render_sharded`` over 2 of the virtual devices."""
    cfg = JRenderConfig(width=W, height=H)
    mesh = j_mesh(jax.devices()[:2])
    ref = np.asarray(jax.jit(lambda s, f: j_render_sharded(
        s, f, cfg, mesh, tracer=j_trace_wavefront))(jscenes["sphere"], _jax_frame()))
    got = _ranks_agree(worlds.get(2), "wf2")
    _frame_rule(got, ref, "wf2")
    np.testing.assert_array_equal(got, _port_one_rank(pscenes, "sphere", W, H, "wavefront"))


@pytest.mark.parametrize("key,n,wh,tracer", [
    ("uneven30", 4, (W, 30), "best"),
    ("wf_uneven30", 4, (W, 30), "wavefront"),
    ("uneven10", 8, (16, 10), "best"),
])
def test_uneven_rows_equal_one_rank(worlds, pscenes, key, n, wh, tracer):
    """A last window that runs past H (30 rows over 4 ranks: windows of 8;
    10 over 8: windows of 2) is cut, and the frame is the 1-rank frame."""
    got = _ranks_agree(worlds.get(n), key)
    assert got.shape == (wh[1], wh[0], 3)
    np.testing.assert_array_equal(got, _port_one_rank(pscenes, "sphere", *wh, tracer))


def _jax_hits(jscene, w, h):
    cam = JCamera.create(JCameraConfig(position=worker.GEO_CAMERA, yaw_deg=-90.0), w, h)
    d = j_rays(jnp.asarray(cam.inverse_view), jnp.asarray(cam.inverse_projection), w, h)
    o = jnp.broadcast_to(jnp.asarray(cam.position)[:, None, None], d.shape)
    return jax.jit(j_trace_wavefront)(jscene, o, d)


@pytest.mark.parametrize("key,scene,wh", [
    ("geo5", "multi", (40, 24)),  # 5 instances over 4 shards: blocks 2, 2, 1, 0
    ("geo1", "single", (32, 16)),  # more shards than instances
])
def test_geo_tracer_matches_jax_wavefront(worlds, jscenes, pscenes, key, scene, wh):
    """``make_geo_sharded_tracer`` over 4 ranks: every hit record field bit
    for bit the port's ``trace_wavefront``'s; against the JAX
    ``trace_wavefront`` the winners (hit, triangle, instance: the tie rule)
    exactly and t, u, v on the hits within 1e-5, the rule of the port's
    tracers (tests/test_torch_tracers.py: the ray's move to object space
    rounds apart by an ulp)."""
    ref = _jax_hits(jscenes[scene], *wh)
    o, d = worker.rays_of(*wh)
    port = trace_wavefront(pscenes[scene], o, d)
    ranks = worlds.get(4)
    hit = np.asarray(ref.hit)
    assert hit.sum() > 0
    for f in ("t", "u", "v", "tri", "instance", "hit"):
        got = _ranks_agree(ranks, f"{key}.{f}")
        np.testing.assert_array_equal(got, getattr(port, f).numpy(), err_msg=f)
        if f in ("t", "u", "v"):
            np.testing.assert_allclose(got[hit], np.asarray(getattr(ref, f))[hit],
                                       rtol=0, atol=1e-5, err_msg=f)
        else:
            np.testing.assert_array_equal(got, np.asarray(getattr(ref, f)), err_msg=f)


def test_render_2d_equals_render_frame(worlds, pscenes):
    """``render_sharded_2d`` on a 2x2 mesh (rows x instance blocks) bit-equal
    to the port's ``render_frame(tracer=trace_wavefront)``."""
    _, frame = worker.frame_of(W, H, worker.GEO_CAMERA, -1.8)
    ref = render_frame(pscenes["multi"], frame, RenderConfig(width=W, height=H),
                       device="cpu", tracer=trace_wavefront).numpy()
    np.testing.assert_array_equal(_ranks_agree(worlds.get(4), "r2d"), ref)


def _jax_step(jscene, target, position, **kw):
    """(loss, albedo gradient x H*W*3) of the JAX ``image_loss_and_grads``
    (mean L2), jitted."""
    frame = _jax_frame(position=position)
    loss, g = jax.jit(lambda s: j_loss_and_grads(
        s, frame, W, H, target=jnp.asarray(target), **kw))(jscene)
    return float(loss), np.asarray(g.materials.albedo) * (H * W * 3)


def _implied_grad(before, after):
    return (before - after) / (LR / (H * W * 3))


@pytest.mark.parametrize("kind", ["1d", "2d"])
def test_train_step_matches_jax_and_one_rank(worlds, jscenes, pscenes, kind):
    """``train_step_sharded`` over 2 ranks (K2.1's plain version finds the
    hits) and ``train_step_sharded_2d`` on a 2x2 mesh (the instance-sharded
    wavefront walk): loss and the gradient the albedo update implies
    against the JAX ``image_loss_and_grads`` (the 2-D one through
    ``trace_wavefront``, its exact twin), and loss and albedo against the
    port's 1-rank step."""
    from clraytracer_tpu_torch.parallel import geometry as geo

    if kind == "1d":
        scene, key, n, target = "sphere", "train2", 2, _target()
        position, jkw = worker.CAMERA, {}
        tracer = make_differentiable_tracer(TRACERS["best"])
    else:
        scene, key, n, target = "multi", "t2d", 4, _target(seed=3)
        position, jkw = worker.GEO_CAMERA, {"base_tracer": j_trace_wavefront}
        tracer = make_differentiable_tracer(
            geo.make_geo_sharded_tracer(sh.make_device_mesh(device="cpu")))
    loss_ref, g_ref = _jax_step(jscenes[scene], target, position, **jkw)
    _, frame = worker.frame_of(W, H, position)
    loss1, new1 = sh._train_step(pscenes[scene], frame, torch.from_numpy(target),
                                 sh.make_device_mesh(device="cpu"), LR, W, H, 2, tracer)
    ranks = worlds.get(n)
    loss = float(_ranks_agree(ranks, f"{key}.loss"))
    albedo = _ranks_agree(ranks, f"{key}.albedo")
    before = pscenes[scene].materials.albedo.numpy()
    np.testing.assert_allclose(loss, loss_ref, rtol=2e-2, atol=1e-5)
    np.testing.assert_allclose(_implied_grad(before, albedo), g_ref, rtol=2e-2, atol=1e-5)
    assert np.abs(g_ref).max() > 0
    np.testing.assert_allclose(loss, float(loss1), rtol=1e-5)
    np.testing.assert_allclose(albedo, new1.materials.albedo.numpy(), rtol=1e-5)


@pytest.mark.slow
def test_train_step_matches_jax_train_step_sharded(worlds, jscenes, pscenes):
    """The port's 2-rank step against the JAX ``train_step_sharded`` itself
    on 2 virtual devices (its shard_map forward and backward compile for
    minutes on the CPU, hence ``slow``)."""
    frame = _jax_frame()
    mesh = j_mesh(jax.devices()[:2])
    loss_j, new_j = j_train_step_sharded(jscenes["sphere"], frame, jnp.asarray(_target()),
                                         mesh, lr=LR)
    ranks = worlds.get(2)
    before = pscenes["sphere"].materials.albedo.numpy()
    np.testing.assert_allclose(float(_ranks_agree(ranks, "train2.loss")), float(loss_j),
                               rtol=2e-2, atol=1e-5)
    np.testing.assert_allclose(
        _implied_grad(before, _ranks_agree(ranks, "train2.albedo")),
        _implied_grad(before, np.asarray(new_j.materials.albedo)), rtol=2e-2, atol=1e-5)


def test_cli_sweep_two_processes(tmp_path):
    """``sweep --device cpu`` as 2 processes on a file rendezvous: rank 0
    prints the rows for 1 and 2 ranks and the summary; rank 1 prints
    nothing."""
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = str(ROOT) + (os.pathsep + env["PYTHONPATH"]
                                      if env.get("PYTHONPATH") else "")
    procs = [
        subprocess.Popen(
            [sys.executable, "-m", "clraytracer_tpu_torch", "sweep", "--device", "cpu",
             "--scene", "sphere", "--tris", "256", "--width", "32", "--height", "24",
             "--iters", "2", "--coordinator", f"file://{tmp_path}/rdv",
             "--num-processes", "2", "--process-id", str(r)],
            cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        )
        for r in range(2)
    ]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=WORLD_TIMEOUT_S)
            assert p.returncode == 0, err.decode()[-3000:]
            outs.append(out.decode())
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    lines = [json.loads(x) for x in outs[0].splitlines() if x.startswith("{")]
    rows, summary = lines[:-1], lines[-1]
    assert [r["devices"] for r in rows] == [1, 2]
    assert all(np.isfinite(r["mrays_per_s"]) and r["mrays_per_s"] > 0 for r in rows)
    assert rows[0]["efficiency"] == 1.0
    assert summary["processes"] == 2 and summary["backend"] == "gloo"
    assert summary["sweep"] == rows and summary["platform"] == "cpu"
    assert outs[1].strip() == ""
