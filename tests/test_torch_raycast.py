"""The port's ``raycast`` and ``pick`` against the JAX package's on the
CPU, both through ``trace_bvh`` (the default of each): 64 seeded rays and
tests/test_raycast.py's three on the ``sphere_scene`` fixture, and 16
seeded screen points. ``index``, ``instance`` and ``hit`` exact;
``distance``, ``normal``, ``uv`` and ``color`` within 1e-5. Then the
port's ``raycast(tracer=trace_best)`` (K2.1's plain version here) against
its ``trace_bvh`` result: the same hits on all but at most 1 of 64 rays
(a seam tie). Last, ``pick``'s one packed record and its unpacking on the
host against ``raycast``'s fields, bit for bit."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from clraytracer_tpu import raycast as jray
from clraytracer_tpu.camera import Camera as JCamera
from clraytracer_tpu.config import CameraConfig as JCameraConfig
from clraytracer_tpu_torch import raycast as tray
from clraytracer_tpu_torch.camera import Camera as TCamera
from clraytracer_tpu_torch.config import CameraConfig as TCameraConfig
from clraytracer_tpu_torch.camera import screen_point_to_ray
from clraytracer_tpu_torch.render import TRACERS, trace_best
from clraytracer_tpu_torch.scene.bridge import scene_from_numpy
from test_torch_scene import flatten
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

ATOL = 1e-5
CAMERA = dict(position=(0.13, 0.21, 10.0))


@pytest.fixture(scope="module")
def scenes(sphere_scene):
    return sphere_scene, scene_from_numpy(*flatten(sphere_scene), device="cpu")


def _rays(n=64, seed=0):
    """64 seeded rays from a shell of radius 10 towards points near the
    sphere (radius 2), some passing it, and tests/test_raycast.py's
    three."""
    rng = np.random.default_rng(seed)
    o = rng.normal(size=(n, 3))
    o = o / np.linalg.norm(o, axis=1, keepdims=True) * 10.0
    d = rng.uniform(-2.6, 2.6, size=(n, 3)) - o
    o = np.concatenate([o, [[0, 0, 10], [0, 0, 10], [50, 50, 50]]])
    d = np.concatenate([d, [[0, 0, -1], [0.05, 0.03, -1], [0, 0, -1]]])
    d = d / np.linalg.norm(d, axis=1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32)


def _assert_records_match(got, ref):
    for f in ("index", "instance", "hit"):
        np.testing.assert_array_equal(np.asarray(getattr(got, f)), np.asarray(getattr(ref, f)),
                                      err_msg=f)
    for f in ("distance", "normal", "uv", "color"):
        g, r = np.asarray(getattr(got, f)), np.asarray(getattr(ref, f))
        assert g.shape == r.shape, f
        np.testing.assert_allclose(g, r, rtol=0, atol=ATOL, err_msg=f)


def test_raycast_matches_jax(scenes):
    js, ts = scenes
    o, d = _rays()
    ref = jray.raycast(js, jnp.asarray(o), jnp.asarray(d))
    got = tray.raycast(ts, torch.from_numpy(o), torch.from_numpy(d))
    hits = np.asarray(ref.hit)
    assert 16 < hits.sum() < hits.size and hits[-3] and hits[-2] and not hits[-1]
    _assert_records_match(got, ref)
    assert got.distance[-1] == np.float32(tray.MISS)
    np.testing.assert_allclose(float(got.distance[-3]), 8.0, atol=0.05)


def test_raycast_single_ray_equals_batch(scenes):
    """tests/test_raycast.py:48: one ray alone gives the batch's value."""
    _, ts = scenes
    o, d = _rays()
    batch = tray.raycast(ts, torch.from_numpy(o), torch.from_numpy(d))
    for i in (0, len(o) - 2):
        solo = tray.raycast(ts, torch.from_numpy(o[i : i + 1]), torch.from_numpy(d[i : i + 1]))
        for f in solo._fields:
            np.testing.assert_array_equal(getattr(solo, f).numpy()[0],
                                          getattr(batch, f).numpy()[i], err_msg=f)


def test_pick_matches_jax(scenes):
    js, ts = scenes
    w, h = 64, 48
    jc = JCamera.create(JCameraConfig(**CAMERA), w, h)
    tc = TCamera.create(TCameraConfig(**CAMERA), w, h)
    pts = np.random.default_rng(1).uniform(0, 1, (16, 2)) * (w, h)
    pts[0] = (w / 2, h / 2)  # the sphere's centre: a hit
    hits = 0
    for x, y in pts:
        ref = jray.pick(js, jc, float(x), float(y))
        got = tray.pick(ts, tc, float(x), float(y))
        assert isinstance(got.distance, np.float32) and isinstance(got.index, np.int32)
        assert isinstance(got.normal, np.ndarray) and got.normal.shape == (3,)
        _assert_records_match(got, ref)
        hits += bool(got.hit)
    assert 1 <= hits < 16


def test_pick_center_hits_and_corner_misses(scenes):
    """tests/test_raycast.py's two picks on the port."""
    _, ts = scenes
    cam = TCamera.create(TCameraConfig(**CAMERA), 64, 48)
    rec = tray.pick(ts, cam, 32.0, 24.0)
    assert bool(rec.hit) and 7.0 < float(rec.distance) < 9.0
    np.testing.assert_allclose(np.linalg.norm(rec.normal), 1.0, atol=1e-5)
    assert rec.normal[2] > 0.5 and np.all((rec.color >= 0) & (rec.color <= 1))
    rec = tray.pick(ts, cam, 1.0, 1.0)
    assert not bool(rec.hit) and rec.distance == np.float32(tray.MISS)


def test_raycast_through_k21_agrees_with_bvh(scenes):
    """``tracer=trace_best`` (K2.1's plain version on the CPU) against
    ``trace_bvh``: at most 1 of the 64 seeded rays differs in hit, triangle
    or instance; where they agree, the same record within 1e-5."""
    _, ts = scenes
    o, d = _rays()
    o, d = torch.from_numpy(o[:64]), torch.from_numpy(d[:64])
    ref = tray.raycast(ts, o, d)
    got = tray.raycast(ts, o, d, tracer=trace_best)
    same = (got.hit == ref.hit) & (got.index == ref.index) & (got.instance == ref.instance)
    assert int((~same).sum()) <= 1
    assert int(got.hit.sum()) > 16
    for f in ("distance", "normal", "uv", "color"):
        np.testing.assert_allclose(getattr(got, f)[same].numpy(), getattr(ref, f)[same].numpy(),
                                   rtol=0, atol=ATOL, err_msg=f)


@pytest.mark.parametrize("tracer", ["bvh", "best"])
def test_pick_record_packs_and_unpacks_to_raycast_fields(scenes, tracer):
    """``pick`` reads one packed record back (``pack_record``,
    ``unpack_record``): through the plain path it gives what ``raycast``'s
    fields copied one by one give, in type, dtype, shape and every bit
    (index, instance and hit exact), on hits and misses."""
    _, ts = scenes
    cam = TCamera.create(TCameraConfig(**CAMERA), 64, 48)
    pts = [(32.0, 24.0), (1.0, 1.0)] + [tuple(p) for p in
                                        np.random.default_rng(2).uniform(0, 1, (6, 2)) * (64, 48)]
    hits = 0
    for x, y in pts:
        o, d = screen_point_to_ray(cam, float(x), float(y))
        rec = tray.raycast(ts, torch.from_numpy(o)[None], torch.from_numpy(d)[None],
                           TRACERS[tracer])
        want = tray.HitRecord(*(np.asarray(t)[0] for t in rec))
        for got in (tray.pick(ts, cam, float(x), float(y), TRACERS[tracer]),
                    tray.unpack_record(tray.pack_record(rec).numpy())):
            for f in want._fields:
                a, b = getattr(got, f), getattr(want, f)
                assert type(a) is type(b) and a.dtype == b.dtype and a.shape == b.shape, f
                assert a.tobytes() == b.tobytes(), f
        hits += bool(want.hit)
    assert 1 <= hits < len(pts)
