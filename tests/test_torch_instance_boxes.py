"""The world boxes of the kernels' instance level (``ops.trace``'s
``instance_boxes_plain``, the plain version of csrc/instbox.cu) on the CPU:
each holds its instance's mesh under the instance's transform, each chunk
box its 32 members, the boxes follow an edit of the instance rows, and the
walk's world test (grown by the boxes' margin) passes every hit the plain
version finds, under rotations, scales of 0.01 and 100 and shears.
Imports no JAX."""

import dataclasses

import numpy as np
import pytest
import torch

from clraytracer_tpu_torch.engine import Engine
from clraytracer_tpu_torch.config import CameraConfig, RenderConfig
from clraytracer_tpu_torch.ops import trace as tr
from clraytracer_tpu_torch.ops.shade import refresh_packed
from clraytracer_tpu_torch.scene import SceneBuilder
from clraytracer_tpu_torch.scene import procedural_tex as ptex
from clraytracer_tpu_torch.scene.procedural import cube, uv_sphere
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

KINDS = ("rotated", "scale0.01", "scale100", "sheared")


def _linear(kind: str, k: int) -> np.ndarray:
    """Instance k's linear part (row-vector convention) under ``kind``."""
    a = 0.37 * k + 0.1
    c, s = np.cos(a), np.sin(a)
    rot = np.array([[c, 0.0, -s], [0.0, 1.0, 0.0], [s, 0.0, c]]) @ np.array(
        [[1.0, 0.0, 0.0], [0.0, np.cos(2 * a), np.sin(2 * a)],
         [0.0, -np.sin(2 * a), np.cos(2 * a)]])
    return {"rotated": rot, "scale0.01": 0.01 * rot, "scale100": 100.0 * rot,
            "sheared": np.array([[1.0, 0.6, 0.0], [0.0, 1.0, 0.0], [-0.8, 0.3, 1.0]]) @ rot}[kind]


def _forward(kind: str, k: int) -> np.ndarray:
    size = {"scale0.01": 0.01, "scale100": 100.0}.get(kind, 1.0)
    m = np.eye(4)
    m[:3, :3] = _linear(kind, k)
    m[3, :3] = np.array([(k % 6 - 2.5) * 2.5, (k // 6 - 1.5) * 2.5, -0.5 * (k % 3)]) * size
    return m.astype(np.float32)


def _builder(kind: str, n: int):
    """``n`` instances of two meshes (a sphere and a cube, alternating),
    each under ``_forward(kind, k)``; the meshes' vertices beside."""
    b = SceneBuilder()
    b.import_procedural(ptex.sky_gradient(16, 8))
    mat = b.create_material(albedo=(0.7, 0.6, 0.5))
    meshes = [uv_sphere(0.6, n_lat=6, n_lon=12), cube(0.5)]
    handles = [b.add_mesh(m, materials_start=mat) for m in meshes]
    for k in range(n):
        b.add_instance(handles[k % 2], _forward(kind, k))
    verts = [np.concatenate([m.v0, m.v1, m.v2]).astype(np.float64) for m in meshes]
    return b, verts


def _world(verts: np.ndarray, m: np.ndarray) -> np.ndarray:
    return verts @ m[:3, :3].astype(np.float64) + m[3, :3].astype(np.float64)


def _assert_holds(box: torch.Tensor, pts: np.ndarray):
    """``pts`` [k, 3] inside ``box`` [8] grown by its margin at |o| = 0."""
    lo, hi, alpha = box[0:3].double().numpy(), box[3:6].double().numpy(), float(box[6])
    assert (pts >= lo - alpha).all() and (pts <= hi + alpha).all(), (lo, hi, pts.min(0), pts.max(0))


@pytest.mark.parametrize("kind", KINDS)
def test_world_boxes_hold_every_vertex(kind):
    b, verts = _builder(kind, 5)
    kt = tr.kernel_tables(b.build(device="cpu"))
    assert kt.inst_box.shape == (5, 8) and kt.n_chunks == 0
    for k in range(5):
        _assert_holds(kt.inst_box[k], _world(verts[k % 2], _forward(kind, k)))
        # the margin is small beside the box
        extent = float((kt.inst_box[k, 3:6] - kt.inst_box[k, 0:3]).max())
        assert 0.0 < float(kt.inst_box[k, 6]) < 1e-3 * max(extent, 1.0)


def test_chunk_boxes_hold_their_members():
    """70 instances: chunks of 32, 32 and 6; each chunk box holds each of
    its members' boxes and margins."""
    b, _ = _builder("sheared", 70)
    kt = tr.kernel_tables(b.build(device="cpu"))
    assert kt.n_chunks == tr.chunk_count(70) == 3 and kt.chunk_box.shape == (3, 8)
    for c in range(3):
        members = kt.inst_box[32 * c:32 * c + 32]
        ch = kt.chunk_box[c]
        assert (members[:, 0:3] >= ch[0:3]).all() and (members[:, 3:6] <= ch[3:6]).all()
        assert (members[:, 6:8] <= ch[6:8]).all()
        assert torch.equal(ch[0:3], members[:, 0:3].amin(dim=0))
        assert torch.equal(ch[3:6], members[:, 3:6].amax(dim=0))
    assert tr.chunk_count(32) == 0 and tr.chunk_count(33) == 2


def test_chunk_width_is_one_decision():
    """The chunk width the tables are built with (``INSTANCE_CHUNK``) is the
    one the kernels index the chunk boxes by (traverse.cuh's CLRT_ICHUNK,
    which instbox.cu uses as well), and tables whose chunk boxes do not
    number ``chunk_count(n_inst)`` are refused before a launch."""
    import re
    from pathlib import Path

    csrc = Path(tr.__file__).resolve().parent.parent / "csrc"
    (width,) = re.findall(r"^#define CLRT_ICHUNK (\d+)$",
                          (csrc / "traverse.cuh").read_text(), re.M)
    assert int(width) == tr.INSTANCE_CHUNK
    assert "CLRT_ICHUNK * c" in (csrc / "instbox.cu").read_text()
    b, _ = _builder("rotated", 40)
    kt = tr.kernel_tables(b.build(device="cpu"))
    assert kt.as_c().n_chunks == kt.n_chunks == 2
    with pytest.raises(ValueError, match="chunk_count"):
        dataclasses.replace(kt, chunk_box=kt.chunk_box[:1].clone()).as_c()


def test_unbounded_and_empty_instance_boxes():
    """A singular transform gives an unbounded box (every ray passes), an
    instance without triangles a box at +inf (every ray misses), which a
    chunk's union leaves out."""
    hyper = torch.tensor([[-1.0, -2.0, -3.0, 1.0, 2.0, 3.0, 0.0, 0.0]])
    eye = torch.eye(4).reshape(16)
    rows = torch.stack([torch.cat([eye, torch.zeros(1)])] * 40)
    rows[1, 0:3] = 0.0  # singular
    ranges = ((0, 1, 0, 1), (0, 1, 0, 1), (32, 0, 1, 0)) + ((0, 1, 0, 1),) * 37
    box, chunk = tr.instance_boxes_plain(rows, ranges, torch.cat([hyper, hyper]))
    inf = float("inf")
    assert torch.equal(box[1], torch.tensor([-inf] * 3 + [inf] * 3 + [0.0, 0.0]))
    assert torch.equal(box[2], torch.tensor([inf] * 6 + [0.0, 0.0]))
    assert (box[0, 0:3] <= hyper[0, 0:3]).all() and (box[0, 3:6] >= hyper[0, 3:6]).all()
    assert torch.equal(chunk[0, 0:6], box[1, 0:6])  # the unbounded member
    assert torch.equal(chunk[1, 0:6], box[0, 0:6])  # the identity members only
    ranges = ((32, 0, 1, 0),) * 40
    _, chunk = tr.instance_boxes_plain(rows, ranges, hyper)
    assert torch.isinf(chunk[:, 0:6]).all() and (chunk[:, 0:6] > 0).all()


def _world_slab(box: torch.Tensor, rays: torch.Tensor, bt: torch.Tensor):
    """csrc/traverse.cuh ``world_slab`` in float32, rays [6, n] against
    one box [8] → (pass [n], tnear [n])."""
    o, d = rays[0:3], rays[3:6]
    inv = 1.0 / d
    onorm = o.abs().amax(dim=0)
    mu = box[6] + box[7] * onorm
    tn = torch.full_like(bt, -float("inf"))
    tf = torch.full_like(bt, float("inf"))
    for a in range(3):
        t0 = ((box[a] - mu) - o[a]) * inv[a]
        t1 = ((box[3 + a] + mu) - o[a]) * inv[a]
        ok = ~(torch.isnan(t0) | torch.isnan(t1))
        tn = torch.where(ok, torch.maximum(tn, torch.minimum(t0, t1)), tn)
        tf = torch.where(ok, torch.minimum(tf, torch.maximum(t0, t1)), tf)
    return (tn <= tf) & (tf > 0.0) & (tn <= bt), tn


@pytest.mark.parametrize("kind", KINDS)
def test_world_test_passes_every_plain_hit(kind):
    """Rays through every instance (from 12 sizes away, and axis-parallel
    rays through each centre): wherever trace_plain finds a hit, the walk's
    world test of that instance's box passes the ray, with tnear at or
    below the hit's t."""
    b, _ = _builder(kind, 12)
    kt = tr.kernel_tables(b.build(device="cpu"))
    size = {"scale0.01": 0.01, "scale100": 100.0}.get(kind, 1.0)
    rng = np.random.default_rng(7)
    centres = np.array([_forward(kind, k)[3, :3] for k in range(12)], np.float64)
    eye = np.array([0.1, 0.2, 12.0]) * size
    target = np.repeat(centres, 48, axis=0) + rng.uniform(-0.7, 0.7, (48 * 12, 3)) * size
    d = target - eye
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    rays = [np.concatenate([np.broadcast_to(eye, d.shape), d], axis=1)]
    for axis in range(3):
        for sign in (1.0, -1.0):
            ad = np.zeros((12, 3))
            ad[:, axis] = sign
            rays.append(np.concatenate([centres - ad * 10.0 * size, ad], axis=1))
    rays = torch.from_numpy(np.concatenate(rays).T.astype(np.float32)).contiguous()
    out = tr.trace_plain(kt, rays)
    hit = out[0].abs() < tr.BIG
    inst = out[4].view(torch.int32).long()
    assert int(hit.sum()) > rays.shape[1] // 3
    for k in range(12):
        on = hit & (inst == k)
        assert int(on.sum()) > 0
        ok, tn = _world_slab(kt.inst_box[k], rays[:, on], torch.full((int(on.sum()),), tr.BIG))
        assert ok.all() and (tn <= out[0][on]).all()


def test_boxes_follow_an_edit_of_the_instance_rows(monkeypatch):
    """After ``Engine.set_instance_transform`` and a tick, and after an
    ``instances.inverse_transform`` replaced by ``dataclasses.replace``
    and ``refresh_packed``: the tables' boxes are the plain version's of
    the new rows, built once, by the tick or by ``refresh_packed`` and not
    when the tables are read, and the moved instance's box holds its mesh
    where it now is, not where it was."""
    plain, calls = tr.instance_boxes_plain, []
    monkeypatch.setattr(tr, "instance_boxes_plain",
                        lambda *args: calls.append(1) or plain(*args))
    b, verts = _builder("rotated", 4)
    eng = Engine(b, RenderConfig(width=16, height=12), CameraConfig(position=(0.0, 0.0, 12.0)),
                 device="cpu")
    eng.start()
    eng.tick()
    before = tr.kernel_tables(eng.scene).inst_box.clone()
    moved = _forward("rotated", 2)
    moved[3, :3] = (7.0, -3.0, 1.0)
    eng.set_instance_transform(2, moved)
    assert len(calls) == 1
    eng.tick()
    assert len(calls) == 2
    kt = tr.kernel_tables(eng.scene)
    assert len(calls) == 2
    assert torch.equal(kt.inst_box, plain(kt.inst, kt.ranges_host, kt.hyper_box)[0])
    _assert_holds(kt.inst_box[2], _world(verts[0], moved))
    assert not (kt.inst_box[2, 0:3] <= before[2, 3:6]).all()
    assert torch.equal(kt.inst_box[[0, 1, 3]], before[[0, 1, 3]])
    scene = eng.scene
    inv = scene.instances.inverse_transform.clone()
    back = _forward("rotated", 2)
    inv[2] = torch.from_numpy(np.linalg.inv(back.astype(np.float64)).astype(np.float32))
    edited = refresh_packed(dataclasses.replace(
        scene, instances=dataclasses.replace(scene.instances, inverse_transform=inv)))
    assert len(calls) == 3
    kt2 = tr.kernel_tables(edited)
    assert len(calls) == 3
    assert kt2 is not kt
    _assert_holds(kt2.inst_box[2], _world(verts[0], back))
    assert torch.equal(kt2.inst_box[[0, 1, 3]], before[[0, 1, 3]])
