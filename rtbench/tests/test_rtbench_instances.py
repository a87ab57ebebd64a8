"""The 401-instance configuration (``configs/instances401.json``,
``scenes/instances.py``) and its cell's readers: the scene's counts, crowd
and material starts; each new reader on a hand-built timeline with the
program's new spans, and without them (a program that lacks them)."""

from __future__ import annotations

import json
import math

import numpy as np
import pytest

from rtbench import cells
from rtbench.scenes import instances, museum
from rtbench.tests.test_rtbench_spans import DEVICE, HOST, timeline

CONFIG = json.loads((cells.HERE / "configs" / "instances401.json").read_text())
SEED = 2**31 + 163


@pytest.fixture(scope="module")
def spec():
    return instances.build(CONFIG, SEED)


def test_the_pool_is_full(spec):
    assert len(spec.instances) == CONFIG["instances"] == 401
    assert sum(m.count for m in spec.meshes) == CONFIG["triangles"] == 161_360
    assert (sum(spec.meshes[i.mesh].count for i in spec.instances)
            == CONFIG["instanced_triangles"] == 15_922_160)
    assert len(spec.materials) - 1 == CONFIG["materials"]
    assert len(spec.textures) - 3 == CONFIG["textures"]


def test_the_museum_and_the_crowd(spec):
    ref = museum.build(dict(CONFIG, offsets={**CONFIG["offsets"], "figure": [0.0, 0.0, 0.0]}),
                       SEED)
    atrium, gallery, figure = ref.instances
    # the atrium and the gallery at the museum's offsets, then 399 figures
    for got, want in zip(spec.instances[:2], (atrium, gallery)):
        assert (got.mesh, got.material_start) == (want.mesh, want.material_start)
        assert np.array_equal(got.transform, want.transform)
    assert [i.material_start for i in spec.instances[:3]] == [1, 21, 35]
    assert {(i.mesh, i.material_start) for i in spec.instances[2:]} == {
        (figure.mesh, figure.material_start)}
    # the seed sets the maps and nothing else
    assert all(np.array_equal(a.image, b.image) for a, b in zip(spec.textures[3:], ref.textures[3:]))
    other = instances.build(CONFIG, SEED + 1)
    assert all(np.array_equal(a.transform, b.transform)
               for a, b in zip(spec.instances, other.instances))
    assert not np.array_equal(spec.textures[3].image, other.textures[3].image)
    # rigid transforms: a turn about the vertical axis and a move
    for k, inst in enumerate(spec.instances[2:], start=2):
        r = inst.transform[:3, :3].astype(np.float64)
        assert np.allclose(r @ r.T, np.eye(3), atol=1e-6)
        assert np.allclose(r[1], (0.0, 1.0, 0.0)) and np.allclose(r[:, 1], (0.0, 1.0, 0.0))
        i, j = (k - 2) % 19, (k - 2) // 19
        assert np.allclose(inst.transform[3, :3], (-27.0 + 3 * i, 1.5, -18.5 + 3 * j))
        turn = math.radians(7.5 * k)
        assert np.allclose(r[0, [0, 2]], (math.cos(turn), -math.sin(turn)), atol=1e-6)


def test_the_animated_instance_is_a_figure_in_the_crowd(spec):
    k = CONFIG["animate"]["instance"]
    assert k == 163
    inst = spec.instances[k]
    assert inst.mesh == spec.instances[2].mesh
    assert np.allclose(inst.transform[3, :3], (0.0, 1.5, 5.5))


#: the program's new spans in the hand-built frame: the edit's inversion
#: before the tick, and the instance table inside it
NEW = [("engine.inverse", -20, -15), ("engine.instances", 2, 9)]


def read(name: str, tl, kind: str = "frames"):
    return cells.reader(cells.HERE, name)(
        {"timeline": tl, "kind": kind, "units": 1, "window_s": 0.002})


def test_span_readers_read_the_new_spans():
    tl = timeline(host=[("rtbench.frame", -20, 2000)] + HOST[1:] + NEW)
    assert read("instances_host_ms.instances401", tl) == pytest.approx(0.007)
    assert read("inverses.instances401", tl) == 1.0
    # a program without the new spans (the parent), and a run of steps
    for name in ("instances_host_ms.instances401", "inverses.instances401"):
        assert read(name, timeline()) is None
        assert read(name, tl, kind="steps") is None


@pytest.mark.parametrize("name, walk", [("k22_device_ms.instances401", "k22_device_ms.walk"),
                                        ("idle_share.instances401", "idle_share.walk")])
def test_device_readers_are_the_walks(name, walk):
    tl = timeline(host=HOST + [("rtbench.render_frame", 100, 1900)])
    got = read(name, tl)
    assert got is not None and got == read(walk, tl)
    assert read(name, timeline(device=DEVICE[:1]), kind="steps") is None
