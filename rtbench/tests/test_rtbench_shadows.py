"""The shadowed museum's cell (``configs/museum160k-shadows.json``,
``traffic/shadowwalk.json``, ``loops/shadowframes.py``) and its readers:
the cell's loop on the CPU through the program's plain versions, the
reference's shadow switch, the byte count with the shadow rays' triangles,
and each new reader on a hand-built timeline, with and without a shadow
instantiation of K2.2 in it."""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from rtbench import cells, roofline
from rtbench.loops import shadowframes
from rtbench.poses import Pose
from rtbench.reference import frame, shadows
from rtbench.scenes.geometry import _quad_grid, uv_sphere
from rtbench.scenes.spec import Instance, Material, Texture, base_spec, translation
from rtbench.tests.conftest import TINY, make_checkout, run_cell
from rtbench.tests.test_rtbench_spans import DEVICE, HOST, timeline

CELL = "museum160k-shadows-walk"
CONFIG = json.loads((cells.HERE / "configs" / "museum160k-shadows.json").read_text())
SPHERE = json.loads((cells.HERE / "configs" / "sphere1m.json").read_text())
#: the museum's 161,360 triangles take the CPU's plain versions minutes a
#: frame: the CPU's checkout puts the tests' 528-triangle sphere in its place,
#: shadows on, and runs the cell's own mix and loop at the walk's test sizes
SIZES = dict(TINY, **{"museum160k-shadows": dict(SPHERE, **TINY["sphere1m"],
                                                 render=CONFIG["render"]),
                      "shadowwalk": TINY["walk"]})
KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]
SMALL = {"width": 48, "height": 32, "bounces": 2, "sun_angle": -1.96}
POSE = Pose((0.13, 5.0, 6.0), -90.0, -40.0)


def test_the_configuration_is_the_museums_with_shadows_on():
    museum = json.loads((cells.HERE / "configs" / "museum160k.json").read_text())
    for key, value in museum.items():
        if key not in ("source", "deployment", "assumed"):
            assert CONFIG[key] == value, key
    assert CONFIG["assumed"][:3] == museum["assumed"] and len(CONFIG["assumed"]) == 4
    assert CONFIG["render"] == {"enable_shadows": True} and CONFIG["reduced"] == []
    bench = cells.Benchmark(cells.HERE.parent / "BENCHMARK.json")
    cell = bench.cell(CELL)
    assert bench.config(cell) == CONFIG and cell["chips"] == 1
    walk = cells.traffic(cells.HERE, "walk")
    mix = cells.traffic(cells.HERE, cell["traffic"])
    assert mix["loop"] == "shadowframes"
    assert {k: v for k, v in mix.items() if k not in ("loop", "why")} == {
        k: v for k, v in walk.items() if k not in ("loop", "why")}


def test_the_cell_on_the_cpu(tmp_path):
    out = run_cell(make_checkout(tmp_path / "checkout", SIZES), CELL, seconds=2.0)
    r = out["result"]
    assert [k for k in r if k in KEYS] == KEYS
    assert list(r)[-1] == "checks"
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] >= 2
    assert set(r["metrics"]) == {"frame_ms", "frame_p95_ms", "setup_s"}
    assert set(r["checks"]) == {"pixels_off", "picks_off"}
    assert out["forbidden"] == []


@pytest.fixture(scope="module")
def small():
    """A floor with an imported map under a raised sphere, which casts its
    shadow on the floor toward the camera."""
    rng = np.random.default_rng(2**31 + 2201)
    spec = base_spec(8, (64, 32))
    spec.textures.append(Texture(image=rng.integers(0, 256, (8, 8, 3), dtype=np.uint8)))
    spec.materials.append(Material(albedo=(0.9, 0.8, 0.7), albedo_tex=len(spec.textures) - 1))
    spec.meshes.append(_quad_grid(2, (-5.0, 0.0, -5.0), (10.0, 0.0, 0.0), (0.0, 0.0, 10.0),
                                  (0.0, 1.0, 0.0), 1.0))
    spec.meshes.append(uv_sphere(1.2, 5, 10))
    spec.instances.append(Instance(mesh=0, transform=translation(0.0, 0.0, 0.0), material_start=1))
    spec.instances.append(Instance(mesh=1, transform=translation(0.0, 2.0, 0.0), material_start=1))
    return spec


def _pixels(cfg):
    py, px = torch.meshgrid(torch.arange(float(cfg["height"])), torch.arange(float(cfg["width"])),
                            indexing="ij")
    return px.reshape(-1), py.reshape(-1)


def test_the_reference_without_shadows_is_the_frame_reference(small):
    dev = torch.device("cpu")
    px, py = _pixels(SMALL)
    plain = frame.Scene(small, dev).frame_pixels(POSE, SMALL, px, py)
    off = shadows.Scene(small, dev, shadows=False).frame_pixels(POSE, SMALL, px, py)
    on = shadows.Scene(small, dev).frame_pixels(POSE, SMALL, px, py)
    assert torch.equal(off, plain)
    assert 0 < int(((on - plain).abs().amax(dim=1) > 0.02).sum()) < px.numel() // 2


def test_the_count_adds_the_occluders_as_triangles(small):
    dev = torch.device("cpu")
    poses, transforms = [POSE] * 2, [small.instances[1].transform] * 2
    args = (SMALL, poses, transforms, 1, 2)
    base = roofline.frame_bytes(frame.Scene(small, dev), *args)
    shadowed = shadowframes.frame_bytes(shadows.Scene(small, dev), *args)
    assert shadowframes.frame_bytes(shadows.Scene(small, dev, shadows=False), *args) == base
    # the sphere occludes the floor: its triangles that camera rays do not
    # hit count once each, and nothing else
    added = shadowed - base
    assert added > 0 and added % roofline.TRIANGLE_BYTES == 0


def test_the_loop_stands_in_for_the_reference_only_while_it_runs():
    scene, count = frame.Scene, roofline.frame_bytes
    counted = {}
    with shadowframes.shadowed(CONFIG, counted):
        assert frame.Scene.func is shadows.Scene and frame.Scene.keywords == {"shadows": True}
        assert roofline.frame_bytes is not count
    assert (frame.Scene, roofline.frame_bytes) == (scene, count)
    with shadowframes.shadowed(dict(CONFIG, render={}), counted):
        assert frame.Scene.keywords == {"shadows": False}
    assert (frame.Scene, roofline.frame_bytes) == (scene, count)


SHADOW_K22 = ("void render_shadow_kernel<1, false, false, 0>", 510, 530, 1500)


def read(name: str, tl, kind: str = "frames", **ctx):
    return cells.reader(cells.HERE, name)(
        {"timeline": tl, "kind": kind, "units": 1, "window_s": 0.002, **ctx})


def test_device_readers_on_a_shadowed_frame():
    host = HOST + [("rtbench.render_frame", 100, 1900)]
    tl = timeline(host=host, device=[SHADOW_K22 if d[0].startswith("void render_kernel") else d
                                     for d in DEVICE])
    assert read("k22_device_ms.shadows", tl) == pytest.approx(0.97)
    # inside render_frame: the copy in render.prepare, K2.2 and the two
    # elementwise kernels, 0.08 + 0.97 + 0.1 + 0.05 ms
    got = read("frame_roofline.shadows", tl, shadow_frame_bytes=3.35e6)
    assert got == pytest.approx(100.0 * 1e-6 / 1.2e-3)
    assert read("idle_share.shadows", tl) == read("idle_share.walk", tl)
    assert read("k22_device_ms.shadows", tl, kind="steps") is None


def test_a_frame_without_the_shadow_walk_reads_nothing():
    """Only ``render_kernel<1, ...>`` inside ``render_frame``: no shadow
    instantiation ran, so K2.2's shadow time and the shadowed roofline read
    None, never a faster K2.2."""
    tl = timeline(host=HOST + [("rtbench.render_frame", 100, 1900)])
    assert read("k22_device_ms.walk", tl) == pytest.approx(0.67)
    assert read("k22_device_ms.shadows", tl) is None
    assert read("frame_roofline.shadows", tl, shadow_frame_bytes=3.35e6) is None
    # nor does a traced run whose loop counted no bytes
    shadowed = timeline(host=HOST + [("rtbench.render_frame", 100, 1900)],
                        device=[SHADOW_K22])
    assert read("frame_roofline.shadows", shadowed) is None
