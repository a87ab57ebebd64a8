"""The port's spans (``utils.timer.ScopeTimer``) on the CPU: an edit, a
tick, a frame and a pick of a small ``Engine`` leave every span in the
profiler's trace, nested as the layers call each other, and one range of
a table build, the tick's, which holds the frame's one box build; a
scene's first frame builds its tables inside ``render.prepare``; with the
profiler off no range is opened while ``profiler_stats`` still gains each
name; both range primitives emit it."""

import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from clraytracer_tpu_torch.config import CameraConfig, RenderConfig
from clraytracer_tpu_torch.engine import Engine
from clraytracer_tpu_torch.ops import trace as tr
from clraytracer_tpu_torch.scene import SceneBuilder
from clraytracer_tpu_torch.scene.procedural import uv_sphere
from clraytracer_tpu_torch.scene.textures import gradient_sky
from clraytracer_tpu_torch.utils import timer
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

#: every span of an edit, tick, frame and pick on the CPU (``engine.wait``
#: is the watchdog's synchronise on the card)
SPANS = ("engine.inverse", "engine.tick", "engine.instances", "tables.instances", "engine.render",
         "render.prepare", "render.k22", "render.finish", "render.post", "render.untile",
         "engine.pick", "pick.trace", "pick.readback")
#: the span each span opens inside
PARENT = {"engine.instances": "engine.tick", "tables.instances": "engine.tick",
          "render.prepare": "engine.render",
          "render.k22": "engine.render", "render.finish": "engine.render",
          "render.post": "engine.render", "render.untile": "engine.render",
          "pick.trace": "engine.pick", "pick.readback": "engine.pick"}


def _started() -> Engine:
    b = SceneBuilder()
    b.import_texture(gradient_sky(32, 16))
    mat = b.create_material(albedo=(0.8, 0.3, 0.2))
    b.add_instance(b.add_mesh(uv_sphere(1.5, n_lat=7, n_lon=14), materials_start=mat))
    eng = Engine(b, RenderConfig(width=32, height=24), CameraConfig(position=(0.0, 0.0, 8.0)),
                 device="cpu")
    eng.start()
    return eng


@pytest.fixture
def engine():
    eng = _started()
    eng.render()  # the tables of the scene as built
    return eng


def _edit_tick_render_pick(eng):
    move = np.eye(4, dtype=np.float32)
    move[3, 0] = 0.1  # a row-vector translation
    eng.set_instance_transform(0, move)
    eng.tick()
    eng.render()
    return eng.pick(16.0, 12.0)


def _ranges(prof, tmp_path) -> list[tuple[str, float, float]]:
    """(name, start us, end us) of each host range of the trace."""
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    return [(e["name"], float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)))
            for e in events if e.get("ph") == "X"
            and e.get("cat") in ("user_annotation", "cpu_op")]


def _traced(fn, tmp_path):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return _ranges(prof, tmp_path)


def _inside(got, name: str, outer: str) -> list[bool]:
    """Per range called ``name``: does a range called ``outer`` hold it?"""
    spans = [(a, b) for n, a, b in got if n == outer]
    return [any(oa <= a and b <= ob for oa, ob in spans) for n, a, b in got if n == name]


def test_a_frame_leaves_every_span_nested(engine, tmp_path):
    got = _traced(lambda: _edit_tick_render_pick(engine), tmp_path)
    names = [n for n, _, _ in got]
    for span in SPANS:
        assert names.count(span) >= 1, span
    assert "engine.wait" not in names
    for span, parent in PARENT.items():
        assert all(_inside(got, span, parent)), (span, parent)
    assert not any(_inside(got, "tables.instances", "engine.instances"))
    assert [n for n in names if n.startswith("tables.")] == ["tables.instances"]


def test_the_box_build_runs_in_the_tick(engine, tmp_path, monkeypatch):
    """An edited frame builds its world boxes once, inside the tick's
    ``tables.instances``, and not inside ``render.prepare``."""
    plain = tr.instance_boxes_plain

    def boxes(*args):
        with torch.profiler.record_function("boxes"):
            return plain(*args)

    monkeypatch.setattr(tr, "instance_boxes_plain", boxes)
    got = _traced(lambda: _edit_tick_render_pick(engine), tmp_path)
    assert _inside(got, "boxes", "tables.instances") == [True]
    assert _inside(got, "boxes", "render.prepare") == [False]


def test_the_first_frame_builds_the_tables_inside_prepare(tmp_path):
    """A scene's first frame builds its kernel and frame tables once each,
    inside ``render.prepare``; its second builds none."""
    eng = _started()
    got = _traced(lambda: (eng.render(), eng.render()), tmp_path)
    builds = [n for n, _, _ in sorted(got, key=lambda r: r[1]) if n.startswith("tables.")]
    assert builds == ["tables.kernel", "tables.frame"]
    for span in builds:
        assert _inside(got, span, "render.prepare") == [True]


def test_an_edit_inverts_the_edited_instance_alone(tmp_path):
    """Of five instances, an edit of one opens one ``engine.inverse``
    range (the builder inverts it at the edit) and the tick none: the
    tick's ``engine.instances`` reads the kept table."""
    b = SceneBuilder()
    mesh = b.add_mesh(uv_sphere(0.5, n_lat=5, n_lon=8))
    for k in range(5):
        move = np.eye(4, dtype=np.float32)
        move[3, 0] = 1.5 * k
        b.add_instance(mesh, move)
    eng = Engine(b, RenderConfig(width=16, height=12), CameraConfig(position=(3.0, 0.0, 9.0)),
                 device="cpu")
    eng.start()
    move = np.eye(4, dtype=np.float32)
    move[3, 1] = 0.2

    def edit_and_tick():
        eng.set_instance_transform(2, move)
        eng.tick()

    got = _traced(edit_and_tick, tmp_path)
    start = {n: a for n, a, _ in got}
    names = [n for n, _, _ in got]
    assert names.count("engine.inverse") == 1 and names.count("engine.instances") == 1
    assert start["engine.inverse"] < start["engine.tick"] < start["engine.instances"]


def test_a_frame_without_an_edit_builds_no_table(engine, tmp_path):
    got = _traced(engine.render, tmp_path)
    assert "engine.render" in [n for n, _, _ in got]
    assert [n for n, _, _ in got if n.startswith("tables.")] == []


def test_no_range_while_the_profiler_is_off(engine, monkeypatch):
    def refuse(name):
        raise AssertionError(f"a range was opened for {name} with the profiler off")

    monkeypatch.setattr(timer, "_Range", refuse)
    for name in SPANS:
        timer.profiler_stats[name] = -1.0
    _edit_tick_render_pick(engine)
    assert all(timer.profiler_stats[name] >= 0.0 for name in SPANS)
    assert set(SPANS) <= set(engine.stats)


@pytest.mark.parametrize("primitive", ["fast", "record_function"])
def test_both_range_primitives_emit_the_name(primitive, monkeypatch, tmp_path):
    if primitive == "fast":
        assert hasattr(torch._C._profiler, "_RecordFunctionFast")
        assert timer._Range is torch._C._profiler._RecordFunctionFast
    else:
        monkeypatch.setattr(timer, "_Range", torch.autograd.profiler.record_function)

    def scope():
        with timer.ScopeTimer("spans.test", log=False):
            torch.ones(4).sum()

    got = _traced(scope, tmp_path)
    assert [n for n, _, _ in got].count("spans.test") == 1
    assert timer.profiler_stats["spans.test"] >= 0.0
