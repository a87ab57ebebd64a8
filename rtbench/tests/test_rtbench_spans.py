"""The readers of the program's spans: each on a hand-built timeline of
one frame and one pick, where it returns the sum it should; none where the
trace holds no program span (a commit without them); and the traced CPU
walk of the tests' checkout, which reports those the CPU has."""

from __future__ import annotations

import pytest

from rtbench import cells, program_spans
from rtbench.tests.conftest import run_cell
from rtbench.tracing import Timeline

#: (name, start us, end us) of the host ranges of one frame and a pick
HOST = [
    ("rtbench.frame", 0, 2000),
    ("engine.tick", 0, 100), ("tables.shading", 10, 60),
    ("engine.render", 100, 1900),
    ("render.prepare", 100, 500), ("tables.kernel", 120, 200), ("tables.frame", 200, 260),
    ("render.k22", 500, 540), ("render.finish", 540, 600), ("engine.wait", 600, 1900),
    ("engine.pick", 1900, 2000), ("pick.trace", 1900, 1950), ("pick.readback", 1950, 2000),
]
#: (name, launch us, device start us, device end us) of the device's operations
DEVICE = [
    ("Memcpy HtoD (Pinned -> Device)", 70, 80, 300),  # the tick's upload
    ("Memcpy HtoD (Pageable -> Device)", 270, 450, 530),  # a table in render.prepare
    ("void render_kernel<1, false, false, 0>", 510, 530, 1200),
    ("void at::native::elementwise_kernel", 550, 1200, 1300),
    ("void at::native::vectorized_elementwise_kernel", 560, 1700, 1750),
    ("void trace_kernel", 1920, 1930, 1940),
    ("Memcpy DtoH (Device -> Pageable)", 1955, 1960, 1970),
]
# idle: [300, 450] in render.prepare (150 us), [1300, 1700] in engine.wait,
# [1750, 1930] in engine.wait (150) then pick.trace (30), [1940, 1960] in
# pick.trace (10) then pick.readback (10)


def timeline(host=HOST, device=DEVICE) -> Timeline:
    events = [{"ph": "X", "cat": "user_annotation", "name": n, "ts": a, "dur": b - a, "tid": 1}
              for n, a, b in host]
    for corr, (n, launch, a, b) in enumerate(device):
        events.append({"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
                       "ts": launch, "dur": 5, "tid": 1, "args": {"correlation": corr}})
        events.append({"ph": "X", "cat": "kernel", "name": n, "ts": a, "dur": b - a, "tid": 7,
                       "args": {"correlation": corr}})
    return Timeline(events)


def read(name: str, tl: Timeline, kind: str = "frames"):
    return cells.reader(cells.HERE, name)({"timeline": tl, "kind": kind, "units": 1})


@pytest.mark.parametrize("name, want", [
    ("tick_host_ms.walk", 0.1), ("prepare_host_ms.walk", 0.4), ("wait_host_ms.walk", 1.3),
    ("host_idle_ms.walk", 0.19), ("table_builds.walk", 3.0), ("pick_readback_ms.walk", 0.05)])
def test_each_reader_sums_its_spans(name, want):
    tl = timeline()
    assert read(name, tl) == pytest.approx(want)
    # a commit without the program's spans, and a run of steps: nothing
    assert read(name, timeline(host=[r for r in HOST if r[0] == "rtbench.frame"])) is None
    assert read(name, tl, kind="steps") is None


def test_idle_by_innermost_span():
    by = program_spans.idle_by_span(timeline(), within="rtbench.frame")
    assert by == pytest.approx({None: 0.0, "render.prepare": 150.0, "engine.wait": 550.0,
                                "pick.trace": 40.0, "pick.readback": 10.0})
    # cut to a frame range that ends inside the first gap
    by = program_spans.idle_by_span(timeline(host=HOST[1:] + [("rtbench.frame", 0, 400)]),
                                    within="rtbench.frame")
    assert by == pytest.approx({None: 0.0, "render.prepare": 100.0})
    # idle with no program span open
    host = [("rtbench.frame", 0, 2000)]
    assert program_spans.idle_by_span(timeline(host=host)) == pytest.approx(
        {None: 150.0 + 400.0 + 180.0 + 20.0})


def test_walk_traced_reports_the_spans_on_the_cpu(checkout):
    r = run_cell(checkout, "sphere1m-walk", seconds=5.0, trace=1)["result"]
    assert r["correct"] is True
    m = {k: v["value"] for k, v in r["metrics"].items()}
    for name in ("tick_host_ms.walk", "prepare_host_ms.walk", "pick_readback_ms.walk"):
        assert m[name] > 0.0, name
    assert m["table_builds.walk"] == 3.0
    # no watchdog's synchronise and no device operations on the CPU
    assert "wait_host_ms.walk" not in m and "host_idle_ms.walk" not in m
