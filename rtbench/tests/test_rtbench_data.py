"""A configuration, a traffic mix, a loop, a per-layer metric and a cell
added as files and entries only, with no edit to a file that is there."""

from __future__ import annotations

import json

from rtbench.tests.conftest import REPO, run_cell


def test_added_files_are_found(checkout):
    rt = checkout / "rtbench"
    run_py = (rt / "run.py").read_bytes()
    cfg = json.loads((rt / "configs" / "sphere1m.json").read_text())
    cfg["radius"] = 1.5
    (rt / "configs" / "sphere_small.json").write_text(json.dumps(cfg))
    mix = json.loads((rt / "traffic" / "walk.json").read_text())
    mix["pick_every"] = 2
    (rt / "traffic" / "walk_fast_picks.json").write_text(json.dumps(mix))
    (rt / "metrics" / "frames_seen.walk.py").write_text(
        "def read(ctx):\n    return float(ctx['frames'])\n")
    (rt / "limits" / "sphere_small-walk_fast_picks.json").write_text(
        (rt / "limits" / "sphere1m-walk.json").read_text())
    bench = json.loads((checkout / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "sphere_small", "source": "https://example.org/s",
                             "file": "rtbench/configs/sphere_small.json", "reduced": [],
                             "why": "a test"})
    bench["workloads"].append({"name": "sphere_small-walk_fast_picks", "config": "sphere_small",
                               "traffic": "walk_fast_picks", "chips": 1, "why": "a test"})
    for m in bench["end_to_end"]:
        if "workloads" in m and "sphere1m-walk" in m["workloads"]:
            m["workloads"].append("sphere_small-walk_fast_picks")
    bench["per_layer"].append({"name": "frames_seen.walk", "unit": "count", "better": "higher",
                               "source": "program_counter", "layer": "engine",
                               "moves": "frame_ms",
                               "workloads": ["sphere_small-walk_fast_picks"]})
    (checkout / "BENCHMARK.json").write_text(json.dumps(bench))

    r = run_cell(checkout, "sphere_small-walk_fast_picks", seconds=3.0, trace=1)["result"]
    assert r["correct"] is True
    assert r["metrics"]["frames_seen.walk"]["value"] == r["attempted"]
    r = run_cell(checkout, "sphere_small-walk_fast_picks", seconds=1.0)["result"]
    assert set(r["metrics"]) == {"frame_ms", "setup_s"}
    assert (rt / "run.py").read_bytes() == run_py == (REPO / "rtbench" / "run.py").read_bytes()


def _add_cell(checkout, cell: str, config: str, traffic: str, like: str) -> None:
    """Entries for ``cell`` in the checkout's BENCHMARK.json, reporting the
    end-to-end metrics of the cell ``like``, with its limits."""
    rt = checkout / "rtbench"
    (rt / "limits" / f"{cell}.json").write_text((rt / "limits" / f"{like}.json").read_text())
    bench = json.loads((checkout / "BENCHMARK.json").read_text())
    if config not in [c["name"] for c in bench["configs"]]:
        bench["configs"].append({"name": config, "source": "https://example.org/s",
                                 "file": f"rtbench/configs/{config}.json", "reduced": [],
                                 "why": "a test"})
    bench["workloads"].append({"name": cell, "config": config, "traffic": traffic, "chips": 1,
                               "why": "a test"})
    for m in bench["end_to_end"]:
        if "workloads" in m and like in m["workloads"]:
            m["workloads"].append(cell)
    (checkout / "BENCHMARK.json").write_text(json.dumps(bench))


def test_a_render_option_and_a_loop_added_as_files(checkout):
    """A configuration's ``render`` options reach the program's
    RenderConfig, and a mix's loop is found as a new file."""
    rt = checkout / "rtbench"
    before = {p: p.read_bytes() for p in rt.rglob("*.py")}
    cfg = json.loads((rt / "configs" / "sphere1m.json").read_text())
    cfg["render"] = {"enable_post": False}
    (rt / "configs" / "sphere_raw.json").write_text(json.dumps(cfg))
    (rt / "loops" / "frames_marked.py").write_text(
        "from rtbench.loops import frames\n\n"
        "def measure(run):\n"
        "    out = frames.measure(run)\n"
        "    out.context['marked'] = 1.0\n"
        "    return out\n\n"
        "control = frames.control\n")
    mix = json.loads((rt / "traffic" / "walk.json").read_text())
    mix["loop"] = "frames_marked"
    (rt / "traffic" / "walk_marked.json").write_text(json.dumps(mix))
    (rt / "metrics" / "marked.walk.py").write_text(
        "def read(ctx):\n    return ctx.get('marked')\n")
    _add_cell(checkout, "sphere1m-walk_marked", "sphere1m", "walk_marked", "sphere1m-walk")
    _add_cell(checkout, "sphere_raw-walk", "sphere_raw", "walk", "sphere1m-walk")
    bench = json.loads((checkout / "BENCHMARK.json").read_text())
    bench["per_layer"].append({"name": "marked.walk", "unit": "count", "better": "higher",
                               "source": "program_counter", "layer": "engine",
                               "moves": "frame_ms", "workloads": ["sphere1m-walk_marked"]})
    (checkout / "BENCHMARK.json").write_text(json.dumps(bench))

    r = run_cell(checkout, "sphere1m-walk_marked", seconds=3.0, trace=1)["result"]
    assert r["correct"] is True and r["metrics"]["marked.walk"]["value"] == 1.0
    # the program renders without its post chain; the reference keeps it
    r = run_cell(checkout, "sphere_raw-walk", seconds=1.0)["result"]
    assert r["correct"] is False and r["checks"]["pixels_off"]["value"] > 0.5
    assert all(p.read_bytes() == b for p, b in before.items())


def test_run_names_no_cell_config_mix_or_metric():
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    names = ([c["name"] for c in bench["configs"]] + [w["name"] for w in bench["workloads"]]
             + [w["traffic"] for w in bench["workloads"]]
             + [m["name"] for m in bench["end_to_end"] + bench["per_layer"]])
    for f in ("run.py", "cells.py"):
        text = (REPO / "rtbench" / f).read_text()
        assert [n for n in names if n in text] == []
