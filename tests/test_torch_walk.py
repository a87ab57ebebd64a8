"""The walk's measurement helpers, on the CPU: chip_smoke.py's per-bounce
split of K2.2's counters and the figures derived from them, and the
statistics build of tools/torch_k22_variant_times.py (the children-outer
steps counted under a compile-time switch of that script, never by the
shipped kernels), and tools/torch_instance_walk.py's engagement of the
instance level."""

import importlib.util
import sys
from pathlib import Path

import pytest
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

ROOT = Path(__file__).resolve().parents[1]


def _tool(name="torch_k22_variant_times"):
    spec = importlib.util.spec_from_file_location(name, ROOT / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    sys.path.insert(0, str(ROOT))
    spec.loader.exec_module(mod)
    return mod


def test_walk_figures_are_per_ray_and_per_step():
    import chip_smoke as cs

    f = cs.walk_figures([6400, 320, 7, 5, 10, 4], 100)
    assert f == {"rays": 100, "box_tests_per_ray": 64.0, "tri_tests_per_ray": 3.2,
                 "rays_per_node_step": 20.0, "staged_per_ray": 0.04}
    empty = cs.walk_figures([0, 0, 0, 0, 0, 0], 0)
    assert empty["box_tests_per_ray"] is None and empty["rays_per_node_step"] is None


def test_bounce_split_takes_bounce1_as_the_frame_less_bounce0():
    """Bounce 1's counters are the frame's less bounce 0's, its rays
    bounce 0's shaded hits (the rays that go on)."""
    import chip_smoke as cs

    frame, b0 = [1000, 200, 60, 45, 20, 9], [640, 120, 40, 30, 12, 5]
    split = cs.bounce_split(frame, b0, 40)
    assert split["bounce0"]["counts"] == dict(
        boxes=640, triangles=120, ray_transforms=40, hits=30, node_steps=12,
        staged_clusters=5)
    assert split["bounce1"]["counts"] == dict(
        boxes=360, triangles=80, ray_transforms=20, hits=15, node_steps=8,
        staged_clusters=4)
    assert split["bounce0"]["rays"] == 40 and split["bounce1"]["rays"] == 30
    assert split["bounce1"]["box_tests_per_ray"] == 12.0
    assert split["bounce1"]["rays_per_node_step"] == 360 / (32 * 8)
    for name in ("bounce0", "bounce1"):
        assert split[name] == {"counts": split[name]["counts"],
                               **cs.walk_figures(list(split[name]["counts"].values()),
                                                 split[name]["rays"])}


def test_tool_reads_its_own_trees_chip_smoke():
    """The timing script takes the walk figures from its own tree's
    chip_smoke.py, whatever tree it times."""
    tool = _tool()
    here = tool.own_chip_smoke()
    assert Path(here.__file__).resolve() == ROOT / "chip_smoke.py"
    assert here.walk_figures([6400, 320, 7, 5, 10, 4], 100)["box_tests_per_ray"] == 64.0


def test_stats_build_counts_children_outer_steps_in_a_copy(tmp_path):
    """The statistics sources: traverse.cuh's one ray-transform count moved
    into each children-outer branch (the hierarchy's child test and the
    instance level's world test), in a copy; the tree's own sources
    unchanged."""
    tool = _tool()
    csrc = ROOT / "clraytracer_tpu_torch" / "csrc"
    before = {f.name: f.read_bytes() for f in csrc.iterdir()}
    tool.stats_sources(ROOT, tmp_path)
    assert {f.name: f.read_bytes() for f in csrc.iterdir()} == before
    assert sorted(f.name for f in tmp_path.iterdir()) == sorted(before)
    text = (tmp_path / "traverse.cuh").read_text()
    lines = text.splitlines()
    at = [k for k, ln in enumerate(lines) if tool.CHILDREN_OUTER_MARK in ln]
    assert len(at) == 2
    for k in at:
        assert lines[k + 1].strip() == "if (lane == 0) ++cnt.xforms;"
    assert text.count("++cnt.xforms;") == len(at)
    for name in before:
        if name != "traverse.cuh":
            assert (tmp_path / name).read_bytes() == before[name]
    broken = tmp_path / "broken"
    (broken / "clraytracer_tpu_torch" / "csrc").mkdir(parents=True)
    for name, data in before.items():
        if name == "traverse.cuh":
            data = data.replace(tool.CHILDREN_OUTER_MARK.encode(), b"// other")
        (broken / "clraytracer_tpu_torch" / "csrc" / name).write_bytes(data)
    out = tmp_path / "out"
    out.mkdir()
    with pytest.raises(SystemExit):
        tool.stats_sources(broken, out)


def test_instance_walk_engagement_by_bounce():
    """The instance level's engagement: instances entered a live ray and
    the pass share, ray transforms over instances x live rays; bounce 0's
    live rays are the frame's pixels, bounce 1's bounce 0's shaded hits."""
    import chip_smoke as cs

    tool = _tool("torch_instance_walk")
    split = cs.bounce_split([1000, 200, 60, 45, 20, 9], [640, 120, 40, 30, 12, 5], 40)
    e = tool.engagement(split, 4, 32)
    assert e["bounce0"] == {"live_rays": 32, "entered_per_ray": 1.25, "pass_share": 40 / 128}
    assert e["bounce1"] == {"live_rays": 30, "entered_per_ray": 20 / 30, "pass_share": 20 / 120}
    none = tool.engagement(cs.bounce_split([0] * 6, [0] * 6, 8), 4, 0)
    assert none["bounce0"]["pass_share"] is None and none["bounce1"]["entered_per_ray"] is None
