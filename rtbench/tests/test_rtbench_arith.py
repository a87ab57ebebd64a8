"""The benchmark's arithmetic on synthetic inputs: the 95th percentile,
the device timeline (busy union, idle share, launches inside a host range),
the roofline's bytes, the comparison's rules and the reference's hit
query."""

from __future__ import annotations

import math

import numpy as np
import pytest
import torch

from rtbench import check, loops, roofline
from rtbench.reference.hits import Geometry, moller_trumbore
from rtbench.scenes.geometry import uv_sphere
from rtbench.scenes.spec import Instance, SceneSpec, translation
from rtbench.tracing import Timeline, device_ops


def test_p95_is_the_nearest_rank():
    assert loops.p95(list(range(1, 101))) == 95
    assert loops.p95([3.0]) == 3.0
    assert loops.p95([1.0] * 94 + [math.inf] * 6) == math.inf
    assert loops.p95([1.0] * 95 + [math.inf] * 5) == 1.0


def _events():
    ev = [
        {"ph": "X", "cat": "user_annotation", "name": "rtbench.render_frame", "ts": 0.0,
         "dur": 100.0, "tid": 1},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 10.0, "dur": 2.0,
         "tid": 1, "args": {"correlation": 1}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 50.0, "dur": 2.0,
         "tid": 1, "args": {"correlation": 2}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 150.0, "dur": 2.0,
         "tid": 1, "args": {"correlation": 3}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 60.0, "dur": 2.0,
         "tid": 2, "args": {"correlation": 4}},
        {"ph": "X", "cat": "kernel", "name": "render_kernel<1>", "ts": 20.0, "dur": 30.0,
         "args": {"correlation": 1}},
        {"ph": "X", "cat": "kernel", "name": "add", "ts": 40.0, "dur": 20.0,
         "args": {"correlation": 2}},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH", "ts": 160.0, "dur": 10.0,
         "args": {"correlation": 3}},
        {"ph": "X", "cat": "kernel", "name": "add", "ts": 300.0, "dur": 5.0,
         "args": {"correlation": 4}},
    ]
    return Timeline(ev)


def test_busy_is_the_union_and_idle_the_rest():
    tl = _events()
    # [20, 60) + [160, 170) + [300, 305)
    assert tl.busy_us() == pytest.approx(40.0 + 10.0 + 5.0)
    window_s = 400e-6
    idle = 100.0 * (1.0 - tl.busy_us() * 1e-6 / window_s)
    assert idle == pytest.approx(100.0 * (1 - 55.0 / 400.0))


def test_launches_are_put_inside_their_host_range_by_thread():
    tl = _events()
    inside, outside = tl.inside(lambda n: n == "rtbench.render_frame")
    assert sorted(op.name for op in inside) == ["add", "render_kernel<1>"]
    # launched after the range, and on another thread during it
    assert sorted(op.name for op in outside) == ["Memcpy DtoH", "add"]
    assert device_ops(tl.ops)[0] == (30.0, 1, "render_kernel<1>")
    gaps = tl.idle_gaps(2)
    assert gaps[0][1] == pytest.approx(130e-6) and gaps[1][1] == pytest.approx(100e-6)


def test_roofline_counts_each_distinct_input_once():
    inst = torch.tensor([0, 0, 1, 1])
    tri = torch.tensor([5, 5, 5, 7])
    mat = torch.tensor([2, 2, 3, 3])
    uu = torch.zeros(4)
    vv = torch.zeros(4)
    key = lambda m, u, v: torch.where(m == 2, torch.tensor(11), torch.tensor(-1))
    got = roofline.counted_bytes(8, 4, [(inst, tri, mat, uu, vv), (inst[:1], tri[:1],
                                                                  mat[:1], uu[:1], vv[:1])], key)
    want = (8 * 4 * 12 + roofline.CAMERA_BYTES + 3 * roofline.TRIANGLE_BYTES
            + 2 * roofline.MATERIAL_BYTES + 1 * roofline.TEXEL_BYTES)
    assert got == want
    assert roofline.TRIANGLE_BYTES == 70


def test_pixels_off_counts_the_share_over_the_tolerance():
    a = torch.zeros(4, 3)
    b = a.clone()
    b[0, 1] = check.PX_TOL * 2
    b[1, 2] = check.PX_TOL / 2
    b[2, 0] = float("nan")
    assert check.pixels_off(b, a) == pytest.approx(0.5)


def test_leaf_gaps_leave_out_what_is_nought_to_rounding():
    ref = {"a": 1.0, "b": 2.0, "c": 4.0, "d": 1e-9, "e": 0.0}
    port = {"a": 1.01, "b": 2.0, "c": 4.0, "d": 5e-9, "e": 0.0, "f": 0.0}
    gap, stray, out = check.leaf_gaps(port, ref)
    # a's gap over the larger of its norm and the median of the nonzero (1.5)
    assert gap == pytest.approx(0.01 / 1.5)
    assert sorted(out) == ["d", "e", "f"] and stray == pytest.approx(5e-9 / 1.5)
    assert check.leaf_gaps({"a": 1.0}, ref)[0] == math.inf
    ok, shown = check.verdict({"x": 0.5, "y": 2.0}, {"x": 1.0, "y": 1.0})
    assert not ok and shown["y"] == {"value": 2.0, "limit": 1.0}


def test_hit_query_is_the_brute_force_nearest():
    g = np.random.default_rng(0)
    mesh = uv_sphere(1.0, 10, 20)
    spec = SceneSpec(meshes=[mesh], textures=[], materials=[],
                     instances=[Instance(0, translation(0.0, 0.0, 0.0), 0),
                                Instance(0, translation(0.5, 0.2, 0.0), 0)])
    geo = Geometry(spec, torch.device("cpu"))
    n = 300
    o = torch.tensor(g.normal(size=(3, n)) * 0.3 + np.array([[0.0], [0.0], [4.0]]),
                     dtype=torch.float32)
    d = torch.tensor(g.normal(size=(3, n)) * 0.25 + np.array([[0.0], [0.0], [-1.0]]),
                     dtype=torch.float32)
    d = d / d.norm(dim=0)
    hits = geo.closest(o, d)
    # brute force over every triangle of both instances
    v = [torch.tensor(getattr(mesh, k)) for k in ("v0", "v1", "v2")]
    best = torch.full((n,), math.inf)
    for off in (0.0, 0.5):
        oo = (o.T - torch.tensor([off, 0.2 if off else 0.0, 0.0]))[:, None]
        t, uu, vv = moller_trumbore(oo, d.T[:, None], v[0][None], v[1][None], v[2][None])
        ok = (t > 0) & (uu >= 0) & (vv >= 0) & (uu + vv <= 1)
        best = torch.minimum(best, torch.where(ok, t, torch.full_like(t, math.inf)).amin(1))
    assert torch.equal(torch.isfinite(best), hits.hit)
    assert torch.allclose(best[hits.hit], hits.t[hits.hit], rtol=1e-5)
    assert 50 < int(hits.hit.sum()) < n
