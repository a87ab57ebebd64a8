"""The any-hit shadow walk and the K2.4 row scatter, on the CPU.

* The any-hit design's semantic argument (csrc/traverse.cuh): an occlusion
  test that stops at the first accepted triangle in index order gives the
  same shadow factor as the nearest-hit ``trace_plain``'s ``t < BIG``, on
  the shadowed ground, on a sphere that shadows itself and on the equal-t
  scene of tests/_torch_ties.py. This checks the argument, not the
  kernel: the warp walk's visit order and its one grazing-hit exception
  (a triangles-outer leaf tests lanes whose own boxes culled it) are held
  against ``render_fused_plain`` only on the card.
* ``chip_smoke.py``'s K2.2 bound with the shadow walk's counts apart, and
  the nearest-hit counts kept for (k).
* The ``render_cuda`` wrapper's shadow counters: refused when malformed,
  and nothing launches on the CPU.
* K2.4 (csrc/gather.cu ``sum_peers``): its warp sum over lanes that share
  a row, as a Python transcription run lane by lane (a check of the
  algorithm; the CUDA code is checked on the card), and the CPU dispatch
  of ``scatter_rows``.
"""

import numpy as np
import pytest
import torch

import chip_smoke as cs
from _torch_ties import package, tie_recipe, tie_rays
from clraytracer_tpu_torch.cli import build_scene
from clraytracer_tpu_torch.ops import gather_rows as gr
from clraytracer_tpu_torch.ops import render_fused as rf
from clraytracer_tpu_torch.ops import trace as tr
from clraytracer_tpu_torch.ops.clusters import CLUSTER_SIZE


def occluded_first_hit(kt: tr.KernelTables, rays: torch.Tensor, live: torch.Tensor):
    """Plain any-hit occlusion: per live ray, walk instances and their
    clusters in index order and stop at the first cluster holding an
    accepted triangle (t > 0, u, v >= 0, u + v <= 1, t < BIG) → [n] bool.
    Rays already occluded take no further test."""
    n = rays.shape[1]
    open_ = live.clone()
    occluded = torch.zeros(n, dtype=torch.bool)
    for inst, (_sc0, _scn, cl0, cl_n) in enumerate(kt.ranges_host):
        for s0 in range(cl0 * CLUSTER_SIZE, (cl0 + cl_n) * CLUSTER_SIZE, CLUSTER_SIZE):
            idx = open_.nonzero()[:, 0]
            if idx.numel() == 0:
                return occluded
            o, d = rays[0:3, idx, None], rays[3:6, idx, None]
            ox, oy, oz, dx, dy, dz = tr._object_ray(kt.inst[inst], o, d)
            p = kt.planes[s0:s0 + CLUSTER_SIZE].T
            nx, ny, nz, nw, ux, uy, uz, uw, vx, vy, vz, vw = p[:, None, :]
            den = dx * nx + dy * ny + dz * nz
            t = (ox * nx + oy * ny + oz * nz + nw) * (-1.0 / den)
            u = (ox * ux + oy * uy + oz * uz + uw) + t * (dx * ux + dy * uy + dz * uz)
            v = (ox * vx + oy * vy + oz * vz + vw) + t * (dx * vx + dy * vy + dz * vz)
            ok = (t > 0.0) & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t < tr.BIG)
            hit = idx[ok.any(dim=1)]
            occluded[hit] = True
            open_[hit] = False
    return occluded


def _shadow_case(scene, spec, w, h, sun=None):
    """(traversal tables, bounce-0 shadow rays, live mask) of a w x h frame
    of chip_smoke's camera for ``spec``."""
    kt = tr.kernel_tables(scene)
    frame = cs.option_frame(spec, w, h, sun=sun)
    rays, _ = cs.camera_rays(w, h, "cpu", frame)
    srays, hit = cs.shadow_rays(kt, rays, tr.trace_plain(kt, rays), rf.camera_row(frame).sun)
    return kt, srays, hit


def _assert_same_shadow(kt, rays, live, min_occluded, mixed=True):
    ref = tr.trace_plain(kt, rays, live.float())[0] < tr.BIG
    got = occluded_first_hit(kt, rays, live)
    assert torch.equal(got, ref & live)
    assert not got[~live].any()
    assert int(got.sum()) >= min_occluded
    if mixed:  # some live rays reach the sun
        assert int(got.sum()) < int(live.sum())


@pytest.mark.parametrize("spec,sun,min_occluded", [
    ("ground", None, 40), ("sphere", None, 10), ("sphere", cs.BACKLIT_SUN, 70)])
def test_any_hit_occlusion_equals_nearest_hit_shadow(spec, sun, min_occluded):
    """On the shadowed ground (sun overhead, the sphere's shadow on the
    quad) and on a sphere that shadows itself (hits facing away from the
    sun; lit from behind, most of them): the first-accepted-hit test and
    the nearest hit agree on every shadow ray."""
    scene = cs.option_scene(spec, device="cpu")
    kt, srays, live = _shadow_case(scene, spec, 48, 32, sun=sun)
    _assert_same_shadow(kt, srays, live, min_occluded, mixed=sun is None)


def test_any_hit_occlusion_equals_nearest_hit_on_ties():
    """The equal-t scene: hits that tie across instances and across slots
    of one instance, seeded rays with a live mask."""
    kt = tr.kernel_tables(tie_recipe(package("clraytracer_tpu_torch")).build(device="cpu"))
    rays = torch.from_numpy(tie_rays(1024))
    live = torch.arange(rays.shape[1]) % 5 != 0
    _assert_same_shadow(kt, rays, live, min_occluded=300)


def test_chip_smoke_bound_splits_the_shadow_walk():
    """variant_bound: this run's counts set the bound; the shadow walk's
    counts and the primary walks' (the rest) print apart; for (k) the
    nearest-hit counts of the walk before (kept fixed) give a second bound
    beside it, and for other keys none. k22_registers names each
    instantiation's ptxas entry."""
    scene = build_scene("two", device="cpu")
    kt, ft = tr.kernel_tables(scene), tr.frame_tables(scene)
    counts = [10**9, 2 * 10**9, 3 * 10**7, 10**6, 5, 6]
    shadow = [4 * 10**8, 10**9, 10**7, 0, 2, 1]
    args = (kt, ft, counts, 3, 40, 1920 * 1088, 2, 0, False)
    key = ("K2.2", "k", 198)
    b = cs.variant_bound(*args, key=key, shadow_counts=shadow)
    plain = cs.variant_bound(*args)
    assert (b["bound_ms"], b["bound_by"], b["operations"]) == (
        plain["bound_ms"], plain["bound_by"], plain["operations"])
    assert b["shadow_walk_counts"] == dict(zip(tr.COUNTER_NAMES, shadow))
    assert b["primary_walk_counts"] == dict(
        zip(tr.COUNTER_NAMES, [a - s for a, s in zip(counts, shadow)]))
    assert cs.NEAREST_SHADOW_WALK_COUNTS[key] == (13536618, 48518176, 9232436, 1304787)
    old = cs.variant_bound(kt, ft, list(cs.NEAREST_SHADOW_WALK_COUNTS[key]) + [0, 0],
                           *args[3:])
    assert b["bound_ms_nearest_hit_shadow_counts"] == old["bound_ms"]
    assert "bound_ms_nearest_hit_shadow_counts" not in plain
    assert "shadow_walk_counts" not in plain
    regs = cs.k22_registers([
        {"kernel": "_Z13render_kernelILi0ELb0ELb0EEv11SceneTables12RenderParamsPfPy",
         "registers": 126, "spill_stores": 0, "spill_loads": 0},
        {"kernel": "_Z20render_shadow_kernelILi2ELb1ELb0EEv11SceneTables12RenderParamsPfPyS2_",
         "registers": 140, "spill_stores": 0, "spill_loads": 0},
        {"kernel": "_Z13render_kernelILi1ELb0ELb1EEv11SceneTables12RenderParamsPfPy",
         "registers": 127, "spill_stores": 4, "spill_loads": 4},
    ])
    assert regs == {"default": {"registers": 126, "spill_stores": 0, "spill_loads": 0},
                    "atlas2+shadows+gi": {"registers": 140, "spill_stores": 0,
                                          "spill_loads": 0},
                    "rays+atlas1": {"registers": 127, "spill_stores": 4, "spill_loads": 4}}


def test_render_cuda_refuses_bad_shadow_counters_and_launches_nothing_on_cpu():
    scene = build_scene("two", device="cpu")
    args = cs.frame_args(scene, (32, 24))
    before = (rf.render_cuda.launches, dict(rf.render_cuda.variant_launches))
    good = torch.zeros(6, dtype=torch.int64)
    for bad in (torch.zeros(5, dtype=torch.int64), torch.zeros(6, dtype=torch.float32),
                torch.zeros(2, 6, dtype=torch.int64)):
        with pytest.raises(ValueError, match="counters must be"):
            rf.render_cuda(*args, shadows=True, shadow_counters=bad)
    with pytest.raises(ValueError, match="shadows=True"):
        rf.render_cuda(*args, shadow_counters=good)
    with pytest.raises(ValueError, match="CUDA"):
        rf.render_cuda(*args, shadows=True, shadow_counters=good)
    assert (rf.render_cuda.launches, dict(rf.render_cuda.variant_launches)) == before
    assert not good.any()


def sum_peers_model(rows: np.ndarray, x: np.ndarray) -> dict:
    """csrc/gather.cu ``sum_peers`` transcribed to Python and run lane by
    lane over one warp: rows
    [32] (each lane's clipped row), x [32] (its value) → {lane: sum} for
    each group's lowest lane, the lane that adds it."""
    lanes = range(32)
    peers = [sum(1 << k for k in lanes if rows[k] == rows[lane]) for lane in lanes]
    rel = [bin(peers[l] & ((1 << l) - 1)).count("1") for l in lanes]
    above = [peers[l] & ~((2 << l) - 1) & 0xFFFFFFFF for l in lanes]
    x = [float(v) for v in x]
    while any(above):
        nxt = [(a & -a).bit_length() for a in above]  # __ffs
        got = [x[n - 1] if n else x[l] for l, n in zip(lanes, nxt)]  # shuffles
        x = [x[l] + got[l] if nxt[l] else x[l] for l in lanes]
        done = sum(1 << l for l in lanes if rel[l] & 1)  # ballot
        above = [a & ~done for a in above]
        rel = [r >> 1 for r in rel]
    return {l: x[l] for l in lanes if l == (peers[l] & -peers[l]).bit_length() - 1}


@pytest.mark.parametrize("groups", [1, 2, 5, 32])
def test_scatter_warp_sum_model_gives_each_row_its_sum(groups):
    """The warp sum of K2.4 (its algorithm, modelled lane by lane): for rows
    shared by any subset of lanes, in runs or scattered, each group's
    lowest lane ends with the exact sum of its lanes' integer values."""
    rng = np.random.default_rng(groups)
    for rows in (np.sort(rng.integers(0, groups, 32)), rng.integers(0, groups, 32)):
        x = rng.integers(-1000, 1000, 32)
        got = sum_peers_model(rows, x)
        want = {int(np.flatnonzero(rows == r)[0]): float(x[rows == r].sum())
                for r in np.unique(rows)}
        assert got == want


@pytest.mark.parametrize("n,w", [(7, 1), (30, 3), (1001, 25), (4097, 32)])
def test_scatter_rows_on_cpu_is_the_plain_version(n, w):
    """K2.4's dispatcher on CPU tensors: the plain version, no launch, at
    ray counts the kernel takes one ray a thread (N % 4 != 0, N below a
    warp) and column counts of one chunk, part of one and several."""
    rng = np.random.default_rng(n)
    g = torch.from_numpy(rng.normal(size=(w, n)).astype(np.float32))
    idx = torch.from_numpy(rng.integers(-3, 20, n).astype(np.int32))
    before = gr.scatter_rows_cuda.launches
    got = gr.scatter_rows(g, idx, 17)
    want = np.zeros((17, w), np.float64)
    mag = np.zeros((17, w), np.float64)
    rows = np.clip(idx.numpy(), 0, 16)
    np.add.at(want, rows, g.numpy().T.astype(np.float64))
    np.add.at(mag, rows, np.abs(g.numpy().T.astype(np.float64)))
    # K2.4's stated tolerance: 1e-5 * sum |g| + 1e-7 per element
    assert (np.abs(got.numpy() - want) <= 1e-5 * mag + 1e-7).all()
    assert gr.scatter_rows_cuda.launches == before


def test_chip_smoke_band_check_takes_the_same_rays_of_the_whole_launch():
    """chip_smoke's band check of a large cell: the plain version on a band
    of image rows (``band_args``, here across a strip boundary) equals the
    whole frame's plain output at those rays (``band_index``), shadows on."""
    scene = cs.option_scene("sphere", device="cpu")
    w, h, y0, rows = 256, 120, 60, 8
    args = cs.option_args(scene, cs.option_frame("sphere", w, h), w, h)
    assert args[5] == 64  # two strips of rows, the band crosses into the second
    whole = rf.render_fused_plain(*args, "cpu", shadows=True)
    band = rf.render_fused_plain(*cs.band_args(args, y0, rows), "cpu", shadows=True)
    idx = cs.band_index(w, args[5], y0, rows, "cpu")
    assert band.shape == (9, rows * 2 * 128) and idx.unique().numel() == idx.numel()
    assert torch.equal(band, whole[:, idx])
    assert (band[0:3].abs().sum(0) > 0).any()
