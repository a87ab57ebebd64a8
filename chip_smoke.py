"""Smoke run of clraytracer_tpu_torch on one NVIDIA card (H100, sm_90a).

    python3 chip_smoke.py [--out results.json]

Builds the CUDA kernels from csrc/ (one nvcc per source, in parallel),
holds each kernel against its plain PyTorch version on the card, drives the
main paths (``render.render_frame``: the default frame on three scenes and
the frame's options on four more; ``diff.image_loss_and_grads``, the
differentiable step) and prints one JSON line per phase:

1. device: card name and power limit, torch/CUDA versions, build seconds
2. trace: K2.1 vs ``trace_plain`` on ``two`` (320x240 camera rays + 4096
   seeded random rays), with and without a live mask, and ``return_slots``
3. fused: K2.2 vs ``render_fused_plain`` on ``two`` and ``sphere`` at
   320x240 (at most FRAME_MISMATCH_MAX rays over 1e-5 on the nine planes);
   options: every option instantiation of K2.2 (atlas modes 0/1/2 x
   shadows x GI, the shadowed ground, the four jittered samples of a
   ``samples=4`` frame) vs its plain version at 320x240 (pool indices
   exact, at most FRAME_MISMATCH_MAX rays over 1e-5, GI included)
4. main path: ``render.render_frame`` on (a) ``sphere`` 4224 tris at
   1920x1080, (b) ``two`` at 1249x720, (c) ``sphere --tris 1000000`` at
   1920x1080; frame ms (CUDA events, median of 20 after 3 warm-ups),
   Mrays/s = W*H*bounces/dt (no clamp), the host's time to issue a frame,
   K2.2 launches per frame (must be 1), work counts per frame, K2.2 and
   the frame's torch tail piece by piece, K2.2's bounce 0 alone, K2.1 on
   the frame's camera rays and on its hits and its misses alone, finite
   image and its mean, and both kernels against their plain versions on
   that configuration's scene (K2.1 on 4096 seeded camera rays, K2.2 on a
   128x64 strip). Then (d) the hit-query entry ``ops.trace.trace`` on
   (a)'s scene and 1920x1080 camera rays: one K2.1 launch per call (and
   no K2.2). Then the option cells, each through ``render.render_frame``
   at 1920x1080: (h) ``atlas`` (bench.py's sphere with imported textures,
   atlas mode 1), (i) ``atlas65`` (mode 2), (j) ``sphere`` with GI
   (bench.py's gi row), (k) the shadowed ground, (l) and (m) (a)'s and
   (c)'s spheres with shadows (in each shadow cell the bounce-0 hits in
   shadow must be > 0); frame ms, K2.2 ms, the tail piece by piece, the
   host's time to issue a frame, K2.2's six counters and bound (the shadow
   walk's counts apart, and the same frame without shadows timed beside),
   the device's idle share and time by kernel, one launch of the cell's
   instantiation per frame, K2.2 vs its plain version at 1920x1080 (for
   (m)'s million triangles on a band of 16 image rows of its 1920x1080
   launch, which must hold hits in shadow) and on a strip
5. profile: torch.profiler over 10 frames of (a), device time by kernel
   and the device's idle share against (a)'s unprofiled frame time
6. diff: the differentiable step ``diff.image_loss_and_grads``.
   (e) ``sphere`` 4224 tris at 1920x1080, 2 bounces, L2 against black
   (the JAX bench's grads row): step ms (CUDA events, median of 10 after
   2 warm-ups), fwd+bwd Mrays/s = W*H*bounces/step, launches per step
   (K2.1, K2.3 and K2.4 twice each), peak memory, finite gradients that
   are nonzero on albedo, v0 and the instance transforms; K2.3 (bit-exact)
   and K2.4 (within 1e-5 * sum|g| + 1e-7) against their plain versions and
   library calls on the step's own inputs, timed per call and on the
   card (``device_ms``); torch.profiler over 3 steps.
   (f) the card's step against the CPU step (plain versions) on ``two``
   and ``sphere`` at 160x120. (g) 5 Adam steps of ``cli.fit`` on
   ``two``'s albedo at 1249x720: the loss falls
7. kernels: each kernel against its plain version at (a)'s shapes, the
   six work counters of K2.1/K2.2 on every main-path configuration and
   their registers and spill bytes (``-Xptxas -v``), then the kernels
   line: per kernel its TPU counterpart, launches on its path, error
   against the plain version, ms (events around one call, the host's
   issue included; device_ms beside it: the card's time, ``device_ms``),
   plain ms, bound ms (K2.1/K2.2: the bytes the scene's data needs,
   ``walk_bytes``, and this run's counts; the phase lines print beside it
   the bound from the per-ray walk's counts), library ms (per call;
   library_device_ms beside it);
   one entry per K2.2 instantiation of the option cells, its bound
   counting its deferred planes and its shading

then the card's ``name, power.limit`` line and, last, the ``{"ok": true,
"device": ...}`` line. Any failure exits non-zero without that line.
Imports no JAX and nothing of the JAX package.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

# published H100 SXM peaks (NVIDIA data sheet): FP32 outside the tensor
# cores, HBM3 bandwidth
PEAK_F32 = 67e12
PEAK_BYTES = 3.35e12
# f32 operations per unit of work, counted from csrc/ (a division or a
# square root counts as one); the first four of the kernels' int64[6]
# counters (ops.trace.COUNTER_NAMES) count the units: box tests, triangle
# tests, ray transforms, interpolated hits. The last two count the warps'
# 32-child node tests and the clusters they staged in shared memory.
BOX_OPS = 27  # slab: 6 sub + 6 mul + 12 min/max + 3 compares
TRI_OPS = 45  # plane test: den 5 + b_n 6 + t 2 + u 13 + v 13 + u+v 1 + 5 cmp
XFORM_OPS = 36  # ray to object space: origin 18 + direction 15 + 3 reciprocals
INTERP_OPS = 27  # w0 2 + five 3-term interpolations of 5
# render.cu per shaded hit after interpolation: world normal 15, object ray
# 33, normalise 9, material row 4, checker texel 17, colour 24, Phong and
# reflection 86
SHADE_OPS = 188
RAYGEN_OPS = 59  # render.cu per camera ray: NDC 7, invProj 24, invView 18, norm 10
# per shaded hit by atlas mode: mode 0 is SHADE_OPS; the atlas modes skip
# the texel and colour (41) and the colour terms of the Phong sum (15), and
# add the deferred planes: mode 1 the pool index 6, colour bytes 12 and
# coefficients 9 (159); mode 2 reads no material row (-4) and emits only
# the coefficients 9 (137)
SHADE_OPS_BY_MODE = {0: SHADE_OPS, 1: 159, 2: 137}
# render.cu gi_sample per shaded hit: two uniforms 4, sin 4, phi 1, cos and
# sin 2, their products 2, helper test 2, tangent 6 + normalise 10,
# binormal 9 + normalise 10, direction 15, side test 5 + flip 3, weight 2;
# the throughput product 3 (6 in mode 0)
GI_OPS = 86

# Those four counts as the per-ray walk (one thread per ray, the hierarchy
# in index order) that csrc/traverse.cuh's warp walk replaced ran them at
# the main path's shapes (this script, NVIDIA H100 80GB HBM3, 700 W), keyed
# by (kernel, configuration, triangles). The phase lines print the bound
# they give beside this run's, so a walk that needs more tests than the one
# it replaced shows there; the kernels line holds only this run's numbers.
PER_RAY_WALK_COUNTS = {
    ("K2.2", "a", 4224): (22337367, 14502656, 2179137, 90177),
    ("K2.2", "b", 2220): (5273356, 3669472, 2042510, 48010),
    ("K2.2", "c", 1002000): (166356994, 13883264, 2179296, 90343),
    ("K2.1", "a", 4224): (17438758, 10321312, 2088960, 90177),
}
# The same four counts of (k)'s frame when its shadow ray walked as a
# nearest-hit ray (both walks together; this script on an NVIDIA H100 80GB
# HBM3, 700 W, before the any-hit walk). Cell (k)'s line prints the bound
# they give beside this run's; the kernels line holds only this run's.
NEAREST_SHADOW_WALK_COUNTS = {
    ("K2.2", "k", 198): (13536618, 48518176, 9232436, 1304787),
}

CAMERA = (0.13, 0.21, 10.0)
SUN = -1.96
CHECK_WH = (320, 240)  # kernel-vs-plain checks (phases 2 and 3)
# per main-path configuration (phase 4): K2.1 on this many seeded camera
# rays of the full frame, K2.2 on one 128-pixel strip of the same camera
CHECK_RAYS = 4096
CHECK_STRIP_WH = (128, 64)
# The kernels and their plain versions pick the same winner by
# construction: the least (t, instance, slot) over the accepted candidates,
# a rule that does not depend on the order a warp visits clusters in, and
# the kernels cull only boxes with tnear > best t. Only a float slab test
# that culls a grazing hit the plain brute force keeps can part them: at
# most this many rays of a frame may differ by more than 1e-5 (K2.2), or
# in (t, slot, instance) (K2.1). The 1% seam allowance holds only against
# the JAX package, in the CPU tests.
FRAME_MISMATCH_MAX = 16
# main-path configurations: (tag, scene, --tris, width, height); (c)'s
# triangle count is TRIS_LARGE (bench.py's large scene)
TRIS_LARGE = 1_000_000
MAIN = (
    ("a", "sphere", 4096, 1920, 1080),
    ("b", "two", 4096, 1249, 720),
    ("c", "sphere", None, 1920, 1080),
)
FRAMES, WARMUP = 20, 3
# K2.2's option cells (phase option_cells), each through render_frame:
# (tag, scene of ``option_scene``, --tris, width, height, RenderConfig keys)
OPTION_CELLS = (
    ("h", "atlas", 4096, 1920, 1080, {}),
    ("i", "atlas65", 4096, 1920, 1080, {}),
    ("j", "sphere", 4096, 1920, 1080, {"enable_gi": True}),
    ("k", "ground", 4096, 1920, 1080, {"enable_shadows": True}),
    # (a)'s and (c)'s spheres with shadows: hits facing away from the sun
    # cast shadow rays through the sphere itself
    ("l", "sphere", 4096, 1920, 1080, {"enable_shadows": True}),
    ("m", "sphere", TRIS_LARGE, 1920, 1080, {"enable_shadows": True}),
)
# Above this many triangles a cell's plain version runs on a band of
# CHECK_BAND_ROWS image rows through the middle of the frame, held against
# those rays of the cell's own launch: its brute force over 1M triangles at
# 1920x1080 passes 2M rays over 31,313 chunks of 32 slots per trace, hours
# on the card
PLAIN_FULL_MAX_TRIS = 100_000
CHECK_BAND_ROWS = 16
GI_SEED = 7  # the seed of the GI checks (phase options)
# a sun behind the sphere as the smoke camera sees it (shadow rays head
# away from the camera, through the sphere): most bounce-0 hits in shadow
BACKLIT_SUN = 0.0
# differentiable step (phase diff): (e) the JAX bench's grads configuration
# (bench.py:217, sphere --tris 4096 → 4224 triangles), (f) card vs CPU at
# DIFF_CHECK_WH, (g) Adam steps of ``fit`` on ``two``'s albedo
DIFF_E = ("e", "sphere", 4096, 1920, 1080)
DIFF_CHECK_WH = (160, 120)
DIFF_G = ("g", "two", 1249, 720, 5)
STEPS, STEP_WARMUP = 10, 2


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def event_ms(fn, reps: int, warmup: int = 3) -> tuple[float, list[float]]:
    """Median ms of ``reps`` calls, each timed with CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2], times


# a spin kernel of this many cycles (about 10 ms on an H100) holds the card
# while the host issues a timed run of calls behind it
SLEEP_CYCLES = 20_000_000


def device_ms(fn, calls: int = 5, runs: int = 5) -> float:
    """A kernel's time on the card: CUDA events around a run of ``calls``
    calls, over ``calls``, the median of ``runs``, each run queued behind a
    spin kernel (``torch.cuda._sleep``) that keeps the card busy while the
    host issues it, so that the events time the card's work alone.
    ``event_ms`` around one call issued to an idle card also counts the
    host's time to issue it: for a kernel of a tenth of a millisecond
    behind a Python wrapper, a large part."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SLEEP_CYCLES)
        a.record()
        for _ in range(calls):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / calls)
    times.sort()
    return times[len(times) // 2]


def hits_match(ref_hit, got_hit, ref_t, got_t, ref_tri, got_tri) -> dict:
    """tests/test_trace.py::assert_hits_match's rule, on numpy arrays."""
    import numpy as np

    n = ref_hit.size
    mism = int((ref_hit != got_hit).sum())
    both = ref_hit & got_hit
    close = np.isclose(ref_t[both], got_t[both], rtol=1e-4, atol=1e-5)
    same_tri = float((ref_tri[both] == got_tri[both]).mean()) if both.any() else 1.0
    ok = (
        mism <= max(1, 0.01 * n)
        and (close.mean() > 0.99 if close.size else True)
        and same_tri > 0.98
    )
    return {"ok": bool(ok), "hit_mismatch": mism, "t_close": float(close.mean()),
            "same_tri": same_tri}


def walk_bound(key, bytes_moved, counts, camera_rays=0, shade=False) -> dict:
    """A K2.1/K2.2 bound from this run's bytes and counts, with the bound
    the per-ray walk's counts give at the same shapes
    (``PER_RAY_WALK_COUNTS[key]``) printed beside it."""
    from clraytracer_tpu_torch.ops.trace import COUNTER_NAMES

    ms, by = bound(bytes_moved, counts, camera_rays, shade)
    out = {"counts": dict(zip(COUNTER_NAMES, counts)), "bytes": bytes_moved,
           "bound_ms": ms, "bound_by": by}
    old = PER_RAY_WALK_COUNTS.get(key)
    if old is not None:
        out["bound_ms_per_ray_walk_counts"] = bound(bytes_moved, old, camera_rays, shade)[0]
    return out


def walk_bytes(kt, clusters: int, slots: int, ft=None) -> int:
    """Scene bytes a K2.1/K2.2 launch must read: the instance rows and box
    tables once, the plane rows of each of ``clusters`` clusters (those
    that hold a winning triangle: a walk opens at least those, and tests a
    cluster's 32 triangles together, as the hierarchy has no finer box),
    the attribute rows of the ``slots`` winning triangles, and K2.2's
    material and texture rows once."""
    ts = [kt.inst, kt.ranges, kt.hyper_box, kt.super_box, kt.cluster_box]
    if ft is not None:
        ts += [ft.mat_rows, ft.tex]
    row = lambda t: t.shape[1] * t.element_size()
    return (sum(t.numel() * t.element_size() for t in ts)
            + clusters * 32 * row(kt.planes) + slots * row(kt.attrs))


def winners(out) -> tuple[int, int]:
    """(distinct clusters, distinct slots) that hold a winning triangle in
    a K2.1 output [11, n]."""
    import torch

    slots = torch.unique(out[3].view(torch.int32)[out[0].abs() < 1e30])
    return int(torch.unique(slots // 32).numel()), int(slots.numel())


def host_ms(fn, reps: int) -> float:
    """Median host time of one call of ``fn``: its launches issued, the
    device drained before each call."""
    import torch

    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    times.sort()
    return times[len(times) // 2]


def ptxas_summary(log: str) -> list:
    """Registers, spill bytes and static shared memory per kernel, from
    nvcc's ``-Xptxas -v`` report."""
    import re

    out, cur = [], {}
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            cur = {"kernel": m.group(1)}
            out.append(cur)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m and cur:
            cur["spill_stores"], cur["spill_loads"] = int(m.group(1)), int(m.group(2))
        m = re.search(r"Used (\d+) registers", ln)
        if m and cur:
            cur["registers"] = int(m.group(1))
            sm = re.search(r"(\d+) bytes smem", ln)
            cur["smem_bytes"] = int(sm.group(1)) if sm else 0
    return out


def k22_registers(entries: list) -> dict:
    """K2.2's ptxas entries (``ptxas_summary`` of render.cu) by
    instantiation name (``render_fused.variant``): registers and spill
    bytes."""
    import re

    from clraytracer_tpu_torch.ops.render_fused import variant

    out = {}
    for e in entries:
        m = re.search(r"(render_kernel|render_shadow_kernel)ILi(\d)ELb(\d)EE", e["kernel"])
        if m:
            name = variant(int(m.group(2)), m.group(1) == "render_shadow_kernel",
                           m.group(3) == "1")
            out[name] = {k: e.get(k) for k in ("registers", "spill_stores", "spill_loads")}
    return out


def table_bytes(kt, ft=None) -> int:
    ts = [kt.inst, kt.ranges, kt.hyper_box, kt.super_box, kt.cluster_box,
          kt.planes, kt.attrs]
    if ft is not None:
        ts += [ft.mat_rows, ft.tex]
    return sum(t.numel() * t.element_size() for t in ts)


def bound(
    bytes_moved: float, counts, camera_rays: int = 0, shade: bool = False
) -> tuple[float, str]:
    """max(bytes / HBM rate, f32 ops / FP32 peak) in ms. ``counts``: the
    kernel's [boxes, triangles, transforms, hits, ...]; ``camera_rays`` and
    ``shade`` add K2.2's raygen and shading."""
    boxes, tris, xforms, hits = (float(c) for c in counts[:4])
    ops = (
        boxes * BOX_OPS + tris * TRI_OPS + xforms * XFORM_OPS
        + hits * (INTERP_OPS + (SHADE_OPS if shade else 0))
        + camera_rays * RAYGEN_OPS
    )
    t_bytes = bytes_moved / PEAK_BYTES * 1e3
    t_ops = ops / PEAK_F32 * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")


def camera_rays(width, height, device, frame=None):
    """Screen-tile-ordered camera rays [6, n] of ``frame`` (default: the
    smoke camera) and the smoke camera."""
    import torch

    from clraytracer_tpu_torch.camera import Camera, ray_directions_tiled
    from clraytracer_tpu_torch.config import CameraConfig
    from clraytracer_tpu_torch.ops.render_fused import tile_rows

    cam = Camera.create(CameraConfig(position=CAMERA), width, height)
    src = cam if frame is None else frame
    pos = cam.position if frame is None else frame.camera_position
    f32 = lambda x: torch.as_tensor(x, dtype=torch.float32).to(device)
    d = ray_directions_tiled(
        f32(src.inverse_view), f32(src.inverse_projection),
        width, height, tile_rows(width * height),
    ).reshape(3, -1)
    o = f32(pos)[:, None].expand_as(d)
    return torch.cat([o, d]).contiguous(), cam


def compare_trace(got, ref, live=None) -> dict:
    """K2.1's [11, n] output against trace_plain's: the hit rule, at most
    FRAME_MISMATCH_MAX rays not exact in (t, slot, instance), then the
    attributes at rtol 1e-5 / atol 1e-6 wherever both pick the same slot."""
    import numpy as np
    import torch

    gt, rt = got[0].cpu().numpy(), ref[0].cpu().numpy()
    gh, rh = np.abs(gt) < 1e30, np.abs(rt) < 1e30
    gs = got[3].view(torch.int32).cpu().numpy()
    rs = ref[3].view(torch.int32).cpu().numpy()
    case = hits_match(rh, gh, rt, gt, rs, gs)
    gi = got[4].view(torch.int32).cpu().numpy()
    ri = ref[4].view(torch.int32).cpu().numpy()
    # the tie rule makes the winner exact: rays whose t, slot or instance
    # differ at all
    case["rays_not_exact"] = int(((gt != rt) | (gs != rs) | (gi != ri)).sum())
    same = gh & rh & (gs == rs)
    attr = [1, 2, 5, 6, 7, 8, 9, 10]  # u v n xyz uu vv mat
    ga, ra = got[attr].cpu().numpy()[:, same], ref[attr].cpu().numpy()[:, same]
    case["attrs_ok"] = bool(np.allclose(ga, ra, rtol=1e-5, atol=1e-6))
    err = float(np.abs(ga - ra).max()) if same.any() else 0.0
    terr = float(np.abs(gt[same] - rt[same]).max()) if same.any() else 0.0
    case["max_abs_err"] = max(err, terr)
    if live is not None:
        dead = live.cpu().numpy() == 0
        case["dead_lanes_miss"] = bool((gt[dead] == np.float32(-1e30)).all())
    case["ok"] = (case["ok"] and case["attrs_ok"] and case.get("dead_lanes_miss", True)
                  and case["rays_not_exact"] <= FRAME_MISMATCH_MAX)
    return case


def phase_trace(dev, results) -> None:
    import torch

    from clraytracer_tpu_torch.cli import build_scene
    from clraytracer_tpu_torch.ops import trace as tr

    scene = build_scene("two", device=dev)
    kt = tr.kernel_tables(scene)
    cam_rays, _ = camera_rays(*CHECK_WH, dev)
    g = torch.Generator(device="cpu").manual_seed(0)
    ro = (torch.rand(3, 4096, generator=g) * 8.0 - 4.0) + torch.tensor([0.0, 0.5, 6.0])[:, None]
    rd = torch.randn(3, 4096, generator=g)
    rd = rd / torch.linalg.vector_norm(rd, dim=0, keepdim=True)
    rays = torch.cat([cam_rays, torch.cat([ro, rd]).to(dev)], dim=1).contiguous()
    n = rays.shape[1]
    live = (torch.rand(n, generator=g) > 0.3).float().to(dev)
    out = {"phase": "trace", "scene": "two", "rays": n, "cases": []}
    worst = 0.0
    for name, lv in (("all", None), ("live", live)):
        got = tr.trace_cuda(kt, rays, lv)
        ref = tr.trace_plain(kt, rays, lv)
        torch.cuda.synchronize()
        case = {"case": name, **compare_trace(got, ref, lv)}
        worst = max(worst, case["max_abs_err"])
        out["cases"].append(case)
    # the SceneHit entry: return_slots keeps the raw slot, else tri_gid[slot]
    o3, d3 = rays[0:3], rays[3:6]
    h_slot = tr.trace(scene, o3, d3, return_slots=True)
    h_tri = tr.trace(scene, o3, d3)
    slots = h_slot.tri.long()
    out["return_slots_ok"] = bool(
        torch.equal(kt.tri_gid[slots].int(), h_tri.tri)
        and torch.equal(h_slot.t, h_tri.t)
    )
    out["ok"] = all(c["ok"] for c in out["cases"]) and out["return_slots_ok"]
    results["trace_err"] = worst
    emit(out)
    if not out["ok"]:
        raise SystemExit("trace phase failed")


def frame_args(scene, wh):
    """K2.2's arguments for a ``wh`` frame of the smoke camera, 2 bounces."""
    from clraytracer_tpu_torch.camera import Camera
    from clraytracer_tpu_torch.config import CameraConfig
    from clraytracer_tpu_torch.ops import render_fused as rf
    from clraytracer_tpu_torch.ops.trace import kernel_tables
    from clraytracer_tpu_torch.render import frame_inputs_from_camera

    w, h = wh
    cam = Camera.create(CameraConfig(position=CAMERA), w, h)
    cr = rf.camera_row(frame_inputs_from_camera(cam, SUN))
    trows = rf.tile_rows(w * h)
    rows_total = -(-h // trows) * -(-w // 128) * trows
    return kernel_tables(scene), rf.frame_tables(scene), cr, w, h, trows, rows_total, 2


def phase_fused(dev, results) -> None:
    import torch

    from clraytracer_tpu_torch.cli import build_scene
    from clraytracer_tpu_torch.ops import render_fused as rf

    worst = 0.0
    for spec in ("two", "sphere"):
        args = frame_args(build_scene(spec, device=dev), CHECK_WH)
        got = rf.render_cuda(*args)
        ref = rf.render_fused_plain(*args, dev)
        torch.cuda.synchronize()
        line = {"phase": "fused", "scene": spec, **compare_options(got, ref, 0, False)}
        worst = max(worst, line["max_abs_err_all"])
        emit(line)
        if not line["ok"]:
            raise SystemExit("fused phase failed")
    results["fused_err"] = worst


# ---------------------------------------------------------------------------
# K2.2's options: imported textures (atlas modes 1 and 2), sun shadows, GI
# ---------------------------------------------------------------------------


def option_scene(spec: str, tris: int = 4096, device=None):
    """Scenes of the option cells. ``atlas``: bench.py:78-92's sphere with
    its textures imported as images (the bakes of a 512x256 sky and a
    128/8 checker); ``atlas65``: the same with unused materials up to 65,
    past the 64 of atlas mode 1; ``ground``: test_shadows.py:88-98's
    checkered ground quad under a red sphere. Others: ``cli.build_scene``."""
    from clraytracer_tpu_torch import math3d
    from clraytracer_tpu_torch.cli import build_scene
    from clraytracer_tpu_torch.scene import SceneBuilder
    from clraytracer_tpu_torch.scene import procedural_tex as ptex
    from clraytracer_tpu_torch.scene.procedural import quad, uv_sphere
    from clraytracer_tpu_torch.scene.textures import checkerboard, gradient_sky

    b = SceneBuilder()
    if spec in ("atlas", "atlas65"):
        n_lat = max(4, int((tris / 4) ** 0.5) + 1)
        b.import_texture(gradient_sky(512, 256))
        checker = b.import_texture(checkerboard(128, 8))
        mat = b.create_material(
            albedo=(0.9, 0.6, 0.3), albedo_tex=checker, shininess=1.0, roughness=0.4
        )
        b.add_instance(b.add_mesh(uv_sphere(2.0, n_lat=n_lat, n_lon=2 * n_lat),
                                  materials_start=mat))
        if spec == "atlas65":
            while len(b._materials) < 65:
                b.create_material(albedo=(0.5, 0.5, 0.5))
    elif spec == "ground":
        b.import_procedural(ptex.sky_gradient(32, 16))
        checker = b.import_procedural(ptex.checker(16, 4))
        ground = b.create_material(albedo=(0.85, 0.85, 0.85), albedo_tex=checker)
        red = b.create_material(albedo=(0.9, 0.2, 0.2))
        b.add_instance(b.add_mesh(quad(8.0, y=0.0), materials_start=ground))
        b.add_instance(b.add_mesh(uv_sphere(1.0, n_lat=8, n_lon=14), materials_start=red),
                       math3d.translation(0.0, 1.6, 0.0))
    else:
        return build_scene(spec, tris, device=device)
    return b.build(device=device)


def option_frame(spec: str, w: int, h: int, sun: float | None = None):
    """The camera and sun of a cell: test_shadows.py:38-44's view of the
    ground (sun overhead), else the smoke camera and SUN; ``sun`` sets
    another sun angle."""
    import math

    from clraytracer_tpu_torch.camera import Camera
    from clraytracer_tpu_torch.config import CameraConfig
    from clraytracer_tpu_torch.render import frame_inputs_from_camera

    if spec == "ground":
        cam = Camera.create(CameraConfig(position=(0.3, 4.0, 7.0), pitch_deg=-28.0), w, h)
        return frame_inputs_from_camera(cam, -math.pi / 2 if sun is None else sun)
    cam = Camera.create(CameraConfig(position=CAMERA), w, h)
    return frame_inputs_from_camera(cam, SUN if sun is None else sun)


def option_args(scene, frame, w, h, bounces=2):
    """K2.2's positional arguments for a w x h frame of ``frame``'s camera."""
    from clraytracer_tpu_torch.ops import render_fused as rf
    from clraytracer_tpu_torch.ops.trace import kernel_tables

    trows = rf.tile_rows(w * h)
    rows_total = -(-h // trows) * -(-w // 128) * trows
    return (kernel_tables(scene), rf.frame_tables(scene), rf.camera_row(frame), w, h,
            trows, rows_total, bounces)


def band_args(args, y0: int, rows: int):
    """K2.2's positional arguments ``args`` of a w x h frame, cut to the
    image rows y0 .. y0 + rows - 1 at full width: one strip of ``rows``
    rows per 128 columns, the camera row's row0 set to y0. Without GI a
    ray's planes depend only on its pixel, so these rays' planes are those
    of the same pixels in the whole frame's launch (``band_index``)."""
    from clraytracer_tpu_torch.ops.render_fused import CameraRow

    kt, ft, cr, w, h, _trows, _rows_total, bounces = args
    cr = CameraRow(cam=tuple(cr.cam[:35]) + (float(y0),), sun=cr.sun)
    return (kt, ft, cr, w, h, rows, rows * -(-w // 128), bounces)


def band_index(w: int, trows: int, y0: int, rows: int, device):
    """The ray indices, in a launch of width w and strip height trows, of
    the rays of ``band_args(..., y0, rows)`` in that band's order."""
    import torch

    tiles_x = -(-w // 128)
    r = torch.arange(rows * tiles_x, device=device)[:, None]
    lane = torch.arange(128, device=device)[None, :]
    py = y0 + r % rows
    whole = ((py // trows) * tiles_x + r // rows) * trows + py % trows
    return (whole * 128 + lane).reshape(-1)


def compare_options(got, ref, mode: int, gi: bool) -> dict:
    """K2.2's [9 + K*B, n] output against render_fused_plain's (atlas mode
    ``mode``, GI on or off): mode 1's pool-index planes exactly (as i32),
    every other plane within 1e-5 on all but FRAME_MISMATCH_MAX rays, with
    GI as without."""
    import torch

    from clraytracer_tpu_torch.ops.render_fused import deferred_planes

    k = deferred_planes(mode, gi)
    idx_rows = [9 + k * b for b in range((got.shape[0] - 9) // k)] if mode == 1 else []
    other = [r for r in range(got.shape[0]) if r not in idx_rows]
    diff = (got[other] - ref[other]).abs().amax(dim=0)
    bad = diff > 1e-5
    for r in idx_rows:
        bad |= got[r].view(torch.int32) != ref[r].view(torch.int32)
    n = diff.numel()
    allowed = FRAME_MISMATCH_MAX
    finite = bool(torch.isfinite(got[other]).all())
    good = diff[~bad]
    return {
        "rays": n, "rays_differing": int(bad.sum()), "allowed": allowed,
        "max_abs_err_within": float(good.max()) if good.numel() else 0.0,
        "max_abs_err_all": float(diff.max()), "finite": finite,
        "ok": int(bad.sum()) <= allowed and finite,
    }


def phase_options(dev, results) -> None:
    """Every option combination of K2.2 against render_fused_plain at
    CHECK_WH: atlas modes 0 (``sphere``), 1 (``atlas``) and 2
    (``atlas65``), each without and with shadows and GI, the shadowed
    ground, and the four jittered samples of a ``samples=4`` atlas GI
    frame (each with its own seed, as ``render_frame`` launches them)."""
    import torch

    from clraytracer_tpu_torch.ops import render_fused as rf
    from clraytracer_tpu_torch.render import _sample_offsets, jitter_projection

    w, h = CHECK_WH
    cases = []
    for spec in ("sphere", "atlas", "atlas65", "ground"):
        scene = option_scene(spec, device=dev)
        frame = option_frame(spec, w, h)
        mode = rf.atlas_mode_of(scene)
        combos = [(sh, gi) for sh in (False, True) for gi in (None, GI_SEED)]
        if spec == "ground":
            combos = [(True, None), (True, GI_SEED)]
        frames = [(frame, None, sh, gi) for sh, gi in combos]
        if spec == "atlas":
            for si, (jx, jy) in enumerate(_sample_offsets(4)):
                fj = frame._replace(inverse_projection=jitter_projection(
                    frame.inverse_projection, jx * 2.0 / w, jy * 2.0 / h))
                frames.append((fj, si, True, GI_SEED + si))
        for fr, si, sh, gi in frames:
            args = option_args(scene, fr, w, h)
            opts = dict(atlas_mode=mode, shadows=sh, gi_seed=gi)
            got = rf.render_cuda(*args, **opts)
            ref = rf.render_fused_plain(*args, dev, **opts)
            torch.cuda.synchronize()
            case = {"scene": spec, "atlas_mode": mode, "shadows": sh, "gi_seed": gi,
                    "sample": si, "variant": rf.variant(mode, sh, gi is not None),
                    **compare_options(got, ref, mode, gi is not None)}
            cases.append(case)
            emit({"phase": "options", **case})
            if not case["ok"]:
                raise SystemExit("options phase failed")
    results["options"] = cases


def shadow_rays(kt, rays, rec, sun):
    """The bounce-0 shadow rays [6, n] of camera rays [6, n] whose hit
    record (K2.1's [11, n] layout) is ``rec``, from render.cu's origin
    ``(mo + md t) + n 0.01`` toward the sun (sin, cos), and the mask of the
    rays that hit."""
    import torch

    from clraytracer_tpu_torch.ops import trace as tr

    t = rec[0]
    hit = t < tr.BIG
    m = kt.inst[rec[4].view(torch.int32).long()].T
    o, d = rays[0:3], rays[3:6]
    nw = [rec[5] * m[c] + rec[6] * m[4 + c] + rec[7] * m[8 + c] for c in range(3)]
    sn = torch.sqrt(nw[0] * nw[0] + nw[1] * nw[1] + nw[2] * nw[2])
    so = [((o[0] * m[c] + o[1] * m[4 + c] + o[2] * m[8 + c] + m[12 + c])
           + (d[0] * m[c] + d[1] * m[4 + c] + d[2] * m[8 + c]) * t) + (nw[c] / sn) * 0.01
          for c in range(3)]
    zero = torch.zeros_like(t)
    return torch.stack(so + [zero, zero - sun[0], zero - sun[1]]).contiguous(), hit


def shadow_masks(kt, rays, sun):
    """The masks [n] of bounce-0 hits whose shadow ray toward the sun is
    occluded and of the hits, of camera rays [6, n], by K2.1 launches
    (``shadow_rays``)."""
    from clraytracer_tpu_torch.ops import trace as tr

    srays, hit = shadow_rays(kt, rays, tr.trace_cuda(kt, rays), sun)
    occ = tr.trace_cuda(kt, srays, hit.float())[0] < tr.BIG
    return hit & occ, hit


def shadowed_hits(kt, rays, sun) -> tuple[int, int]:
    """(bounce-0 hits in shadow, hits) of camera rays [6, n]
    (``shadow_masks``)."""
    in_shadow, hit = shadow_masks(kt, rays, sun)
    return int(in_shadow.sum()), int(hit.sum())


def band_start(mask, w: int, h: int, trows: int, rows: int) -> int:
    """The first image row of a band of ``rows`` rows centred on the median
    image row of the rays in ``mask`` (a launch's strip order, width w,
    strip height trows), kept inside the frame; the middle of the frame
    when the mask is empty."""
    import torch

    r = torch.nonzero(mask)[:, 0] // 128
    if r.numel() == 0:
        return (h - rows) // 2
    py = (r // trows // -(-w // 128)) * trows + r % trows
    mid = int(py.float().median())
    return max(0, min(h - rows, mid - rows // 2))


def variant_bound(kt, ft, counts, clusters, slots, n, bounces, mode, gi, key=None,
                  shadow_counts=None) -> dict:
    """A K2.2 instantiation's bound: the bytes the scene's data needs
    (``walk_bytes``) plus its 9 + K*B output planes, and the operations of
    this run's counts (the shadow walk's included) with the shading of its
    atlas mode and GI per shaded hit and the raygen per ray.
    ``shadow_counts``: the shadow walk's own counts, printed apart with the
    primary walks' (the rest). ``key`` (kernel, cell, triangles): where
    ``NEAREST_SHADOW_WALK_COUNTS`` holds it, the bound those counts give is
    printed beside this run's."""
    from clraytracer_tpu_torch.ops.render_fused import deferred_planes
    from clraytracer_tpu_torch.ops.trace import COUNTER_NAMES

    planes = 9 + deferred_planes(mode, gi) * bounces
    bytes_moved = walk_bytes(kt, clusters, slots, ft) + planes * n * 4
    t_bytes = bytes_moved / PEAK_BYTES * 1e3

    def operations(c):
        boxes, tris, xforms, hits = (float(x) for x in c[:4])
        return (boxes * BOX_OPS + tris * TRI_OPS + xforms * XFORM_OPS
                + hits * (INTERP_OPS + SHADE_OPS_BY_MODE[mode] + (GI_OPS if gi else 0))
                + n * RAYGEN_OPS)

    ops = operations(counts)
    t_ops = ops / PEAK_F32 * 1e3
    out = {"counts": dict(zip(COUNTER_NAMES, counts)), "bytes": bytes_moved,
           "operations": ops, "output_planes": planes, "bound_ms": max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
    if shadow_counts is not None:
        out["shadow_walk_counts"] = dict(zip(COUNTER_NAMES, shadow_counts))
        out["primary_walk_counts"] = dict(
            zip(COUNTER_NAMES, (a - b for a, b in zip(counts, shadow_counts))))
    old = NEAREST_SHADOW_WALK_COUNTS.get(key)
    if old is not None:
        out["bound_ms_nearest_hit_shadow_counts"] = max(
            t_bytes, operations(old) / PEAK_F32 * 1e3)
    return out


def phase_option_cells(dev, results) -> None:
    """The option cells on the main path, each through render.render_frame
    at full width with the counts from zero: (h) ``atlas`` (mode 1), (i)
    ``atlas65`` (mode 2), (j) ``sphere`` with GI (bench.py's gi row), (k)
    the shadowed ground, sun overhead, (l) and (m) (a)'s and (c)'s spheres
    with shadows. Per cell: frame ms, K2.2 ms, the tail after it (texel
    gather / sky, post, untile), the host's time to issue a frame, K2.2's
    six counters, its bound, torch.profiler over 5 frames (device time by
    kernel, idle share), K2.2 against its plain version at the cell's own
    shapes (above PLAIN_FULL_MAX_TRIS triangles on a band of the same
    launch's rays, ``band_args``; the plain run also gives plain_ms) and on
    a CHECK_STRIP_WH strip. In the shadow
    cells also the bounce-0 hits in shadow, the shadow walk's six counts
    apart, and the same frame without shadows (its instantiation's ms and
    counts; in (k) the k0 split)."""
    import torch

    from clraytracer_tpu_torch.config import RenderConfig
    from clraytracer_tpu_torch.ops import render_fused as rf
    from clraytracer_tpu_torch.ops import trace as tr
    from clraytracer_tpu_torch.ops.post import post_process_tiled
    from clraytracer_tpu_torch.render import _untile, render_frame

    results["option_cells"] = []
    for tag, spec, tris, w, h, cfg_kw in OPTION_CELLS:
        t0 = time.perf_counter()
        scene = option_scene(spec, tris, device=dev)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        cfg = RenderConfig(width=w, height=h, **cfg_kw)
        frame = option_frame(spec, w, h)
        mode = rf.atlas_mode_of(scene)
        gi = cfg.enable_gi
        opts = dict(atlas_mode=mode, shadows=cfg.enable_shadows,
                    gi_seed=cfg.gi_seed if gi else None)
        name = rf.variant(mode, cfg.enable_shadows, gi)
        img = render_frame(scene, frame, cfg)  # first frame: tables upload
        torch.cuda.synchronize()
        # ---- the main path's own run: counts from zero
        reset_counts()
        ms, times = event_ms(lambda: render_frame(scene, frame, cfg), FRAMES, WARMUP)
        frames = FRAMES + WARMUP
        launches = {"K2.2": rf.render_cuda.launches, "K2.1": tr.trace_cuda.launches,
                    "K2.2_variants": dict(rf.render_cuda.variant_launches)}
        frame_host_ms = host_ms(lambda: render_frame(scene, frame, cfg), FRAMES)
        args = option_args(scene, frame, w, h, cfg.bounces)
        kt, ft, rows_total = args[0], args[1], args[6]
        n = rows_total * 128
        counters = torch.zeros(6, dtype=torch.int64, device=dev)
        shadow_cnt = (torch.zeros(6, dtype=torch.int64, device=dev)
                      if cfg.enable_shadows else None)
        out = rf.render_cuda(*args, counters, shadow_counters=shadow_cnt, **opts)
        kms, _ = event_ms(lambda: rf.render_cuda(*args, **opts), 10, 2)
        kdev = device_ms(lambda: rf.render_cuda(*args, **opts))
        # a shadow cell's frame without shadows (the instantiation of its
        # other options), timed beside it: the shadow walk's share
        unshadowed = None
        if cfg.enable_shadows:
            u_opts = dict(opts, shadows=False)
            u_cnt = torch.zeros(6, dtype=torch.int64, device=dev)
            rf.render_cuda(*args, u_cnt, **u_opts)
            unshadowed = {
                "variant": rf.variant(mode, False, gi),
                "kernel_ms": event_ms(lambda: rf.render_cuda(*args, **u_opts), 10, 2)[0],
                "kernel_device_ms": device_ms(lambda: rf.render_cuda(*args, **u_opts)),
                "counts": u_cnt.cpu().tolist(),
            }
        cnt = counters.cpu().tolist()
        rays, _cam = camera_rays(w, h, dev, frame)
        clusters, slots = winners(tr.trace_cuda(kt, rays))
        kb = variant_bound(
            kt, ft, cnt, clusters, slots, n, cfg.bounces, mode, gi,
            key=("K2.2", tag, int(scene.tris.count)),
            shadow_counts=None if shadow_cnt is None else shadow_cnt.cpu().tolist())
        shadow, in_shadow = None, None
        if cfg.enable_shadows:
            in_shadow, hit0 = shadow_masks(kt, rays, args[2].sun)
            shadow = {"bounce0_hits": int(hit0.sum()),
                      "bounce0_hits_in_shadow": int(in_shadow.sum()),
                      "walk_counts": kb["shadow_walk_counts"],
                      "without_shadows": unshadowed}
        del rays
        # the plain version on the same inputs: timed once, and held against
        # the output of the launch above, at the cell's own shapes (above
        # PLAIN_FULL_MAX_TRIS triangles on a band of that launch's rays,
        # through the middle of its bounce-0 hits in shadow)
        pargs, p_out, p_frame, band = args, out, f"{w}x{h}", None
        if int(scene.tris.count) > PLAIN_FULL_MAX_TRIS:
            if gi:
                raise SystemExit(f"option cell {tag}: a band check needs a frame without GI")
            y0 = (band_start(in_shadow, w, h, args[5], CHECK_BAND_ROWS)
                  if in_shadow is not None else (h - CHECK_BAND_ROWS) // 2)
            pargs = band_args(args, y0, CHECK_BAND_ROWS)
            band = band_index(w, args[5], y0, CHECK_BAND_ROWS, dev)
            p_out = out[:, band]
            p_frame = (f"{w}x{CHECK_BAND_ROWS} band (rows {y0}-{y0 + CHECK_BAND_ROWS - 1})"
                       f" of {w}x{h}")
            if shadow is not None:  # the checked band holds hits in shadow too
                shadow["band_bounce0_hits"] = int(hit0[band].sum())
                shadow["band_bounce0_hits_in_shadow"] = int(in_shadow[band].sum())
        keep = []
        plain_ms, _ = event_ms(
            lambda: keep.append(rf.render_fused_plain(*pargs, dev, **opts)), 1, 0)
        full = compare_options(p_out, keep.pop(), mode, gi)
        del p_out
        out3 = out.reshape(-1, rows_total, 128)
        trows = args[5]
        layout = ("strip", trows, -(-w // 128), -(-h // trows))
        fin = lambda: rf._finish_frame(scene, out3, mode, gi)
        res = fin()
        post = lambda: post_process_tiled(res, w, h, layout)
        pp = post()
        tail = {
            "finish_ms": event_ms(fin, 10, 2)[0],
            "post_ms": event_ms(post, 10, 2)[0],
            "untile_ms": event_ms(
                lambda: _untile(pp, layout, h, w).permute(1, 2, 0).contiguous(), 10, 2
            )[0],
        }
        del out, out3, res, pp
        prof = device_profile(lambda: render_frame(scene, frame, cfg), 5, ms)
        img = render_frame(scene, frame, cfg)
        finite = bool(torch.isfinite(img).all())
        sargs = option_args(scene, frame, *CHECK_STRIP_WH, cfg.bounces)
        check = compare_options(rf.render_cuda(*sargs, **opts),
                                rf.render_fused_plain(*sargs, dev, **opts), mode, gi)
        torch.cuda.synchronize()
        line = {
            "phase": "option_cells", "config": tag, "scene": spec, "variant": name,
            "atlas_mode": mode, "options": cfg_kw, "materials": int(scene.materials.count),
            "triangles": int(scene.tris.count), "width": w, "height": h,
            "bounces": cfg.bounces, "host_build_s": build_s,
            "frame_ms": ms, "frame_ms_min": times[0], "frame_ms_max": times[-1],
            "frame_host_ms": frame_host_ms,
            "mrays_per_s": w * h * cfg.bounces / (ms * 1e-3) / 1e6,
            "kernel_ms": kms, "kernel_device_ms": kdev, "plain_ms": plain_ms,
            "kernel_bound_ms": kb["bound_ms"],
            "kernel_bound_by": kb["bound_by"], "kernel_bound": kb,
            "winning_clusters": clusters, "winning_slots": slots, "tail": tail,
            "launches": launches, "frames": frames,
            "box_tests": cnt[0], "tri_tests": cnt[1], "ray_transforms": cnt[2],
            "shaded_hits": cnt[3], "node_steps": cnt[4], "staged_clusters": cnt[5],
            "rays_traced": n, "shadow": shadow, "finite": finite,
            "mean": float(img.mean()), "check": {"frame": list(CHECK_STRIP_WH), **check},
            "check_full": {"frame": p_frame, **full}, "plain_frame": p_frame,
            "profile": prof,
        }
        line["ok"] = (
            finite and check["ok"] and full["ok"] and launches["K2.2"] == frames
            and launches["K2.2_variants"] == {name: frames} and launches["K2.1"] == 0
            and (shadow is None or shadow["bounce0_hits_in_shadow"] > 0)
            and (shadow is None or band is None or shadow["band_bounce0_hits_in_shadow"] > 0)
        )
        results["option_cells"].append(line)
        results["fused_err"] = max(results["fused_err"], check["max_abs_err_within"],
                                   full["max_abs_err_within"])
        emit(line)
        if not line["ok"]:
            raise SystemExit(f"option cell {tag} failed")


def check_config(scene, w, h, dev) -> dict:
    """Both kernels against their plain versions on a main-path scene:
    K2.1 on CHECK_RAYS seeded camera rays of the w x h frame, K2.2 on a
    CHECK_STRIP_WH frame of the same camera. On (c) this is the one check
    of the traversal across several hyper groups."""
    import torch

    from clraytracer_tpu_torch.ops import render_fused as rf
    from clraytracer_tpu_torch.ops import trace as tr

    kt = tr.kernel_tables(scene)
    rays, _cam = camera_rays(w, h, dev)
    g = torch.Generator(device="cpu").manual_seed(1)
    pick = torch.randperm(rays.shape[1], generator=g)[:CHECK_RAYS].to(dev)
    sub = rays[:, pick].contiguous()
    k21 = compare_trace(tr.trace_cuda(kt, sub), tr.trace_plain(kt, sub))
    args = frame_args(scene, CHECK_STRIP_WH)
    k22 = compare_options(rf.render_cuda(*args), rf.render_fused_plain(*args, dev), 0, False)
    torch.cuda.synchronize()
    return {
        "hyper_groups": sum(-(-r[1] // 32) for r in kt.ranges_host),
        "K2.1": {"rays": CHECK_RAYS, **k21},
        "K2.2": {"frame": list(CHECK_STRIP_WH), **k22},
        "ok": k21["ok"] and k22["ok"],
    }


def phase_main(dev, results, tris_large: int) -> None:
    import torch

    from clraytracer_tpu_torch.cli import build_scene
    from clraytracer_tpu_torch.config import RenderConfig
    from clraytracer_tpu_torch.ops import render_fused as rf
    from clraytracer_tpu_torch.ops import trace as tr
    from clraytracer_tpu_torch.ops.post import post_process_tiled
    from clraytracer_tpu_torch.render import (
        _untile,
        frame_inputs_from_camera,
        render_frame,
    )
    from clraytracer_tpu_torch.camera import Camera
    from clraytracer_tpu_torch.config import CameraConfig

    results["main"] = []
    for tag, spec, tris, w, h in MAIN:
        tris = tris_large if tris is None else tris
        t0 = time.perf_counter()
        scene = build_scene(spec, tris, device=dev)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        note = None
        if tag == "c" and build_s > 180.0:
            note = f"host build {build_s:.1f} s > 180 s: cut to --tris 262144"
            t0 = time.perf_counter()
            scene = build_scene(spec, 262144, device=dev)
            torch.cuda.synchronize()
            build_s = time.perf_counter() - t0
            tris = 262144
        cfg = RenderConfig(width=w, height=h)
        cam = Camera.create(CameraConfig(position=CAMERA), w, h)
        frame = frame_inputs_from_camera(cam, SUN)
        img = render_frame(scene, frame, cfg)  # first frame: tables upload
        torch.cuda.synchronize()
        # ---- the main path's own run: counts from zero
        reset_counts()
        ms, times = event_ms(lambda: render_frame(scene, frame, cfg), FRAMES, WARMUP)
        frames = FRAMES + WARMUP
        launches = {"K2.2": rf.render_cuda.launches, "K2.1": tr.trace_cuda.launches,
                    "K2.2_variants": dict(rf.render_cuda.variant_launches)}
        frame_host_ms = host_ms(lambda: render_frame(scene, frame, cfg), FRAMES)
        # ---- test counts of one frame (a separate launch with counters)
        kt, ft = tr.kernel_tables(scene), rf.frame_tables(scene)
        cr = rf.camera_row(frame)
        trows = rf.tile_rows(w * h)
        rows_total = -(-h // trows) * -(-w // 128) * trows
        counters = torch.zeros(6, dtype=torch.int64, device=dev)
        out = rf.render_cuda(kt, ft, cr, w, h, trows, rows_total, cfg.bounces, counters)
        launch = lambda: rf.render_cuda(kt, ft, cr, w, h, trows, rows_total, cfg.bounces)
        kms, _ = event_ms(launch, 10, 2)
        kdev = device_ms(launch)
        cnt = counters.cpu().tolist()
        # ---- the walk split: K2.2's bounce 0 alone, and K2.1 on the frame's
        # camera rays, on the rays that hit alone and on those that miss
        # alone (each set compacted, so that a warp holds all hits or all
        # misses); the triangles these rays hit (bounce 0) enter K2.2's bound
        rays, _cam = camera_rays(w, h, dev)
        rec = tr.trace_cuda(kt, rays)
        hit = rec[0] < tr.BIG
        clusters, slots = winners(rec)
        split = {"k22_bounce0_ms": event_ms(
            lambda: rf.render_cuda(kt, ft, cr, w, h, trows, rows_total, 1), 10, 2)[0]}
        for name, rs in (("all", rays), ("hit", rays[:, hit].contiguous()),
                         ("miss", rays[:, ~hit].contiguous())):
            split[f"k21_{name}_rays"] = rs.shape[1]
            split[f"k21_{name}_ms"] = event_ms(lambda: tr.trace_cuda(kt, rs), 10, 2)[0]
        del rec, rays, rs
        kb = walk_bound(("K2.2", tag, int(scene.tris.count)),
                        walk_bytes(kt, clusters, slots, ft) + 9 * rows_total * 128 * 4,
                        cnt, rows_total * 128, shade=True)
        # ---- the frame's torch tail after the kernel, piece by piece
        out9 = out.reshape(9, rows_total, 128)
        layout = ("strip", trows, -(-w // 128), -(-h // trows))
        fin = lambda: rf._finish_frame(scene, out9)
        res = fin()
        post = lambda: post_process_tiled(res, w, h, layout)
        pp = post()
        tail = {
            "sky_ms": event_ms(fin, 10, 2)[0],
            "post_ms": event_ms(post, 10, 2)[0],
            "untile_ms": event_ms(
                lambda: _untile(pp, layout, h, w).permute(1, 2, 0).contiguous(), 10, 2
            )[0],
        }
        img = render_frame(scene, frame, cfg)
        finite = bool(torch.isfinite(img).all())
        check = check_config(scene, w, h, dev)
        results["trace_err"] = max(results["trace_err"], check["K2.1"]["max_abs_err"])
        results["fused_err"] = max(results["fused_err"], check["K2.2"]["max_abs_err_all"])
        line = {
            "phase": "main", "config": tag, "scene": spec,
            "triangles": int(scene.tris.count), "width": w, "height": h,
            "bounces": cfg.bounces, "host_build_s": build_s,
            "frame_ms": ms, "frame_ms_min": times[0], "frame_ms_max": times[-1],
            "frame_host_ms": frame_host_ms,
            "mrays_per_s": w * h * cfg.bounces / (ms * 1e-3) / 1e6,
            "kernel_ms": kms, "kernel_device_ms": kdev, "kernel_bound_ms": kb["bound_ms"],
            "kernel_bound_by": kb["bound_by"], "kernel_bound": kb,
            "winning_clusters": clusters, "winning_slots": slots, "split": split,
            "tail": tail,
            "k22_launches": launches["K2.2"], "frames": frames,
            "k22_launches_per_frame": launches["K2.2"] / frames,
            "k21_launches": launches["K2.1"],
            "box_tests": cnt[0], "tri_tests": cnt[1],
            "ray_transforms": cnt[2], "shaded_hits": cnt[3],
            "node_steps": cnt[4], "staged_clusters": cnt[5],
            "rays_traced": rows_total * 128,
            "finite": finite, "mean": float(img.mean()),
            "table_bytes": table_bytes(kt, ft),
            "check": check,
            "k22_variant_launches": launches["K2.2_variants"],
            "ok": finite and launches["K2.2"] == frames and check["ok"]
            and launches["K2.2_variants"] == {"default": frames},
        }
        if note:
            line["note"] = note
        results["main"].append(line)
        emit(line)
        if not line["ok"]:
            raise SystemExit(f"main path {tag} failed")
        del out

    # ---- (d) the hit-query entry ``ops.trace.trace`` (K2.1) on (a)'s scene
    # and 1920x1080 camera rays: its own path, its own counts from zero
    _tag, spec, tris, w, h = MAIN[0]
    scene = build_scene(spec, tris, device=dev)
    rays, _cam = camera_rays(w, h, dev)
    o3, d3 = rays[0:3], rays[3:6]
    hit = tr.trace(scene, o3, d3)  # first call: tables upload
    torch.cuda.synchronize()
    reset_counts()
    ms, times = event_ms(lambda: tr.trace(scene, o3, d3), FRAMES, WARMUP)
    calls = FRAMES + WARMUP
    launches = {"K2.1": tr.trace_cuda.launches, "K2.2": rf.render_cuda.launches}
    n = rays.shape[1]
    line = {
        "phase": "main", "config": "d", "entry": "ops.trace.trace",
        "scene": spec, "triangles": int(scene.tris.count), "rays": n,
        "call_ms": ms, "call_ms_min": times[0], "call_ms_max": times[-1],
        "mrays_per_s": n / (ms * 1e-3) / 1e6,
        "k21_launches": launches["K2.1"], "calls": calls,
        "k21_launches_per_call": launches["K2.1"] / calls,
        "k22_launches": launches["K2.2"],
        "hits": int(hit.hit.sum()), "finite": bool(torch.isfinite(hit.t).all()),
        "ok": launches["K2.1"] == calls and launches["K2.2"] == 0
        and int(hit.hit.sum()) > 0,
    }
    results["trace_path"] = line
    emit(line)
    if not line["ok"]:
        raise SystemExit("main path d failed")


def device_profile(fn, reps: int, step_ms: float) -> dict:
    """torch.profiler over ``reps`` calls of ``fn``: device time by kernel
    (the trace's ``kernel``/``gpu_mem*`` events) and the device's idle
    share, 1 - busy / step, where busy is the union of the device
    intervals per call and ``step_ms`` the call's CUDA-event median taken
    without the profiler (its host-side tracing slows the launches and so
    stretches the profiled span)."""
    import os
    import tempfile

    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    dev_ev = [
        e for e in events
        if e.get("ph") == "X" and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")
    ]
    if not dev_ev:
        raise SystemExit("profile: the trace holds no device events")
    spans = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in dev_ev)
    busy, end = 0.0, spans[0][0]  # union of the device intervals, in us
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    span = spans[-1][1] - spans[0][0]
    by_name: dict = {}
    for e in dev_ev:
        dt, c = by_name.get(e["name"], (0.0, 0))
        by_name[e["name"]] = (dt + float(e["dur"]), c + 1)
    rows = sorted(((dt, k, c) for k, (dt, c) in by_name.items()), reverse=True)
    ops = []
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0.0)
        if us > 0:
            ops.append((float(us), e.key, int(e.count)))
    ops.sort(reverse=True)
    return {
        "device_busy_ms_per_call": busy / reps / 1e3,
        "device_idle_share": 1.0 - busy / reps / 1e3 / step_ms,
        "profiled_wall_ms_per_call": wall_us / reps / 1e3,
        "profiled_device_span_ms_per_call": span / reps / 1e3,
        "device_launches_per_call": len(dev_ev) / reps,
        "kernels": [
            {"name": k[:80], "ms_per_call": dt / reps / 1e3, "calls_per_call": c / reps}
            for dt, k, c in rows[:12]
        ],
        "ops": [  # torch ops by the device time of their own kernels
            {"op": k[:80], "ms_per_call": us / reps / 1e3, "calls_per_call": c / reps}
            for us, k, c in ops[:15]
        ],
    }


def phase_profile(dev, results) -> None:
    """torch.profiler over 10 frames of config (a), against (a)'s
    unprofiled frame time from phase 4 (``device_profile``)."""
    import torch

    from clraytracer_tpu_torch.camera import Camera
    from clraytracer_tpu_torch.cli import build_scene
    from clraytracer_tpu_torch.config import CameraConfig, RenderConfig
    from clraytracer_tpu_torch.render import frame_inputs_from_camera, render_frame

    _tag, spec, tris, w, h = MAIN[0]
    scene = build_scene(spec, tris, device=dev)
    cfg = RenderConfig(width=w, height=h)
    frame = frame_inputs_from_camera(
        Camera.create(CameraConfig(position=CAMERA), w, h), SUN
    )
    for _ in range(3):
        render_frame(scene, frame, cfg)
    torch.cuda.synchronize()
    reps = 10
    frame_ms = results["main"][0]["frame_ms"]
    prof = device_profile(lambda: render_frame(scene, frame, cfg), reps, frame_ms)
    results["profile"] = {
        "phase": "profile", "config": "a", "frames": reps,
        "frame_ms_unprofiled": frame_ms, **prof,
    }
    emit(results["profile"])


def cli_camera(w: int, h: int):
    from clraytracer_tpu_torch.camera import Camera
    from clraytracer_tpu_torch.config import CameraConfig

    return Camera.create(CameraConfig(position=CAMERA), w, h)


def diff_frame(w: int, h: int, dev):
    """Frame inputs of the smoke camera, moved to the card once."""
    import torch

    from clraytracer_tpu_torch.render import FrameInputs, frame_inputs_from_camera

    frame = frame_inputs_from_camera(cli_camera(w, h), SUN)
    return FrameInputs(*(torch.as_tensor(x).to(dev) for x in frame))


def grads_disagree(got: dict, ref: dict) -> list:
    """Keys whose card gradients disagree with the CPU step's: aggregated
    leaves (materials, instances) to rtol 1e-3, per-row leaves (tris,
    atlas) on >= 99% of rows within 1e-3 |g| + 1e-4 max |g|; every other
    leaf zero in both. Non-finite values disagree."""
    import torch

    bad = []
    for key, r in ref.items():
        a, b = r.double().cpu(), got[key].double().cpu()
        group = key.split(".")[0]
        scale = float(a.abs().max())
        if not bool(torch.isfinite(b).all()):
            bad.append(key)
            continue
        if group in ("tris", "atlas"):
            close = (b - a).abs() <= 1e-3 * a.abs() + 1e-4 * scale
            frac = float(close.reshape(close.shape[0], -1).all(dim=1).double().mean())
            ok = frac >= 0.99
        elif group in ("materials", "instances"):
            ok = bool(((b - a).abs() <= 1e-3 * a.abs() + 1e-6 * scale).all())
        else:
            ok = not bool(a.any()) and not bool(b.any())
        if not ok:
            bad.append(key)
    return bad


def reset_counts() -> None:
    from clraytracer_tpu_torch.ops import gather_rows as gr
    from clraytracer_tpu_torch.ops import render_fused as rf
    from clraytracer_tpu_torch.ops import trace as tr

    rf.render_cuda.launches = 0
    rf.render_cuda.variant_launches = {}
    tr.trace_cuda.launches = 0
    gr.gather_rows_cuda.launches = 0
    gr.scatter_rows_cuda.launches = 0


def read_counts() -> dict:
    from clraytracer_tpu_torch.ops import gather_rows as gr
    from clraytracer_tpu_torch.ops import render_fused as rf
    from clraytracer_tpu_torch.ops import trace as tr

    return {"K2.1": tr.trace_cuda.launches, "K2.2": rf.render_cuda.launches,
            "K2.3": gr.gather_rows_cuda.launches,
            "K2.4": gr.scatter_rows_cuda.launches}


def check_gather_kernels(gathers, scatters) -> dict:
    """K2.3 and K2.4 against their plain versions and library calls on the
    step's own inputs (bounce 0's gather and its scatter, which the
    backward runs last), timed with CUDA events."""
    import torch

    from clraytracer_tpu_torch.ops import gather_rows as gr

    out = {"K2.3": {"cases": []}, "K2.4": {"cases": []}}
    for b, (table, idx) in enumerate(gathers):
        got = gr.gather_rows_cuda(table, idx)
        ref = gr.gather_rows_plain(table, idx)
        torch.cuda.synchronize()
        out["K2.3"]["cases"].append({
            "bounce": b, "bit_exact": bool(torch.equal(got, ref)),
            "max_abs_err": float((got - ref).abs().max()),
        })
    for b, (g, idx, t_rows) in enumerate(reversed(scatters)):
        got = gr.scatter_rows_cuda(g, idx, t_rows)
        ref = gr.scatter_rows_plain(g, idx, t_rows)
        mag = gr.scatter_rows_plain(g.abs(), idx, t_rows)
        torch.cuda.synchronize()
        err = (got - ref).abs()
        out["K2.4"]["cases"].append({
            "bounce": b, "max_abs_err": float(err.max()),
            "max_err_over_tol": float((err / (1e-5 * mag + 1e-7)).max()),
            "within_tol": bool((err <= 1e-5 * mag + 1e-7).all()),
            "nonzero_terms": int((g != 0).sum()), "terms": g.numel(),
        })
    out["K2.3"]["ok"] = all(c["bit_exact"] for c in out["K2.3"]["cases"])
    out["K2.4"]["ok"] = all(c["within_tol"] for c in out["K2.4"]["cases"])

    table, idx = gathers[0]
    g, gidx, t_rows = scatters[-1]
    n, w = idx.numel(), table.shape[1]
    table_t = table.t().contiguous()
    reps = 20
    bytes_moved = n * 4 + n * w * 4 + t_rows * w * 4
    # ms and library_ms: one event pair around each call; device_ms and
    # library_device_ms beside them: the card's time (``device_ms``)
    gather = lambda: gr.gather_rows_cuda(table, idx)
    lib_gather = lambda: torch.index_select(table_t, 1, idx)
    k3 = {
        "ms": event_ms(gather, reps)[0], "device_ms": device_ms(gather),
        "plain_ms": event_ms(lambda: gr.gather_rows_plain(table, idx), reps)[0],
        "library_ms": event_ms(lib_gather, reps)[0],
        "library_device_ms": device_ms(lib_gather),
        "bound_ms": bytes_moved / PEAK_BYTES * 1e3, "bound_by": "bytes",
        "bytes": bytes_moved, "shape": f"table [{table.shape[0]}, {w}], idx [{n}]",
    }
    lib_scatter = lambda: torch.zeros(w, t_rows, device=g.device).index_add_(1, gidx, g)
    adds = int((g != 0).sum())
    t_bytes = bytes_moved / PEAK_BYTES * 1e3
    t_ops = adds / PEAK_F32 * 1e3
    scatter = lambda: gr.scatter_rows_cuda(g, gidx, t_rows)
    k4 = {
        "ms": event_ms(scatter, reps)[0], "device_ms": device_ms(scatter),
        "plain_ms": event_ms(lambda: gr.scatter_rows_plain(g, gidx, t_rows), reps)[0],
        "library_ms": event_ms(lib_scatter, reps)[0],
        "library_device_ms": device_ms(lib_scatter),
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "bytes": bytes_moved, "adds": adds,
        "shape": f"g [{w}, {n}], idx [{n}] -> [{t_rows}, {w}]",
    }
    out["K2.3"].update(k3)
    out["K2.4"].update(k4)
    return out


def phase_diff(dev, results) -> None:
    """The differentiable step (``diff.image_loss_and_grads``) on the card:
    (e) the bench's grads configuration, (f) card against CPU, (g) fit."""
    import torch

    from clraytracer_tpu_torch import cli
    from clraytracer_tpu_torch.cli import build_scene
    from clraytracer_tpu_torch.diff import (
        grad_leaves,
        image_loss_and_grads,
        render_image_diff,
    )
    from clraytracer_tpu_torch.ops import gather_rows as gr
    from clraytracer_tpu_torch.render import frame_inputs_from_camera

    # ---- (e) sphere 4224 tris, 1920x1080, 2 bounces, L2 against black
    _tag, spec, tris, w, h = DIFF_E
    scene = build_scene(spec, tris, device=dev)
    frame = diff_frame(w, h, dev)
    target = torch.zeros(h, w, 3, device=dev)
    step = lambda: image_loss_and_grads(scene, frame, w, h, target=target)
    step()  # first step: tables upload
    torch.cuda.synchronize()
    # ---- the main path's own run: counts from zero
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    base_mem = torch.cuda.memory_allocated()
    ms, times = event_ms(step, STEPS, STEP_WARMUP)
    peak = torch.cuda.max_memory_allocated()
    counts = read_counts()
    steps = STEPS + STEP_WARMUP
    # ---- the step's split: the forward (render + loss, building the
    # graph) alone, then the backward (autograd.grad) alone
    s_leaf, params = grad_leaves(scene)
    leaves = list(params.values())
    fwd = lambda: torch.mean((render_image_diff(s_leaf, frame, w, h) - target) ** 2)
    fwd_ms, _ = event_ms(fwd, 5, 1)
    bwd_times = []
    for i in range(6):
        loss_t = fwd()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        torch.autograd.grad(loss_t, leaves, allow_unused=True)
        b.record()
        b.synchronize()
        if i:
            bwd_times.append(a.elapsed_time(b))
    bwd_times.sort()
    del loss_t, s_leaf, params, leaves
    loss, grads = step()
    finite = all(bool(torch.isfinite(g).all()) for g in grads.values())
    nonzero = {k: float(grads[k].float().abs().max()) > 0.0
               for k in ("materials.albedo", "tris.v0", "instances.inverse_transform")}
    # ---- capture bounce inputs of one step for the kernel checks
    gathers, scatters = [], []
    real_gather, real_scatter = gr.gather_rows, gr.scatter_rows

    def rec_gather(table, idx):
        gathers.append((table.detach(), idx))
        return real_gather(table, idx)

    def rec_scatter(g, idx, t_rows):
        scatters.append((g, idx, t_rows))
        return real_scatter(g, idx, t_rows)

    gr.gather_rows, gr.scatter_rows = rec_gather, rec_scatter
    try:
        step()
    finally:
        gr.gather_rows, gr.scatter_rows = real_gather, real_scatter
    kern = check_gather_kernels(gathers, scatters)
    n_rays = gathers[0][1].numel()
    hits0 = int((gathers[0][1] != 0).sum())
    del gathers, scatters
    prof = device_profile(step, 3, ms)
    line = {
        "phase": "diff", "config": "e", "scene": spec,
        "triangles": int(scene.tris.count), "width": w, "height": h,
        "bounces": 2, "loss": float(loss),
        "step_ms": ms, "step_ms_min": times[0], "step_ms_max": times[-1],
        "mrays_per_s": w * h * 2 / (ms * 1e-3) / 1e6,
        "forward_ms": fwd_ms, "backward_ms": bwd_times[len(bwd_times) // 2],
        "steps": steps, "launches": counts,
        "launches_per_step": {k: v / steps for k, v in counts.items()},
        "peak_mem_bytes": peak, "mem_before_bytes": base_mem,
        "rays_per_bounce": n_rays, "bounce0_rays_off_row0": hits0,
        "grads_finite": finite, "grads_nonzero": nonzero,
        "grad_norms": {k: float(torch.linalg.vector_norm(grads[k].float()))
                       for k in ("materials.albedo", "tris.v0",
                                 "instances.inverse_transform")},
        "kernels_check": {k: {"ok": v["ok"], "cases": v["cases"]}
                          for k, v in kern.items()},
        "profile": prof,
    }
    line["ok"] = (
        finite and all(nonzero.values()) and kern["K2.3"]["ok"] and kern["K2.4"]["ok"]
        and counts == {"K2.1": 2 * steps, "K2.2": 0, "K2.3": 2 * steps,
                       "K2.4": 2 * steps}
    )
    results["diff"] = {"e": line, "kernels": kern}
    emit(line)
    if not line["ok"]:
        raise SystemExit("diff (e) failed")
    del grads

    # ---- (f) the card's step against the CPU step (plain versions)
    fw, fh = DIFF_CHECK_WH
    for spec_f in ("two", "sphere"):
        cpu = build_scene(spec_f, 4096, device="cpu")
        gpu = build_scene(spec_f, 4096, device=dev)
        fr_c = frame_inputs_from_camera(cli_camera(fw, fh), SUN)
        fr_g = diff_frame(fw, fh, dev)
        img_c = render_image_diff(cpu, fr_c, fw, fh, device="cpu")
        img_g = render_image_diff(gpu, fr_g, fw, fh).cpu()
        px_bad = float(((img_g - img_c).abs() > 1e-5).any(dim=-1).double().mean())
        tgt = torch.zeros(fh, fw, 3)
        loss_c, g_c = image_loss_and_grads(cpu, fr_c, fw, fh, target=tgt, device="cpu")
        reset_counts()
        loss_g, g_g = image_loss_and_grads(gpu, fr_g, fw, fh, target=tgt.to(dev))
        torch.cuda.synchronize()
        counts = read_counts()
        bad = grads_disagree(g_g, g_c)
        rel = abs(float(loss_g) - float(loss_c)) / abs(float(loss_c))
        line = {
            "phase": "diff", "config": "f", "scene": spec_f, "width": fw,
            "height": fh, "pixels_over_1e-5": px_bad, "loss_cpu": float(loss_c),
            "loss_card": float(loss_g), "loss_rel_err": rel,
            "grads_disagree": bad, "launches": counts,
            "max_rel_err": {
                k: float((g_g[k].double().cpu() - g_c[k].double()).abs().max()
                         / max(float(g_c[k].double().abs().max()), 1e-30))
                for k in ("materials.albedo", "tris.v0", "instances.inverse_transform")
            },
        }
        line["ok"] = (px_bad <= 0.01 and rel <= 1e-5 and not bad
                      and counts == {"K2.1": 2, "K2.2": 0, "K2.3": 2, "K2.4": 2})
        emit(line)
        if not line["ok"]:
            raise SystemExit(f"diff (f) {spec_f} failed")

    # ---- (g) Adam inverse rendering of ``two``'s albedo at 1249x720
    _tag, spec_g, gw, gh, n_steps = DIFF_G
    scene = build_scene(spec_g, 4096, device=dev)
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    report, _fitted = cli.fit(
        scene, frame_inputs_from_camera(cli_camera(gw, gh), SUN), gw, gh,
        steps=n_steps, lr=0.05, seed=0,
    )
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    # the target render and every step trace and gather twice; no K2.4: the
    # triangle table needs no gradient when only the albedo is fitted
    want = {"K2.1": 2 * (n_steps + 1), "K2.2": 0, "K2.3": 2 * (n_steps + 1),
            "K2.4": 0}
    line = {
        "phase": "diff", "config": "g", "scene": spec_g, "width": gw,
        "height": gh, "param": "albedo", "lr": 0.05, **report,
        "fit_wall_s": wall, "launches": counts,
        "ok": report["loss_last"] < report["loss_first"] and counts == want,
    }
    emit(line)
    if not line["ok"]:
        raise SystemExit("diff (g) failed")


def phase_kernels(dev, results) -> None:
    """Holds each kernel against its plain version at the main path's shapes
    (config (a): sphere, 4224 tris, 1920x1080), times both, and prints the
    kernels line. ``launches`` are the counts of the paths' own runs
    (phase 4): K2.2 from render_frame (a)-(c), K2.1 from the trace entry (d)."""
    import torch

    from clraytracer_tpu_torch.cli import build_scene
    from clraytracer_tpu_torch.ops import render_fused as rf
    from clraytracer_tpu_torch.ops import trace as tr
    from clraytracer_tpu_torch.render import frame_inputs_from_camera

    _tag, spec, tris, w, h = MAIN[0]
    scene = build_scene(spec, tris, device=dev)
    kt, ft = tr.kernel_tables(scene), rf.frame_tables(scene)
    rays, cam = camera_rays(w, h, dev)
    n = rays.shape[1]
    cnt1 = torch.zeros(6, dtype=torch.int64, device=dev)
    got = tr.trace_cuda(kt, rays, None, cnt1)
    ref = tr.trace_plain(kt, rays)
    torch.cuda.synchronize()
    check1 = compare_trace(got, ref)
    clusters, slots = winners(got)
    del got, ref
    t_ms, _ = event_ms(lambda: tr.trace_cuda(kt, rays), 10, 2)
    t_dev = device_ms(lambda: tr.trace_cuda(kt, rays))
    tp_ms, _ = event_ms(lambda: tr.trace_plain(kt, rays), 1, 0)
    kb1 = walk_bound(("K2.1", "a", int(scene.tris.count)),
                     6 * n * 4 + walk_bytes(kt, clusters, slots) + 11 * n * 4,
                     cnt1.cpu().tolist())

    cr = rf.camera_row(frame_inputs_from_camera(cam, SUN))
    trows = rf.tile_rows(w * h)
    rows_total = -(-h // trows) * -(-w // 128) * trows
    cnt2 = torch.zeros(6, dtype=torch.int64, device=dev)
    got = rf.render_cuda(kt, ft, cr, w, h, trows, rows_total, 2, cnt2)
    ref = rf.render_fused_plain(kt, ft, cr, w, h, trows, rows_total, 2, dev)
    torch.cuda.synchronize()
    check2 = compare_options(got, ref, 0, False)
    del got, ref
    r_ms, _ = event_ms(
        lambda: rf.render_cuda(kt, ft, cr, w, h, trows, rows_total, 2), 10, 2
    )
    r_dev = device_ms(lambda: rf.render_cuda(kt, ft, cr, w, h, trows, rows_total, 2))
    rp_ms, _ = event_ms(
        lambda: rf.render_fused_plain(kt, ft, cr, w, h, trows, rows_total, 2, dev),
        1, 0,
    )
    cnt2 = cnt2.cpu().tolist()
    kb2 = walk_bound(("K2.2", "a", int(scene.tris.count)),
                     walk_bytes(kt, clusters, slots, ft) + 9 * rows_total * 128 * 4,
                     cnt2, rows_total * 128, shade=True)
    emit({"phase": "kernels_at_main_shapes", "scene": spec, "width": w, "height": h,
          "K2.1": check1, "K2.2": check2, "K2.1_bound": kb1, "K2.2_bound": kb2,
          "main_path_counts": {m["config"]: m["kernel_bound"]["counts"]
                               for m in results["main"]},
          "ptxas": results["ptxas"]})
    if not (check1["ok"] and check2["ok"]):
        raise SystemExit("a kernel disagrees with its plain version at main-path shapes")
    emit({"kernels": [
        {
            "name": "K2.1 trace (hit record)", "route": "cuda",
            "source": "clraytracer_tpu_torch/csrc/trace.cu",
            "replaces": "clraytracer_tpu/ops/trace_pallas.py:928",
            "launches": results["trace_path"]["k21_launches"],
            "path": f"(d) ops.trace.trace, {w}x{h} camera rays",
            "max_abs_err": max(results["trace_err"], check1["max_abs_err"]),
            "tolerance": (f"hit rule of tests/test_trace.py; <= {FRAME_MISMATCH_MAX} "
                          "rays not exact in (t, slot, instance); attrs rtol 1e-5 atol 1e-6"),
            "ms": t_ms, "device_ms": t_dev, "plain_ms": tp_ms, "bound_ms": kb1["bound_ms"],
            "bound_by": kb1["bound_by"], "library_ms": None,
            "shape": f"{n} camera rays, {spec} {scene.tris.count} tris",
        },
        {
            "name": "K2.2 fused frame", "route": "cuda",
            "source": "clraytracer_tpu_torch/csrc/render.cu",
            "replaces": "clraytracer_tpu/ops/render_pallas.py:109",
            "launches": sum(m["k22_launches"] for m in results["main"]),
            "path": "(a)-(c) render.render_frame",
            "max_abs_err": max(results["fused_err"], check2["max_abs_err_all"]),
            "tolerance": f"<= {FRAME_MISMATCH_MAX} rays over 1e-5 on any of nine planes",
            "ms": r_ms, "device_ms": r_dev, "plain_ms": rp_ms, "bound_ms": kb2["bound_ms"],
            "bound_by": kb2["bound_by"], "library_ms": None,
            "shape": f"{w}x{h}x2 bounces, {spec} {scene.tris.count} tris",
        },
        *option_kernel_entries(results),
        *diff_kernel_entries(results),
    ]})


def option_kernel_entries(results) -> list:
    """One kernels-line entry per K2.2 instantiation that an option cell
    drives ((h)-(k)): its launches in that cell's main-path run, its error
    against the plain version (at the cell's shapes, on its strip and in
    phase options), its ms at the cell's shapes beside the plain version's
    and its bound."""
    out = []
    for line, (tag, spec, _tris, w, h, cfg_kw) in zip(results["option_cells"], OPTION_CELLS):
        errs = [c["max_abs_err_within"] for c in results["options"]
                if c["variant"] == line["variant"]]
        errs += [line["check"]["max_abs_err_within"], line["check_full"]["max_abs_err_within"]]
        out.append({
            "name": f"K2.2 fused frame, {line['variant']}", "route": "cuda",
            "source": "clraytracer_tpu_torch/csrc/render.cu",
            "replaces": "clraytracer_tpu/ops/render_pallas.py:109",
            "launches": line["launches"]["K2.2_variants"].get(line["variant"], 0),
            "path": f"({tag}) render.render_frame, {spec}, {cfg_kw or 'defaults'}",
            "max_abs_err": max(errs),
            "tolerance": (f"pool indices exact; other planes within 1e-5 on all but "
                          f"{FRAME_MISMATCH_MAX} rays"),
            "ms": line["kernel_ms"], "device_ms": line["kernel_device_ms"],
            "plain_ms": line["plain_ms"],
            "bound_ms": line["kernel_bound_ms"], "bound_by": line["kernel_bound_by"],
            "library_ms": None,
            "shape": f"{w}x{h}x{line['bounces']} bounces, {spec} {line['triangles']} tris",
            "plain_shape": line["plain_frame"],
        })
    return out


def diff_kernel_entries(results) -> list:
    """K2.3 and K2.4 entries of the kernels line, from phase diff (e)."""
    e, kern = results["diff"]["e"], results["diff"]["kernels"]
    out = []
    for key, name, src, fn in (
        ("K2.3", "K2.3 gather rows (diff forward)", "clrt_gather_rows",
         "clraytracer_tpu/ops/gather_pallas.py:77"),
        ("K2.4", "K2.4 scatter rows (diff backward)", "clrt_scatter_rows",
         "clraytracer_tpu/ops/gather_pallas.py:110"),
    ):
        k = kern[key]
        out.append({
            "name": name, "route": "cuda",
            "source": "clraytracer_tpu_torch/csrc/gather.cu",
            "entry": src, "replaces": fn,
            "launches": e["launches"][key],
            "path": f"(e) diff.image_loss_and_grads, {e['width']}x{e['height']}x2",
            "max_abs_err": max(c["max_abs_err"] for c in k["cases"]),
            "tolerance": ("bit-exact" if key == "K2.3"
                          else "1e-5 * sum|g| (plain scatter of |g|) + 1e-7"),
            "ms": k["ms"], "device_ms": k["device_ms"], "plain_ms": k["plain_ms"],
            "bound_ms": k["bound_ms"], "bound_by": k["bound_by"],
            "library_ms": k["library_ms"], "library_device_ms": k["library_device_ms"],
            "shape": k["shape"],
        })
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None, help="also write every line here (JSON)")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    try:
        from clraytracer_tpu_torch.runtime import kernels
    except ImportError as exc:
        print(f"chip_smoke: the package is missing ({exc})", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    results: dict = {}
    card = card_line()
    t0 = time.perf_counter()
    kernels.build_all()
    build_s = time.perf_counter() - t0
    regs = {src: ptxas_summary(log) for src, log in kernels.build_log.items()}
    results["ptxas"] = regs
    # K2.2's default instantiation (atlas mode 0, no GI, no shadows)
    k22_default = [e for e in regs.get("render.cu", [])
                   if "render_kernelILi0ELb0EE" in e["kernel"]]
    emit({
        "phase": "device", "card": card, "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(), "torch": torch.__version__,
        "cuda": torch.version.cuda, "python": sys.version.split()[0],
        "kernel_build_s": build_s, "ptxas": regs, "k22_default": k22_default,
        "k22_instantiations": k22_registers(regs.get("render.cu", [])),
    })
    phase_trace(dev, results)
    phase_fused(dev, results)
    phase_options(dev, results)
    phase_main(dev, results, TRIS_LARGE)
    phase_option_cells(dev, results)
    phase_profile(dev, results)
    phase_diff(dev, results)
    phase_kernels(dev, results)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": card, **results}, f, indent=1, default=str)
    print(card_line(), flush=True)
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }})
    return 0


if __name__ == "__main__":
    sys.exit(main())
