"""Smoke run of clraytracer_tpu_torch on one NVIDIA card (H100, sm_90a).

    python3 chip_smoke.py [--out results.json]

Builds the CUDA kernels from csrc/ (one nvcc per source, in parallel),
holds each kernel against its plain PyTorch version on the card, drives the
main path (``render.render_frame``, the default frame) on three scenes,
and prints one JSON line per phase:

1. device: card name and power limit, torch/CUDA versions, build seconds
2. trace: K2.1 vs ``trace_plain`` on ``two`` (320x240 camera rays + 4096
   seeded random rays), with and without a live mask, and ``return_slots``
3. fused: K2.2 vs ``render_fused_plain`` on ``two`` and ``sphere`` at
   320x240 (at most FRAME_MISMATCH_MAX rays over 1e-5 on the nine planes)
4. main path: ``render.render_frame`` on (a) ``sphere`` 4224 tris at
   1920x1080, (b) ``two`` at 1249x720, (c) ``sphere --tris 1000000`` at
   1920x1080; frame ms (CUDA events, median of 20 after 3 warm-ups),
   Mrays/s = W*H*bounces/dt (no clamp), K2.2 launches per frame (must be
   1), work counts per frame, finite image and its mean, and both kernels
   against their plain versions on that configuration's scene (K2.1 on
   4096 seeded camera rays, K2.2 on a 128x64 strip). Then (d)
   the hit-query entry ``ops.trace.trace`` on (a)'s scene and 1920x1080
   camera rays: one K2.1 launch per call (and no K2.2)
5. profile: torch.profiler over 10 frames of (a), device time by kernel
   and the device's idle share against (a)'s unprofiled frame time
6. kernels: each kernel against its plain version at (a)'s shapes, then
   the kernels line: per kernel its TPU counterpart, launches on its path,
   error against the plain version, ms, plain ms, bound ms

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
# square root counts as one); the kernels' int64[4] counters count the
# units: box tests, triangle tests, ray transforms, interpolated hits
BOX_OPS = 27  # slab: 6 sub + 6 mul + 12 min/max + 3 compares
TRI_OPS = 45  # plane test: den 5 + b_n 6 + t 2 + u 13 + v 13 + u+v 1 + 5 cmp
XFORM_OPS = 36  # ray to object space: origin 18 + direction 15 + 3 reciprocals
INTERP_OPS = 27  # w0 2 + five 3-term interpolations of 5
# render.cu per shaded hit after interpolation: world normal 15, object ray
# 33, normalise 9, material row 4, checker texel 17, colour 24, Phong and
# reflection 86
SHADE_OPS = 188
RAYGEN_OPS = 59  # render.cu per camera ray: NDC 7, invProj 24, invView 18, norm 10

CAMERA = (0.13, 0.21, 10.0)
SUN = -1.96
CHECK_WH = (320, 240)  # kernel-vs-plain checks (phases 2 and 3)
# per main-path configuration (phase 4): K2.1 on this many seeded camera
# rays of the full frame, K2.2 on one 128-pixel strip of the same camera
CHECK_RAYS = 4096
CHECK_STRIP_WH = (128, 64)
# K2.2 and render_fused_plain share slot order and strict t < best, so on
# the card they agree exactly by construction: at most this many rays of a
# frame may differ by more than 1e-5 (the 1% seam allowance holds only
# against the JAX package, in the CPU tests)
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
    kernel's [boxes, triangles, transforms, hits]; ``camera_rays`` and
    ``shade`` add K2.2's raygen and shading."""
    boxes, tris, xforms, hits = (float(c) for c in counts)
    ops = (
        boxes * BOX_OPS + tris * TRI_OPS + xforms * XFORM_OPS
        + hits * (INTERP_OPS + (SHADE_OPS if shade else 0))
        + camera_rays * RAYGEN_OPS
    )
    t_bytes = bytes_moved / PEAK_BYTES * 1e3
    t_ops = ops / PEAK_F32 * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")


def camera_rays(width, height, device):
    """Screen-tile-ordered camera rays [6, n] and the frame inputs."""
    import torch

    from clraytracer_tpu_torch.camera import Camera, ray_directions_tiled
    from clraytracer_tpu_torch.config import CameraConfig
    from clraytracer_tpu_torch.ops.render_fused import tile_rows

    cam = Camera.create(CameraConfig(position=CAMERA), width, height)
    d = ray_directions_tiled(
        torch.from_numpy(cam.inverse_view).to(device),
        torch.from_numpy(cam.inverse_projection).to(device),
        width, height, tile_rows(width * height),
    ).reshape(3, -1)
    o = torch.tensor(cam.position, device=device)[:, None].expand_as(d)
    return torch.cat([o, d]).contiguous(), cam


def compare_trace(got, ref, live=None) -> dict:
    """K2.1's [11, n] output against trace_plain's: the hit rule, then the
    attributes at rtol 1e-5 / atol 1e-6 wherever both pick the same slot."""
    import numpy as np
    import torch

    gt, rt = got[0].cpu().numpy(), ref[0].cpu().numpy()
    gh, rh = np.abs(gt) < 1e30, np.abs(rt) < 1e30
    gs = got[3].view(torch.int32).cpu().numpy()
    rs = ref[3].view(torch.int32).cpu().numpy()
    case = hits_match(rh, gh, rt, gt, rs, gs)
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
    case["ok"] = case["ok"] and case["attrs_ok"] and case.get("dead_lanes_miss", True)
    return case


def compare_frame(got, ref) -> dict:
    """K2.2's [9, n] output against render_fused_plain's: at most
    FRAME_MISMATCH_MAX rays off by more than 1e-5 on any of the nine
    planes."""
    import torch

    diff = (got - ref).abs().amax(dim=0)
    bad = int((diff > 1e-5).sum())
    n = diff.numel()
    good = diff[diff <= 1e-5]
    finite = bool(torch.isfinite(got).all())
    return {
        "rays": n, "rays_over_1e-5": bad,
        "max_abs_err_within": float(good.max()) if good.numel() else 0.0,
        "max_abs_err_all": float(diff.max()), "finite": finite,
        "ok": bad <= FRAME_MISMATCH_MAX and finite,
    }


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
        line = {"phase": "fused", "scene": spec, **compare_frame(got, ref)}
        worst = max(worst, line["max_abs_err_all"])
        emit(line)
        if not line["ok"]:
            raise SystemExit("fused phase failed")
    results["fused_err"] = worst


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
    k22 = compare_frame(rf.render_cuda(*args), rf.render_fused_plain(*args, dev))
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
        rf.render_cuda.launches = 0
        tr.trace_cuda.launches = 0
        ms, times = event_ms(lambda: render_frame(scene, frame, cfg), FRAMES, WARMUP)
        frames = FRAMES + WARMUP
        launches = {"K2.2": rf.render_cuda.launches, "K2.1": tr.trace_cuda.launches}
        # ---- test counts of one frame (a separate launch with counters)
        kt, ft = tr.kernel_tables(scene), rf.frame_tables(scene)
        cr = rf.camera_row(frame)
        trows = rf.tile_rows(w * h)
        rows_total = -(-h // trows) * -(-w // 128) * trows
        counters = torch.zeros(4, dtype=torch.int64, device=dev)
        out = rf.render_cuda(kt, ft, cr, w, h, trows, rows_total, cfg.bounces, counters)
        kms, _ = event_ms(
            lambda: rf.render_cuda(kt, ft, cr, w, h, trows, rows_total, cfg.bounces),
            10, 2,
        )
        cnt = counters.cpu().tolist()
        kb_ms, kb_by = bound(table_bytes(kt, ft) + 9 * rows_total * 128 * 4, cnt,
                             rows_total * 128, shade=True)
        # ---- the frame's torch tail after the kernel, piece by piece
        out9 = out.reshape(9, rows_total, 128)
        layout = ("strip", trows, -(-w // 128), -(-h // trows))
        fin = lambda: rf._finish_frame(scene, out9[0:3], out9[3:6], out9[6:9])
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
            "mrays_per_s": w * h * cfg.bounces / (ms * 1e-3) / 1e6,
            "kernel_ms": kms, "kernel_bound_ms": kb_ms, "kernel_bound_by": kb_by,
            "tail": tail,
            "k22_launches": launches["K2.2"], "frames": frames,
            "k22_launches_per_frame": launches["K2.2"] / frames,
            "k21_launches": launches["K2.1"],
            "box_tests": cnt[0], "tri_tests": cnt[1],
            "ray_transforms": cnt[2], "shaded_hits": cnt[3],
            "rays_traced": rows_total * 128,
            "finite": finite, "mean": float(img.mean()),
            "table_bytes": table_bytes(kt, ft),
            "check": check,
            "ok": finite and launches["K2.2"] == frames and check["ok"],
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
    rf.render_cuda.launches = 0
    tr.trace_cuda.launches = 0
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


def phase_profile(dev, results) -> None:
    """torch.profiler over 10 frames of config (a): device time by kernel
    (the trace's ``kernel``/``gpu_mem*`` events) and the device's idle
    share, 1 - busy / frame, where busy is the union of the device
    intervals per frame and frame is phase 4's CUDA-event median of (a),
    taken without the profiler (its host-side tracing slows the launches
    and so stretches the profiled span)."""
    import os
    import tempfile

    import torch
    from torch.profiler import ProfilerActivity, profile

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
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            render_frame(scene, frame, cfg)
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
        raise SystemExit("profile phase: the trace holds no device events")
    spans = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in dev_ev)
    busy, end = 0.0, spans[0][0]  # union of the device intervals, in us
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    span = spans[-1][1] - spans[0][0]
    frame_ms = results["main"][0]["frame_ms"]
    by_name: dict = {}
    for e in dev_ev:
        dt, c = by_name.get(e["name"], (0.0, 0))
        by_name[e["name"]] = (dt + float(e["dur"]), c + 1)
    rows = sorted(((dt, k, c) for k, (dt, c) in by_name.items()), reverse=True)
    results["profile"] = {
        "phase": "profile", "config": "a", "frames": reps,
        "frame_ms_unprofiled": frame_ms,
        "device_busy_ms_per_frame": busy / reps / 1e3,
        "device_idle_share": 1.0 - busy / reps / 1e3 / frame_ms,
        "profiled_wall_ms_per_frame": wall_us / reps / 1e3,
        "profiled_device_span_ms_per_frame": span / reps / 1e3,
        "device_launches_per_frame": len(dev_ev) / reps,
        "kernels": [
            {"name": k[:80], "ms_per_frame": dt / reps / 1e3, "calls_per_frame": c / reps}
            for dt, k, c in rows[:12]
        ],
    }
    emit(results["profile"])


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
    cnt1 = torch.zeros(4, dtype=torch.int64, device=dev)
    got = tr.trace_cuda(kt, rays, None, cnt1)
    ref = tr.trace_plain(kt, rays)
    torch.cuda.synchronize()
    check1 = compare_trace(got, ref)
    del got, ref
    t_ms, _ = event_ms(lambda: tr.trace_cuda(kt, rays), 10, 2)
    tp_ms, _ = event_ms(lambda: tr.trace_plain(kt, rays), 1, 0)
    b1, by1 = bound(6 * n * 4 + table_bytes(kt) + 11 * n * 4, cnt1.cpu().tolist())

    cr = rf.camera_row(frame_inputs_from_camera(cam, SUN))
    trows = rf.tile_rows(w * h)
    rows_total = -(-h // trows) * -(-w // 128) * trows
    cnt2 = torch.zeros(4, dtype=torch.int64, device=dev)
    got = rf.render_cuda(kt, ft, cr, w, h, trows, rows_total, 2, cnt2)
    ref = rf.render_fused_plain(kt, ft, cr, w, h, trows, rows_total, 2, dev)
    torch.cuda.synchronize()
    check2 = compare_frame(got, ref)
    del got, ref
    r_ms, _ = event_ms(
        lambda: rf.render_cuda(kt, ft, cr, w, h, trows, rows_total, 2), 10, 2
    )
    rp_ms, _ = event_ms(
        lambda: rf.render_fused_plain(kt, ft, cr, w, h, trows, rows_total, 2, dev),
        1, 0,
    )
    b2, by2 = bound(table_bytes(kt, ft) + 9 * rows_total * 128 * 4,
                    cnt2.cpu().tolist(), rows_total * 128, shade=True)
    emit({"phase": "kernels_at_main_shapes", "scene": spec, "width": w, "height": h,
          "K2.1": check1, "K2.2": check2,
          "K2.1_counts": cnt1.cpu().tolist(), "K2.2_counts": cnt2.cpu().tolist(),
          "counts": "boxes, triangles, ray transforms, hits"})
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
            "tolerance": "hit rule of tests/test_trace.py; attrs rtol 1e-5 atol 1e-6",
            "ms": t_ms, "plain_ms": tp_ms, "bound_ms": b1, "bound_by": by1,
            "library_ms": None,
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
            "ms": r_ms, "plain_ms": rp_ms, "bound_ms": b2, "bound_by": by2,
            "library_ms": None,
            "shape": f"{w}x{h}x2 bounces, {spec} {scene.tris.count} tris",
        },
    ]})


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
    regs = {
        src: [ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln]
        for src, log in kernels.build_log.items()
    }
    emit({
        "phase": "device", "card": card, "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(), "torch": torch.__version__,
        "cuda": torch.version.cuda, "python": sys.version.split()[0],
        "kernel_build_s": build_s, "ptxas": regs,
    })
    phase_trace(dev, results)
    phase_fused(dev, results)
    phase_main(dev, results, TRIS_LARGE)
    phase_profile(dev, results)
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
