"""Smoke run of clraytracer_tpu_torch on one NVIDIA card (H100, sm_90a).

    python3 chip_smoke.py [--out results.json]

Builds the CUDA kernels from csrc/ (one nvcc per source, in parallel),
holds each kernel against its plain PyTorch version on the card, drives the
main paths (``render.render_frame``, the default frame, on three scenes;
``diff.image_loss_and_grads``, the differentiable step) and prints one
JSON line per phase:

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
6. diff: the differentiable step ``diff.image_loss_and_grads``.
   (e) ``sphere`` 4224 tris at 1920x1080, 2 bounces, L2 against black
   (the JAX bench's grads row): step ms (CUDA events, median of 10 after
   2 warm-ups), fwd+bwd Mrays/s = W*H*bounces/step, launches per step
   (K2.1, K2.3 and K2.4 twice each), peak memory, finite gradients that
   are nonzero on albedo, v0 and the instance transforms; K2.3 (bit-exact)
   and K2.4 (within 1e-5 * sum|g| + 1e-7) against their plain versions and
   library calls on the step's own inputs; torch.profiler over 3 steps.
   (f) the card's step against the CPU step (plain versions) on ``two``
   and ``sphere`` at 160x120. (g) 5 Adam steps of ``cli.fit`` on
   ``two``'s albedo at 1249x720: the loss falls
7. kernels: each kernel against its plain version at (a)'s shapes, then
   the kernels line: per kernel its TPU counterpart, launches on its path,
   error against the plain version, ms, plain ms, bound ms, library ms

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
    k3 = {
        "ms": event_ms(lambda: gr.gather_rows_cuda(table, idx), reps)[0],
        "plain_ms": event_ms(lambda: gr.gather_rows_plain(table, idx), reps)[0],
        "library_ms": event_ms(lambda: torch.index_select(table_t, 1, idx), reps)[0],
        "bound_ms": bytes_moved / PEAK_BYTES * 1e3, "bound_by": "bytes",
        "bytes": bytes_moved, "shape": f"table [{table.shape[0]}, {w}], idx [{n}]",
    }
    lib_scatter = lambda: torch.zeros(w, t_rows, device=g.device).index_add_(1, gidx, g)
    adds = int((g != 0).sum())
    t_bytes = bytes_moved / PEAK_BYTES * 1e3
    t_ops = adds / PEAK_F32 * 1e3
    k4 = {
        "ms": event_ms(lambda: gr.scatter_rows_cuda(g, gidx, t_rows), reps)[0],
        "plain_ms": event_ms(lambda: gr.scatter_rows_plain(g, gidx, t_rows), reps)[0],
        "library_ms": event_ms(lib_scatter, reps)[0],
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
        *diff_kernel_entries(results),
    ]})


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
            "ms": k["ms"], "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
            "bound_by": k["bound_by"], "library_ms": k["library_ms"],
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
