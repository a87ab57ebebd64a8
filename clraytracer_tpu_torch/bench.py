"""Benchmark twin of the repository's ``bench.py``: forward ray throughput
of ``render.render_frame`` (or the differentiable step with ``--grads``) on
the flagship scene, timed on the card.

    python -m clraytracer_tpu_torch.bench [--width 1920 --height 1080 ...]
    python -m clraytracer_tpu_torch.bench --matrix --out rows.json

Prints one JSON line: ``{"metric", "value", "unit", ...}``. Each call of
the timed function has CUDA events around it, after ``WARMUP`` calls, and
the row reports the median of ``--iters`` (the host clock with ``--device
cpu``); nothing clamps the time. Beside it stand the device and, on the
card, its ``nvidia-smi`` name and power limit. The JAX bench's
``vs_baseline`` (a target set for a TPU chip) is not printed.

``--matrix`` runs the JAX bench's rows (flagship, museum, 1M-tri, atlas,
gi, grads), each in its own process, prints one line per row (an error row
where a row fails, as ``museum`` does without ``$CLRT_REFERENCE_ASSETS``)
and writes the rows only where ``--out`` points.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

#: untimed calls before the timed ones: the first builds the kernels and
#: uploads the scene's tables
WARMUP = 2
CAMERA = (0.13, 0.21, 10.0)
SUN = -1.96
#: the JAX bench's matrix (bench.py:281-288): (row, extra arguments)
MATRIX_ROWS = (
    ("flagship", []),
    ("museum", ["--scene", "museum"]),
    ("1M-tri", ["--tris", "1000000"]),
    ("atlas", ["--atlas"]),
    ("gi", ["--gi"]),
    ("grads", ["--grads", "--iters", "4"]),
)


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="clraytracer_tpu_torch.bench")
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--iters", type=int, default=8)
    ap.add_argument("--tracer", default="best", help="a name of render.TRACERS")
    ap.add_argument("--tris", type=int, default=4096, help="approx triangle count")
    ap.add_argument("--scene", default=None,
                    help="named scene or path (.obj/.clm/.clsnap.npz); default: "
                    "the textured sphere of the JAX bench")
    ap.add_argument("--camera-pos", type=float, nargs=3, default=None)
    ap.add_argument("--yaw", type=float, default=-90.0)
    ap.add_argument("--atlas", action="store_true",
                    help="the default scene's textures imported as images "
                    "(atlas mode 1) instead of procedural descriptors")
    ap.add_argument("--gi", action="store_true", help="the Monte-Carlo GI frame")
    ap.add_argument("--grads", action="store_true",
                    help="the differentiable step (L2 against black, gradients "
                    "of every scene leaf) instead of the forward frame")
    ap.add_argument("--matrix", action="store_true",
                    help="every row of the JAX bench's matrix, each in its own process")
    ap.add_argument("--out", default=None,
                    help="also write the row (or, with --matrix, the rows) here as JSON")
    ap.add_argument("--device", default=None,
                    help="cuda (default) | cpu (the kernels' plain versions, host clock)")
    return ap


def card_line() -> str:
    """The card's ``name, power.limit`` as nvidia-smi prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def default_builder(tris: int, atlas: bool):
    """The JAX bench's scene (bench.py:73-92), not yet built: a checkered
    sphere of about ``tris`` triangles under a sky gradient, its textures
    procedural or, with ``atlas``, imported as images."""
    from clraytracer_tpu_torch.cli import scene_builder

    if not atlas:
        return scene_builder("sphere", tris)
    from clraytracer_tpu_torch.scene import SceneBuilder
    from clraytracer_tpu_torch.scene.procedural import uv_sphere
    from clraytracer_tpu_torch.scene.textures import checkerboard, gradient_sky

    n_lat = max(4, int((tris / 4) ** 0.5) + 1)
    b = SceneBuilder()
    b.import_texture(gradient_sky(512, 256))
    checker = b.import_texture(checkerboard(128, 8))
    mat = b.create_material(
        albedo=(0.9, 0.6, 0.3), albedo_tex=checker, shininess=1.0, roughness=0.4
    )
    b.add_instance(b.add_mesh(uv_sphere(2.0, n_lat=n_lat, n_lon=2 * n_lat),
                              materials_start=mat))
    return b


def call_ms(fn, iters: int, dev) -> list[float]:
    """ms of each of ``iters`` calls after ``WARMUP`` calls: CUDA events
    around each call on the card (the event after the call synchronised),
    the host clock on the CPU."""
    import torch

    for _ in range(WARMUP):
        fn()
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.synchronize(dev)
    times = []
    for _ in range(iters):
        if cuda:
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        else:
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
    return times


def run(args) -> dict:
    """One row: the frame's (or the step's) time and rays/s."""
    import torch

    from clraytracer_tpu_torch.camera import Camera
    from clraytracer_tpu_torch.cli import build_scene
    from clraytracer_tpu_torch.config import CameraConfig, RenderConfig
    from clraytracer_tpu_torch.device import resolve_device
    from clraytracer_tpu_torch.render import TRACERS, frame_inputs_from_camera, render_frame

    dev = resolve_device(args.device)
    if args.tracer not in TRACERS:
        raise SystemExit(f"error: tracer '{args.tracer}' is not one of {', '.join(TRACERS)}")
    if args.scene:
        scene = build_scene(args.scene, args.tris, device=dev)
        label = args.scene.rsplit("/", 1)[-1]
    else:
        scene = default_builder(args.tris, args.atlas).build(device=dev)
        label = "sphere scene" + (" (atlas tex)" if args.atlas else "")
    pos = tuple(args.camera_pos) if args.camera_pos else CAMERA
    cam = Camera.create(CameraConfig(position=pos, yaw_deg=args.yaw), args.width, args.height)
    config = RenderConfig(width=args.width, height=args.height, enable_gi=args.gi)
    frame = frame_inputs_from_camera(cam, SUN)
    w, h, bounces = args.width, args.height, config.bounces
    keep = []
    if args.grads:
        from clraytracer_tpu_torch.diff import image_loss_and_grads

        target = torch.zeros((h, w, 3), device=dev)

        def step():
            loss, grads = image_loss_and_grads(scene, frame, w, h, target=target, device=dev)
            # read every gradient leaf, as the JAX bench consumes them
            keep[:] = [loss + sum(g.float().sum() * 1e-9 for g in grads.values())]

        times = call_ms(step, args.iters, dev)
        metric = (f"fwd+bwd rays/s, {w}x{h}x{bounces}bounce {label}, "
                  "grads w.r.t. all scene leaves")
    else:
        tracer = TRACERS[args.tracer]

        def one():
            keep[:] = [render_frame(scene, frame, config, dev, tracer)]

        times = call_ms(one, args.iters, dev)
        metric = (f"fwd rays/s, {w}x{h}x{bounces}bounce {label}"
                  + (" +GI" if args.gi else "") + f", tracer={args.tracer}")
    if not bool(torch.isfinite(keep[0]).all()):
        raise SystemExit("error: the benchmarked call produced non-finite values")
    ms = statistics.median(times)
    cuda = dev.type == "cuda"
    return {
        "metric": metric,
        "value": w * h * bounces / (ms * 1e-3) / 1e6,
        "unit": "Mrays/s",
        "ms": ms, "ms_min": min(times), "ms_max": max(times), "iters": args.iters,
        "clock": "cuda events" if cuda else "host",
        "device": dev.type,
        "kind": torch.cuda.get_device_name(dev) if cuda else "cpu",
        "card": card_line() if cuda else None,
        "triangles": int(scene.tris.count),
    }


def run_matrix(args) -> list[dict]:
    """Every row of ``MATRIX_ROWS`` in its own process (a failure or a
    full card in one row does not touch the next)."""
    root = str(Path(__file__).resolve().parent.parent)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(p for p in (root, env.get("PYTHONPATH")) if p)
    common = ["--width", str(args.width), "--height", str(args.height),
              "--iters", str(args.iters)]
    if args.device:
        common += ["--device", args.device]
    rows = []
    for name, extra in MATRIX_ROWS:
        cmd = [sys.executable, "-m", "clraytracer_tpu_torch.bench", *common, *extra]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True, timeout=1800, env=env)
            line = next((ln for ln in proc.stdout.splitlines() if ln.startswith("{")), None)
            if proc.returncode != 0 or line is None:
                row = {"metric": name, "error": (proc.stderr or "no output").strip()[-500:]}
            else:
                row = {**json.loads(line), "row": name}
        except subprocess.TimeoutExpired:
            row = {"metric": name, "error": "timeout"}
        rows.append(row)
        print(json.dumps(row), flush=True)
    return rows


def main(argv: list[str] | None = None) -> int:
    args = parser().parse_args(argv)
    from clraytracer_tpu_torch.device import resolve_device

    resolve_device(args.device)  # no card and no --device cpu: raise here
    if args.matrix:
        out = run_matrix(args)
    else:
        out = run(args)
        print(json.dumps(out), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
