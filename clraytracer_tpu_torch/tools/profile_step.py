"""Per-op profile of the differentiable step (or the forward frame): the
JAX package's ``tools/profile_step.py`` on ``torch.profiler``.

    python -m clraytracer_tpu_torch.tools.profile_step [--forward] [--width W --height H]
        [--tris N] [--reps R] [--top K] [--device cpu]

Builds the flagship scene (``cli.build_scene("sphere", --tris)``), runs
the step (``diff.image_loss_and_grads`` with its default loss, plus the
sum of every gradient so that all of them are computed) or with
``--forward`` ``render.render_frame``, twice untimed, then ``--reps``
times under the profiler. On the card it prints the step's time by CUDA
events, the card's time per step (the sum of the trace's kernels, copies and
fills) and the top ``--top`` device ops by their own time on the card,
each with its launches per step. With ``--device cpu`` there is no device
trace: it prints the torch ops by their self CPU time instead, and says
so.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import tempfile

import torch
from torch.profiler import ProfilerActivity, profile

from clraytracer_tpu_torch import bench
from clraytracer_tpu_torch.camera import Camera
from clraytracer_tpu_torch.cli import build_scene
from clraytracer_tpu_torch.config import CameraConfig, RenderConfig
from clraytracer_tpu_torch.device import resolve_device
from clraytracer_tpu_torch.diff import image_loss_and_grads
from clraytracer_tpu_torch.render import FrameInputs, frame_inputs_from_camera, render_frame

#: the trace's categories of work on the card
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


def flagship_inputs(tris: int, width: int, height: int, dev: torch.device):
    """(scene, frame) of the flagship step: ``sphere`` at ``tris``, the
    bench's camera and sun, the frame's tensors on ``dev``."""
    scene = build_scene("sphere", tris, device=dev)
    cam = Camera.create(CameraConfig(position=bench.CAMERA, yaw_deg=-90.0), width, height)
    frame = FrameInputs(*(x.to(dev) for x in frame_inputs_from_camera(cam, bench.SUN)))
    return scene, frame


def step_fn(args, dev: torch.device):
    """The profiled call: the step (loss and gradient sum) or the frame."""
    scene, frame = flagship_inputs(args.tris, args.width, args.height, dev)
    if args.forward:
        cfg = RenderConfig(width=args.width, height=args.height)
        return lambda: render_frame(scene, frame, cfg, device=dev).sum()

    def step():
        loss, grads = image_loss_and_grads(scene, frame, args.width, args.height, device=dev)
        return loss + sum(g.float().sum() for g in grads.values()) * 1e-9

    return step


def device_ops(prof) -> list[tuple[float, int, str]]:
    """(us, launches, name) of each kernel, copy or fill name on the card,
    from the profiler's Chrome trace, most time first."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    by_name: dict[str, tuple[float, int]] = {}
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in DEVICE_CATEGORIES:
            us, n = by_name.get(e["name"], (0.0, 0))
            by_name[e["name"]] = (us + float(e["dur"]), n + 1)
    return sorted(((us, n, k) for k, (us, n) in by_name.items()), reverse=True)


def cpu_ops(prof) -> list[tuple[float, int, str]]:
    """(us, calls, name) of each torch op by its self CPU time."""
    rows = [(float(e.self_cpu_time_total), int(e.count), e.key) for e in prof.key_averages()]
    return sorted((r for r in rows if r[0] > 0), reverse=True)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m clraytracer_tpu_torch.tools.profile_step")
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--tris", type=int, default=4096)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--top", type=int, default=30)
    ap.add_argument("--forward", action="store_true",
                    help="profile the forward render_frame instead of the step")
    ap.add_argument("--device", default=None, help="cuda (default) | cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    cuda = dev.type == "cuda"
    fn = step_fn(args, dev)
    step_ms = statistics.median(bench.call_ms(fn, args.reps, dev))
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=activities) as prof:
        for _ in range(args.reps):
            fn()
        if cuda:
            torch.cuda.synchronize(dev)
    what = "render_frame" if args.forward else "step"
    r = args.reps
    if cuda:
        rows = device_ops(prof)
        if not rows:
            raise SystemExit("profile_step: the trace holds no device events")
        print(f"{what} {args.width}x{args.height}: {step_ms:.3f} ms (CUDA events, median "
              f"of {r}); device time {sum(x[0] for x in rows) / 1e3 / r:.3f} ms/{what} in "
              f"{sum(x[1] for x in rows) / r:g} launches ({r} profiled; "
              f"{bench.card_line()})")
    else:
        rows = cpu_ops(prof)
        print(f"{what} {args.width}x{args.height}: {step_ms:.3f} ms (host clock, median of "
              f"{r}); CPU run: no device trace, ops by self CPU time")
    for us, n, name in rows[:args.top]:
        print(f"{us / 1e3 / r:9.3f} ms  x{n / r:<6g} {name[:105]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
