"""Turntable viewer: an orbiting camera's frames written as PNGs (and a
GIF), through the Engine frame loop (render → end_frame); the headless
stand-in for the reference's window (Window.cpp, Editor/Editor.cpp:71-102).

Usage:
  python -m clraytracer_tpu_torch.tools.viewer --scene two --frames 24 \\
      --width 480 --height 360 -o turntable [--device cpu]
"""

from __future__ import annotations

import argparse
import math
import os
import time


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="clraytracer_tpu_torch.tools.viewer")
    ap.add_argument("--scene", default="two")
    ap.add_argument("--width", type=int, default=480)
    ap.add_argument("--height", type=int, default=360)
    ap.add_argument("--frames", type=int, default=24)
    ap.add_argument("--radius", type=float, default=10.0)
    ap.add_argument("--elevation", type=float, default=1.5)
    ap.add_argument("--tracer", default="best")
    ap.add_argument("--gif", action="store_true", help="also write turn.gif (needs PIL)")
    ap.add_argument("--device", default=None, help="cuda (default) | cpu")
    ap.add_argument("-o", "--output", default="turntable")
    args = ap.parse_args(argv)

    from clraytracer_tpu_torch.camera import Camera
    from clraytracer_tpu_torch.cli import build_scene
    from clraytracer_tpu_torch.config import CameraConfig, RenderConfig
    from clraytracer_tpu_torch.engine import Engine
    from clraytracer_tpu_torch.render import save_png, to_srgb_u8

    os.makedirs(args.output, exist_ok=True)
    engine = Engine(
        config=RenderConfig(width=args.width, height=args.height),
        tracer=args.tracer,
        scene=build_scene(args.scene, device=args.device),
        device=args.device,
    )
    frames = []
    t0 = time.perf_counter()
    for i in range(args.frames):
        ang = 2.0 * math.pi * i / args.frames
        pos = (args.radius * math.sin(ang), args.elevation, args.radius * math.cos(ang))
        yaw = math.degrees(math.atan2(-math.cos(ang), -math.sin(ang)))
        engine.camera = Camera.create(
            CameraConfig(position=pos, yaw_deg=yaw), args.width, args.height
        )
        img = engine.render().cpu().numpy()
        engine.end_frame()
        path = os.path.join(args.output, f"frame_{i:04d}.png")
        save_png(path, img)
        frames.append(to_srgb_u8(img)[::-1])  # display flip, as save_png
        print(f"frame {i + 1}/{args.frames} -> {path}", flush=True)
    dt = time.perf_counter() - t0
    print(f"{args.frames} frames in {dt:.1f} s ({dt / args.frames * 1e3:.0f} ms avg, "
          f"host clock, PNG writes included)")
    if args.gif:
        from PIL import Image

        imgs = [Image.fromarray(f) for f in frames]
        gif = os.path.join(args.output, "turn.gif")
        imgs[0].save(gif, save_all=True, append_images=imgs[1:], duration=80, loop=0)
        print(f"wrote {gif}")
    engine.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
