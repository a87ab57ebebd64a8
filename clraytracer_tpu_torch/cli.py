"""Command line: render a named procedural scene to PNG.

Usage:
  python -m clraytracer_tpu_torch render --scene two --width 1024 --height 768 -o out.png
  python -m clraytracer_tpu_torch render --scene sphere --tris 1000000 --device cuda

Scenes: ``sphere`` (``--tris`` sets the triangle count), ``two`` and
``field`` — the JAX package's named scenes (cli.py:28-74), whose textures
are all procedural. The other commands and scene sources of the JAX CLI
come with later parts of the port.
"""

from __future__ import annotations

import argparse
import logging
import sys
import time


def build_scene(spec: str, tris: int = 4096, device=None):
    """Named procedural scenes, as the JAX package's ``build_scene``."""
    from clraytracer_tpu_torch import math3d
    from clraytracer_tpu_torch.scene import SceneBuilder
    from clraytracer_tpu_torch.scene import procedural_tex as ptex
    from clraytracer_tpu_torch.scene.procedural import cube, sphere_field, uv_sphere

    b = SceneBuilder()
    b.import_procedural(ptex.sky_gradient(512, 256))
    if spec == "sphere":
        n_lat = max(4, int((tris / 4) ** 0.5) + 1)
        checker = b.import_procedural(ptex.checker(128, 8))
        mat = b.create_material(
            albedo=(0.9, 0.6, 0.3), albedo_tex=checker, shininess=1.0, roughness=0.4
        )
        mesh = b.add_mesh(
            uv_sphere(2.0, n_lat=n_lat, n_lon=2 * n_lat), materials_start=mat
        )
        b.add_instance(mesh)
    elif spec == "two":
        checker = b.import_procedural(ptex.checker(64, 8))
        m1 = b.create_material(albedo=(0.9, 0.2, 0.2), albedo_tex=checker)
        m2 = b.create_material(albedo=(0.2, 0.9, 0.2))
        s = b.add_mesh(uv_sphere(1.5, 24, 48), materials_start=m1)
        c = b.add_mesh(cube(1.0), materials_start=m2)
        b.add_instance(s, math3d.translation(-2.0, 1.0, 0.0))
        b.add_instance(c, math3d.rotation_y(0.7) @ math3d.translation(2.5, 0.5, -1.0))
    elif spec == "field":
        mat = b.create_material(albedo=(0.7, 0.7, 0.9))
        mesh = b.add_mesh(
            sphere_field(n_side=6, n_lat=16, n_lon=32), materials_start=mat
        )
        b.add_instance(mesh)
    else:
        raise SystemExit(
            f"error: scene '{spec}' is not one of the named scenes "
            "(sphere, two, field)"
        )
    return b.build(device=device)


def _camera(args):
    from clraytracer_tpu_torch.camera import Camera
    from clraytracer_tpu_torch.config import CameraConfig

    return Camera.create(
        CameraConfig(
            position=tuple(args.camera_pos), yaw_deg=args.yaw, pitch_deg=args.pitch
        ),
        args.width,
        args.height,
    )


def cmd_render(args) -> int:
    import torch

    from clraytracer_tpu_torch.config import RenderConfig
    from clraytracer_tpu_torch.render import render, save_png

    log = logging.getLogger("clraytracer_tpu_torch")
    scene = build_scene(args.scene, args.tris, device=args.device)
    cfg = RenderConfig(
        width=args.width,
        height=args.height,
        bounces=args.bounces,
        sun_angle=args.sun_angle,
        enable_post=not args.no_post,
    )
    t0 = time.perf_counter()
    img = render(scene, _camera(args), cfg, device=args.device)
    if scene.device.type == "cuda":
        torch.cuda.synchronize()
    log.info("rendered %dx%d in %.1f ms (first frame, incl. set-up)",
             args.width, args.height, (time.perf_counter() - t0) * 1e3)
    save_png(args.output, img)
    log.info("wrote %s", args.output)
    return 0


def main(argv: list[str] | None = None) -> int:
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    ap = argparse.ArgumentParser(prog="clraytracer_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("render", help="render a frame to PNG")
    p.add_argument("--scene", default="sphere", help="sphere | two | field")
    p.add_argument("--width", type=int, default=1024)
    p.add_argument("--height", type=int, default=768)
    p.add_argument("--tris", type=int, default=4096)
    p.add_argument("--bounces", type=int, default=2)
    p.add_argument("--sun-angle", type=float, default=-1.96)
    p.add_argument("--camera-pos", type=float, nargs=3, default=[0.13, 0.21, 10.0])
    p.add_argument("--yaw", type=float, default=-90.0)
    p.add_argument("--pitch", type=float, default=0.0)
    p.add_argument("--device", default=None,
                   help="cuda (default) | cpu (the kernels' plain versions)")
    p.add_argument("-o", "--output", default="render.png")
    p.add_argument("--no-post", action="store_true")
    p.set_defaults(fn=cmd_render)
    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
