"""Command line: render a named procedural scene to PNG, report its
gradients, or fit its parameters to a target image.

Usage:
  python -m clraytracer_tpu_torch render --scene two --width 1024 --height 768 -o out.png
  python -m clraytracer_tpu_torch render --scene sphere --tris 1000000 --device cuda
  python -m clraytracer_tpu_torch grads  --scene sphere --width 1920 --height 1080
  python -m clraytracer_tpu_torch fit    --scene two --steps 100 --lr 0.05

Scenes: ``sphere`` (``--tris`` sets the triangle count), ``two`` and
``field`` — the JAX package's named scenes (cli.py:28-74), whose textures
are all procedural. The other commands and scene sources of the JAX CLI
come with later parts of the port.
"""

from __future__ import annotations

import argparse
import json
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


def cmd_grads(args) -> int:
    """Gradient report (cli.py:201 of the JAX package): L2 loss of the
    differentiable render against a black image, and the norms of four
    gradient groups."""
    import torch

    from clraytracer_tpu_torch.diff import image_loss_and_grads
    from clraytracer_tpu_torch.render import frame_inputs_from_camera

    scene = build_scene(args.scene, args.tris, device=args.device)
    frame = frame_inputs_from_camera(_camera(args), args.sun_angle)
    target = torch.zeros((args.height, args.width, 3), device=scene.device)
    loss, grads = image_loss_and_grads(
        scene, frame, args.width, args.height, target=target,
        device=args.device, bounces=args.bounces,
    )
    keys = ("materials.albedo", "atlas.texels", "tris.v0",
            "instances.inverse_transform")
    out = {
        "loss": float(loss),
        "grad_norms": {
            k: float(torch.linalg.vector_norm(grads[k].float())) for k in keys
        },
    }
    print(json.dumps(out, indent=2))
    return 0


def fit(scene_true, frame, width, height, bounces=2, param="albedo",
        steps=100, lr=5e-2, seed=0, device=None):
    """Inverse rendering (cli.py:232 of the JAX package): render a target
    with the true scene, start the parameter group from
    ``clip(0.5 + 0.1 * normal, 0, 1)`` drawn with numpy's generator from
    ``seed``, and descend the image L2 with Adam. Returns (report, the
    fitted scene)."""
    import dataclasses

    import numpy as np
    import torch

    from clraytracer_tpu_torch.diff import render_image_diff
    from clraytracer_tpu_torch.ops.shade import _all_procedural

    log = logging.getLogger("clraytracer_tpu_torch")
    if param == "texels" and _all_procedural(scene_true):
        raise ValueError(
            "--fit-param texels: every texture of this scene is procedural, "
            "so its texel gradients are zero by design"
        )
    group, field = {"albedo": ("materials", "albedo"),
                    "texels": ("atlas", "texels")}[param]

    def with_param(p):
        g = dataclasses.replace(getattr(scene_true, group), **{field: p})
        return dataclasses.replace(scene_true, **{group: g})

    def render(s):
        return render_image_diff(s, frame, width, height, bounces=bounces,
                                 device=device)

    # the frame moves to the device once, not in every step
    dev = scene_true.device
    frame = type(frame)(*(torch.as_tensor(x, dtype=torch.float32, device=dev)
                          for x in frame))
    with torch.no_grad():
        target = render(scene_true)
    leaf = getattr(getattr(scene_true, group), field)
    rng = np.random.default_rng(seed)
    init = np.clip(
        np.float32(0.5)
        + np.float32(0.1) * rng.standard_normal(leaf.shape).astype(np.float32),
        0.0, 1.0,
    )
    p = torch.tensor(init, dtype=leaf.dtype, device=leaf.device, requires_grad=True)
    opt = torch.optim.Adam([p], lr=lr)
    losses = []
    for i in range(steps):
        opt.zero_grad()
        loss = torch.mean((render(with_param(p)) - target) ** 2)
        loss.backward()
        opt.step()
        losses.append(loss.detach())
        if i % max(1, steps // 10) == 0:
            log.info("fit step %d: loss %.6g", i, float(losses[-1]))
    losses = [float(x) for x in losses]
    init_t = torch.as_tensor(init, device=leaf.device)
    report = {
        "param": param,
        "steps": steps,
        "loss_first": losses[0],
        "loss_last": losses[-1],
        "losses": losses,
        "param_mae_init": float((init_t - leaf).abs().mean()),
        "param_mae_final": float((p.detach() - leaf).abs().mean()),
    }
    return report, with_param(p.detach())


def cmd_fit(args) -> int:
    from clraytracer_tpu_torch.diff import render_image_diff
    from clraytracer_tpu_torch.render import frame_inputs_from_camera, save_png

    scene_true = build_scene(args.scene, args.tris, device=args.device)
    frame = frame_inputs_from_camera(_camera(args), args.sun_angle)
    report, fitted = fit(
        scene_true, frame, args.width, args.height, args.bounces,
        args.fit_param, args.steps, args.lr, args.seed, args.device,
    )
    report.pop("losses")
    print(json.dumps(report, indent=2))
    if args.output:
        img = render_image_diff(fitted, frame, args.width, args.height,
                                bounces=args.bounces, device=args.device)
        save_png(args.output, img.detach().cpu().numpy())
        logging.getLogger("clraytracer_tpu_torch").info("wrote %s", args.output)
    return 0


def main(argv: list[str] | None = None) -> int:
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    ap = argparse.ArgumentParser(prog="clraytracer_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    def common(p):
        p.add_argument("--scene", default="sphere", help="sphere | two | field")
        p.add_argument("--width", type=int, default=1024)
        p.add_argument("--height", type=int, default=768)
        p.add_argument("--tris", type=int, default=4096)
        p.add_argument("--bounces", type=int, default=2)
        p.add_argument("--sun-angle", type=float, default=-1.96)
        p.add_argument("--camera-pos", type=float, nargs=3,
                       default=[0.13, 0.21, 10.0])
        p.add_argument("--yaw", type=float, default=-90.0)
        p.add_argument("--pitch", type=float, default=0.0)
        p.add_argument("--device", default=None,
                       help="cuda (default) | cpu (the kernels' plain versions)")

    p = sub.add_parser("render", help="render a frame to PNG")
    common(p)
    p.add_argument("-o", "--output", default="render.png")
    p.add_argument("--no-post", action="store_true")
    p.set_defaults(fn=cmd_render)

    p = sub.add_parser("grads", help="gradient report (L2 against black)")
    common(p)
    p.set_defaults(fn=cmd_grads)

    p = sub.add_parser(
        "fit", help="inverse rendering: recover parameters from a target"
    )
    common(p)
    p.add_argument("--fit-param", choices=("albedo", "texels"), default="albedo",
                   help="texels needs a scene with imported textures")
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--lr", type=float, default=5e-2)
    p.add_argument("--seed", type=int, default=0,
                   help="seed of numpy's generator for the initial guess "
                   "(not the JAX package's jax.random draw, so the two CLIs "
                   "start from different guesses)")
    p.add_argument("-o", "--output", default=None,
                   help="write the render of the fitted scene here")
    p.set_defaults(fn=cmd_fit)
    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
