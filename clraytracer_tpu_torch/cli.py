"""Command line: render a scene to PNG, benchmark it, report its
gradients, fit its parameters to a target image, print its statistics or
save it as a snapshot.

Usage:
  python -m clraytracer_tpu_torch render --scene two --width 1024 --height 768 -o out.png
  python -m clraytracer_tpu_torch render --scene sphere --tris 1000000 --device cuda
  python -m clraytracer_tpu_torch render --scene two --shadows --gi --spp 4 --fxaa
  python -m clraytracer_tpu_torch render --scene glass --refraction --ior 1.45
  python -m clraytracer_tpu_torch render --scene path/to/mesh.obj --tracer wavefront
  python -m clraytracer_tpu_torch bench  --width 1920 --height 1080
  python -m clraytracer_tpu_torch grads  --scene sphere --width 1920 --height 1080
  python -m clraytracer_tpu_torch fit    --scene two --steps 100 --lr 0.05 --save-snapshot fit.clsnap.npz
  python -m clraytracer_tpu_torch inspect  --scene path/to/mesh.clm
  python -m clraytracer_tpu_torch snapshot --scene path/to/mesh.obj -o scene.clsnap.npz

Scenes: ``sphere`` (``--tris`` sets the triangle count), ``two``,
``glass``, ``field`` and ``museum`` (the reference's three ``.clm``
scenes under ``$CLRT_REFERENCE_ASSETS``) — the JAX package's named scenes
(cli.py:28-94) — or a path: an OBJ (with its MTL and textures), a
``.clm`` or a ``.clsnap.npz`` snapshot. ``--tracer`` picks the tracer by
name (``render.TRACERS``): best, brute, bvh, wavefront or pallas (the
port's K2.1). ``bench`` runs the benchmark twin (``bench.py`` of this
package) in process. ``sweep`` renders through the multi-device layer
(``parallel/``) over 1, 2, 4, ... ranks of a ``torch.distributed`` group,
one process per rank:

  python -m clraytracer_tpu_torch sweep --width 1920 --height 1080
  torchrun --nproc-per-node 4 -m clraytracer_tpu_torch sweep --coordinator auto
  python -m clraytracer_tpu_torch sweep --device cpu --coordinator file:///tmp/rdv \
      --num-processes 2 --process-id 0    # and --process-id 1 beside it

NCCL takes one rank per card; ``--backend gloo`` puts several ranks on one
card (or the CPU, where gloo is the default).
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys
import time
from pathlib import Path

#: where the ``museum`` scene's reference assets lie (its ``sponza``,
#: ``sibenik`` and ``nanosuit`` folders)
ASSETS_ENV = "CLRT_REFERENCE_ASSETS"


def build_scene(spec: str, tris: int = 4096, device=None):
    """Named scenes or a scene file, as the JAX package's ``build_scene``:
    an OBJ or ``.clm`` is imported as one instance under the procedural
    sky, a ``.clsnap.npz`` restored as saved."""
    if spec.endswith(".clsnap.npz"):
        # the full runtime state as saved: no re-import or rebuild
        from clraytracer_tpu_torch.scene.checkpoint import load_scene

        scene, _ = load_scene(spec, device=device)
        return scene
    return scene_builder(spec, tris).build(device=device)


def scene_builder(spec: str, tris: int = 4096):
    """The SceneBuilder of a named scene or of an OBJ/``.clm`` file, not yet
    built (what ``engine.Engine`` animates)."""
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
    elif spec == "glass":
        # refraction demo (render with --refraction): a transmissive sphere
        # in front of a checkered backdrop sphere
        m_glass = b.create_material(
            albedo=(0.95, 0.98, 1.0), transmission=0.85, shininess=2.0, roughness=0.1
        )
        checker = b.import_procedural(ptex.checker(64, 8))
        m_back = b.create_material(albedo=(0.9, 0.5, 0.3), albedo_tex=checker)
        glass = b.add_mesh(uv_sphere(1.5, 24, 48), materials_start=m_glass)
        back = b.add_mesh(uv_sphere(2.5, 16, 32), materials_start=m_back)
        b.add_instance(glass, math3d.translation(0.0, 0.5, 2.5))
        b.add_instance(back, math3d.translation(0.0, 0.5, -3.0))
    elif spec == "field":
        mat = b.create_material(albedo=(0.7, 0.7, 0.9))
        mesh = b.add_mesh(
            sphere_field(n_side=6, n_lat=16, n_lon=32), materials_start=mat
        )
        b.add_instance(mesh)
    elif spec == "museum":
        # the three reference .clm scenes as one multi-instance scene (~160k
        # tris, ~45 textures: a pool past the reference's 32-texture cap)
        from clraytracer_tpu_torch.config import PoolConfig

        ref = Path(os.environ.get(ASSETS_ENV, "reference/CLRayTracer/Assets"))
        if not ref.exists():
            raise SystemExit("error: museum scene needs the reference assets")
        b = SceneBuilder(PoolConfig(max_textures=64))
        b.import_procedural(ptex.sky_gradient(512, 256))
        sponza = b.import_mesh(ref / "sponza/sponza.clm")
        sibenik = b.import_mesh(ref / "sibenik/sibenik.clm")
        nanosuit = b.import_mesh(ref / "nanosuit/nanosuit.clm")
        b.add_instance(sponza)
        b.add_instance(sibenik, math3d.translation(0.0, 25.0, 0.0))
        b.add_instance(nanosuit, math3d.translation(0.0, 0.0, 3.0))
    else:
        path = Path(spec)
        if not path.exists():
            raise SystemExit(
                f"error: scene '{spec}' is neither a named scene "
                f"(sphere, two, field) nor an existing OBJ/.clsnap path"
            )
        b.add_instance(b.import_mesh(path))
    return b


def _tracer(name: str):
    from clraytracer_tpu_torch.render import TRACERS

    if name not in TRACERS:
        raise SystemExit(f"error: tracer '{name}' is not one of {', '.join(TRACERS)}")
    return TRACERS[name]


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
    tracer = _tracer(args.tracer)
    scene = build_scene(args.scene, args.tris, device=args.device)
    cfg = RenderConfig(
        width=args.width,
        height=args.height,
        bounces=args.bounces,
        sun_angle=args.sun_angle,
        enable_post=not args.no_post,
        enable_fxaa=args.fxaa,
        enable_shadows=args.shadows,
        enable_refraction=args.refraction,
        refraction_ior=args.ior,
        samples=args.spp,
        enable_gi=args.gi,
        gi_seed=args.gi_seed,
    )
    t0 = time.perf_counter()
    img = render(scene, _camera(args), cfg, device=args.device, tracer=tracer)
    if scene.device.type == "cuda":
        torch.cuda.synchronize()
    log.info("rendered %dx%d in %.1f ms (first frame, incl. set-up)",
             args.width, args.height, (time.perf_counter() - t0) * 1e3)
    save_png(args.output, img)
    log.info("wrote %s", args.output)
    return 0


def cmd_bench(args) -> int:
    """The benchmark twin in process, with the JAX ``cmd_bench``'s
    arguments (cli.py:178 of the JAX package) and ``--device``."""
    from clraytracer_tpu_torch import bench

    argv = [
        "--width", str(args.width), "--height", str(args.height),
        "--tris", str(args.tris), "--yaw", str(args.yaw),
        "--camera-pos", *(str(c) for c in args.camera_pos),
        "--tracer", args.tracer,
    ]
    if args.scene and args.scene != "sphere":
        argv += ["--scene", args.scene]
    if args.device:
        argv += ["--device", args.device]
    return bench.main(argv)


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
        steps=100, lr=5e-2, seed=0, device=None, init_output=None):
    """Inverse rendering (cli.py:232 of the JAX package): render a target
    with the true scene, start the parameter group from
    ``clip(0.5 + 0.1 * normal, 0, 1)`` drawn with numpy's generator from
    ``seed``, and descend the image L2 with Adam. ``init_output``: a PNG
    path for the initial guess's render, written before the first step.
    Returns (report, the fitted scene)."""
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
    if init_output:
        from clraytracer_tpu_torch.render import save_png

        with torch.no_grad():
            save_png(init_output, render(with_param(p)).cpu().numpy())
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
    """``fit``; with ``-o out.png`` the initial guess's render goes to
    ``out_init.png`` first and the fitted one to ``out.png`` (cli.py:291-294
    of the JAX package)."""
    import os

    from clraytracer_tpu_torch.diff import render_image_diff
    from clraytracer_tpu_torch.render import frame_inputs_from_camera, save_png

    scene_true = build_scene(args.scene, args.tris, device=args.device)
    frame = frame_inputs_from_camera(_camera(args), args.sun_angle)
    init_output = None
    if args.output:
        root, ext = os.path.splitext(args.output)
        init_output = f"{root}_init{ext}"
    report, fitted = fit(
        scene_true, frame, args.width, args.height, args.bounces,
        args.fit_param, args.steps, args.lr, args.seed, args.device, init_output,
    )
    report.pop("losses")
    print(json.dumps(report, indent=2))
    log = logging.getLogger("clraytracer_tpu_torch")
    if args.output:
        img = render_image_diff(fitted, frame, args.width, args.height,
                                bounces=args.bounces, device=args.device)
        save_png(args.output, img.detach().cpu().numpy())
        log.info("wrote %s", args.output)
    if args.save_snapshot:
        from clraytracer_tpu_torch.scene.checkpoint import save_scene

        save_scene(fitted, args.save_snapshot, extras={"fit": report})
        log.info("wrote %s", args.save_snapshot)
    return 0


def _maybe_init_distributed(args) -> int:
    """Start ``torch.distributed`` when a coordinator is given, by flag or
    by environment (``CLRT_COORDINATOR``, ``CLRT_NUM_PROCESSES``,
    ``CLRT_PROCESS_ID``; cli.py:325 of the JAX package). Returns this
    process's rank (0 without a coordinator).

    ``--coordinator host:port`` rendezvouses over TCP, a URL
    (``file:///path``, ``tcp://host:port``) as given, and ``auto`` through
    the environment that ``torchrun`` sets (``env://``). The backend is
    ``--backend``, else NCCL on the card and gloo on the CPU; the group
    fails after ``parallel.sharding.INIT_TIMEOUT`` without its ranks."""
    import torch.distributed as dist

    from clraytracer_tpu_torch.parallel.sharding import INIT_TIMEOUT

    coord = getattr(args, "coordinator", None) or os.environ.get("CLRT_COORDINATOR")
    if coord is None:
        return 0
    backend = args.backend or ("gloo" if args.device == "cpu" else "nccl")
    if coord == "auto":
        dist.init_process_group(backend, init_method="env://", timeout=INIT_TIMEOUT)
    else:
        nproc = getattr(args, "num_processes", None) or int(
            os.environ.get("CLRT_NUM_PROCESSES", "0"))
        pid = getattr(args, "process_id", None)
        if pid is None:
            pid = int(os.environ.get("CLRT_PROCESS_ID", "-1"))
        if nproc <= 0 or pid < 0:
            raise SystemExit("error: --coordinator needs --num-processes and "
                             "--process-id (or CLRT_NUM_PROCESSES, CLRT_PROCESS_ID)")
        url = coord if "://" in coord else f"tcp://{coord}"
        dist.init_process_group(backend, init_method=url, world_size=nproc, rank=pid,
                                timeout=INIT_TIMEOUT)
    return dist.get_rank()


def cmd_sweep(args) -> int:
    """Scaling sweep (cli.py:373 of the JAX package): rays/s of
    ``render_sharded`` over the first 1, 2, 4, ... ranks, each count
    through a group of those ranks while the others wait. Frame time is
    the median of ``--iters`` frames after a warm-up, the all-gather
    included, timed on rank 0 by CUDA events (on the CPU by the host
    clock); efficiency = rays/s(n) / (n * rays/s(1)). Ranks that share a
    card measure the mechanism, not scaling."""
    import torch
    import torch.distributed as dist

    from clraytracer_tpu_torch.config import RenderConfig
    from clraytracer_tpu_torch.parallel.sharding import (
        DeviceMesh,
        local_device,
        render_sharded,
        replicate_scene,
    )
    from clraytracer_tpu_torch.render import frame_inputs_from_camera
    from clraytracer_tpu_torch.runtime import kernels

    rank = _maybe_init_distributed(args)
    world = dist.get_world_size() if dist.is_initialized() else 1
    dev = local_device(args.device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        # one build: rank 0 compiles into _build/, the others load it after
        if rank == 0:
            kernels.build_all()
        if world > 1:
            dist.barrier()
        kernels.build_all()
    tracer = _tracer(args.tracer)
    scene_h = build_scene(args.scene, args.tris, device=dev)
    frame = frame_inputs_from_camera(_camera(args), args.sun_angle)
    cfg = RenderConfig(width=args.width, height=args.height, bounces=args.bounces)
    counts = [n for n in (1, 2, 4, 8, 16, 32) if n <= world]
    # every rank makes every group, in the same order; the whole world is
    # the default group (so a world of one still runs its collectives)
    groups = {n: None for n in counts}
    if dist.is_initialized():
        groups = {n: dist.new_group(list(range(n))) if n < world else dist.group.WORLD
                  for n in counts}

    def time_n(n: int) -> float:
        mesh = DeviceMesh(groups[n], rank, n, dev)
        scene = replicate_scene(scene_h, mesh)
        ms = []
        for i in range(1 + args.iters):
            if dev.type == "cuda":
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                a.record()
                render_sharded(scene, frame, cfg, mesh, tracer=tracer)
                b.record()
                b.synchronize()
                ms.append(a.elapsed_time(b))
            else:
                t0 = time.perf_counter()
                render_sharded(scene, frame, cfg, mesh, tracer=tracer)
                ms.append((time.perf_counter() - t0) * 1e3)
        steady = sorted(ms[1:])
        return steady[len(steady) // 2]

    rays = args.width * args.height * args.bounces
    results = []
    base = None
    for n in counts:
        if rank < n:
            frame_ms = time_n(n)
            mrays = rays / (frame_ms * 1e-3) / 1e6
            base = mrays if base is None else base
            results.append({"devices": n, "frame_ms": frame_ms, "mrays_per_s": mrays,
                            "efficiency": mrays / (n * base)})
            if rank == 0:
                print(json.dumps(results[-1]), flush=True)
        if world > 1:
            dist.barrier()
    if rank == 0:
        print(json.dumps({
            "platform": dev.type, "kind": (torch.cuda.get_device_name(dev)
                                           if dev.type == "cuda" else "cpu"),
            "backend": dist.get_backend() if dist.is_initialized() else None,
            "tracer": args.tracer, "processes": world, "sweep": results,
        }), flush=True)
    if dist.is_initialized():
        dist.destroy_process_group()
    return 0


def cmd_inspect(args) -> int:
    """The scene's table counts as JSON (cli.py:469 of the JAX package)."""
    from clraytracer_tpu_torch.scene.types import scene_summary

    scene = build_scene(args.scene, args.tris, device=args.device)
    print(json.dumps(scene_summary(scene), indent=2))
    return 0


def cmd_snapshot(args) -> int:
    """Save the scene's full state as a ``.clsnap.npz`` (cli.py:129 of the
    JAX package)."""
    from clraytracer_tpu_torch.scene.checkpoint import save_scene

    scene = build_scene(args.scene, args.tris, device=args.device)
    save_scene(scene, args.output)
    logging.getLogger("clraytracer_tpu_torch").info("wrote %s", args.output)
    return 0


def main(argv: list[str] | None = None) -> int:
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    ap = argparse.ArgumentParser(prog="clraytracer_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    def common(p):
        p.add_argument("--scene", default="sphere",
                       help="sphere | two | glass | field | museum | path "
                       "(.obj/.clm/.clsnap.npz)")
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
        p.add_argument("--tracer", default="best",
                       help="best (K2.1 when the scene has cluster tables, else "
                       "wavefront) | pallas (K2.1) | wavefront | bvh | brute")

    p = sub.add_parser("render", help="render a frame to PNG")
    common(p)
    p.add_argument("-o", "--output", default="render.png")
    p.add_argument("--fxaa", action="store_true")
    p.add_argument("--no-post", action="store_true")
    p.add_argument("--shadows", action="store_true",
                   help="sun shadow rays (beyond the reference: its TODO)")
    p.add_argument("--refraction", action="store_true",
                   help="Snell refraction through transmissive materials "
                   "(beyond the reference: its TODO); see the 'glass' scene")
    p.add_argument("--ior", type=float, default=1.45,
                   help="index of refraction for --refraction")
    p.add_argument("--spp", type=int, default=1,
                   help="sub-pixel samples per pixel (supersampling AA)")
    p.add_argument("--gi", action="store_true",
                   help="Monte-Carlo diffuse GI: uniform-hemisphere bounce "
                   "continuations, albedo * 2*cosTheta throughput; combine "
                   "with --spp N to integrate")
    p.add_argument("--gi-seed", type=int, default=0,
                   help="base RNG seed for --gi sample streams")
    p.set_defaults(fn=cmd_render)

    p = sub.add_parser("bench", help="throughput benchmark (CUDA events)")
    common(p)
    p.set_defaults(fn=cmd_bench)

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
                   help="write the render of the fitted scene here, and the "
                   "initial guess's beside it as <name>_init.png")
    p.add_argument("--save-snapshot", default=None,
                   help="write the fitted scene as a .clsnap.npz")
    p.set_defaults(fn=cmd_fit)

    p = sub.add_parser("inspect", help="scene statistics")
    common(p)
    p.set_defaults(fn=cmd_inspect)

    p = sub.add_parser(
        "sweep", help="multi-device scaling sweep (rays/s against rank count)"
    )
    common(p)
    p.add_argument("--iters", type=int, default=4)
    p.add_argument("--coordinator", default=None,
                   help="host:port, a URL (file:///path, tcp://host:port) or 'auto' "
                   "(torchrun's environment); env fallback CLRT_COORDINATOR")
    p.add_argument("--num-processes", type=int, default=None,
                   help="total process count (CLRT_NUM_PROCESSES)")
    p.add_argument("--process-id", type=int, default=None,
                   help="this process's rank (CLRT_PROCESS_ID)")
    p.add_argument("--backend", choices=("nccl", "gloo"), default=None,
                   help="nccl (default on the card: one rank per card) | gloo "
                   "(default on the CPU; several ranks on one card)")
    p.set_defaults(fn=cmd_sweep)

    p = sub.add_parser(
        "snapshot",
        help="save a scene's full runtime state to a .clsnap.npz checkpoint",
    )
    common(p)
    p.add_argument("-o", "--output", default="scene.clsnap.npz")
    p.set_defaults(fn=cmd_snapshot)
    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
